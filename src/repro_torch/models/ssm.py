"""Mamba-2 SSD (state-space duality) blocks (port of ``repro.models.ssm``).

Prefill runs the chunked scan through ``repro_torch.kernels.ssd.ops.ssd``:
the hand-written CUDA kernel on the card, its plain chunked version on the
CPU.  The reference's pure-XLA ``ssd_chunked`` is that plain version
(``kernels/ssd/ref.py``).  ``ssd_sequential`` is the slow per-token
reference used in tests.  ``ssd_step`` is the O(1)-per-token decode
update, plain torch as in the reference.

The cache is updated in place, like the port's KV cache: ``mamba2_block``
writes the new conv state, SSM state and ``len`` into the cache tensors it
is given (the reference returns a new cache).
"""
from __future__ import annotations

from typing import Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd.ops import ssd
from repro_torch.models.layers import ParamDef, causal_conv1d, rms_norm

# ---------------------------------------------------------------------------
# Core SSD math.  Shapes: x (B,S,H,P), dt (B,S,H) (post-softplus),
# A (H,) negative, Bm/Cm (B,S,N) (n_groups=1, broadcast over heads).
# ---------------------------------------------------------------------------


def ssd_sequential(x, dt, A, Bm, Cm, init_state=None):
    """The per-token recurrence -> (y (B,S,H,P) in x's dtype, h_T (B,H,P,N))."""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    h = (torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device)
         if init_state is None else init_state.float())
    ys = []
    for t in range(S):
        y, h = _step(h, x[:, t].float(), dt[:, t].float(), A, Bm[:, t].float(),
                     Cm[:, t].float())
        ys.append(y)
    y = torch.stack(ys, dim=1) if ys else x.new_zeros((B, 0, H, P), dtype=torch.float32)
    return y.to(x.dtype), h


def _step(state, xt, dtt, A, bt, ct):
    da = torch.exp(dtt * A)                                           # (B,H)
    dbx = dtt[..., None, None] * xt[..., None] * bt[:, None, None, :]
    state = da[..., None, None] * state + dbx
    return torch.einsum("bhpn,bn->bhp", state, ct), state


def ssd_step(state, xt, dtt, A, bt, ct):
    """One decode step.  state (B,H,P,N); xt (B,H,P); dtt (B,H); bt/ct (B,N)."""
    y, state = _step(state, xt.float(), dtt.float(), A, bt.float(), ct.float())
    return y.to(xt.dtype), state


# ---------------------------------------------------------------------------
# Mamba-2 block
# ---------------------------------------------------------------------------


def mamba2_defs(cfg, layers_prefix: Tuple[int, ...] = ()) -> dict:
    lp = layers_prefix
    la = ("layers",) * len(lp)
    di, N, H = cfg.d_inner, cfg.d_state, cfg.n_ssm_heads
    G = cfg.ssm_ngroups
    d_in_proj = 2 * di + 2 * G * N + H   # z, x, B, C, dt
    conv_ch = di + 2 * G * N             # conv over x, B, C
    return {
        "in_proj": ParamDef(lp + (cfg.d_model, d_in_proj), la + ("w_embed", "w_mlp"), cfg.param_dtype),
        "conv_w": ParamDef(lp + (cfg.conv_width, conv_ch), la + ("w_conv", "w_mlp"), cfg.param_dtype, scale=0.2),
        "conv_b": ParamDef(lp + (conv_ch,), la + ("w_mlp",), cfg.param_dtype, "zeros"),
        "A_log": ParamDef(lp + (H,), la + ("w_state",), torch.float32, "ones"),
        "D": ParamDef(lp + (H,), la + ("w_state",), torch.float32, "ones"),
        "dt_bias": ParamDef(lp + (H,), la + ("w_state",), torch.float32, "zeros"),
        "out_norm": ParamDef(lp + (di,), la + ("w_mlp",), cfg.param_dtype, "zeros"),
        "out_proj": ParamDef(lp + (di, cfg.d_model), la + ("w_mlp", "w_embed"), cfg.param_dtype),
    }


def mamba2_cache_defs(cfg, batch: int, layers_prefix: Tuple[int, ...] = ()) -> dict:
    lp = layers_prefix
    la = ("layers",) * len(lp)
    di, N, H, P = cfg.d_inner, cfg.d_state, cfg.n_ssm_heads, cfg.ssm_headdim
    conv_ch = di + 2 * cfg.ssm_ngroups * N
    return {
        "conv": ParamDef(lp + (batch, cfg.conv_width - 1, conv_ch), la + ("cache_batch", None, "cache_heads"), cfg.compute_dtype, "zeros"),
        "ssm": ParamDef(lp + (batch, H, P, N), la + ("cache_batch", "cache_heads", None, "cache_state"), torch.float32, "zeros"),
        "len": ParamDef(lp + (batch,), la + ("cache_batch",), torch.int32, "zeros"),
    }


def _split_in_proj(zxbcdt, cfg):
    di, N = cfg.d_inner, cfg.d_state
    G = cfg.ssm_ngroups
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di: 2 * di + 2 * G * N]
    dt = zxbcdt[..., 2 * di + 2 * G * N:]
    return z, xbc, dt


def mamba2_block(p: Mapping[str, torch.Tensor], u: torch.Tensor, cfg,
                 cache: Optional[dict] = None,
                 seq_lens: Optional[torch.Tensor] = None):
    """u (B, S, E) -> (y, cache), the cache updated in place.

    ``seq_lens`` (B,) marks each row's valid prefix under right-padded
    batched prefill: pad steps become identity SSD updates (dt=0 -> decay
    1, contribution 0), so the carried state ignores every row's padded
    tail.
    """
    B, S, E = u.shape
    cdt = cfg.compute_dtype
    di, N, H, P = cfg.d_inner, cfg.d_state, cfg.n_ssm_heads, cfg.ssm_headdim

    zxbcdt = u @ p["in_proj"].to(cdt)
    z, xbc, dt_raw = _split_in_proj(zxbcdt, cfg)
    dt = F.softplus(dt_raw.float() + p["dt_bias"])
    if seq_lens is not None:
        valid = torch.arange(S, device=u.device)[None, :] < seq_lens[:, None]
        dt = torch.where(valid[..., None], dt, 0.0)

    conv_state = cache["conv"] if cache is not None else None
    xbc, new_conv = causal_conv1d(xbc, p["conv_w"].to(cdt), conv_state,
                                  lengths=seq_lens)
    xbc = F.silu(xbc + p["conv_b"].to(cdt))
    x = xbc[..., :di].reshape(B, S, H, P)
    Bm = xbc[..., di: di + N]
    Cm = xbc[..., di + N:]
    A = -torch.exp(p["A_log"])

    if cache is not None and S == 1:
        y, new_state = ssd_step(cache["ssm"], x[:, 0], dt[:, 0], A, Bm[:, 0], Cm[:, 0])
        y = y[:, None]
        adv = 1
    else:
        init = cache["ssm"] if cache is not None else None
        y, new_state = ssd(x, dt, A, Bm, Cm, init_state=init)
        adv = S if seq_lens is None else seq_lens
    if cache is not None:
        cache["conv"].copy_(new_conv)
        cache["ssm"].copy_(new_state)
        cache["len"].copy_(cache["len"] + adv)

    y = y + x * p["D"][:, None].to(cdt)
    y = y.reshape(B, S, di)
    y = rms_norm(y * F.silu(z), p["out_norm"], cfg.norm_eps)
    out = y @ p["out_proj"].to(cdt)
    return out, cache
