"""RG-LRU recurrent block (RecurrentGemma / Griffin) (port of
``repro.models.rglru``).

h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)
a_t = exp(-c * softplus(Lambda) * r_t),  r/i = sigmoid(dense(x))

Prefill runs the scan through ``repro_torch.kernels.rglru.ops.rglru``: the
hand-written CUDA kernel on the card, its plain blocked version on the
CPU.  The reference's log-space associative scan (in 512-token blocks when
S is a multiple of 512 above it) sums in another order; the tests hold the
two together.  ``rglru_step`` is the O(1)-per-token decode update, plain
torch as in the reference.

The cache is updated in place, like the port's KV cache: ``rglru_block``
writes the new conv state, recurrent state and ``len`` into the cache
tensors it is given (the reference returns a new cache).
"""
from __future__ import annotations

from typing import Mapping, Optional, Tuple

import torch

from repro_torch.kernels.rglru.ops import rglru
from repro_torch.models.layers import ACTIVATIONS, ParamDef, causal_conv1d

RGLRU_C = 8.0


def _gate_defs(cfg, lp, la, D):
    if cfg.gate_blocks:
        G = cfg.gate_blocks
        shape = lp + (G, D // G, D // G)
        axes = la + ("w_heads", None, None)
        return {
            "w_input_gate": ParamDef(shape, axes, cfg.param_dtype),
            "b_input_gate": ParamDef(lp + (D,), la + ("w_mlp",), cfg.param_dtype, "zeros"),
            "w_rec_gate": ParamDef(shape, axes, cfg.param_dtype),
            "b_rec_gate": ParamDef(lp + (D,), la + ("w_mlp",), cfg.param_dtype, "zeros"),
        }
    dense_axes = la + (("w_expert_mlp", "w_mlp") if cfg.opt_gate_bf16 else ("w_mlp", "w_expert_mlp"))
    return {
        "w_input_gate": ParamDef(lp + (D, D), dense_axes, cfg.param_dtype),
        "b_input_gate": ParamDef(lp + (D,), la + ("w_mlp",), cfg.param_dtype, "zeros"),
        "w_rec_gate": ParamDef(lp + (D, D), dense_axes, cfg.param_dtype),
        "b_rec_gate": ParamDef(lp + (D,), la + ("w_mlp",), cfg.param_dtype, "zeros"),
    }


def rglru_scan(x: torch.Tensor, a: torch.Tensor,
               init_state: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x, a (B, S, D) fp32; returns (h (B, S, D), h_last (B, D)), fp32.

    Linear recurrence h_t = a_t h_{t-1} + b_t with b = sqrt(1-a^2)*x."""
    return rglru(x, a, init_state)


def rglru_step(state: torch.Tensor, xt: torch.Tensor, at: torch.Tensor):
    """state/xt/at (B, D) -> (h_t, h_t)."""
    bt = torch.sqrt(torch.clamp(1.0 - at * at, min=1e-12)) * xt
    h = at * state + bt
    return h, h


def rglru_defs(cfg, layers_prefix: Tuple[int, ...] = ()) -> dict:
    lp = layers_prefix
    la = ("layers",) * len(lp)
    D = cfg.lru_width
    return {
        # Griffin recurrent block: two input branches, conv+LRU on one
        "w_x": ParamDef(lp + (cfg.d_model, D), la + ("w_embed", "w_mlp"), cfg.param_dtype),
        "w_gate_branch": ParamDef(lp + (cfg.d_model, D), la + ("w_embed", "w_mlp"), cfg.param_dtype),
        "conv_w": ParamDef(lp + (cfg.conv_width, D), la + ("w_conv", "w_mlp"), cfg.param_dtype, scale=0.2),
        "conv_b": ParamDef(lp + (D,), la + ("w_mlp",), cfg.param_dtype, "zeros"),
        # block-diagonal gate matrices when gate_blocks > 0 (Griffin)
        **_gate_defs(cfg, lp, la, D),
        "lambda_p": ParamDef(lp + (D,), la + ("w_mlp",), torch.float32, "ones"),
        "w_out": ParamDef(lp + (D, cfg.d_model), la + ("w_mlp", "w_embed"), cfg.param_dtype),
    }


def rglru_cache_defs(cfg, batch: int, layers_prefix: Tuple[int, ...] = ()) -> dict:
    lp = layers_prefix
    la = ("layers",) * len(lp)
    D = cfg.lru_width
    return {
        "conv": ParamDef(lp + (batch, cfg.conv_width - 1, D), la + ("cache_batch", None, "cache_heads"), cfg.compute_dtype, "zeros"),
        "h": ParamDef(lp + (batch, D), la + ("cache_batch", "cache_heads"), torch.float32, "zeros"),
        "len": ParamDef(lp + (batch,), la + ("cache_batch",), torch.int32, "zeros"),
    }


def _softplus(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.softplus is log(1 + e^x) everywhere; F.softplus returns x
    # above its threshold 20, which differs by under 1e-8 in fp32.
    # logaddexp(x, 0) is the reference's own definition, exactly
    return torch.logaddexp(x, torch.zeros_like(x))


def rglru_block(p: Mapping[str, torch.Tensor], u: torch.Tensor, cfg,
                cache: Optional[dict] = None,
                seq_lens: Optional[torch.Tensor] = None):
    """Griffin recurrent block.  u (B, S, E) -> (y, cache), the cache
    updated in place.

    ``seq_lens`` (B,) marks each row's valid prefix under right-padded
    batched prefill: pad steps become identity recurrence updates (a=1,
    gated input 0 -> h_t = h_{t-1}), so the carried state h_last ignores
    every row's padded tail.

    The gate products and the gate math run in fp32 (the reference's
    ``opt_gate_bf16=False``); on the card that needs TF32 off for matrix
    products, PyTorch's default.
    """
    B, S, E = u.shape
    cdt = cfg.compute_dtype

    gate = ACTIVATIONS["gelu"](u @ p["w_gate_branch"].to(cdt))   # tanh form
    x = u @ p["w_x"].to(cdt)
    conv_state = cache["conv"] if cache is not None else None
    x, new_conv = causal_conv1d(x, p["conv_w"].to(cdt), conv_state,
                                lengths=seq_lens)
    x = x + p["conv_b"].to(cdt)

    xf = x.float()
    if cfg.gate_blocks:
        G = cfg.gate_blocks
        xg = xf.reshape(B, S, G, -1)
        i_pre = torch.einsum("bsgd,gdf->bsgf", xg, p["w_input_gate"].float()).reshape(B, S, -1)
        r_pre = torch.einsum("bsgd,gdf->bsgf", xg, p["w_rec_gate"].float()).reshape(B, S, -1)
    else:
        i_pre = xf @ p["w_input_gate"].float()
        r_pre = xf @ p["w_rec_gate"].float()
    i_gate = torch.sigmoid(i_pre + p["b_input_gate"].float())
    r_gate = torch.sigmoid(r_pre + p["b_rec_gate"].float())
    log_a = -RGLRU_C * _softplus(p["lambda_p"].float()) * r_gate
    a = torch.exp(log_a)
    gated_x = i_gate * xf
    if seq_lens is not None:
        valid = (torch.arange(S, device=u.device)[None, :] < seq_lens[:, None])[..., None]
        a = torch.where(valid, a, 1.0)
        gated_x = torch.where(valid, gated_x, 0.0)

    if cache is not None and S == 1:
        h, h_last = rglru_step(cache["h"], gated_x[:, 0], a[:, 0])
        h = h[:, None]
        adv = 1
    else:
        init = cache["h"] if cache is not None else None
        h, h_last = rglru_scan(gated_x, a, init_state=init)
        adv = S if seq_lens is None else seq_lens
    if cache is not None:
        cache["conv"].copy_(new_conv)
        cache["h"].copy_(h_last)
        cache["len"].copy_(cache["len"] + adv)

    y = h.to(cdt) * gate
    out = y @ p["w_out"].to(cdt)
    return out, cache
