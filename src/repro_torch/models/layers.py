"""Shared building blocks (port of ``repro.models.layers``: the dense subset
with the local ring-buffer KV cache, and the causal conv).

Parameters are *declared* through ``ParamDef`` trees (shape, dtype, axes,
init) exactly as in the reference, so the port's trees have the
reference's names and shapes; ``init_tree`` materialises them with an
explicit ``torch.Generator``.  The layer functions take their parameters
as a mapping ``p`` (a dict or an ``nn.ParameterDict``), like the
reference's param pytrees.

The attention layer takes ``qk_norm`` (gemma3: an RMSNorm over the head
dim of q and k, before RoPE) and ``cross_kv`` (whisper's decoder: keys
and values given, no RoPE, no cache).  ``opt_bf16_probs`` is left out and
raises ``NotImplementedError`` naming the ROADMAP item.

The KV cache is updated in place: ``_row_update`` and ``_ring_store``
write into the cache tensors they are given, and ``gqa_attention``
advances the cache's ``len`` in place.  That is the port's counterpart of
the reference's buffer donation; callers that need the old cache keep a
copy.  A local-attention layer whose cache holds exactly ``window`` slots
keeps it as a ring buffer (recurrentgemma's attention layers once
``max_len`` exceeds the window).
"""
from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention.ops import flash_attention

# ---------------------------------------------------------------------------
# Parameter declaration
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    dtype: Any = torch.float32
    init: str = "normal"       # normal | zeros | ones | embed
    scale: Optional[float] = None  # stddev override; default fan-in

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"ParamDef shape {self.shape} and axes "
                             f"{self.axes} differ in rank")


def map_defs(fn: Callable[[ParamDef], Any], defs):
    """Apply ``fn`` to every ``ParamDef`` leaf of a nested dict, in sorted
    key order (the leaf order of ``jax.tree.flatten``)."""
    if isinstance(defs, ParamDef):
        return fn(defs)
    return {k: map_defs(fn, defs[k]) for k in sorted(defs)}


def _init_one(d: ParamDef, gen: torch.Generator, device) -> torch.Tensor:
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=d.dtype, device=device)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=d.dtype, device=device)
    if d.init == "embed":
        std = d.scale if d.scale is not None else 0.02
    else:
        # fan-in normal; like the reference, a stacked layer axis counts
        # into the fan-in (prod of every axis but the last)
        fan_in = d.shape[0] if len(d.shape) == 1 else math.prod(d.shape[:-1])
        std = d.scale if d.scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
    x = torch.randn(d.shape, generator=gen, dtype=torch.float32, device=device)
    return x.mul_(std).to(d.dtype)


def init_tree(defs, gen: torch.Generator, device=None):
    """Materialise a ``ParamDef`` tree: one draw from ``gen`` per leaf, in
    sorted key order.  ``gen`` must live on ``device``."""
    return map_defs(lambda d: _init_one(d, gen, device), defs)


# ---------------------------------------------------------------------------
# Elementary ops
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    # gemma convention: (1 + gamma); with gamma init zeros this is identity.
    return (out * (1.0 + gamma.float())).to(dtype)


def squared_relu(x):
    return torch.square(F.relu(x))


#: "gelu" is the tanh approximation in the reference (jax.nn.gelu's
#: default), not torch's erf default
ACTIVATIONS: Dict[str, Callable] = {
    "gelu": partial(F.gelu, approximate="tanh"),
    "gelu_tanh": partial(F.gelu, approximate="tanh"),
    "silu": F.silu,
    "relu": F.relu,
    "sq_relu": squared_relu,
}


def rope_freqs(positions: torch.Tensor, head_dim: int,
               theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions (...,) -> cos/sin tables (..., head_dim/2) in fp32."""
    half = head_dim // 2
    exponent = torch.arange(half, dtype=torch.float32, device=positions.device) / half
    inv = 1.0 / (theta ** exponent)
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (..., S, H, D); cos/sin (..., S, D/2) broadcast over heads.  The
    rotation pairs the two halves of D (not interleaved lanes)."""
    dtype = x.dtype
    x = x.float()
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :]
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              mask_type: str = "causal", window: int = 0,
              prefix_len: int = 0, q_offset: Any = 0,
              kv_len: Optional[Any] = None,
              softmax_scale: Optional[float] = None,
              logit_softcap: float = 0.0,
              bf16_probs: bool = False) -> torch.Tensor:
    """q (B, Sq, H, D), k/v (B, Sk, K, D) -> (B, Sq, H, D), every mask.

    ``q_offset``/``kv_len`` are scalars or per-row (B,) tensors (the serve
    engine's per-slot cache positions).  On the card this is the
    hand-written flash-attention kernel; on the CPU its plain version.
    The reference's chunked ``lax.scan`` path has no counterpart: the
    kernel is the memory-bounded path.
    """
    if bf16_probs:
        raise NotImplementedError(
            "opt_bf16_probs: bf16 score traffic is not ported "
            "(ROADMAP Queue 1, slice 7 measurement/perf knobs)")
    return flash_attention(q, k, v, mask_type=mask_type, window=window,
                           prefix_len=prefix_len, q_offset=q_offset,
                           kv_len=kv_len, softmax_scale=softmax_scale,
                           softcap=logit_softcap)


# ---------------------------------------------------------------------------
# GQA attention layer with KV cache
# ---------------------------------------------------------------------------


def gqa_defs(cfg, layers_prefix: Tuple[int, ...] = ()) -> dict:
    """Param defs for a standard GQA attention layer (optionally stacked)."""
    D = cfg.head_dim
    lp = layers_prefix
    la = ("layers",) * len(lp)
    defs = {
        "wq": ParamDef(lp + (cfg.d_model, cfg.n_heads, D), la + ("w_embed", "w_heads", "w_qk"), cfg.param_dtype),
        "wk": ParamDef(lp + (cfg.d_model, cfg.n_kv_heads, D), la + ("w_embed", "w_kv_heads", "w_qk"), cfg.param_dtype),
        "wv": ParamDef(lp + (cfg.d_model, cfg.n_kv_heads, D), la + ("w_embed", "w_kv_heads", "w_qk"), cfg.param_dtype),
        "wo": ParamDef(lp + (cfg.n_heads, D, cfg.d_model), la + ("w_heads", "w_qk", "w_embed"), cfg.param_dtype),
    }
    if cfg.qk_norm:
        defs["q_norm"] = ParamDef(lp + (D,), la + ("w_qk",), cfg.param_dtype, "zeros")
        defs["k_norm"] = ParamDef(lp + (D,), la + ("w_qk",), cfg.param_dtype, "zeros")
    return defs


def _row_update(cache_arr: torch.Tensor, fresh: torch.Tensor,
                idx: torch.Tensor) -> torch.Tensor:
    """Write ``fresh`` (B, S, ...) into ``cache_arr`` (B, max, ...) in
    place, each row at its own offset ``idx`` (B,), and return it.

    Like ``dynamic_update_slice`` in the reference, an out-of-range start
    is clamped into ``[0, max - S]``: a retired serve slot's ``len`` runs
    past ``max`` and its row is fully rewritten at the next admission."""
    B, S = fresh.shape[:2]
    start = idx.long().clamp(0, cache_arr.shape[1] - S)
    pos = start[:, None] + torch.arange(S, device=cache_arr.device)
    rows = torch.arange(B, device=cache_arr.device)[:, None]
    cache_arr[rows, pos] = fresh.to(cache_arr.dtype)
    return cache_arr


def _ring_store(ring: torch.Tensor, fresh: torch.Tensor, S: int,
                seq_lens: Optional[torch.Tensor]) -> None:
    """Write a prefill's keys or values ``fresh`` (B, S, ...) into the ring
    buffer ``ring`` (B, W, ...) in place, position p at slot p % W.

    Under ``seq_lens`` (B,), slot j of row r holds the highest valid
    position congruent to j mod W (the roll below when the row is exactly
    full); rows shorter than the window leave slots >= seq_lens[r] holding
    whatever position the clip lands on, which ``kv_len`` masks at
    decode."""
    B, W = ring.shape[:2]
    if seq_lens is not None:
        j = torch.arange(W, device=ring.device)[None, :]
        lv = seq_lens.long()[:, None]
        # floor division of a negative numerator, as jnp's // does
        src = torch.clamp(j + W * torch.div(lv - 1 - j, W, rounding_mode="floor"), 0, S - 1)
        rows = torch.arange(B, device=ring.device)[:, None]
        ring.copy_(fresh[rows, src].to(ring.dtype))
    elif S >= W:
        ring.copy_(torch.roll(fresh[:, -W:], S % W, dims=1).to(ring.dtype))
    else:
        ring[:, :S] = fresh.to(ring.dtype)
        ring[:, S:] = 0


def gqa_attention(
    p: Mapping[str, torch.Tensor],
    x: torch.Tensor,                      # (B, S, E)
    cfg,
    *,
    mask_type: str,
    window: int = 0,
    prefix_len: int = 0,
    positions: Optional[torch.Tensor] = None,   # (S,) or per-row (B, S)
    cache: Optional[dict] = None,         # {"k","v": (B, max, K, D), "len": (B,)}
    cross_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    seq_lens: Optional[torch.Tensor] = None,    # (B,) valid prefix per row
) -> Tuple[torch.Tensor, Optional[dict]]:
    """One attention layer; returns (output, cache) with the cache updated
    in place (``None`` without a cache).  ``cross_kv`` (k, v), each
    (B, Sk, K, D), replaces the layer's own keys and values: no RoPE, no
    k norm, and the cache is not read."""
    B, S, E = x.shape
    D = cfg.head_dim
    cdt = cfg.compute_dtype
    q = torch.einsum("bse,ehd->bshd", x, p["wq"].to(cdt))
    if cross_kv is None:
        k = torch.einsum("bse,ekd->bskd", x, p["wk"].to(cdt))
        v = torch.einsum("bse,ekd->bskd", x, p["wv"].to(cdt))
    else:
        k, v = cross_kv

    if cfg.qk_norm:
        # over the head dim, after the projections and before RoPE
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        if cross_kv is None:
            k = rms_norm(k, p["k_norm"], cfg.norm_eps)

    if positions is None:
        # a fresh sequence from position 0 (the loss path): the offset is
        # an int, which the attention backward kernel needs
        positions = torch.arange(S, device=x.device)
        q_offset = 0
    else:
        q_offset = positions[:, 0] if positions.ndim == 2 else positions[0]

    if cfg.rope_theta > 0 and cross_kv is None:
        cos, sin = rope_freqs(positions, D, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)

    kv_len = None
    if cache is not None and cross_kv is None:
        # per-row positions: "len" is a (B,) vector, so each row (serve
        # slot) writes and attends at its own offset
        idx = cache["len"].clone()
        Wc = cache["k"].shape[1]
        ring = mask_type == "local" and Wc == window and window > 0
        # padded batched prefill: each row's valid prefix ends at
        # seq_lens[r]; keys written past it sit at positions the position
        # masks exclude for every valid query, and kv_len masks them later
        s_eff = S if seq_lens is None else seq_lens
        if ring and S > 1:
            # prefill a ring buffer: attend over the fresh full-length k/v
            # with the local mask, then store the last W tokens at slots
            # pos % W (softmax is order-free; RoPE already applied).  What
            # the cache held is not read: the serve engine prefills into a
            # fresh mini cache
            _ring_store(cache["k"], k, S, seq_lens)
            _ring_store(cache["v"], v, S, seq_lens)
            cache["len"].copy_(idx + s_eff)
            q_offset = idx
        elif ring:
            # decode: write at slot idx % W; all live entries are in-window
            slot = torch.remainder(idx, Wc)
            _row_update(cache["k"], k, slot)
            _row_update(cache["v"], v, slot)
            cache["len"].copy_(idx + S)
            k, v = cache["k"].to(cdt), cache["v"].to(cdt)
            kv_len = torch.clamp(idx + S, max=Wc)
            mask_type = "full"   # ring membership IS the window mask
            q_offset = idx
        else:
            _row_update(cache["k"], k, idx)
            _row_update(cache["v"], v, idx)
            cache["len"].copy_(idx + s_eff)
            k, v = cache["k"].to(cdt), cache["v"].to(cdt)
            kv_len = idx + s_eff
            q_offset = idx

    scale = cfg.softmax_scale if cfg.softmax_scale else None
    out = attention(q, k, v, mask_type=mask_type, window=window,
                    prefix_len=prefix_len, q_offset=q_offset, kv_len=kv_len,
                    softmax_scale=scale, logit_softcap=cfg.attn_softcap,
                    bf16_probs=cfg.opt_bf16_probs)
    y = torch.einsum("bshd,hde->bse", out, p["wo"].to(cdt))
    return y, cache


# ---------------------------------------------------------------------------
# MLP / GLU feed-forward
# ---------------------------------------------------------------------------


def ffn_defs(cfg, d_ff: Optional[int] = None, layers_prefix: Tuple[int, ...] = ()) -> dict:
    d_ff = d_ff or cfg.d_ff
    lp = layers_prefix
    la = ("layers",) * len(lp)
    defs = {
        "w_up": ParamDef(lp + (cfg.d_model, d_ff), la + ("w_embed", "w_mlp"), cfg.param_dtype),
        "w_down": ParamDef(lp + (d_ff, cfg.d_model), la + ("w_mlp", "w_embed"), cfg.param_dtype),
    }
    if cfg.glu:
        defs["w_gate"] = ParamDef(lp + (cfg.d_model, d_ff), la + ("w_embed", "w_mlp"), cfg.param_dtype)
    return defs


def ffn(p: Mapping[str, torch.Tensor], x: torch.Tensor, cfg) -> torch.Tensor:
    cdt = cfg.compute_dtype
    act = ACTIVATIONS[cfg.activation]
    h = x @ p["w_up"].to(cdt)
    if cfg.glu:
        h = act(x @ p["w_gate"].to(cdt)) * h
    else:
        h = act(h)
    return h @ p["w_down"].to(cdt)


# ---------------------------------------------------------------------------
# Causal depthwise conv1d (mamba2 / recurrentgemma blocks)
# ---------------------------------------------------------------------------


def causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                  state: Optional[torch.Tensor] = None,
                  lengths: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """x (B, S, C), w (W, C) depthwise causal conv.

    Returns (y, new_state) where state is the last W-1 inputs (B, W-1, C).
    ``lengths`` (B,) marks each row's valid prefix under right-padded
    batched prefill: the carried state is then gathered per row at its own
    boundary instead of from the padded tail.  As in the reference, the
    conv is W shifted multiply-adds in x's dtype (not ``F.conv1d``, which
    cuDNN would run in TF32 on the card).
    """
    W = w.shape[0]
    B, S, C = x.shape
    if state is None:
        xp = F.pad(x, (0, 0, W - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    if W == 1:
        new_state = None
    elif lengths is None:
        new_state = xp[:, -(W - 1):, :]
    else:
        # row r's last W-1 valid inputs live at xp[lengths[r] : lengths[r]+W-1]
        idx = lengths.long()[:, None] + torch.arange(W - 1, device=x.device)
        new_state = torch.gather(xp, 1, idx[..., None].expand(B, W - 1, C))
    y = torch.zeros_like(x)
    for i in range(W):
        y = y + xp[:, i: i + S, :] * w[i]
    return y, new_state
