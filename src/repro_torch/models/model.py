"""The model (port of ``repro.models.model``: the dense, vlm, encdec, ssm
and hybrid branches).

``Model`` is an ``nn.Module`` that holds its weights:

  param_defs()                              declaration (the reference's tree)
  forward(batch)                            logits (no cache)
  cache_defs(batch, max_len) / init_cache   decode-state declaration
  prefill(batch, cache, lengths=)           fill cache, return last logits
  decode_step(tokens, cache)                one token with cache

The weights are declared as the reference declares them, with the stacked
layer axes, and materialised once; each layer's module (``Block`` for an
attention layer, ``DecBlock`` for the encdec family's decoder layers,
``MambaBlock`` for the ssm family, ``RecBlock`` for the hybrid family's
recurrent layers) then holds views of its slice, and the layers run as a
Python loop in the reference's order.  The caches keep the reference's
stacked layout and are updated in place (the reference donates them):

  dense, vlm  {"blocks": {"k", "v": (L, B, max, K, D), "len": (L, B)}}
  grouped     {"groups": {"local": {"k", "v", "len"} with prefix (G, global_every-1),
                          "global": {"k", "v", "len"} with prefix (G,)}}
  encdec      {"blocks": {"self": {"k", "v", "len"}, "cross_k", "cross_v":
                          (L, B, enc_seq, K, D)}}
  ssm         {"blocks": {"conv": (L, B, W-1, C), "ssm": (L, B, H, P, N), "len"}}
  hybrid      {"groups": {"rec": {"conv", "h", "len"} with prefix (G, pattern_rec),
                          "attn": {"k", "v", "len"} with prefix (G,)},
               "tail": {"conv", "h", "len"} with prefix (tail,)}

Local attention layers (the hybrid family's, gemma3's grouped 5:1
pattern, a dense stack with ``local_window`` and no ``global_every``) keep
a ring of ``local_window`` slots once ``max_len`` exceeds the window.
The vlm family prepends ``patch_embeds`` (B, n_prefix, d_model) to the
token embeddings under the prefix mask; the encdec family encodes
``frames`` (B, enc_seq, d_model) once (``encode``) and its decoder layers
attend to the encoder's keys and values, cached per layer at prefill
(``_fill_cross``).

Training: ``loss(batch)`` is the reference's next-token NLL (fp32, from
``logsumexp - gold``; chunked under ``cfg.opt_ce_chunk``), with each layer
of its forward under ``cfg.remat`` (``"full"``: ``torch.utils.checkpoint``;
``"dots"``: selective checkpointing that keeps the plain matrix products'
outputs; ``"none"``); the vlm family's loss skips its patch prefix, the
encdec family's encodes the frames under the loss.  A
model built for inference holds frozen parameters
(``requires_grad=False``), so serving builds no autograd graph; the train
state holds a second model over a copy of the weights (``stacked_params``)
whose parameters require grad.  ``param_index`` maps each parameter to its
leaf and layer index in the reference's stacked tree, and ``leaf_views``
gives the matching views of any tree of that layout (the optimizer's
moments).

Under ``torch.compile`` (the runner's ``jit*`` modes): with
``cfg.scan_layers`` (the default, the reference's ``lax.scan`` over the
stacked layers) each layer runs through its kind's nested compile region
(``_region``: one per module class and layer kind, so gemma3's local and
global layers, whose windows differ, each have their own), so a compiled
step traces one body per kind, the layer's remat inside it, and every
layer of the kind reuses it; with
``scan_layers=False`` (``jit_unrolled``) every layer is traced inline.
Run eagerly, the two are the same calls.  The layers' kernels are
custom ops (``kernels/library.py``), opaque to the compiler.

The moe family and MLA come with their modules (ROADMAP Queue 1, items
6-7).
"""
from __future__ import annotations

import functools
import math
from functools import partial
from typing import Any, Dict, List, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import layers as L
from repro_torch.models import rglru, ssm
from repro_torch.models.layers import ParamDef


def _norm_def(cfg, lp=()):
    return ParamDef(lp + (cfg.d_model,), ("layers",) * len(lp) + ("w_embed",), cfg.param_dtype, "zeros")


def _attn_block_defs(cfg, lp):
    return {"ln1": _norm_def(cfg, lp), "attn": L.gqa_defs(cfg, lp),
            "ln2": _norm_def(cfg, lp), "mlp": L.ffn_defs(cfg, None, lp)}


def _rec_block_defs(cfg, lp):
    return {"ln1": _norm_def(cfg, lp), "rec": rglru.rglru_defs(cfg, lp),
            "ln2": _norm_def(cfg, lp), "mlp": L.ffn_defs(cfg, None, lp)}


def _kv_cache_defs(cfg, batch: int, max_len: int, kind: str, lp=()):
    la = ("layers",) * len(lp)
    size = max_len
    if kind == "local" and 0 < cfg.local_window < max_len:
        size = cfg.local_window   # ring buffer
    kv = lp + (batch, size, cfg.n_kv_heads, cfg.head_dim)
    axes = la + ("cache_batch", "cache_seq", "cache_heads", None)
    cdt = cfg.compute_dtype
    return {
        "k": ParamDef(kv, axes, cdt, "zeros"),
        "v": ParamDef(kv, axes, cdt, "zeros"),
        # per-row position vector: each batch row (serve slot) decodes
        # at its own offset, so one decode batch can mix prompt lengths
        "len": ParamDef(lp + (batch,), la + ("cache_batch",), torch.int32, "zeros"),
    }


def _hybrid_split(cfg):
    """(groups G, tail layers) of the hybrid stack: G x (pattern_rec
    recurrent layers, one attention layer), then the tail's recurrent
    layers."""
    G = cfg.n_layers // (cfg.pattern_rec + 1)
    return G, cfg.n_layers - G * (cfg.pattern_rec + 1)


def _grouped_split(cfg):
    """(groups G, local layers per group) of gemma3's pattern: G x
    (global_every - 1 local layers, one global layer)."""
    return cfg.n_layers // cfg.global_every, cfg.global_every - 1


def check_supported(cfg) -> None:
    """Raise ``NotImplementedError`` for what the port does not run yet."""
    if cfg.family not in ("dense", "vlm", "encdec", "ssm", "hybrid"):
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported yet (ROADMAP "
            f"Queue 1, item 6: models/moe.py)")
    if cfg.use_mla:
        raise NotImplementedError(f"{cfg.name}: MLA is not ported yet "
                                  f"(ROADMAP Queue 1, item 7: deepseek-v2)")
    if cfg.family == "hybrid" and cfg.opt_gate_bf16:
        raise NotImplementedError(
            f"{cfg.name}: opt_gate_bf16 (bf16 RG-LRU gate products) is not "
            f"ported yet (ROADMAP Queue 1, item 14: the dry run's perf knobs)")


def param_defs(cfg) -> Dict[str, Any]:
    """The reference's param tree: stacked ``blocks`` for the dense, vlm,
    encdec and ssm families, ``groups`` for gemma3's pattern,
    ``groups``/``tail`` for the hybrid family."""
    check_supported(cfg)
    d = {
        "embed": ParamDef((cfg.vocab, cfg.d_model), ("w_vocab", "w_embed_pod"),
                          cfg.param_dtype, "embed"),
        "final_norm": _norm_def(cfg),
    }
    if not cfg.tie_embeddings:
        d["lm_head"] = ParamDef((cfg.d_model, cfg.vocab), ("w_embed_pod", "w_vocab"),
                                cfg.param_dtype)
    if cfg.pos_embed == "learned":
        d["pos_embed"] = ParamDef((cfg.max_position, cfg.d_model), (None, "w_embed_pod"),
                                  cfg.param_dtype, "embed", scale=0.02)
    lp = (cfg.n_layers,)
    if cfg.family == "ssm":
        d["blocks"] = {"ln": _norm_def(cfg, lp), "mix": ssm.mamba2_defs(cfg, lp)}
    elif cfg.family == "hybrid":
        G, tail = _hybrid_split(cfg)
        d["groups"] = {"rec": _rec_block_defs(cfg, (G, cfg.pattern_rec)),
                       "attn": _attn_block_defs(cfg, (G,))}
        if tail:
            d["tail"] = _rec_block_defs(cfg, (tail,))
    elif cfg.family == "encdec":
        d["enc_pos_embed"] = ParamDef((cfg.enc_seq, cfg.d_model), (None, "w_embed_pod"),
                                      cfg.param_dtype, "embed", scale=0.02)
        d["enc_blocks"] = _attn_block_defs(cfg, (cfg.n_enc_layers,))
        d["enc_norm"] = _norm_def(cfg)
        d["blocks"] = {**_attn_block_defs(cfg, lp), "ln_cross": _norm_def(cfg, lp),
                       "cross": L.gqa_defs(cfg, lp)}
    elif cfg.global_every > 0:   # gemma3's grouped pattern
        G, n_local = _grouped_split(cfg)
        d["groups"] = {"local": _attn_block_defs(cfg, (G, n_local)),
                       "global": _attn_block_defs(cfg, (G,))}
    else:
        d["blocks"] = _attn_block_defs(cfg, lp)
    return d


def _frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


#: the attention mask of each attention-layer kind
_MASKS = {"global": "causal", "local": "local", "prefix": "prefix", "full": "full"}


class Block(nn.Module):
    """One attention layer: RMSNorm -> attention -> RMSNorm -> FFN, with
    residuals.  ``p`` is the layer's (unstacked) slice of the param tree;
    ``kind`` is "global" (causal), "local" (sliding window of
    ``cfg.local_window``, a ring cache), "prefix" (the vlm family: causal
    but for the ``n_prefix`` patch positions, which every query sees) or
    "full" (the encdec family's encoder)."""

    def __init__(self, cfg, p: Mapping[str, Any], kind: str = "global"):
        super().__init__()
        self.cfg = cfg
        self.mask_type = _MASKS[kind]
        self.window = cfg.local_window if kind == "local" else 0
        self.prefix_len = cfg.n_prefix if kind == "prefix" else 0
        self.ln1 = _frozen(p["ln1"])
        self.attn = nn.ParameterDict({k: _frozen(v) for k, v in p["attn"].items()})
        self.ln2 = _frozen(p["ln2"])
        self.mlp = nn.ParameterDict({k: _frozen(v) for k, v in p["mlp"].items()})

    def forward(self, x: torch.Tensor, *, positions: torch.Tensor,
                cache: Optional[dict] = None,
                seq_lens: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg = self.cfg
        h = L.rms_norm(x, self.ln1, cfg.norm_eps)
        h, _ = L.gqa_attention(self.attn, h, cfg, mask_type=self.mask_type,
                               window=self.window, prefix_len=self.prefix_len,
                               positions=positions, cache=cache, seq_lens=seq_lens)
        x = x + h
        h = L.rms_norm(x, self.ln2, cfg.norm_eps)
        return x + L.ffn(self.mlp, h, cfg)


class DecBlock(nn.Module):
    """One decoder layer of the encdec family: RMSNorm -> causal
    self-attention -> RMSNorm -> cross-attention over the encoder's keys
    and values (mask "full") -> RMSNorm -> FFN, with residuals.  With a
    cache ({"self": kv cache, "cross_k", "cross_v"}) the cross keys and
    values are the cached ones; without, they are projected from
    ``enc_out``."""

    def __init__(self, cfg, p: Mapping[str, Any]):
        super().__init__()
        self.cfg = cfg
        self.ln1 = _frozen(p["ln1"])
        self.attn = nn.ParameterDict({k: _frozen(v) for k, v in p["attn"].items()})
        self.ln_cross = _frozen(p["ln_cross"])
        self.cross = nn.ParameterDict({k: _frozen(v) for k, v in p["cross"].items()})
        self.ln2 = _frozen(p["ln2"])
        self.mlp = nn.ParameterDict({k: _frozen(v) for k, v in p["mlp"].items()})

    def cross_kv(self, enc_out: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """The encoder's keys and values for this layer: (B, enc_seq, K, D)
        each, in the compute dtype."""
        cdt = self.cfg.compute_dtype
        return (torch.einsum("bse,ekd->bskd", enc_out, self.cross["wk"].to(cdt)),
                torch.einsum("bse,ekd->bskd", enc_out, self.cross["wv"].to(cdt)))

    def forward(self, x: torch.Tensor, *, positions: torch.Tensor,
                cache: Optional[dict] = None,
                seq_lens: Optional[torch.Tensor] = None,
                enc_out: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg = self.cfg
        cdt = cfg.compute_dtype
        h = L.rms_norm(x, self.ln1, cfg.norm_eps)
        h, _ = L.gqa_attention(self.attn, h, cfg, mask_type="causal",
                               positions=positions,
                               cache=None if cache is None else cache["self"],
                               seq_lens=seq_lens)
        x = x + h
        h = L.rms_norm(x, self.ln_cross, cfg.norm_eps)
        if cache is None:
            ckv = self.cross_kv(enc_out)
        else:
            ckv = (cache["cross_k"].to(cdt), cache["cross_v"].to(cdt))
        h, _ = L.gqa_attention(self.cross, h, cfg, mask_type="full",
                               positions=positions, cross_kv=ckv)
        x = x + h
        h = L.rms_norm(x, self.ln2, cfg.norm_eps)
        return x + L.ffn(self.mlp, h, cfg)


class RecBlock(nn.Module):
    """One recurrent layer of the hybrid family: RMSNorm -> RG-LRU block ->
    residual -> RMSNorm -> FFN -> residual."""

    def __init__(self, cfg, p: Mapping[str, Any]):
        super().__init__()
        self.cfg = cfg
        self.ln1 = _frozen(p["ln1"])
        self.rec = nn.ParameterDict({k: _frozen(v) for k, v in p["rec"].items()})
        self.ln2 = _frozen(p["ln2"])
        self.mlp = nn.ParameterDict({k: _frozen(v) for k, v in p["mlp"].items()})

    def forward(self, x: torch.Tensor, *, positions: torch.Tensor,
                cache: Optional[dict] = None,
                seq_lens: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg = self.cfg
        h = L.rms_norm(x, self.ln1, cfg.norm_eps)
        h, _ = rglru.rglru_block(self.rec, h, cfg, cache=cache, seq_lens=seq_lens)
        x = x + h
        h = L.rms_norm(x, self.ln2, cfg.norm_eps)
        return x + L.ffn(self.mlp, h, cfg)


class MambaBlock(nn.Module):
    """One ssm layer: RMSNorm -> Mamba-2 mixer, with a residual."""

    def __init__(self, cfg, p: Mapping[str, Any]):
        super().__init__()
        self.cfg = cfg
        self.ln = _frozen(p["ln"])
        self.mix = nn.ParameterDict({k: _frozen(v) for k, v in p["mix"].items()})

    def forward(self, x: torch.Tensor, *, positions: torch.Tensor,
                cache: Optional[dict] = None,
                seq_lens: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = L.rms_norm(x, self.ln, self.cfg.norm_eps)
        h, _ = ssm.mamba2_block(self.mix, h, self.cfg, cache=cache,
                                seq_lens=seq_lens)
        return x + h


def _layer(tree, i):
    """The slice ``i`` (an int or a tuple over the stacked axes) of every
    leaf: views, not copies."""
    if isinstance(tree, torch.Tensor):
        return tree[i]
    return {k: _layer(v, i) for k, v in tree.items()}


def _layout(cfg):
    """The (decoder) layers in the reference's run order, as (path of the
    stacked subtree, index into its layer axes, module kind).  The grouped
    stacks (the hybrid family, gemma3's pattern) run per group: its
    pattern's layers, then its attention layer."""
    if cfg.family == "hybrid":
        G, tail = _hybrid_split(cfg)
        pattern = [(("groups", "rec"), j, "rec") for j in range(cfg.pattern_rec)]
        last = (("groups", "attn"), "local")
    elif cfg.global_every > 0 and cfg.family in ("dense", "vlm"):
        (G, n_local), tail = _grouped_split(cfg), 0
        pattern = [(("groups", "local"), j, "local") for j in range(n_local)]
        last = (("groups", "global"), "global")
    else:
        kind = {"ssm": "mamba", "encdec": "dec", "vlm": "prefix"}.get(
            cfg.family, "local" if cfg.local_window > 0 else "global")
        return [(("blocks",), (i,), kind) for i in range(cfg.n_layers)]
    out = []
    for g in range(G):
        out += [(path, (g, j), kind) for path, j, kind in pattern]
        out.append((last[0], (g,), last[1]))
    return out + [(("tail",), (i,), "rec") for i in range(tail)]


def _subtree(tree, path):
    for key in path:
        tree = tree[key]
    return tree


_MATMULS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, func, *args, **kwargs):
    """``remat="dots"``: keep the outputs of matrix products without batch
    dims (``checkpoint_dots_with_no_batch_dims``), recompute the rest.
    ``einsum`` lowers a product such as "bse,ehd->bshd" to a ``bmm`` over
    a batch of one, so that counts as a plain product too."""
    if func in _MATMULS or (func is torch.ops.aten.bmm.default
                            and args[0].shape[0] == 1):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, mode: str):
    """``fn`` run under the reference's remat policy ``mode``.  A layer
    draws no random numbers, so no generator state is carried into its
    recomputation (``preserve_rng_state=False``), as the reference's remat
    carries none: preserving it would read every card's generator state at
    each layer, host work and torch API calls the CPU does not make."""
    if mode == "none":
        return fn
    if mode == "full":
        return partial(checkpoint, fn, use_reentrant=False, preserve_rng_state=False)
    if mode == "dots":
        return partial(checkpoint, fn, use_reentrant=False, preserve_rng_state=False,
                       context_fn=partial(create_selective_checkpoint_contexts,
                                          _dots_policy))
    raise ValueError(f"unknown remat {mode!r} (none | full | dots)")


@functools.lru_cache(maxsize=None)
def _region(cls: type, kind: str):
    """The forward of the layers of module class ``cls`` and layer kind
    ``kind`` (``_layout``'s) as one nested compile region
    (``torch.compiler.nested_compile_region``): under ``torch.compile`` it
    is traced once and every layer of that kind reuses it, the counterpart
    of the reference's ``lax.scan`` over the stacked layers
    (``scan_layers=True``).  The layers of one kind differ only in their
    weights and caches, which are the region's inputs; the kind fixes the
    Python constants a layer reads (its mask, window and prefix), so no
    reuse rests on a constant traced from another kind.  Run eagerly, it
    is the forward itself."""
    @torch.compiler.nested_compile_region
    def run(blk, remat, x, positions, cache, seq_lens, kw):
        return _remat(partial(cls.forward, blk), remat)(
            x, positions=positions, cache=cache, seq_lens=seq_lens, **kw)
    return run


class Model(nn.Module):
    """The model over a param tree in the reference's layout (the stacked
    leaves carry their layer axes)."""

    def __init__(self, cfg, params: Mapping[str, Any]):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        # the top-level leaves, under their names in the tree
        for name in ("embed", "final_norm", "lm_head", "pos_embed",
                     "enc_pos_embed", "enc_norm"):
            if name in params:
                setattr(self, name, _frozen(params[name]))
        self._layout = _layout(cfg)
        blocks = []
        for path, idx, kind in self._layout:
            p = _layer(_subtree(params, path), idx)
            if kind == "mamba":
                blocks.append(MambaBlock(cfg, p))
            elif kind == "rec":
                blocks.append(RecBlock(cfg, p))
            elif kind == "dec":
                blocks.append(DecBlock(cfg, p))
            else:
                blocks.append(Block(cfg, p, kind))
        self.blocks = nn.ModuleList(blocks)
        # each layer's region, made here: the decorator is not traced
        self._regions = [_region(type(b), kind)
                         for b, (_, _, kind) in zip(blocks, self._layout)]
        if cfg.family == "encdec":
            self.enc_blocks = nn.ModuleList(
                Block(cfg, _layer(params["enc_blocks"], (i,)), "full")
                for i in range(cfg.n_enc_layers))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def param_defs(self) -> Dict[str, Any]:
        return param_defs(self.cfg)

    # ---------------- embedding / head ----------------

    def _embed(self, tokens: torch.Tensor,
               positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Token embeddings (B, S, E) in the compute dtype; with learned
        positions, plus ``pos_embed`` at ``positions`` ((S,) or per-row
        (B, S); default 0..S-1)."""
        cfg = self.cfg
        x = self.embed[tokens.long()].to(cfg.compute_dtype)
        if cfg.embed_scale:
            # the scale is rounded to the compute dtype first, as in the
            # reference (sqrt(2048) is 45.25 in bf16)
            x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=cfg.compute_dtype,
                                 device=x.device)
        if cfg.pos_embed == "learned":
            if positions is None:
                positions = torch.arange(tokens.shape[1], device=x.device)
            x = x + self.pos_embed[positions.long()].to(cfg.compute_dtype)
        return x

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = L.rms_norm(x, self.final_norm, cfg.norm_eps)
        # cast to the compute dtype at every call, as the reference does
        w = self.embed.t() if cfg.tie_embeddings else self.lm_head
        logits = x @ w.to(cfg.compute_dtype)
        if cfg.final_softcap > 0:
            logits = torch.tanh(logits / cfg.final_softcap) * cfg.final_softcap
        return logits

    def _run_layers(self, x, positions, cache, seq_lens=None, remat="none",
                    enc_out=None):
        for blk, region, (path, idx, kind) in zip(self.blocks, self._regions,
                                                  self._layout):
            # per-layer views of the stacked cache: the in-place writes of
            # the layer land in the stacked tensors
            ci = None if cache is None else _layer(_subtree(cache, path), idx)
            kw = {"enc_out": enc_out} if kind == "dec" else {}
            if self.cfg.scan_layers:
                x = region(blk, remat, x, positions, ci, seq_lens, kw)
            else:
                x = _remat(blk, remat)(x, positions=positions, cache=ci,
                                       seq_lens=seq_lens, **kw)
        return x

    def _inputs(self, batch: Mapping[str, torch.Tensor],
                positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The first layer's input: the token embeddings, behind the vlm
        family's ``patch_embeds``."""
        x = self._embed(batch["tokens"], positions)
        if self.cfg.family == "vlm":
            pe = batch["patch_embeds"].to(device=x.device, dtype=self.cfg.compute_dtype)
            x = torch.cat([pe, x], dim=1)
        return x

    # ---------------- encoder (whisper) ----------------

    def encode(self, frames: torch.Tensor, remat: str = "none") -> torch.Tensor:
        """frames (B, enc_seq, d_model) precomputed (the conv front end is
        a stub, as in the reference) -> the encoder's output: learned
        positions, full-mask self-attention layers (each under ``remat``),
        then ``enc_norm``."""
        cfg = self.cfg
        cdt = cfg.compute_dtype
        x = frames.to(device=self.device, dtype=cdt) + self.enc_pos_embed.to(cdt)
        for blk in self.enc_blocks:
            x = _remat(blk, remat)(x, positions=None)
        return L.rms_norm(x, self.enc_norm, cfg.norm_eps)

    def _fill_cross(self, cache: Dict[str, Any], enc_out: torch.Tensor) -> None:
        """Write every decoder layer's cross keys and values (projected from
        ``enc_out``) into ``cache`` in place."""
        ck, cv = cache["blocks"]["cross_k"], cache["blocks"]["cross_v"]
        for i, blk in enumerate(self.blocks):
            k, v = blk.cross_kv(enc_out)
            ck[i].copy_(k)
            cv[i].copy_(v)

    # ---------------- parameters in the reference's layout ----------------

    def param_index(self) -> List[Tuple[Tuple[str, ...], Tuple[int, ...]]]:
        """(leaf path in the reference's param tree, index into its stacked
        layer axes) of each parameter, in ``parameters()`` order."""
        out = []
        for name, _ in self.named_parameters():
            parts = tuple(name.split("."))
            if parts[0] == "blocks":
                path, idx, _ = self._layout[int(parts[1])]
                out.append((path + parts[2:], idx))
            elif parts[0] == "enc_blocks":
                out.append((("enc_blocks",) + parts[2:], (int(parts[1]),)))
            else:
                out.append((parts, ()))
        return out

    def leaf_views(self, tree) -> List[torch.Tensor]:
        """Views of ``tree`` (the reference's stacked layout, as the
        optimizer's moments) matching ``parameters()`` one for one."""
        return [_subtree(tree, path)[idx] for path, idx in self.param_index()]

    def stacked_params(self) -> Dict[str, Any]:
        """A copy of the weights as the reference's param tree (stacked
        layer axes)."""
        out = L.map_defs(lambda d: torch.empty(d.shape, dtype=d.dtype, device=self.device),
                         param_defs(self.cfg))
        with torch.no_grad():
            for view, p in zip(self.leaf_views(out), self.parameters()):
                view.copy_(p)
        return out

    # ---------------- public API ----------------

    def forward(self, batch: Mapping[str, torch.Tensor],
                positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Logits at every position (the vlm family's patch positions
        included)."""
        x = self._inputs(batch, positions)
        enc_out = self.encode(batch["frames"]) if self.cfg.family == "encdec" else None
        if positions is None:
            positions = torch.arange(x.shape[1], device=x.device)
        return self._head(self._run_layers(x, positions, None, enc_out=enc_out))

    def loss(self, batch: Mapping[str, torch.Tensor]):
        """(loss, {"loss", "ppl"}): the mean next-token NLL in fp32 from
        ``logsumexp - gold``, each layer under ``cfg.remat``.  The vlm
        family predicts the text tokens only (the patch prefix is sliced
        off before the head); the encdec family encodes ``batch["frames"]``
        under the loss, its layers under ``cfg.remat`` too.  Under
        ``cfg.opt_ce_chunk`` the sequence is cut into chunks (padded, with
        a valid mask) whose logits are formed one chunk at a time and
        recomputed in the backward, so the full (B, S, V) fp32 logits never
        exist."""
        cfg = self.cfg
        tokens = batch["tokens"]
        x = self._inputs(batch)
        enc_out = (self.encode(batch["frames"], remat=cfg.remat)
                   if cfg.family == "encdec" else None)
        # positions None: each attention layer counts from 0 with an int
        # offset (the backward kernel takes no offset tensor)
        hidden = self._run_layers(x, None, None, remat=cfg.remat, enc_out=enc_out)
        if cfg.family == "vlm":
            hidden = hidden[:, cfg.n_prefix:]
        targets = tokens[:, 1:].long()
        if cfg.opt_ce_chunk > 0:
            hid = hidden[:, :-1]
            B, Sm1, _ = hid.shape
            C = min(cfg.opt_ce_chunk, Sm1)
            pad = (C - Sm1 % C) % C
            hid = F.pad(hid, (0, 0, 0, pad))
            tgt = F.pad(targets, (0, pad))
            valid = F.pad(torch.ones(B, Sm1, device=x.device), (0, pad))
            total = torch.zeros((), device=x.device)
            for c0 in range(0, Sm1 + pad, C):
                sl = slice(c0, c0 + C)
                total = total + checkpoint(self._chunk_nll, hid[:, sl], tgt[:, sl],
                                           valid[:, sl], use_reentrant=False)
            loss = total / (B * Sm1)
        else:
            lg = self._head(hidden)[:, :-1].float()
            logz = torch.logsumexp(lg, dim=-1)
            gold = torch.gather(lg, -1, targets[..., None])[..., 0]
            loss = (logz - gold).mean()
        return loss, {"loss": loss, "ppl": torch.exp(loss)}

    def _chunk_nll(self, h, t, valid):
        lg = self._head(h).float()
        gold = torch.gather(lg, -1, t[..., None])[..., 0]
        return ((torch.logsumexp(lg, dim=-1) - gold) * valid).sum()

    def cache_defs(self, batch: int, max_len: int) -> Dict[str, Any]:
        cfg = self.cfg
        if cfg.family == "ssm":   # a fixed-size state: max_len is unused
            return {"blocks": ssm.mamba2_cache_defs(cfg, batch, (cfg.n_layers,))}
        if cfg.family == "hybrid":
            G, tail = _hybrid_split(cfg)
            d = {"groups": {
                "rec": rglru.rglru_cache_defs(cfg, batch, (G, cfg.pattern_rec)),
                "attn": _kv_cache_defs(cfg, batch, max_len, "local", (G,))}}
            if tail:
                d["tail"] = rglru.rglru_cache_defs(cfg, batch, (tail,))
            return d
        if cfg.family == "encdec":
            shp = (cfg.n_layers, batch, cfg.enc_seq, cfg.n_kv_heads, cfg.head_dim)
            la = ("layers", "cache_batch", "cache_seq", "cache_heads", None)
            cross = ParamDef(shp, la, cfg.compute_dtype, "zeros")
            return {"blocks": {
                "self": _kv_cache_defs(cfg, batch, max_len, "global", (cfg.n_layers,)),
                "cross_k": cross, "cross_v": cross}}
        if cfg.global_every > 0:
            G, n_local = _grouped_split(cfg)
            return {"groups": {
                "local": _kv_cache_defs(cfg, batch, max_len, "local", (G, n_local)),
                "global": _kv_cache_defs(cfg, batch, max_len, "global", (G,))}}
        kind = "local" if cfg.local_window else "global"
        return {"blocks": _kv_cache_defs(cfg, batch, max_len, kind, (cfg.n_layers,))}

    def init_cache(self, batch: int, max_len: int) -> Dict[str, Any]:
        return L.map_defs(
            lambda d: torch.zeros(d.shape, dtype=d.dtype, device=self.device),
            self.cache_defs(batch, max_len))

    def prefill(self, batch: Mapping[str, torch.Tensor], cache: Dict[str, Any],
                lengths: Optional[torch.Tensor] = None):
        """Run the prompt through the model writing ``cache`` in place.

        Returns (last-position logits (B, 1, V), cache).  ``lengths`` (B,)
        enables right-padded batched prefill: row r's prompt is
        ``tokens[r, :lengths[r]]``, its cache ``len`` advances by
        ``lengths[r]`` and its logits are taken at ``lengths[r] - 1``.
        The vlm family's patch prefix counts into the positions, the cache
        ``len`` and ``lengths`` alike; the encdec family encodes
        ``batch["frames"]`` and caches every decoder layer's cross keys and
        values first.
        """
        cfg = self.cfg
        x = self._inputs(batch)
        if cfg.family == "encdec":
            self._fill_cross(cache, self.encode(batch["frames"]))
        positions = torch.arange(x.shape[1], device=x.device)
        seq_lens = None
        if lengths is not None:
            # the valid length in layer coordinates includes the prefix
            seq_lens = torch.as_tensor(lengths, dtype=torch.int32, device=x.device)
            if cfg.family == "vlm":
                seq_lens = seq_lens + cfg.n_prefix
        x = self._run_layers(x, positions, cache, seq_lens=seq_lens)
        if seq_lens is None:
            last = x[:, -1:]
        else:
            rows = torch.arange(x.shape[0], device=x.device)
            last = x[rows, seq_lens.long() - 1][:, None]
        return self._head(last), cache

    def decode_step(self, tokens: torch.Tensor, cache: Dict[str, Any]):
        """tokens (B, 1) -> (logits (B, 1, V), cache updated in place).

        Positions are per-row: each row decodes at its own cache offset
        (the ``len`` vector)."""
        pos = self._cache_len(cache)
        positions = pos[:, None] + torch.arange(1, device=pos.device)
        x = self._run_layers(self._embed(tokens, positions), positions, cache)
        return self._head(x), cache

    @staticmethod
    def _cache_len(cache: Mapping[str, Any]) -> torch.Tensor:
        """The per-row position vector (B,) from the first "len" leaf in
        the reference's flatten order (sorted keys: ``blocks.len``, the
        grouped pattern's ``groups.global.len``, the encdec family's
        ``blocks.self.len`` or the hybrid family's ``groups.attn.len``);
        every layer's counter advances identically."""
        def first_len(tree):
            for k in sorted(tree):
                v = tree[k]
                if k == "len" and isinstance(v, torch.Tensor):
                    return v
                if isinstance(v, Mapping):
                    found = first_len(v)
                    if found is not None:
                        return found
            return None
        x = first_len(cache)
        return x.reshape(-1, x.shape[-1])[0]


def build_model(cfg, *, device: DeviceLike = "cuda", seed: int = 0) -> Model:
    """A model with random weights drawn from ``seed`` on ``device``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return Model(cfg, L.init_tree(param_defs(cfg), gen, dev))
