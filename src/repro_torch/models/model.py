"""The model (port of ``repro.models.model``, dense branch).

``Model`` is an ``nn.Module`` that holds its weights:

  param_defs()                              declaration (the reference's tree)
  forward(batch)                            logits (no cache)
  cache_defs(batch, max_len) / init_cache   decode-state declaration
  prefill(batch, cache, lengths=)           fill cache, return last logits
  decode_step(tokens, cache)                one token with cache

The weights are declared as the reference declares them, with the stacked
layer axis, and materialised once; each layer's ``Block`` then holds views
of its slice, and the layers run as a Python loop.  The KV cache keeps the
reference's stacked layout ``{"blocks": {"k", "v": (L, B, max, K, D),
"len": (L, B)}}`` and is updated in place (the reference donates it).

Only the dense family without a local window is ported; the others come
with their slices (ROADMAP Queue 1, slice 3).  ``loss`` and ``remat``
come with training (slice 2).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Optional

import torch
from torch import nn

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import layers as L
from repro_torch.models.layers import ParamDef


def _norm_def(cfg, lp=()):
    return ParamDef(lp + (cfg.d_model,), ("layers",) * len(lp) + ("w_embed",), cfg.param_dtype, "zeros")


def _attn_block_defs(cfg, lp):
    return {"ln1": _norm_def(cfg, lp), "attn": L.gqa_defs(cfg, lp),
            "ln2": _norm_def(cfg, lp), "mlp": L.ffn_defs(cfg, None, lp)}


def check_supported(cfg) -> None:
    """Raise ``NotImplementedError`` for what the port does not run yet."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported yet "
            f"(ROADMAP Queue 1, slice 3)")
    if cfg.local_window > 0 or cfg.global_every > 0:
        raise NotImplementedError(
            f"{cfg.name}: local/global attention patterns and ring caches "
            f"are not ported yet (ROADMAP Queue 1, slice 3: gemma3-12b)")
    if cfg.use_mla:
        raise NotImplementedError(f"{cfg.name}: MLA is not ported yet "
                                  f"(ROADMAP Queue 1, slice 3: deepseek-v2)")
    if not cfg.tie_embeddings or cfg.pos_embed == "learned":
        raise NotImplementedError(
            f"{cfg.name}: untied heads and learned positions are not ported "
            f"yet (ROADMAP Queue 1, slice 3)")


def param_defs(cfg) -> Dict[str, Any]:
    """The reference's param tree for the dense family: stacked blocks."""
    check_supported(cfg)
    return {
        "embed": ParamDef((cfg.vocab, cfg.d_model), ("w_vocab", "w_embed_pod"),
                          cfg.param_dtype, "embed"),
        "final_norm": _norm_def(cfg),
        "blocks": _attn_block_defs(cfg, (cfg.n_layers,)),
    }


def _frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class Block(nn.Module):
    """One dense layer: RMSNorm -> attention -> RMSNorm -> FFN, with
    residuals.  ``p`` is the layer's (unstacked) slice of the param tree."""

    def __init__(self, cfg, p: Mapping[str, Any]):
        super().__init__()
        self.cfg = cfg
        self.ln1 = _frozen(p["ln1"])
        self.attn = nn.ParameterDict({k: _frozen(v) for k, v in p["attn"].items()})
        self.ln2 = _frozen(p["ln2"])
        self.mlp = nn.ParameterDict({k: _frozen(v) for k, v in p["mlp"].items()})

    def forward(self, x: torch.Tensor, *, positions: torch.Tensor,
                cache: Optional[dict] = None,
                seq_lens: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg = self.cfg
        h = L.rms_norm(x, self.ln1, cfg.norm_eps)
        h, _ = L.gqa_attention(self.attn, h, cfg, mask_type="causal",
                               positions=positions, cache=cache,
                               seq_lens=seq_lens)
        x = x + h
        h = L.rms_norm(x, self.ln2, cfg.norm_eps)
        return x + L.ffn(self.mlp, h, cfg)


def _layer(tree, i: int):
    if isinstance(tree, torch.Tensor):
        return tree[i]
    return {k: _layer(v, i) for k, v in tree.items()}


class Model(nn.Module):
    """The dense model over a param tree in the reference's layout (the
    ``blocks`` leaves carry the stacked layer axis)."""

    def __init__(self, cfg, params: Mapping[str, Any]):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self.embed = _frozen(params["embed"])
        self.final_norm = _frozen(params["final_norm"])
        self.blocks = nn.ModuleList(
            Block(cfg, _layer(params["blocks"], i)) for i in range(cfg.n_layers))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def param_defs(self) -> Dict[str, Any]:
        return param_defs(self.cfg)

    # ---------------- embedding / head ----------------

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = self.embed[tokens.long()].to(cfg.compute_dtype)
        if cfg.embed_scale:
            # the scale is rounded to the compute dtype first, as in the
            # reference (sqrt(2048) is 45.25 in bf16)
            x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=cfg.compute_dtype,
                                 device=x.device)
        return x

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = L.rms_norm(x, self.final_norm, cfg.norm_eps)
        logits = x @ self.embed.to(cfg.compute_dtype).t()
        if cfg.final_softcap > 0:
            logits = torch.tanh(logits / cfg.final_softcap) * cfg.final_softcap
        return logits

    def _run_layers(self, x, positions, cache, seq_lens=None):
        stacked = cache["blocks"] if cache is not None else None
        for i, blk in enumerate(self.blocks):
            # per-layer views of the stacked cache: the in-place writes of
            # the layer land in the stacked tensors
            ci = None if stacked is None else {k: t[i] for k, t in stacked.items()}
            x = blk(x, positions=positions, cache=ci, seq_lens=seq_lens)
        return x

    # ---------------- public API ----------------

    def forward(self, batch: Mapping[str, torch.Tensor],
                positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        tokens = batch["tokens"]
        x = self._embed(tokens)
        if positions is None:
            positions = torch.arange(x.shape[1], device=x.device)
        return self._head(self._run_layers(x, positions, None))

    def cache_defs(self, batch: int, max_len: int) -> Dict[str, Any]:
        cfg = self.cfg
        lp = (cfg.n_layers,)
        kv = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
        axes = ("layers", "cache_batch", "cache_seq", "cache_heads", None)
        cdt = cfg.compute_dtype
        return {"blocks": {
            "k": ParamDef(kv, axes, cdt, "zeros"),
            "v": ParamDef(kv, axes, cdt, "zeros"),
            # per-row position vector: each batch row (serve slot) decodes
            # at its own offset, so one decode batch can mix prompt lengths
            "len": ParamDef(lp + (batch,), ("layers", "cache_batch"), torch.int32, "zeros"),
        }}

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
        """
        tokens = batch["tokens"]
        x = self._embed(tokens)
        positions = torch.arange(x.shape[1], device=x.device)
        seq_lens = None
        if lengths is not None:
            seq_lens = torch.as_tensor(lengths, dtype=torch.int32, device=x.device)
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
        x = self._run_layers(self._embed(tokens), positions, cache)
        return self._head(x), cache

    @staticmethod
    def _cache_len(cache: Mapping[str, Any]) -> torch.Tensor:
        """The per-row position vector (B,) of the first layer (every
        layer's counter advances identically)."""
        return cache["blocks"]["len"][0]


def build_model(cfg, *, device: DeviceLike = "cuda", seed: int = 0) -> Model:
    """A model with random weights drawn from ``seed`` on ``device``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return Model(cfg, L.init_tree(param_defs(cfg), gen, dev))
