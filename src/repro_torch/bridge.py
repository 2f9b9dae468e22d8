"""Weights and caches across the two packages, as numpy arrays.

The reference initialises its parameters with ``jax.random``, which torch
cannot reproduce, so parity tests move the reference's param pytree into
the port: ``params_from_numpy`` takes the tree as numpy arrays (the
stacked layer axis included, bf16 as ``ml_dtypes.bfloat16`` or any float)
and returns the port's ``Model`` holding those weights.
``cache_from_numpy`` / ``cache_to_numpy`` do the same for KV caches, so a
test can compare caches as well as logits.  Nothing here imports JAX.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.device import DeviceLike
from repro_torch.models.layers import ParamDef
from repro_torch.models.model import Model, param_defs


def _tensor(a, dtype: torch.dtype, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        a = a.astype(np.float32)   # numpy has no bf16; ml_dtypes widens
    # a private, writable copy: the model updates nothing in place, but a
    # cache does
    return torch.from_numpy(np.array(a)).to(device=device, dtype=dtype)


def _match(defs, tree, path: str):
    """Convert ``tree`` against ``defs``: same keys, same shapes."""
    if isinstance(defs, ParamDef):
        shape = tuple(np.shape(tree))
        if shape != defs.shape:
            raise ValueError(f"{path}: shape {shape}, expected {defs.shape}")
        return tree
    if not isinstance(tree, Mapping) or set(tree) != set(defs):
        got = sorted(tree) if isinstance(tree, Mapping) else type(tree).__name__
        raise ValueError(f"{path or 'params'}: keys {got}, expected {sorted(defs)}")
    return {k: _match(defs[k], tree[k], f"{path}/{k}") for k in defs}


def _convert(defs, tree, device):
    tree = _match(defs, tree, "")

    def walk(d, t):
        if isinstance(d, ParamDef):
            return _tensor(t, d.dtype, device)
        return {k: walk(d[k], t[k]) for k in d}
    return walk(defs, tree)


def params_from_numpy(tree: Mapping[str, Any], cfg,
                      device: DeviceLike = "cpu") -> Model:
    """The port's model holding the reference's params ``tree``."""
    return Model(cfg, _convert(param_defs(cfg), tree, torch.device(device)))


def cache_from_numpy(tree: Mapping[str, Any], model: Model, batch: int,
                     max_len: int) -> dict:
    """A port KV cache from the reference's cache pytree (numpy leaves)."""
    return _convert(model.cache_defs(batch, max_len), tree, model.device)


def cache_to_numpy(cache: Mapping[str, Any]) -> dict:
    """A KV cache as numpy arrays (bf16 widened to float32)."""
    def leaf(t: torch.Tensor) -> np.ndarray:
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return {k: (leaf(v) if isinstance(v, torch.Tensor) else cache_to_numpy(v))
            for k, v in cache.items()}

