"""AdamW with fp32 state and global-norm clipping (port of
``repro.optim.adamw``).

The update runs over the flat list of leaves with ``torch._foreach_*``
ops, under ``torch.no_grad()``, in place: a handful of fused multi-tensor
kernels per group of leaves instead of one kernel storm per tensor — the
fix the paper upstreamed (TorchBench §4.1.1), of which the reference's
single ``tree.map`` is the JAX analogue.  Leaves go in groups of at most
``GROUP_ELEMENTS`` elements, so the update's two fp32 temporaries stay
bounded by a group, not by the model.  The order of operations is the
reference's: the step is incremented first; clip = min(1, grad_clip /
max(gnorm, 1e-12)); bias corrections 1 - b ** step; m / bc1 over
sqrt(v / bc2) + eps plus decoupled weight decay on p in fp32; the result
cast back to p's dtype.

A tree here is a nest of dicts (leaves in sorted key order, as
``jax.tree.leaves``), lists and tuples; ``params``, ``grads`` and the
state's ``mu``/``nu`` must share one structure.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, NamedTuple, Optional

import torch

from repro_torch.models.layers import ParamDef, map_defs

#: elements of one group of leaves in ``adamw_update`` (1 GiB of fp32)
GROUP_ELEMENTS = 1 << 28


class OptState(NamedTuple):
    step: torch.Tensor     # () int32
    mu: Any
    nu: Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def leaves(tree) -> List[torch.Tensor]:
    """The tensors of a tree, dicts in sorted key order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    return [x for v in tree for x in leaves(v)]


def _map(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return type(tree)(_map(fn, v) for v in tree)


def opt_state_defs(param_defs) -> OptState:
    """ParamDef tree for the optimizer state (fp32 moments, the params'
    shapes and axes)."""
    f = lambda d: ParamDef(d.shape, d.axes, torch.float32, "zeros")   # noqa: E731
    return OptState(step=ParamDef((), (), torch.int32, "zeros"),
                    mu=map_defs(f, param_defs), nu=map_defs(f, param_defs))


def adamw_init(params) -> OptState:
    z = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
    first = leaves(params)[0]
    return OptState(step=torch.zeros((), dtype=torch.int32, device=first.device),
                    mu=_map(z, params), nu=_map(z, params))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of sum(g^2), in fp32."""
    norms = torch._foreach_norm(leaves(tree), 2, dtype=torch.float32)
    return torch.stack(norms).square().sum().sqrt()


def _groups(n: List[int]):
    """Index ranges of consecutive leaves of at most GROUP_ELEMENTS
    elements together (a larger leaf is a group of its own)."""
    start, size = 0, 0
    for i, numel in enumerate(n):
        if i > start and size + numel > GROUP_ELEMENTS:
            yield range(start, i)
            start, size = i, 0
        size += numel
    if start < len(n):
        yield range(start, len(n))


@torch.no_grad()
def adamw_update(params, grads, state: OptState, cfg: AdamWConfig,
                 lr: Optional[torch.Tensor] = None):
    """Update ``params`` and the state's moments in place; returns
    (params, new state, metrics) as the reference returns its new trees."""
    step = state.step + 1
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)
    lr_t = lr if lr is not None else cfg.lr
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1.0 - b1 ** step.to(torch.float32)
    bc2 = 1.0 - b2 ** step.to(torch.float32)
    flat_p, flat_g = leaves(params), leaves(grads)
    flat_m, flat_v = leaves(state.mu), leaves(state.nu)
    for idx in _groups([p.numel() for p in flat_p]):
        p = [flat_p[i] for i in idx]
        p32 = [x if x.dtype == torch.float32 else x.float() for x in p]
        m, v = [flat_m[i] for i in idx], [flat_v[i] for i in idx]
        g = torch._foreach_mul([flat_g[i].float() for i in idx], clip)
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, g, alpha=1 - b1)
        torch._foreach_mul_(v, b2)
        torch._foreach_addcmul_(v, g, g, value=1 - b2)
        del g
        mh = torch._foreach_div(m, bc1)
        vh = torch._foreach_div(v, bc2)
        torch._foreach_sqrt_(vh)
        torch._foreach_add_(vh, cfg.eps)
        torch._foreach_div_(mh, vh)              # mh / (sqrt(vh) + eps)
        del vh
        torch._foreach_add_(mh, p32, alpha=cfg.weight_decay)
        torch._foreach_mul_(mh, lr_t)
        torch._foreach_sub_(p32, mh)
        for x, x32 in zip(p, p32):
            if x is not x32:
                x.copy_(x32)
    return params, OptState(step, state.mu, state.nu), {"grad_norm": gnorm}
