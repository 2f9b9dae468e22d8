"""Three-term roofline model (port of ``repro.core.roofline``).

    compute_s    = flops_global            / (chips * peak_FLOP/s)
    memory_s     = bytes_global            / (chips * HBM_bw)
    collective_s = collective_bytes_global / (chips * link_bw)

The reference takes its quantities from a compiled XLA module; the port
from ``core.hloanalysis.analyze_step``, which runs one eager step and
counts what it executes (per card), scaled to global by ``chips``.  The
peaks are the card's (``core.hardware.DEFAULT_HW``, the H100 SXM): no TPU
number enters the port.  The step-time estimate assumes perfect overlap
(max of terms) and none (sum); reality is in between — the perf loop
drives the *dominant* term down.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

from repro_torch.core.hardware import DEFAULT_HW, HardwareProfile
from repro_torch.core.hloanalysis import HloCost


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_global: float
    bytes_global: float
    collective_bytes_global: float
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float
    useful_ratio: float          # MODEL_FLOPS / counted flops
    step_time_lower_s: float     # max(terms): perfect overlap
    step_time_upper_s: float     # sum(terms): no overlap
    roofline_fraction: float     # compute_s / step_time_upper (how compute-bound)
    hw: str = "h100_sxm"
    collective_counts: Optional[Dict[str, int]] = None
    collective_bytes_by_op: Optional[Dict[str, float]] = None

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def roofline_from_cost(
    cost: HloCost,
    *,
    arch: str,
    shape: str,
    mesh: str,
    chips: int,
    model_flops: float,
    hw: HardwareProfile = DEFAULT_HW,
) -> Roofline:
    fg = cost.flops * chips
    bg = cost.bytes_accessed * chips
    cg = cost.collective_bytes * chips
    compute_s = fg / (chips * hw.peak_flops_bf16)
    memory_s = bg / (chips * hw.hbm_bw)
    collective_s = cg / (chips * hw.link_bw)
    terms = {"compute": compute_s, "memory": memory_s, "collective": collective_s}
    dominant = max(terms, key=terms.get)
    lo = max(terms.values())
    hi = sum(terms.values())
    return Roofline(
        arch=arch, shape=shape, mesh=mesh, chips=chips,
        flops_global=fg, bytes_global=bg, collective_bytes_global=cg,
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        dominant=dominant,
        model_flops=model_flops,
        useful_ratio=model_flops / fg if fg else 0.0,
        step_time_lower_s=lo, step_time_upper_s=hi,
        roofline_fraction=compute_s / hi if hi else 0.0,
        hw=hw.name,
        collective_counts=dict(cost.collective_counts),
        collective_bytes_by_op=dict(cost.collective_bytes_by_op),
    )


def _leaves(defs, path=()):
    """(path, ParamDef) of every leaf of a nested param-def dict."""
    if isinstance(defs, dict):
        for k in sorted(defs):
            yield from _leaves(defs[k], path + (str(k),))
    else:
        yield path, defs


def model_flops_estimate(cfg, shape) -> float:
    """MODEL_FLOPS = 6·N·D (train) / 2·N·D (forward-only), N = *active* params.

    N counts routed-expert weights at top_k/n_experts utilization (MoE);
    D = tokens processed by the step (decode: one per sequence).  The
    params are the port's ``models.model.param_defs(cfg)`` (the
    reference's tree, as a nested dict of ``ParamDef``s); nothing is
    allocated.
    """
    from repro_torch.models.model import param_defs

    total = 0.0
    for path, d in _leaves(param_defs(cfg)):
        n = float(math.prod(d.shape))
        keys = "/".join(path)
        if cfg.n_experts and ("mlp/w_" in keys or "mlp/router" in keys) and "shared" not in keys:
            if "router" not in keys:
                n *= cfg.top_k / cfg.n_experts
        # a tied embedding is counted once: used as both table and head
        total += n
    if shape.kind == "train":
        mult = 6.0
        tokens = shape.global_batch * shape.seq_len
    elif shape.kind == "prefill":
        mult = 2.0
        tokens = shape.global_batch * shape.seq_len
    else:  # decode: one token per sequence
        mult = 2.0
        tokens = shape.global_batch
    return mult * total * tokens
