"""Measured op-class time attribution (port of
``repro.profiler.attribution``): merge a cell's measured phase timeline
with its op-class costs.

* the measured **dispatch** share is taken directly from the timeline
  (in the port: host time the device did not hide, see ``timeline``);
* the measured **device** share is distributed over the op classes
  (``hloanalysis.OP_CLASSES``: matmul / attention / collective /
  elementwise / other).  The reference can only weight them by each
  class's roofline time, ``max(flops_c / peak, bytes_c / hbm_bw)``; the
  port measures them: ``trace_device_time`` sums the device time of a
  kernel trace by class, and ``attribute(..., class_us=...)`` takes those
  shares.  Without a trace it weights by roofline time, as the
  reference;
* each non-collective class's share is further split into **compute** vs
  **memory** by its own flops-time : bytes-time ratio, giving measured
  compute / memory / collective / dispatch / idle fractions that sum to
  exactly 1.0 per cell (the acceptance invariant).  Device time of a
  class the costs cannot explain lands in idle, never vanishes.

A compiled cell's trace is the compiled step's (a serve or loadgen
cell's: the engine's compiled decode step): on the card Inductor's
generated kernels are classed by their kind (``hloanalysis.op_class``:
``triton_poi_*`` elementwise, the reductions other) beside the port's
kernels, which stay custom ops inside the graph; on the CPU
(``aot_eager``) the graph runs the same aten ops as the eager step.  The
cost (flops and bytes) is the uncompiled step's: ``compile_step`` runs
the analysis pass's call uncompiled.

``util`` is the roofline utilization: the cell's analytic device bound
(``hardware.DEFAULT_HW``, the H100) over its measured device time per
step.  On the card it is a share of the bound; on the CPU it only ranks
cells of one sweep against each other.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.core.hardware import DEFAULT_HW, HardwareProfile
from repro_torch.core.hloanalysis import OP_CLASSES, HloCost, op_class
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.accounting import SCOPE_PREFIX
from repro_torch.profiler.timeline import Timeline, device_memory_stats, split_samples


@dataclasses.dataclass
class Attribution:
    """Measured time attribution for one profiled cell."""
    class_us: Dict[str, float]      # measured device us per op class
    class_frac: Dict[str, float]    # same, as fractions of device time
    frac_compute: float
    frac_memory: float
    frac_collective: float
    frac_dispatch: float
    frac_idle: float
    bound_us: float                 # analytic roofline device bound
    util: float                     # bound_us / measured device us
    flops: float
    bytes_accessed: float
    collective_bytes: float
    source: str = "measured"

    def fractions(self) -> Dict[str, float]:
        return {"compute": self.frac_compute, "memory": self.frac_memory,
                "collective": self.frac_collective,
                "dispatch": self.frac_dispatch, "idle": self.frac_idle}

    def to_extra(self) -> Dict[str, Any]:
        """The attribution's share of the well-known ``extra["prof_*"]``
        keys (see ``repro_torch/runner/results.py``)."""
        return {
            "prof_source": self.source,
            "prof_frac_compute": self.frac_compute,
            "prof_frac_memory": self.frac_memory,
            "prof_frac_collective": self.frac_collective,
            "prof_frac_dispatch": self.frac_dispatch,
            "prof_frac_idle": self.frac_idle,
            "prof_class_us": {k: round(v, 2)
                              for k, v in self.class_us.items()},
            "prof_class_frac": dict(self.class_frac),
            "prof_bound_us": self.bound_us,
            "prof_util": self.util,
            "prof_flops": self.flops,
            "prof_bytes": self.bytes_accessed,
            "prof_collective_bytes": self.collective_bytes,
        }


def class_times(cost: HloCost,
                hw: HardwareProfile = DEFAULT_HW
                ) -> Dict[str, Tuple[float, float, float]]:
    """Per-class roofline terms ``{class: (flops_s, bytes_s, bound_s)}``.

    The collective class is bounded by its wire bytes over link bandwidth
    (its HBM-side bytes stay in the memory term like any other class's)."""
    out: Dict[str, Tuple[float, float, float]] = {}
    for cls in OP_CLASSES:
        f_s = cost.flops_by_class.get(cls, 0.0) / hw.peak_flops_bf16
        b_s = cost.bytes_by_class.get(cls, 0.0) / hw.hbm_bw
        bound = max(f_s, b_s)
        if cls == "collective":
            bound = max(bound, cost.collective_bytes / hw.link_bw)
        out[cls] = (f_s, b_s, bound)
    return out


def attribute(timeline: Timeline, cost: HloCost,
              hw: HardwareProfile = DEFAULT_HW,
              class_us: Optional[Dict[str, float]] = None) -> Attribution:
    """Distribute the timeline's measured time over op classes and the
    compute/memory/collective/dispatch/idle decomposition.

    ``class_us`` (measured device time per class, any scale: only the
    shares count) takes the place of the roofline weights; without it
    the result is the reference's, number for number.  The five
    fractions sum to exactly 1.0 whenever the timeline has any time at
    all; device time the costs cannot explain (an empty cost, or a
    measured class with no cost) lands in ``idle``."""
    disp = timeline.dispatch_us
    dev = timeline.device_us
    idle = timeline.idle_us
    total = disp + dev + idle
    per_class = class_times(cost, hw)
    weight = sum(b for _, _, b in per_class.values())
    measured = sum((class_us or {}).get(cls, 0.0) for cls in OP_CLASSES)
    by_class = {cls: 0.0 for cls in OP_CLASSES}
    unattributed = dev
    if measured > 0.0 and dev > 0.0:
        by_class = {cls: dev * class_us.get(cls, 0.0) / measured for cls in OP_CLASSES}
        unattributed = 0.0
    elif weight > 0.0 and dev > 0.0:
        by_class = {cls: dev * b / weight
                    for cls, (_, _, b) in per_class.items()}
        unattributed = 0.0
    frac_compute = frac_memory = 0.0
    if total > 0.0:
        for cls, (f_s, b_s, _) in per_class.items():
            if cls == "collective":
                continue
            if f_s + b_s == 0.0:
                unattributed += by_class[cls]
                continue
            share = by_class[cls] / total
            frac_compute += share * (f_s / (f_s + b_s))
            frac_memory += share * (b_s / (f_s + b_s))
    # util compares the ONE-step analytic bound against the measured
    # PER-STEP device time — never the whole-timeline sum, which would
    # scale utilization by 1/steps and skew cells with different sample
    # counts (a serve cell's N decode steps vs a step cell's N runs)
    dev_per_step = dev / timeline.steps if timeline.steps else 0.0
    return Attribution(
        class_us=by_class,
        class_frac={cls: (us / dev if dev else 0.0)
                    for cls, us in by_class.items()},
        frac_compute=frac_compute,
        frac_memory=frac_memory,
        frac_collective=by_class["collective"] / total if total else 0.0,
        frac_dispatch=disp / total if total else 0.0,
        frac_idle=(idle + unattributed) / total if total else 0.0,
        bound_us=weight * 1e6,
        util=(weight * 1e6) / dev_per_step if dev_per_step else 0.0,
        flops=cost.flops, bytes_accessed=cost.bytes_accessed,
        collective_bytes=cost.collective_bytes)


# ---- the device's busy time --------------------------------------------------

def _in_kernel_scope(event) -> bool:
    parent = event.cpu_parent
    while parent is not None:
        if parent.name.startswith(SCOPE_PREFIX):
            return True
        parent = parent.cpu_parent
    return False


#: CUDA runtime and driver calls that start device work: a trace of the
#: CPU that holds one was given a step that runs on a card
_CUDA_LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                  "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemsetAsync")


def trace_device_time(fn: Callable[[], Any], steps: int = 1, *,
                      device: DeviceLike = "cuda") -> Tuple[float, Dict[str, float]]:
    """``steps`` extra, untimed calls of ``fn`` under ``torch.profiler``:
    the device's busy us per call, and the busy us per call of each op
    class.  ``device`` is resolved as every entry point resolves it
    (``repro_torch.device.resolve_device``): the card unless the caller
    asks for the CPU, and an error where there is no card.

    On a card: the kernel records (memory copies and sets among them),
    classed by ``op_class`` of the kernel's name; raises if the trace
    holds no device time (the profile must not pass a host number off as
    a device number).  On the CPU: the self times of the aten ops, the
    CPU's busy time, classed by ``op_class`` of the op, where ops that run
    inside one of the port's kernel calls (``kernels.accounting``) count
    as attention, so a CPU test runs the same code; raises if ``fn``
    started work on a card (a kernel record or a CUDA launch call in the
    trace), whose host time would otherwise pass for the device's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    # the card's activity is traced whenever there is one, so a CPU trace
    # of work on the card is caught below
    watch_card = cuda or torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if watch_card else [])
    if cuda:
        torch.cuda.synchronize(dev)
    with profile(activities=activities) as prof:
        for _ in range(steps):
            fn()
        if cuda:
            torch.cuda.synchronize(dev)
    by_class = dict.fromkeys(OP_CLASSES, 0.0)
    if cuda:
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA:
                by_class[op_class(e.key)] += e.self_device_time_total
        if not sum(by_class.values()):
            raise RuntimeError("torch.profiler recorded no device time on "
                               f"{dev} (no kernel records)")
    else:
        events = prof.events()
        launched = sorted({e.name for e in events if e.device_type == DeviceType.CUDA
                           or e.name in _CUDA_LAUNCHES})
        if launched:
            raise RuntimeError(f"a trace of {dev} holds work on a card ({launched[:3]}): "
                               "trace the device the step runs on")
        for e in events:
            if e.name.startswith("aten::"):
                cls = "attention" if _in_kernel_scope(e) else op_class(e.name)
                by_class[cls] += e.self_cpu_time_total
    per_call = {cls: us / steps for cls, us in by_class.items()}
    return sum(per_call.values()), per_call


def trace_phases(fn: Callable[[], Any], steps: int, walls_s: Sequence[float],
                 phase_log: list, device_trace: Optional[dict], device: DeviceLike) -> None:
    """Split the sample walls ``walls_s`` into ``phase_log`` with the busy
    time per call B that ``trace_device_time(fn, steps, device=device)``
    measures.  Into ``device_trace`` go the trace's busy and class times,
    and ``clamped_samples`` and ``busy_over_wall_max``: how many samples
    were shorter than B (their device part is clamped to the wall and
    their host part reads 0) and the largest B / W, so a trace that ran
    longer than the timed steps is on record.  A trace that fails leaves
    ``phase_log`` empty and its error in ``device_trace["error"]``
    (re-raised without a ``device_trace``)."""
    try:
        busy_us, class_us = trace_device_time(fn, steps, device=device)
    except RuntimeError as e:
        if device_trace is None:
            raise
        device_trace["error"] = f"{type(e).__name__}: {e}"
        return
    busy_s = busy_us * 1e-6
    if device_trace is not None:
        ratios = [busy_s / w for w in walls_s if w > 0]
        device_trace.update(busy_us=busy_us, class_us=class_us, steps=steps,
                            clamped_samples=sum(r > 1.0 for r in ratios),
                            busy_over_wall_max=max(ratios, default=0.0))
    phase_log.extend(split_samples(walls_s, busy_s))


def profile_extra(phase_log, cost: HloCost, *, kind: str = "step",
                  wall_s: float = 0.0, device_trace: Optional[dict] = None,
                  device: DeviceLike = "cuda") -> Dict[str, Any]:
    """The ``extra["prof_*"]`` payload of one profiled execution: the
    timeline of the measured ``phase_log`` (with the memory stats of
    ``device``, the card unless the caller asks for the CPU), attributed
    over op classes by ``cost`` and the trace's measured class times; a
    failed trace is recorded as ``prof_error``.  The samples the trace's
    busy time clamped go outside the ``prof_`` namespace, into
    ``trace_clamp`` (``{"samples": n, "busy_over_wall_max": r}``, on every
    profiled cell), so the ``prof_*`` key set stays the reference's
    whatever the machine's load."""
    tl = Timeline.from_phase_log(phase_log or [], kind=kind, wall_s=wall_s,
                                 memory=device_memory_stats(resolve_device(device)))
    trace = device_trace or {}
    extra = tl.to_extra()
    if trace.get("error"):
        extra["prof_error"] = trace["error"]
    extra["trace_clamp"] = {"samples": trace.get("clamped_samples", 0),
                            "busy_over_wall_max": trace.get("busy_over_wall_max", 0.0)}
    extra.update(attribute(tl, cost, class_us=trace.get("class_us")).to_extra())
    return extra
