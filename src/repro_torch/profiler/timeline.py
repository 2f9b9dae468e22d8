"""Measured per-step phase timelines: the profiler's raw signal (port of
``repro.profiler.timeline``).

A ``Timeline`` holds one ``(dispatch, device)`` split per measured step:

* step cells (train / infer_prefill / infer_decode): one ``PhaseSample``
  per measured iteration of ``harness.measure`` (warmup excluded);
* serve cells: one ``PhaseSample`` per batched decode step of the
  measured trace replay, plus ``idle_us``: replay wall time *outside*
  decode steps (admission, per-request prefill, host queue management).

The split differs from the reference's.  There the split point is the
jitted call *returning*.  In eager PyTorch the device runs kernels while
the host is still launching them, and once the launch queue is full a
launch blocks the host until the device drains, so the return comes
near the end of the step whether the step is host-bound or
device-bound.  The port therefore splits a sample of wall W with the
device's own busy time B per step, measured from a kernel trace of
extra, untimed steps (``profiler.attribution.trace_device_time``):
``device = min(B, W)`` and ``dispatch = W - device``, the **exposed host
time** during which the device waited on the host (``split_samples``).

Device memory stats (peak / in-use bytes of the cell's card) ride along
on CUDA; on the CPU there are none and the keys are absent.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch

#: cap on the per-sample timeline recorded into ``extra["prof_timeline"]``
#: (serve replays can run thousands of decode steps; aggregates are exact,
#: the sample list is a debugging aid)
TIMELINE_CAP = 128


@dataclasses.dataclass
class PhaseSample:
    """One measured step, split at the dispatch/execution boundary (us)."""
    dispatch_us: float
    device_us: float

    @property
    def total_us(self) -> float:
        return self.dispatch_us + self.device_us


@dataclasses.dataclass
class Timeline:
    """Per-step phase capture for one profiled cell."""
    kind: str                                   # "step" | "decode_step"
    samples: List[PhaseSample] = dataclasses.field(default_factory=list)
    #: serve only: replay wall time outside the decode steps (us)
    idle_us: float = 0.0
    #: device memory stats snapshot, when available
    memory: Optional[Dict[str, int]] = None

    @classmethod
    def from_phase_log(cls, log: Sequence[Tuple[float, float]], *,
                       kind: str = "step", wall_s: float = 0.0,
                       memory: Optional[Dict[str, int]] = None) -> "Timeline":
        """Build from a harness ``phase_log`` — (dispatch_s, device_s)
        tuples in **seconds** as appended by ``harness.measure`` /
        ``ServeEngine.run``.  ``wall_s`` (serve) is the measured replay
        wall; any part of it not inside the logged steps becomes idle."""
        samples = [PhaseSample(d * 1e6, v * 1e6) for d, v in log]
        idle = 0.0
        if wall_s:
            stepped = sum(s.total_us for s in samples)
            idle = max(0.0, wall_s * 1e6 - stepped)
        return cls(kind=kind, samples=samples, idle_us=idle, memory=memory)

    # ---- aggregates ------------------------------------------------------

    @property
    def steps(self) -> int:
        return len(self.samples)

    @property
    def dispatch_us(self) -> float:
        return sum(s.dispatch_us for s in self.samples)

    @property
    def device_us(self) -> float:
        return sum(s.device_us for s in self.samples)

    @property
    def total_us(self) -> float:
        """Everything the profile accounts for: steps + (serve) idle."""
        return self.dispatch_us + self.device_us + self.idle_us

    def to_extra(self) -> Dict[str, object]:
        """The timeline's share of the well-known ``extra["prof_*"]`` keys
        (see ``repro_torch/runner/results.py``)."""
        n = max(1, self.steps)
        out: Dict[str, object] = {
            "prof_kind": self.kind,
            "prof_steps": self.steps,
            "prof_dispatch_us_mean": self.dispatch_us / n,
            "prof_device_us_mean": self.device_us / n,
            "prof_timeline": [[round(s.dispatch_us, 2), round(s.device_us, 2)]
                              for s in self.samples[:TIMELINE_CAP]],
        }
        if self.idle_us:
            out["prof_idle_us"] = self.idle_us
        if self.memory:
            if self.memory.get("peak_bytes"):
                out["prof_device_peak_bytes"] = self.memory["peak_bytes"]
            if self.memory.get("bytes_in_use"):
                out["prof_device_bytes_in_use"] = self.memory["bytes_in_use"]
        return out


def split_samples(walls_s: Sequence[float],
                  busy_s: float) -> List[Tuple[float, float]]:
    """``(dispatch_s, device_s)`` for each sample wall in ``walls_s``,
    given the device's busy time per step ``busy_s``: the device part is
    ``min(busy_s, wall)``, the rest exposed host time.  A sample shorter
    than ``busy_s`` reads all device; ``attribution.trace_phases`` records
    how many were and by how much."""
    return [(w - min(busy_s, w), min(busy_s, w)) for w in walls_s]


def device_memory_stats(device) -> Optional[Dict[str, int]]:
    """Peak (since the last ``torch.cuda.reset_peak_memory_stats``) and
    live bytes of ``device`` when it is a card, else None (the CPU has no
    allocator stats; readers tolerate absence, as of every other
    well-known extra)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    return {"peak_bytes": int(torch.cuda.max_memory_allocated(dev)),
            "bytes_in_use": int(torch.cuda.memory_allocated(dev))}
