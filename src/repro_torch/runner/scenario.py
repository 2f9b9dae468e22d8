"""Declarative scenario matrix (port of ``repro.runner.scenario``).

A ``Scenario`` is one fully specified benchmark execution:

    arch x task x batch x seq x dtype x compiler-mode [x slots x trace]

Names, axes and validation are the reference's, so the two packages'
result stores compare row by row.

How the compiler modes map onto PyTorch in the port (the reference's
mapping is ``repro.core.compilers``: ``eager`` is op-by-op dispatch and
``jit`` the TorchInductor analogue):

    eager         the step uncompiled, through ``harness.measure_eager``:
                  one warm call, ``max(2, runs // 2)`` timed calls, no
                  donation, ``compile_us = 0``; a profiled eager cell
                  records ``prof_skipped = "eager"``
    jit           ``torch.compile`` of the step (``harness.compile_step``:
                  Inductor on the card, ``aot_eager`` on the CPU); the
                  arguments it updates in place (the KV cache, the train
                  state) are copied at every call, outside the compiled
                  region, so each call sees the arguments it was given —
                  what a jitted step without donation sees
    jit_donated   compiled; the step updates the cache in place and the
                  updated state is threaded into the next call (donation)
    jit_unrolled  compiled with ``scan_layers=False``: the layer loop traced
                  inline, every layer in the graph (``jit`` compiles each
                  layer kind's block once, as one nested compile region
                  that every layer of the kind reuses, the counterpart of
                  the reference's ``lax.scan``)
    jit_noremat   compiled with ``remat="none"``

Nothing runs uncompiled under a ``jit*`` name: a compile error, a
recompile past Dynamo's limit or a timed call that recompiles is an
error record of the cell.  Serving cells (``task="serve"``) run the
engine uncompiled in both their modes (ROADMAP Queue 1, item 13c).

``task="loadgen"`` and ``task="kernel"`` validate here, but the port's
runner does not run them yet (ROADMAP Queue 1, slice 7).
"""
from __future__ import annotations

import dataclasses
import itertools
import re
from typing import Any, Dict, Iterable, List, Sequence, Tuple

import torch

#: single-step tasks measured by the harness ``measure()`` protocol
STEP_TASKS = ("train", "infer_prefill", "infer_decode")

#: all tasks of the reference (see the module docstring for what runs)
TASKS = STEP_TASKS + ("serve", "loadgen", "kernel")

KERNEL_MODES = ("jit",)

#: execution modes valid for the serving task ("jit_donated" updates the
#: KV cache in place in each decode step)
SERVE_MODES = ("jit", "jit_donated")

MODES = ("eager", "jit", "jit_donated", "jit_unrolled", "jit_noremat")

#: reduced-config overrides per mode (applied at arch-build time)
MODE_OVERRIDES: Dict[str, Dict[str, Any]] = {
    "jit_unrolled": {"scan_layers": False},
    "jit_noremat": {"remat": "none"},
}

DTYPES = ("fp32", "bf16")


def dtype_overrides(dtype: str) -> Dict[str, Any]:
    if dtype == "fp32":
        return {}
    if dtype == "bf16":
        return {"param_dtype": torch.bfloat16}
    raise ValueError(f"unknown dtype {dtype!r} (known: {DTYPES})")


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One cell of the execution matrix (hashable: used as a cache key).

    The serving task carries three extra axes — ``slots``, ``trace`` and
    ``admission`` — which stay inert (0 / "") on every other task.  For
    ``task="serve"`` ``batch`` is the trace's request count and ``seq``
    its prompt length.
    """
    arch: str
    task: str = "train"
    batch: int = 2
    seq: int = 64
    dtype: str = "fp32"
    mode: str = "jit_donated"
    slots: int = 0
    trace: str = ""
    load: float = 0.0
    split: str = ""
    admission: str = ""

    def __post_init__(self):
        if self.task not in TASKS:
            raise ValueError(f"unknown task {self.task!r} (known: {TASKS})")
        if self.mode not in MODES:
            raise ValueError(f"unknown mode {self.mode!r} (known: {MODES})")
        if self.dtype not in DTYPES:
            raise ValueError(f"unknown dtype {self.dtype!r} (known: {DTYPES})")
        if self.task in ("serve", "loadgen"):
            if self.mode not in SERVE_MODES:
                raise ValueError(f"{self.task} supports modes {SERVE_MODES}, "
                                 f"not {self.mode!r}")
            if self.slots == "auto":
                raise ValueError("slots='auto' is a ScenarioMatrix axis value; "
                                 "a bare Scenario needs an int")
            if self.slots == 0:
                object.__setattr__(self, "slots", 4)
            if not self.trace:
                object.__setattr__(self, "trace", "uniform")
            if not self.admission:
                object.__setattr__(self, "admission", "batched")
            from repro_torch.launch.serve import ADMISSIONS
            if self.admission not in ADMISSIONS:
                raise ValueError(f"unknown admission {self.admission!r} "
                                 f"(known: {ADMISSIONS})")
            if self.slots < 1:
                raise ValueError(f"serve needs slots >= 1, got {self.slots}")
            from repro_torch.runner.traces import (FILE_PREFIX, PROFILES,
                                                   PROMPT_PROFILES, split_trace)
            if self.trace.startswith(FILE_PREFIX):
                if not self.trace[len(FILE_PREFIX):]:
                    raise ValueError("trace='file:' needs a path")
            else:
                arrival, plen = split_trace(self.trace)
                if arrival not in PROFILES:
                    raise ValueError(
                        f"unknown trace profile {arrival!r} (known: "
                        f"{PROFILES}, or 'file:PATH')")
                if plen not in PROMPT_PROFILES:
                    raise ValueError(
                        f"unknown prompt-length profile {plen!r} "
                        f"(known: {PROMPT_PROFILES})")
        if self.task == "loadgen":
            if self.load == 0.0:
                object.__setattr__(self, "load", 1.0)
            if not self.load > 0:
                raise ValueError(f"loadgen needs load > 0, got {self.load}")
            if self.split and not re.fullmatch(r"\d+/\d+", self.split):
                raise ValueError(
                    f"split must be 'i/n' (e.g. '0/2'), got {self.split!r}")
        elif self.task == "serve":
            if self.load or self.split:
                raise ValueError("load/split are loadgen-only axes "
                                 "(use task='loadgen')")
        elif self.slots or self.trace or self.load or self.split \
                or self.admission:
            raise ValueError(f"slots/trace/load/split/admission are "
                             f"serve/loadgen-only axes (task={self.task!r})")
        if self.task == "kernel":
            if self.mode not in KERNEL_MODES:
                raise ValueError(f"kernel cells support modes {KERNEL_MODES}, "
                                 f"not {self.mode!r}")
            if self.arch.count("@") != 2:
                raise ValueError(
                    f"kernel cells need a candidate-id arch "
                    f"('kernel@DIMS@PARAMS'), got {self.arch!r}")

    @property
    def bench(self) -> str:
        """The suite-registry benchmark name ("arch/task")."""
        return f"{self.arch}/{self.task}"

    @property
    def name(self) -> str:
        base = f"{self.arch}/{self.task}/b{self.batch}/s{self.seq}/{self.dtype}/{self.mode}"
        adm = "/adm-single" if self.admission == "single" else ""
        if self.task == "serve":
            return f"{base}/x{self.slots}/{self.trace}{adm}"
        if self.task == "loadgen":
            name = f"{base}/x{self.slots}/{self.trace}/L{self.load:g}"
            if self.split:
                i, n = self.split.split("/")
                name += f"/{i}of{n}"
            return name + adm
        return base

    def build_overrides(self) -> Dict[str, Any]:
        """Reduced-config overrides implied by (mode, dtype)."""
        return {**dtype_overrides(self.dtype), **MODE_OVERRIDES.get(self.mode, {})}

    def build_key(self) -> Tuple:
        """Cache key for the arch build this scenario needs."""
        base = (self.arch, self.dtype, self.mode in MODE_OVERRIDES and self.mode)
        if self.task in ("serve", "loadgen"):
            return base + ("serve", self.slots)
        if self.task == "kernel":
            return ("kernel", self.arch, self.dtype)
        return base

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "Scenario":
        return cls(**{f.name: d[f.name] for f in dataclasses.fields(cls) if f.name in d})


def select_scenarios(scenarios: Iterable[Scenario],
                     filter: Sequence[str] = (),
                     exclude: Sequence[str] = ()) -> List[Scenario]:
    """Keep iff ANY ``filter`` regex matches the scenario name (empty keeps
    all); drop if ANY ``exclude`` matches."""
    flt = re.compile("|".join(filter)) if filter else None
    exc = re.compile("|".join(exclude)) if exclude else None
    return [s for s in scenarios
            if (flt is None or flt.search(s.name))
            and not (exc is not None and exc.search(s.name))]


@dataclasses.dataclass
class ScenarioMatrix:
    """Cartesian scenario expander with filter/exclude/skip selection.

    ``slots`` / ``traces`` / ``admissions`` multiply out only under
    ``task="serve"`` / ``"loadgen"``; ``loads`` / ``splits`` under
    ``"loadgen"`` only.  Serve cells skip modes outside ``SERVE_MODES``,
    kernel cells modes outside ``KERNEL_MODES``.  ``slots="auto"`` (resolved
    from a measured load curve in the reference) waits for ``loadgen``
    (ROADMAP Queue 1, slice 7) and raises.
    """
    archs: Sequence[str]
    tasks: Sequence[str] = STEP_TASKS
    batches: Sequence[int] = (2,)
    seqs: Sequence[int] = (64,)
    dtypes: Sequence[str] = ("fp32",)
    modes: Sequence[str] = ("jit_donated",)
    slots: Sequence[int] = (4,)
    traces: Sequence[str] = ("uniform",)
    loads: Sequence[float] = (1.0,)
    splits: Sequence[str] = ("",)
    admissions: Sequence[str] = ("batched",)
    filter: Sequence[str] = ()
    exclude: Sequence[str] = ()
    skip: Sequence[str] = ()

    def expand(self) -> List[Scenario]:
        if "auto" in self.slots:
            raise NotImplementedError("slots='auto' needs the load-curve "
                                      "autoscaler (runner/loadgen.py, ROADMAP "
                                      "Queue 1, slice 7)")
        skip = set(self.skip)
        out: List[Scenario] = []
        for arch, task, batch, seq, dtype, mode in itertools.product(
                self.archs, self.tasks, self.batches, self.seqs,
                self.dtypes, self.modes):
            if task == "serve":
                if mode not in SERVE_MODES:
                    continue
                cells = [Scenario(arch=arch, task=task, batch=batch, seq=seq,
                                  dtype=dtype, mode=mode, slots=k, trace=t,
                                  admission=adm)
                         for k, t, adm in itertools.product(
                             self.slots, self.traces, self.admissions)]
            elif task == "loadgen":
                if mode not in SERVE_MODES:
                    continue
                cells = [Scenario(arch=arch, task=task, batch=batch, seq=seq,
                                  dtype=dtype, mode=mode, slots=k, trace=t,
                                  load=ld, split=sp, admission=adm)
                         for k, t, ld, sp, adm in itertools.product(
                             self.slots, self.traces, self.loads, self.splits,
                             self.admissions)]
            elif task == "kernel" and mode not in KERNEL_MODES:
                continue
            else:
                cells = [Scenario(arch=arch, task=task, batch=batch, seq=seq,
                                  dtype=dtype, mode=mode)]
            out.extend(s for s in cells if not {s.name, s.bench, s.arch} & skip)
        return select_scenarios(out, self.filter, self.exclude)

    def __iter__(self):
        return iter(self.expand())

    def __len__(self) -> int:
        return len(self.expand())
