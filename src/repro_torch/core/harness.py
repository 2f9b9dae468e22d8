"""Measurement harness (port of ``repro.core.harness``, paper §2.2).

* measures only the computation phase: inputs are on the device before
  timing starts, and ``torch.cuda.synchronize()`` bounds the region where
  the reference calls ``block_until_ready``;
* runs each benchmark N times and reports the **median** run, plus
  mean/p10/p90;
* collects host peak memory (tracemalloc of the run) and the device
  memory delta (``torch.cuda.memory_allocated()``; 0 on the CPU);
* a regression-injection hook lets CI create known slowdowns and memory
  bloat.

A step's first call is its ``compile_us``: ``torch.compile``'s compile
where the step is ``compile_step``'s, else kernel build at first use,
library handles and allocator warm-up.  ``compile_budget`` is a process's
account of its compiles and of Inductor's disk cache.  Donation becomes in-place update: a step
updates its ``mutable`` arguments in place; donated ones are threaded
through the calls (``_thread``), the others are copied per call so every
call sees the arguments it was given (what a jitted step without donation
sees).  ``measure`` has the reference's profiler and tracing hooks
(``phase_log``, ``events``); ``measure_eager`` times the uncompiled step
for the compiler modes.
"""
from __future__ import annotations

import copy
import dataclasses
import gc
import os
import time
import tracemalloc
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.build import BUILD_DIR

#: ``torch.compile``'s backend by device type: Inductor on the card; on
#: the CPU ``aot_eager`` (the AOT-autograd graphs run as traced), the
#: counterpart of the kernels' plain versions, which compiles a reduced
#: cell in seconds where Inductor's C++ takes tens of them
COMPILE_BACKENDS = {"cuda": "inductor", "cpu": "aot_eager"}

#: compiles of one code object (one step function, shared by every cell
#: of a task) before Dynamo refuses: it raises there
#: (``fail_on_recompile_limit_hit``), where by default it would run the
#: frame uncompiled without a word
RECOMPILE_LIMIT = 64

#: where Inductor (and Triton under it) keeps its compiled kernels on the
#: card: under the checkout's ``build/`` (listed in ``.gitignore``),
#: shared by the workers, whatever the environment names
INDUCTOR_CACHE_DIR = str(BUILD_DIR / "inductor")

#: ``torch._dynamo.utils.compile_times()`` entries ``compile_budget``
#: reports, by the name it gives them
COMPILE_PHASES = {"total": "_compile.compile_inner", "dynamo_trace": "bytecode_tracing",
                  "backend": "OutputGraph.call_user_compiler",
                  "aot_autograd": "create_aot_dispatcher_function",
                  "inductor_codegen": "fx_codegen_and_compile",
                  "triton_compile_wait": "async_compile.wait"}


@dataclasses.dataclass
class Measurement:
    name: str
    median_us: float
    mean_us: float
    p10_us: float
    p90_us: float
    compile_us: float
    host_peak_bytes: int
    device_bytes_delta: int
    runs: int

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def clone_tree(x: Any) -> Any:
    """A copy of every tensor in a nest of dicts, lists, tuples (named ones
    too) and modules (a train state's model is copied whole)."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, torch.nn.Module):
        return copy.deepcopy(x)
    if isinstance(x, dict):
        return {k: clone_tree(v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(clone_tree(v) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(clone_tree(v) for v in x)
    return x


def _cuda_devices(x: Any, found: set) -> set:
    if isinstance(x, torch.Tensor):
        if x.is_cuda:
            found.add(x.device)
    elif isinstance(x, torch.nn.Module):
        for t in list(x.parameters()) + list(x.buffers()):
            _cuda_devices(t, found)
    elif isinstance(x, dict):
        for v in x.values():
            _cuda_devices(v, found)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _cuda_devices(v, found)
    return found


def _synchronize(devices) -> None:
    for d in devices:
        torch.cuda.synchronize(d)


def _device_bytes(devices) -> int:
    return sum(torch.cuda.memory_allocated(d) for d in devices)


class RegressionHook:
    """Injected fault for CI validation: slows steps / leaks buffers
    (allocated on ``device``)."""

    def __init__(self, slowdown_s: float = 0.0, leak_bytes: int = 0,
                 device: DeviceLike = "cuda"):
        self.slowdown_s = slowdown_s
        self.leak_bytes = leak_bytes
        self.device = device
        self._leaked = []

    def fire(self) -> None:
        if self.slowdown_s:
            time.sleep(self.slowdown_s)
        if self.leak_bytes:
            self._leaked.append(torch.zeros(self.leak_bytes // 4,
                                            dtype=torch.float32,
                                            device=self.device))


class _CountingBackend:
    """The compile backend ``name``, whose compiled graphs count their
    calls (``dynamo_counts()["graph_calls"]``): a step call that runs no
    compiled graph ran uncompiled.  One per device type, so that cells
    that trace one program share Dynamo's cache entry."""

    def __init__(self, name: str):
        self.name = name
        self.calls = 0

    def __call__(self, gm, example_inputs):
        from torch._dynamo import lookup_backend
        fn = lookup_backend(self.name)(gm, example_inputs)

        def run(*args):
            self.calls += 1
            return fn(*args)
        return run


#: the counting backends by device type (``compile_step``)
_BACKENDS: dict = {}


def compile_step(step_fn: Callable, device: DeviceLike) -> Callable:
    """``torch.compile`` of ``step_fn`` for tensors on ``device``, with the
    backend ``COMPILE_BACKENDS`` names for it (an unknown device raises),
    static shapes (each cell its own specialisation), eager's roundings
    (Inductor's ``emulate_precision_casts``, a setting global to the
    process: every graph compiled after it rounds so) and no fallback: Dynamo
    raises at ``RECOMPILE_LIMIT`` compiles of one function, and a compile
    error reaches the caller.  Called under a dispatch mode (an
    analysis pass, untimed), the callable runs ``step_fn`` uncompiled.  The
    compile happens at the first call.  For the card it sets
    ``TORCHINDUCTOR_CACHE_DIR`` and ``TRITON_CACHE_DIR`` to
    ``INDUCTOR_CACHE_DIR`` and its ``triton`` folder, whatever they
    named before (``compile_env`` gives them to workers before they
    start)."""
    dev = torch.device(device)
    if dev.type not in COMPILE_BACKENDS:
        raise ValueError(f"compile_step: no compile backend for device {dev}")
    from torch import _dynamo
    from torch._inductor import config as inductor_config
    _dynamo.config.recompile_limit = RECOMPILE_LIMIT
    _dynamo.config.fail_on_recompile_limit_hit = True
    # a fused chain of bf16 elementwise ops rounds after each op, as the
    # uncompiled step does (Inductor would round once, at the end: a
    # bf16 ulp apart from eager, 0.0625 on gemma-2b's softcapped logits)
    inductor_config.emulate_precision_casts = True
    if dev.type == "cuda":
        os.environ["TORCHINDUCTOR_CACHE_DIR"] = INDUCTOR_CACHE_DIR
        os.environ["TRITON_CACHE_DIR"] = os.path.join(INDUCTOR_CACHE_DIR, "triton")
    backend = _BACKENDS.setdefault(dev.type, _CountingBackend(COMPILE_BACKENDS[dev.type]))
    compiled = torch.compile(step_fn, backend=backend, dynamic=False)

    def step(*args):
        # a pass under a dispatch mode (the cost analysis) runs the step
        # itself: Dynamo, entered under one, would leave the step's code
        # uncompiled for good, every later cell of the task included
        if _get_current_dispatch_mode() is not None:
            return step_fn(*args)
        return compiled(*args)
    return step


def compile_env() -> dict:
    """The cache folders a worker process takes from the process that
    spawns it, so that a graph either compiled loads from Inductor's disk
    cache in the other.  The cache key also holds the float32 matmul
    precision (``torch.backends.cuda.matmul.fp32_precision``: ``"none"`` by
    default, ``"ieee"`` once ``allow_tf32`` was set False, so a worker left
    at the default missed every graph its parent compiled with TF32 off):
    the dispatcher passes it in the worker's arguments
    (``BenchmarkRunner._dispatch_config``)."""
    return {"TORCHINDUCTOR_CACHE_DIR": INDUCTOR_CACHE_DIR,
            "TRITON_CACHE_DIR": os.path.join(INDUCTOR_CACHE_DIR, "triton")}


def compile_budget() -> dict:
    """This process's account of its compiles: ``seconds`` inside them by
    phase (``COMPILE_PHASES``, from ``torch._dynamo.utils.compile_times``:
    Dynamo's trace, AOT autograd, Inductor's codegen, the wait for Triton's
    compiles; ``total`` holds them all), the ``graphs`` Dynamo made, and the
    hits, misses and bypasses of Inductor's FX-graph cache and of AOT
    autograd's cache; zeros before anything compiled."""
    import sys
    out = {"pid": os.getpid(), "graphs": 0,
           "seconds": dict.fromkeys(COMPILE_PHASES, 0.0),
           "fxgraph_cache": {"hit": 0, "miss": 0, "bypass": 0},
           "autograd_cache": {"hit": 0, "miss": 0, "bypass": 0}}
    if "torch._dynamo" not in sys.modules:
        return out
    from torch._dynamo.utils import compilation_time_metrics, counters
    for name, key in COMPILE_PHASES.items():
        out["seconds"][name] = round(sum(compilation_time_metrics.get(key, ())), 3)
    out["graphs"] = int(counters["stats"]["unique_graphs"])
    for kind in ("hit", "miss", "bypass"):
        out["fxgraph_cache"][kind] = int(counters["inductor"][f"fxgraph_cache_{kind}"])
        out["autograd_cache"][kind] = int(counters["aot_autograd"][f"autograd_cache_{kind}"])
    return out


def dynamo_counts() -> dict:
    """Dynamo's process-wide tallies: ``frames`` (frames it was asked to
    compile, a recompile among them), ``graphs`` (graphs it made),
    ``graph_breaks`` (breaks by reason) and ``graph_calls`` (calls of the
    graphs ``compile_step``'s backends compiled); zeros before anything
    compiled."""
    import sys
    calls = sum(b.calls for b in _BACKENDS.values())
    if "torch._dynamo" not in sys.modules:
        return {"frames": 0, "graphs": 0, "graph_breaks": {}, "graph_calls": calls}
    from torch._dynamo.utils import counters
    return {"frames": int(counters["frames"]["total"]),
            "graphs": int(counters["stats"]["unique_graphs"]),
            "graph_breaks": dict(counters["graph_break"]), "graph_calls": calls}


def prepare(step_fn: Callable, donate: Tuple[int, ...] = (),
            mutable: Tuple[int, ...] = ()) -> Callable:
    """The callable ``measure`` times.  ``mutable`` are the argument slots
    the step updates in place; those not in ``donate`` are copied at every
    call, so the caller's arguments stay as they were."""
    copied = tuple(i for i in mutable if i not in donate)
    if not copied:
        return step_fn

    def step(*args):
        args = tuple(clone_tree(a) if i in copied else a
                     for i, a in enumerate(args))
        return step_fn(*args)
    return step


def _thread(out: Any, cur_args: Tuple, donate: Tuple[int, ...]) -> Tuple:
    """Thread a step's output state back into its donated argument slot.

    Suite convention: serving steps are ``(model, toks, cache) -> (logits,
    cache)`` with ``donate == (2,)``; train steps are ``(state, batch) ->
    (state, metrics)`` with ``donate == (0,)``.
    """
    if donate == (0,) and isinstance(out, tuple) and len(out) == 2:
        return (out[0],) + cur_args[1:]
    if donate == (2,) and isinstance(out, tuple) and len(out) == 2:
        return cur_args[:2] + (out[1],)
    return cur_args


def measure(name: str, step_fn: Callable, args: Tuple, donate: Tuple[int, ...] = (),
            *, runs: int = 10, warmup: int = 1,
            hook: Optional[RegressionHook] = None,
            jitted: Optional[Callable] = None,
            final_args: Optional[list] = None,
            phase_log: Optional[list] = None,
            events: Optional[list] = None,
            device_trace: Optional[dict] = None,
            device: Optional[DeviceLike] = None,
            compiled: bool = False) -> Measurement:
    """Paper protocol: median-of-N timing of the computation phase.

    ``jitted`` lets a caller (the BenchmarkRunner) pass the prepared
    callable (``prepare``); ``final_args`` (a mutable list) receives the
    threaded steady-state arguments.  Device work is waited for with
    ``torch.cuda.synchronize()`` on ``device`` when it is a card and on
    every card the arguments (modules' parameters among them) live on,
    inside each timed sample.

    ``phase_log`` (a mutable list) is the profiler hook: it receives one
    ``(dispatch_s, device_s)`` tuple per *measured* step, and needs
    ``device``, the device the step runs on, which is traced (nothing is
    guessed from the arguments: a CPU trace of a step on the card raises).
    The reference splits a step where the jitted call returns; an eager
    step's launches overlap its kernels and block on a full launch queue,
    so its return says little.  Here the device part of a sample of wall
    W is min(B, W), where B is the device's busy time per step that a
    kernel trace of ``min(runs, 3)`` more steps measures after the loop,
    untimed (``profiler.attribution.trace_device_time``, on the CPU the
    aten ops' busy time); the dispatch part, W - min(B, W), is host time the device
    did not hide.  ``device_trace`` (a dict) receives the trace's
    ``busy_us``, ``class_us`` (busy us per op class), ``steps`` and its
    clamped samples (``trace_phases``), or its ``error``.  The traced
    steps thread the donated state on: a profiled cell's ``final_args``
    are ``min(runs, 3)`` steps further on than an unprofiled one's
    (``device_bytes_delta`` is taken before the trace).  Without a log
    nothing is traced and the timed loop is the unprofiled one.

    ``events`` (a mutable list) is the tracing hook: it receives one
    ``(phase, wall_t0, wall_t1)`` tuple per protocol phase — "compile"
    (the first call + its synchronize), "warm" (the warmup prefix of the
    loop) and "measure" (the timed iterations).

    A timed call that makes Dynamo compile (a recompile) raises after the
    loop: its time would be a compile's, not the step's.  ``compiled``
    says the step is ``compile_step``'s: a timed call that ran none of
    its compiled graphs ran uncompiled, and raises too.
    """
    if phase_log is not None and device is None:
        raise ValueError("measure(phase_log=...) needs device=: the device the step "
                         "runs on, which the profile traces")
    devices = _cuda_devices(args, set())
    if device is not None:
        device = resolve_device(device)
        if device.type == "cuda":
            devices.add(device)
    gc.collect()
    _synchronize(devices)
    dev0 = _device_bytes(devices)
    if jitted is None:
        jitted = prepare(step_fn, donate)
    tw = time.time() if events is not None else 0.0
    t0 = time.perf_counter()
    out = jitted(*args)
    _synchronize(devices)
    compile_us = (time.perf_counter() - t0) * 1e6
    cur_args = _thread(out, args, donate)
    if events is not None:
        t_phase = time.time()
        events.append(("compile", tw, t_phase))

    tracemalloc.start()
    times = []
    walls = []
    before = None
    for i in range(warmup + runs):
        if i == warmup:
            before = dynamo_counts()
        if events is not None and i == warmup:
            now = time.time()
            events.append(("warm", t_phase, now))
            t_phase = now
        t0 = time.perf_counter()
        out = jitted(*cur_args)
        _synchronize(devices)
        t_done = time.perf_counter()
        dt = (t_done - t0) * 1e6
        if hook is not None:
            hook.fire()
            dt += (hook.slowdown_s * 1e6)
        if i >= warmup:
            times.append(dt)
            if phase_log is not None:
                walls.append(t_done - t0)
        cur_args = _thread(out, cur_args, donate)
    if events is not None:
        events.append(("measure", t_phase, time.time()))
    _, host_peak = tracemalloc.get_traced_memory()
    tracemalloc.stop()
    after = dynamo_counts()
    if after["frames"] != before["frames"]:
        raise RuntimeError(f"{name}: a timed call compiled (Dynamo recompiled the "
                           f"step): its time is not the compiled step's")
    if compiled and after["graph_calls"] - before["graph_calls"] < runs:
        raise RuntimeError(f"{name}: a timed call ran no compiled graph: the "
                           f"step ran uncompiled")
    dev1 = _device_bytes(devices)
    if phase_log is not None:
        from repro_torch.profiler.attribution import trace_phases

        def one_step():
            nonlocal cur_args
            cur_args = _thread(jitted(*cur_args), cur_args, donate)

        trace_phases(one_step, max(1, min(runs, 3)), walls, phase_log, device_trace,
                     device)
    if final_args is not None:
        final_args.append(cur_args)
    arr = np.array(times)
    return Measurement(
        name=name,
        median_us=float(np.median(arr)),
        mean_us=float(arr.mean()),
        p10_us=float(np.percentile(arr, 10)),
        p90_us=float(np.percentile(arr, 90)),
        compile_us=compile_us,
        host_peak_bytes=int(host_peak),
        device_bytes_delta=int(dev1 - dev0),
        runs=runs,
    )


def measure_eager(name: str, step_fn: Callable, args: Tuple, *, runs: int = 3,
                  hook: Optional[RegressionHook] = None,
                  device: Optional[DeviceLike] = None) -> Measurement:
    """Op-by-op timing of the uncompiled step — the eager analogue of
    ``measure`` for the compiler-mode comparison (the reference's
    ``jax.disable_jit`` protocol): one warm call, then ``max(2, runs)``
    timed calls, each ended by a synchronize of the cards of ``args`` (and
    ``device``).  No compile (``compile_us`` 0), no donation: ``step_fn``
    is called on ``args`` each time (``prepare`` copies what it updates in
    place).  ``p10``/``p90`` are the min and max, and the device delta 0,
    as in the reference."""
    devices = _cuda_devices(args, set())
    if device is not None and resolve_device(device).type == "cuda":
        devices.add(resolve_device(device))
    step_fn(*args)                # warm
    _synchronize(devices)
    tracemalloc.start()
    times = []
    for _ in range(max(2, runs)):
        t0 = time.perf_counter()
        step_fn(*args)
        _synchronize(devices)
        dt = (time.perf_counter() - t0) * 1e6
        if hook is not None:
            hook.fire()
            dt += hook.slowdown_s * 1e6
        times.append(dt)
    _, host_peak = tracemalloc.get_traced_memory()
    tracemalloc.stop()
    arr = np.array(times)
    return Measurement(
        name=name, median_us=float(np.median(arr)), mean_us=float(arr.mean()),
        p10_us=float(arr.min()), p90_us=float(arr.max()), compile_us=0.0,
        host_peak_bytes=int(host_peak), device_bytes_delta=0, runs=len(times))
