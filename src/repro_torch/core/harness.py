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

PyTorch runs eagerly, so there is no compile: the reference's
``compile_us`` is the first call here (kernel build at first use, library
handles, allocator warm-up).  Donation becomes in-place update: a step
updates its ``mutable`` arguments in place; donated ones are threaded
through the calls (``_thread``), the others are copied per call so every
call sees the arguments it was given (what a jitted step without donation
sees).  ``measure_eager`` and the profiler/tracing hooks wait for the
compiler modes and ``profiler/`` (ROADMAP Queue 1, slice 5).
"""
from __future__ import annotations

import dataclasses
import gc
import time
import tracemalloc
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike


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
    """A copy of every tensor in a nest of dicts, lists and tuples."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, dict):
        return {k: clone_tree(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(clone_tree(v) for v in x)
    return x


def _cuda_devices(x: Any, found: set) -> set:
    if isinstance(x, torch.Tensor):
        if x.is_cuda:
            found.add(x.device)
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
    cache)`` with ``donate == (2,)``; train steps will be ``(state, batch)
    -> (state, metrics)`` with ``donate == (0,)``.
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
            final_args: Optional[list] = None) -> Measurement:
    """Paper protocol: median-of-N timing of the computation phase.

    ``jitted`` lets a caller (the BenchmarkRunner) pass the prepared
    callable (``prepare``); ``final_args`` (a mutable list) receives the
    threaded steady-state arguments.  Device work is waited for with
    ``torch.cuda.synchronize()`` on every CUDA device the arguments live
    on, inside each timed sample.
    """
    devices = _cuda_devices(args, set())
    gc.collect()
    _synchronize(devices)
    dev0 = _device_bytes(devices)
    if jitted is None:
        jitted = prepare(step_fn, donate)
    t0 = time.perf_counter()
    out = jitted(*args)
    _synchronize(devices)
    compile_us = (time.perf_counter() - t0) * 1e6
    cur_args = _thread(out, args, donate)

    tracemalloc.start()
    times = []
    for i in range(warmup + runs):
        t0 = time.perf_counter()
        out = jitted(*cur_args)
        _synchronize(devices)
        dt = (time.perf_counter() - t0) * 1e6
        if hook is not None:
            hook.fire()
            dt += (hook.slowdown_s * 1e6)
        if i >= warmup:
            times.append(dt)
        cur_args = _thread(out, cur_args, donate)
    _, host_peak = tracemalloc.get_traced_memory()
    tracemalloc.stop()
    if final_args is not None:
        final_args.append(cur_args)
    dev1 = _device_bytes(devices)
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
