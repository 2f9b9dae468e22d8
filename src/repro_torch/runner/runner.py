"""The BenchmarkRunner (port of ``repro.runner.runner``, serial in-process
subset).

* resolves ``Scenario``s against the suite registry (``core.suite``);
* reuses expensive state across scenarios: arch builds (config + model on
  the device) per (arch, dtype, mode-overrides), prepared steps with their
  threaded arguments per scenario, serve engines per (build, mode,
  max_len, admission);
* emits one schema-v1 ``RunResult`` per execution into a ``ResultStore``,
  stamped ``extra["prov_framework"]="torch"`` and ``extra["prov_device"]``.

Runs ``infer_prefill``, ``infer_decode`` and ``serve`` cells in modes
``jit`` and ``jit_donated`` (see ``scenario.py`` for the mapping); other
tasks and modes come back as error records naming the ROADMAP item.  Not
ported yet, and raising ``NotImplementedError`` when asked for: the pool
(``jobs``), cluster dispatch and subprocess isolation (ROADMAP Queue 1,
slice 4); profiling, span tracing, coverage, kernel micro-bench cells,
loadgen and the dry-run tier (slice 5).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.core.harness import RegressionHook, measure, prepare
from repro_torch.core.suite import Built, build_arch, get_benchmark
from repro_torch.device import DeviceLike, device_name, resolve_device
from repro_torch.runner.latency import percentile
from repro_torch.runner.results import ResultStore, RunResult
from repro_torch.runner.scenario import PORTED_MODES, Scenario, ScenarioMatrix
from repro_torch.runner.traces import (cache_len_bound, capture_spec,
                                       spec_for_scenario)
from repro_torch.runner.traces import generate as generate_trace

_DISPATCH = "(ROADMAP Queue 1, slice 4: dispatch)"
_MEASURE = "(ROADMAP Queue 1, slice 5: measurement subsystems)"


def _unported(**flags) -> None:
    """Raise for the first runner feature asked for that is not ported."""
    where = {"isolate": _DISPATCH, "jobs": _DISPATCH, "cluster": _DISPATCH,
             "profile": _MEASURE, "tracer": _MEASURE, "coverage": _MEASURE}
    for name, asked in flags.items():
        if asked:
            raise NotImplementedError(f"BenchmarkRunner {name}= is not "
                                      f"ported yet {where[name]}")


@dataclasses.dataclass
class RunnerStats:
    model_builds: int = 0
    model_cache_hits: int = 0
    executable_builds: int = 0
    executable_cache_hits: int = 0
    scenarios_run: int = 0
    errors: int = 0


@dataclasses.dataclass
class _ExecEntry:
    jitted: Callable                # the prepared step (harness.prepare)
    step: Callable
    args: Tuple                     # threaded, donation-valid arguments
    donate: Tuple[int, ...]


class BenchmarkRunner:
    def __init__(self, store: Optional[ResultStore] = None, *,
                 runs: int = 5, warmup: int = 1, compile_warmup: int = 3,
                 reuse: bool = True, device: DeviceLike = "cuda",
                 isolate: bool = False, jobs: int = 0, cluster: str = "",
                 profile: bool = False, tracer: Any = None,
                 coverage: bool = False):
        _unported(isolate=isolate, jobs=jobs > 1, cluster=cluster,
                  profile=profile, tracer=tracer is not None,
                  coverage=coverage)
        self.device = resolve_device(device)
        self.store = store
        self.runs = runs
        self.warmup = warmup
        # extra warmup steps after a fresh build: the first calls run well
        # above steady state (allocator growth, library handles)
        self.compile_warmup = compile_warmup
        self.reuse = reuse
        self.stats = RunnerStats()
        self._built: Dict[Tuple, Built] = {}
        self._execs: Dict[Scenario, _ExecEntry] = {}
        self._serve_engines: Dict[Tuple, Any] = {}

    # ---- build / executable caches -------------------------------------

    def built_for(self, arch: str, *, dtype: str = "fp32",
                  mode: str = "jit_donated") -> Built:
        """The cached arch build for (arch, dtype, mode-overrides)."""
        sc = Scenario(arch=arch, dtype=dtype, mode=mode)
        key = sc.build_key()
        if key in self._built:
            self.stats.model_cache_hits += 1
            return self._built[key]
        built = build_arch(arch, sc.build_overrides(), self.device)
        self.stats.model_builds += 1
        if self.reuse:
            self._built[key] = built
        return built

    def _resolve(self, scenario: Scenario) -> Tuple[_ExecEntry, Dict[str, bool]]:
        if self.reuse and scenario in self._execs:
            self.stats.executable_cache_hits += 1
            return self._execs[scenario], {"model_reused": True,
                                           "executable_reused": True}
        if scenario.mode not in PORTED_MODES:
            raise NotImplementedError(
                f"mode {scenario.mode!r} is not ported yet (ROADMAP Queue 1, "
                f"slice 5: compilers, eager vs torch.compile)")
        hits0 = self.stats.model_cache_hits
        built = self.built_for(scenario.arch, dtype=scenario.dtype,
                               mode=scenario.mode)
        bench = get_benchmark(scenario.arch, scenario.task)
        step, args, donate = bench.make(batch=scenario.batch, seq=scenario.seq,
                                        built=built)
        d = donate if scenario.mode == "jit_donated" else ()
        entry = _ExecEntry(jitted=prepare(step, d, mutable=donate), step=step,
                           args=args, donate=d)
        self.stats.executable_builds += 1
        if self.reuse:
            self._execs[scenario] = entry
        return entry, {"model_reused": self.stats.model_cache_hits > hits0,
                       "executable_reused": False}

    # ---- measured path --------------------------------------------------

    def run(self, scenario: Scenario, *, hook: Optional[RegressionHook] = None,
            runs: Optional[int] = None, warmup: Optional[int] = None,
            record: bool = True, profile: Optional[bool] = None,
            extra: Optional[Dict[str, Any]] = None) -> RunResult:
        """Execute one scenario and return its RunResult (benchmark failures
        come back as status="error" records, they are not raised).

        ``task="serve"`` cells run the continuous-batching engine over the
        scenario's trace instead of the ``measure()`` step protocol.
        """
        _unported(profile=profile)
        if scenario.task in ("loadgen", "kernel"):
            raise NotImplementedError(f"task={scenario.task!r} is not ported "
                                      f"yet {_MEASURE}")
        if scenario.task == "serve":
            return self._run_serve(scenario, hook=hook, record=record,
                                   extra=extra)
        t0 = time.perf_counter()
        self.stats.scenarios_run += 1
        try:
            entry, cache = self._resolve(scenario)
            wu = self.warmup if warmup is None else warmup
            if not cache.get("executable_reused"):
                wu += self.compile_warmup
            final_args: List[Tuple] = []
            m = measure(scenario.name, entry.step, entry.args, entry.donate,
                        runs=runs or self.runs, warmup=wu, hook=hook,
                        jitted=entry.jitted, final_args=final_args)
            if self.reuse and final_args:
                # the donated cache was updated in place and threaded: keep
                # the threaded args for the next measurement
                entry.args = final_args[0]
            rr = RunResult.from_measurement(
                scenario, m, wall_s=time.perf_counter() - t0, cache=cache)
            if cache.get("executable_reused"):
                rr.compile_us = 0.0
        except Exception as e:  # noqa: BLE001 — fault containment per cell
            self.stats.errors += 1
            # a failed measure may have left a half-updated cache: evict
            self._execs.pop(scenario, None)
            rr = RunResult.from_error(scenario, f"{type(e).__name__}: {e}",
                                      wall_s=time.perf_counter() - t0)
        return self._finalize(rr, extra, record)

    def _finalize(self, rr: RunResult, extra: Optional[Dict[str, Any]],
                  record: bool) -> RunResult:
        """Shared result epilogue: merge extras, stamp provenance, record."""
        if extra:
            rr.extra.update(extra)
        rr.extra.setdefault("prov_framework", "torch")
        rr.extra.setdefault("prov_device", device_name(self.device))
        if record and self.store is not None:
            self.store.append(rr)
        return rr

    # ---- serving path ----------------------------------------------------

    def _serve_engine_for(self, scenario: Scenario, built: Built,
                          max_len: int) -> Tuple[Any, bool]:
        """The cached engine for a serve cell; returns (engine, reused)."""
        from repro_torch.launch.serve import ServeEngine
        key = (scenario.build_key(), scenario.mode, max_len,
               scenario.admission)
        if self.reuse and key in self._serve_engines:
            self.stats.executable_cache_hits += 1
            return self._serve_engines[key], True
        engine = ServeEngine(built, slots=scenario.slots, max_len=max_len,
                             donate=scenario.mode == "jit_donated",
                             admission=scenario.admission)
        self.stats.executable_builds += 1
        if self.reuse:
            self._serve_engines[key] = engine
        return engine, False

    def _run_serve(self, scenario: Scenario, *,
                   hook: Optional[RegressionHook] = None,
                   record: bool = True,
                   extra: Optional[Dict[str, Any]] = None) -> RunResult:
        """One serving cell: regenerate the scenario's trace, replay it
        through the (cached) engine, and fold the latency distribution into
        a RunResult — ``median_us``/``mean_us``/``p10_us``/``p90_us`` are
        per-token decode latencies; TTFT/per-token p50/p95/p99 and
        throughput land under the well-known ``extra`` keys."""
        from repro_torch.launch.serve import summarize_metrics
        t0 = time.perf_counter()
        self.stats.scenarios_run += 1
        key = None
        try:
            spec = spec_for_scenario(scenario)
            hits0 = self.stats.model_cache_hits
            built = self.built_for(scenario.arch, dtype=scenario.dtype,
                                   mode=scenario.mode)
            model_reused = self.stats.model_cache_hits > hits0
            reqs = generate_trace(spec, vocab=built.cfg.vocab)
            max_len = cache_len_bound(reqs)
            key = (scenario.build_key(), scenario.mode, max_len,
                   scenario.admission)
            engine, engine_reused = self._serve_engine_for(scenario, built,
                                                           max_len)
            cache = {"model_reused": model_reused or engine_reused,
                     "executable_reused": engine_reused}
            compile_us = 0.0
            if not engine_reused:
                # untimed warm replay on a fresh engine (first-call costs,
                # recorded as compile_us), so the measured replay's latency
                # samples are steady-state
                tc = time.perf_counter()
                engine.run(reqs)
                compile_us = (time.perf_counter() - tc) * 1e6
            out = engine.run(reqs, hook=hook)
            sx = summarize_metrics(out)
            plens = sorted(len(r.prompt) for r in reqs)
            sx.update(trace=scenario.trace, slots=scenario.slots,
                      tokens=out["tokens_by_rid"],
                      prompt_len_p50=percentile(plens, 50),
                      prompt_len_p95=percentile(plens, 95))
            sx["capture"] = dataclasses.asdict(capture_spec(
                reqs, seed=spec.seed, source=f"capture:{scenario.name}"))
            lats = out["tok_lat_s"] or out["ttft_s"]
            rr = RunResult(
                name=scenario.name, bench=scenario.bench, arch=scenario.arch,
                task=scenario.task, batch=scenario.batch, seq=scenario.seq,
                dtype=scenario.dtype, mode=scenario.mode, status="ok",
                median_us=percentile(lats, 50) * 1e6,
                mean_us=sum(lats) / len(lats) * 1e6,
                p10_us=percentile(lats, 10) * 1e6,
                p90_us=percentile(lats, 90) * 1e6,
                compile_us=compile_us, runs=out["requests"],
                wall_s=time.perf_counter() - t0, cache=cache,
                ts=time.time(), extra=sx)
        except Exception as e:  # noqa: BLE001 — fault containment per cell
            self.stats.errors += 1
            # the engine's in-place KV cache may be half-updated: evict it
            if key is not None:
                self._serve_engines.pop(key, None)
            rr = RunResult.from_error(scenario, f"{type(e).__name__}: {e}",
                                      wall_s=time.perf_counter() - t0)
        return self._finalize(rr, extra, record)

    def run_matrix(self, matrix: ScenarioMatrix, *,
                   hooks: Optional[Dict[str, RegressionHook]] = None,
                   runs: Optional[int] = None,
                   warmup: Optional[int] = None,
                   jobs: Optional[int] = None,
                   cluster: Optional[str] = None,
                   profile: Optional[bool] = None) -> List[RunResult]:
        """Run every scenario of the matrix in order, in this process; hooks
        are keyed by benchmark name ("arch/task") or full scenario name."""
        _unported(jobs=(jobs or 0) > 1, cluster=cluster, profile=profile)
        out = []
        for sc in matrix.expand():
            hook = (hooks or {}).get(sc.name) or (hooks or {}).get(sc.bench)
            out.append(self.run(sc, hook=hook, runs=runs, warmup=warmup))
        return out

    def run_dryrun(self, *args, **kwargs):
        raise NotImplementedError("the derived (dry-run) tier is not ported "
                                  "yet (ROADMAP Queue 1, slice 5)")
