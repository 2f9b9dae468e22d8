"""Sharded process-pool dispatch for ``BenchmarkRunner.run_matrix`` (port
of ``repro.runner.pool``).

Scenarios are scheduled as **build-key groups** (``rank_groups``): every
scenario of one (arch, dtype, mode-overrides) is dispatched to the same
worker back-to-back, so the per-worker arch-build and prepared-step caches
keep paying off exactly as they do in-process.

Two placement strategies share those groups:

* **dynamic stealing** (default): the first ``jobs`` ranked groups seed
  one worker each (deterministic start), and the remaining groups sit in
  a shared deque that idle workers *pull* from as they finish.
* **static LPT** (``steal=False``, and the ``assign_shards`` function):
  groups are placed largest-guessed-weight-first onto the least-loaded
  shard up front.

``ShardScheduler`` owns N *persistent* worker subprocesses
(``python -m repro_torch.runner.worker --serve --device D``, every one on
the dispatching runner's device) that live across ``run()`` calls.  Jobs
and results are JSONL messages (``runner/protocol.py``, the protocol the
cluster speaks over TCP) over each worker's stdin/stdout pipes, so the
parent collects results as cells complete and a crash costs exactly the
in-flight cell: the dead worker is respawned and its group's remaining
cells continue.  A worker whose cell failed with a CUDA error replies and
then exits (``exiting`` in the reply; a sticky CUDA error fails every
later call of its process), and the pool respawns it for the rest of its
group.  Worker ``RunnerStats`` are delta-merged into the per-run stats
after every cell.

The **measurement fence** is one flock per device of this host
(``measure_lock_path``), shared by the pool's and ``local:N`` cluster
workers.  On the CPU, workers overlap their builds and first calls and
serialize only their timed loops, as in the reference.  On a card, the
workers share the device itself (time-sliced without MPS), so each cell's
every launch, its warm pass included, runs under the fence: what overlaps
is interpreter start, imports, loading the kernel libraries and idle
time, and ``jobs=N`` on one card buys fault containment, warm persistent
workers and overlapped start-up, not parallel measurement.  Each worker
also holds its own CUDA context and caching allocator, so ``jobs=2`` can
run out of device memory where the serial path fits.  ``measure_fence=
False`` opts out for pure-throughput sweeps.

Regression hooks are forwarded as their plain parameters
(``slowdown_s`` / ``leak_bytes``).
"""
from __future__ import annotations

import collections
import os
import subprocess
import sys
import tempfile
import threading
import time
from typing import Callable, Deque, Dict, List, Optional, Sequence, Tuple

from repro_torch.fleet.metrics import registry as metrics_registry
from repro_torch.runner.protocol import Channel, job_message, stats_delta
from repro_torch.runner.results import RunResult
from repro_torch.runner.scenario import Scenario
from repro_torch.telemetry.spans import NULL_TRACER, Tracer, group_label


def _src_dir() -> str:
    import repro_torch
    pkg = (repro_torch.__file__ and os.path.dirname(repro_torch.__file__)) or \
        list(repro_torch.__path__)[0]
    return os.path.dirname(os.path.abspath(pkg))


def _subprocess_env() -> Dict[str, str]:
    """A worker's environment: this process's, the package on its path,
    and the compile cache it shares with this process
    (``harness.compile_env``)."""
    from repro_torch.core.harness import compile_env
    env = dict(os.environ, **compile_env())
    src = _src_dir()
    env["PYTHONPATH"] = src + (os.pathsep + env["PYTHONPATH"]
                               if env.get("PYTHONPATH") else "")
    return env


def measure_lock_path(device: str) -> str:
    """The measurement fence's flock path for ``device``: one per device of
    this host, so that every worker sharing it (the pool's and
    ``local:N``'s, of any runner) fences against every other.  The file
    stays: removing it while a worker holds it would let the next opener
    lock a new file."""
    return os.path.join(tempfile.gettempdir(),
                        "repro_torch_measure_" + device.replace(":", "_") + ".lock")


#: relative cost guess per task for shard balancing (a train step runs
#: fwd+bwd+update; decode is a single cached token; a serve cell replays a
#: whole continuous-batching trace — many decode steps plus per-request
#: prefills) — only the ratios matter, and only for load balance, never
#: for correctness
_TASK_WEIGHT = {"train": 4, "infer_prefill": 2, "infer_decode": 1,
                "serve": 8, "loadgen": 8, "kernel": 1}


def rank_groups(scenarios: Sequence[Scenario]) -> List[Tuple[List[int], int]]:
    """Build-key groups of scenario *indices*, ranked heaviest-guessed-
    weight first (group weight = sum of per-task cost weights, ties broken
    by first appearance — sorted() is stable).  Scenarios of one build_key
    stay together in input order.  This is the shared scheduling unit for
    the single-host pool AND the cluster coordinator: a group is the chunk
    a worker owns so its caches stay hot."""
    groups: Dict[Tuple, List[int]] = {}
    weight: Dict[Tuple, int] = {}
    order: List[Tuple] = []
    for i, sc in enumerate(scenarios):
        key = sc.build_key()
        if key not in groups:
            groups[key] = []
            weight[key] = 0
            order.append(key)
        groups[key].append(i)
        weight[key] += _TASK_WEIGHT.get(sc.task, 2)
    ranked = sorted(order, key=lambda k: -weight[k])
    return [(groups[k], weight[k]) for k in ranked]


def assign_shards(scenarios: Sequence[Scenario], jobs: int) -> List[List[int]]:
    """Static LPT: partition scenario indices into ``jobs`` shards by
    build_key, placing ranked groups onto the currently lightest shard
    (ties by shard index).  Fully deterministic for a given scenario list;
    shards may come back empty when there are fewer groups than jobs."""
    jobs = max(1, int(jobs))
    shards: List[List[int]] = [[] for _ in range(jobs)]
    load = [0] * jobs
    for idxs, w in rank_groups(scenarios):
        target = min(range(jobs), key=lambda j: (load[j], j))
        shards[target].extend(idxs)
        load[target] += w
    return shards


def steal_plan(ranked: Sequence[Tuple[List[int], int]], jobs: int
               ) -> Tuple[List[List[int]], Deque[List[int]]]:
    """Dynamic placement: the first ``jobs`` ranked groups seed one worker
    each (deterministic start), the tail goes into the shared steal deque
    idle workers pull from.  Returns ``(seeds, deque)``."""
    jobs = max(1, int(jobs))
    seeds: List[List[int]] = [[] for _ in range(jobs)]
    for j, (idxs, _) in enumerate(ranked[:jobs]):
        seeds[j] = list(idxs)
    return seeds, collections.deque(list(idxs) for idxs, _ in ranked[jobs:])


class _Worker:
    """One persistent ``worker --serve`` subprocess + its protocol state."""

    def __init__(self, idx: int, argv: List[str], env: Dict[str, str]):
        self.idx = idx
        self.argv = argv
        self.env = env
        self.proc: Optional[subprocess.Popen] = None
        self.chan: Optional[Channel] = None
        self.generation = 0          # bumped per spawn (stats-delta resets)
        # cumulative worker stats already delta-merged by the parent; lives
        # on the worker (NOT per run() call) because the process — and its
        # monotonically growing counters — persists across run() calls
        self.stats_seen: Dict[str, int] = {}
        # same delta-merge protocol for the worker's metrics registry
        # (flat cumulative counters; see repro_torch.fleet.metrics)
        self.metrics_seen: Dict[str, float] = {}
        self.stats_gen = -1
        self.stderr_path = ""

    def ensure(self) -> subprocess.Popen:
        if self.proc is None or self.proc.poll() is not None:
            self._cleanup_stderr()
            fd, self.stderr_path = tempfile.mkstemp(
                suffix=".log", prefix=f"repro_torch_shard{self.idx}_")
            self.proc = subprocess.Popen(
                self.argv, env=self.env, stdin=subprocess.PIPE,
                stdout=subprocess.PIPE, stderr=fd, bufsize=0)
            os.close(fd)
            self.chan = Channel.over_pipes(self.proc.stdout, self.proc.stdin)
            self.generation += 1
            if self.generation > 1:
                metrics_registry().inc("pool_respawns_total")
        return self.proc

    def send(self, msg: dict) -> None:
        self.ensure()
        self.chan.send(msg)

    def recv(self, timeout: float) -> Optional[dict]:
        """One protocol line, or None on EOF/timeout (worker dead/hung)."""
        if self.chan is None:
            return None
        return self.chan.recv(timeout)

    def stderr_tail(self, n: int = 500) -> str:
        try:
            with open(self.stderr_path, errors="replace") as f:
                return f.read()[-n:]
        except OSError:
            return ""

    def death_reason(self, timeout: float) -> str:
        if self.proc is not None:
            try:                 # give a just-died worker time to be reaped
                self.proc.wait(0.5)
            except subprocess.TimeoutExpired:
                return (f"shard worker {self.idx} timed out "
                        f"after {timeout:.0f}s")
        code = self.proc.poll() if self.proc is not None else None
        return (f"shard worker {self.idx} died (exit {code}): "
                f"{self.stderr_tail()}")

    def kill(self, grace: float = 0.0) -> None:
        proc, self.proc = self.proc, None
        self.chan = None
        if proc is not None:
            try:
                if proc.stdin:
                    proc.stdin.close()      # EOF => clean worker exit
            except OSError:
                pass
            if proc.poll() is None:
                try:
                    proc.wait(grace or 0.1)
                except subprocess.TimeoutExpired:
                    proc.terminate()
                    try:
                        proc.wait(5)
                    except subprocess.TimeoutExpired:
                        proc.kill()
                        proc.wait()
            if proc.stdout:
                proc.stdout.close()
        self._cleanup_stderr()

    def _cleanup_stderr(self) -> None:
        if self.stderr_path and os.path.exists(self.stderr_path):
            try:
                os.remove(self.stderr_path)
            except OSError:
                pass
        self.stderr_path = ""


class ShardScheduler:
    """Dispatch scenario batches across persistent worker subprocesses."""

    def __init__(self, jobs: int, *, runs: int = 5, warmup: int = 1,
                 compile_warmup: int = 3, reuse: bool = True,
                 measure_fence: bool = True, device: str = "cuda",
                 matmul_precision: str = "",
                 timeout: float = 1200.0, steal: bool = True):
        if os.name != "posix":
            # the protocol needs select()able pipes + flock; fail loudly
            # instead of turning every cell into a "worker died" record
            raise RuntimeError("sharded dispatch (jobs>1) requires a POSIX "
                               "host; use the serial path (jobs=0)")
        self.jobs = max(1, int(jobs))
        self.timeout = timeout
        self.steal = steal
        self.device = device
        argv = [sys.executable, "-m", "repro_torch.runner.worker", "--serve",
                "--runs", str(runs), "--warmup", str(warmup),
                "--compile-warmup", str(compile_warmup), "--device", device]
        if matmul_precision:
            argv += ["--matmul-precision", matmul_precision]
        if not reuse:
            argv.append("--no-reuse")
        # measurement fence (see the module docstring and worker._run_cell)
        self.measure_lock_path = ""
        if measure_fence and reuse:
            self.measure_lock_path = measure_lock_path(device)
            argv += ["--measure-lock", self.measure_lock_path]
        env = _subprocess_env()
        self._workers = [_Worker(i, argv, env) for i in range(self.jobs)]
        self._lock = threading.Lock()

    # ---- lifecycle -------------------------------------------------------

    def worker_pids(self) -> List[int]:
        """PIDs of the currently-spawned shard workers (the no-orphans
        gate: after ``close()`` each must be dead)."""
        return [w.proc.pid for w in self._workers if w.proc is not None]

    def close(self) -> None:
        for worker in self._workers:
            worker.kill(grace=2.0)

    def __enter__(self) -> "ShardScheduler":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    # ---- dispatch --------------------------------------------------------

    def run(self, scenarios: Sequence[Scenario], *,
            hooks: Optional[dict] = None,
            runs: Optional[int] = None, warmup: Optional[int] = None,
            profile: bool = False,
            on_result: Optional[Callable[[RunResult], None]] = None,
            steal: Optional[bool] = None,
            tracer: Optional[Tracer] = None, trace_parent=None,
            extras: Optional[Dict[str, dict]] = None):
        """Run every scenario, grouped by build_key; returns
        ``(results_in_input_order, run_stats)`` where ``run_stats`` is a
        ``RunnerStats`` of everything the workers did *during this call*.

        ``steal`` (default: the scheduler's setting) picks dynamic
        group stealing vs static LPT placement.  ``profile`` rides in
        every job message, so workers record the measured
        ``extra["prof_*"]`` payload exactly like the serial path.
        ``on_result`` fires from worker-reader threads as cells complete
        (the ResultStore append path is thread-safe for exactly this).

        ``tracer``/``trace_parent`` stitch the dispatch into the caller's
        trace: each stolen group gets a ``group:`` span, each cell a
        ``dispatch:`` span whose context rides the job message so the
        worker's own spans come back parented under it (matched by cell).
        ``extras`` maps scenario name -> extra dict forwarded with the
        job and merged into that cell's result.
        """
        from repro_torch.runner.runner import RunnerStats
        tracer = tracer or NULL_TRACER
        extras = extras or {}
        steal = self.steal if steal is None else steal
        ranked = rank_groups(scenarios)
        if steal:
            seeds, queue = steal_plan(ranked, self.jobs)
        else:
            # static LPT: every group pre-placed, nothing left to steal
            shards = assign_shards(scenarios, self.jobs)
            seeds, queue = [list(s) for s in shards], collections.deque()
        results: List[Optional[RunResult]] = [None] * len(scenarios)
        run_stats = RunnerStats()
        threads = []
        for worker, seed in zip(self._workers, seeds):
            if not seed and not queue:
                continue
            t = threading.Thread(
                target=self._drive,
                args=(worker, seed, queue, scenarios, hooks or {}, runs,
                      warmup, profile, results, run_stats, on_result,
                      tracer, trace_parent, extras),
                name=f"shard-{worker.idx}", daemon=True)
            threads.append(t)
            t.start()
        for t in threads:
            t.join()
        return [r for r in results if r is not None], run_stats

    def _drive(self, worker: _Worker, seed: List[int],
               queue: Deque[List[int]], scenarios: Sequence[Scenario],
               hooks: dict, runs: Optional[int], warmup: Optional[int],
               profile: bool, results: List[Optional[RunResult]], run_stats,
               on_result: Optional[Callable[[RunResult], None]],
               tracer: Tracer = NULL_TRACER, trace_parent=None,
               extras: Optional[Dict[str, dict]] = None) -> None:
        """One worker's job stream: its seed group first, then whatever
        groups it can steal from the shared deque.  Crashes cost one cell
        each (the worker is respawned for its group's remaining cells)."""
        group = seed
        while True:
            if not group:
                with self._lock:
                    if not queue:
                        return
                    group = queue.popleft()   # steal the next ranked group
                    depth = len(queue)
                reg = metrics_registry()
                reg.inc("pool_steals_total")
                reg.set_gauge("pool_queue_depth", depth)
                continue
            gspan = None
            if tracer.enabled and group:
                key = scenarios[group[0]].build_key()
                gspan = tracer.start(
                    "group:" + group_label(key), parent=trace_parent,
                    kind="group", shard=worker.idx, cells=len(group))
            try:
                for idx in group:
                    self._run_one(worker, idx, scenarios, hooks, runs,
                                  warmup, profile, results, run_stats,
                                  on_result, tracer, gspan, extras or {})
            finally:
                if gspan is not None:
                    tracer.finish(gspan)
            group = []

    def _run_one(self, worker: _Worker, idx: int,
                 scenarios: Sequence[Scenario], hooks: dict,
                 runs: Optional[int], warmup: Optional[int], profile: bool,
                 results: List[Optional[RunResult]], run_stats,
                 on_result: Optional[Callable[[RunResult], None]],
                 tracer: Tracer = NULL_TRACER, group_span=None,
                 extras: Optional[Dict[str, dict]] = None) -> None:
        from repro_torch.runner.runner import stamp
        sc = scenarios[idx]
        extra = (extras or {}).get(sc.name)
        ds = tracer.start("dispatch:" + sc.name, kind="dispatch",
                          parent=group_span, cell=sc.name,
                          shard=worker.idx) if tracer.enabled else None
        t0 = time.perf_counter()
        try:
            worker.ensure()
            if worker.generation != worker.stats_gen:
                worker.stats_gen = worker.generation
                worker.stats_seen = {}   # fresh interpreter: from zero
                worker.metrics_seen = {}
            hook = hooks.get(sc.name) or hooks.get(sc.bench)
            job = job_message(sc, runs=runs, warmup=warmup,
                              profile=profile, hook=hook,
                              trace=tracer.context(ds), extra=extra)
            rr, stats, metrics, spans, exiting = self._round_trip(worker, job)
        except Exception as e:  # noqa: BLE001 — e.g. spawn ENOMEM: the
            rr, stats, metrics, spans = None, None, None, None  # keep emitting
            exiting = False
            reason = f"shard worker {worker.idx} dispatch failed: {e!r}"
        else:
            reason = None if rr is not None else \
                worker.death_reason(self.timeout)
        if rr is None:
            worker.kill()
            metrics_registry().inc("pool_worker_deaths_total")
            rr = RunResult.from_error(sc, reason,
                                      wall_s=time.perf_counter() - t0)
            if extra:
                rr.extra.update(extra)
            stamp(rr, self.device)   # worker never saw it: stamp here
            with self._lock:
                run_stats.scenarios_run += 1
                run_stats.errors += 1
        else:
            rr.wall_s = time.perf_counter() - t0   # incl. dispatch
            delta = stats_delta(stats, worker.stats_seen)
            if delta:
                with self._lock:
                    run_stats.merge(delta)
            if metrics:
                metrics_registry().merge_cumulative(
                    stats_delta(metrics, worker.metrics_seen))
            if exiting:
                # a CUDA error: the worker leaves after this reply; reap
                # it so the group's next cell respawns a fresh one
                worker.kill(grace=30.0)
        if ds is not None:
            tracer.ingest(spans, proc=f"shard{worker.idx}")
            ds.set(status=rr.status)
            tracer.finish(ds)
            rr.extra.setdefault("span_trace", tracer.trace_id)
            rr.extra["span_dispatch"] = ds.span_id
        rr.extra["shard"] = worker.idx
        rr.extra["isolated"] = True
        results[idx] = rr
        try:
            if on_result is not None:
                on_result(rr)
        except Exception:  # noqa: BLE001 — a failing store append must
            pass           # not kill the shard; the result is returned

    def _round_trip(self, worker: _Worker, job: dict):
        """Send one job, read its result (which carries the worker's
        cumulative stats, metrics-registry counters, traced spans, and
        whether the worker exits after it); all-None when the worker dies
        or hangs."""
        try:
            worker.send(job)
            msg = worker.recv(self.timeout)
        except (OSError, ValueError):
            return None, None, None, None, False
        if not msg or msg.get("op") != "result":
            return None, None, None, None, False
        return (RunResult.from_dict(msg["result"]), msg.get("stats"),
                msg.get("metrics"), msg.get("spans"), bool(msg.get("exiting")))
