"""Persistent, schema'd benchmark results (port of ``repro.runner.results``).

``RunResult`` — one versioned record per scenario execution, schema v1
with the reference's fields unchanged, so the two packages' stores compare
row by row:

    schema       int    record version (this file: SCHEMA_VERSION)
    name         str    scenario id "arch/task/bN/sN/dtype/mode"
    bench        str    suite benchmark name "arch/task"
    arch/task/batch/seq/dtype/mode   the scenario axes
    status       str    "ok" | "error" | "skipped"
    median_us, mean_us, p10_us, p90_us, compile_us   timing (us)
    host_peak_bytes, device_bytes_delta              memory
    runs         int    measured iterations (after warmup)
    wall_s       float  end-to-end wall time incl. build and first call
    cache        dict   {"model_reused": bool, "executable_reused": bool}
    ts           float  unix timestamp
    error        str?   exception text when status == "error"
    extra        dict   free-form payload

Provenance stamps the port adds to every record (still schema v1):

    extra["prov_framework"]  str  "torch" — which package measured it
    extra["prov_device"]     str  the device the cell ran on:
                                  ``torch.cuda.get_device_name`` on the
                                  card, "cpu" on the CPU (a CPU number is
                                  never a device number)

Serving cells (``task="serve"``) carry the reference's serve keys: the
core timing fields hold per-token decode latencies and ``runs`` is the
request count; ``extra`` holds ``ttft_p50|p95|p99`` and
``tok_lat_p50|p95|p99`` (us), ``tok_per_s``, ``decode_steps``,
``queue_depth_mean|max``, ``trace``, ``slots``, ``tokens``,
``tokens_digest``, ``prompt_len_p50|p95``, ``capture``, ``admission``,
``admit_calls``, ``admit_batch_mean|max`` and ``admit_shapes`` (the
meanings are documented in ``repro.runner.results``).

Profiled cells (``run(..., profile=True)``; ``repro_torch.profiler``)
additionally carry the reference's ``prof_*`` keys (still schema v1), with
the same names, the same set for the same ``Scenario``, and these
meanings.  The trace runs 3 more steps (at most ``runs``) after the timed
loop, untimed: a profiled step cell's threaded state (a donated cache or
train state) is that many steps further on than an unprofiled one's.

    extra["prof_kind"]     str    "step" (train/infer cells: one sample per
                                  measured iteration) | "decode_step"
                                  (serve: one per batched decode step)
    extra["prof_steps"]    int    profiled samples
    extra["prof_timeline"] list   [dispatch_us, device_us] per sample,
                                  capped at profiler.TIMELINE_CAP (128)
    extra["prof_device_us_mean"]  float  the device's busy time per step
                                  (at most the sample's wall), from a
                                  kernel trace (``torch.profiler``) of
                                  extra, untimed steps: on the card the
                                  kernels' time, on the CPU the aten ops'
    extra["prof_dispatch_us_mean"] float host time the device did not hide:
                                  the sample's wall less its device part
                                  (eager launches overlap the kernels, so
                                  the reference's call-return split does
                                  not carry over)
    extra["prof_idle_us"]  float  serve only: measured replay wall outside
                                  decode steps (admission, prefill, queue)
    extra["prof_frac_compute"|"prof_frac_memory"|"prof_frac_collective"
         |"prof_frac_dispatch"|"prof_frac_idle"]
                           float  measured time decomposition; the five
                                  fractions sum to 1.0 per cell (device
                                  time split over op classes by the
                                  trace's measured class times, then into
                                  compute vs memory per class by its
                                  flops : bytes roofline terms; device time
                                  the costs can't explain lands in idle)
    extra["prof_class_us"|"prof_class_frac"]   dict   measured device time
                                  per op class (hloanalysis.OP_CLASSES:
                                  matmul/attention/collective/elementwise/
                                  other; attention is the port's kernels),
                                  us and fraction of device time
    extra["prof_flops"|"prof_bytes"|"prof_collective_bytes"]   the eager
                                  step's counted work (``analyze_step``)
    extra["prof_bound_us"] float  the step's roofline bound on the H100
                                  (``core.hardware.DEFAULT_HW``)
    extra["prof_util"]     float  bound / measured device time per step
    extra["prof_device_peak_bytes"|"prof_device_bytes_in_use"]   the
                                  card's allocator stats (absent on CPU)
    extra["prof_error"]    str    the trace or the cost pass failed; the
                                  cell's status stays "ok"
    extra["trace_clamp"]   dict   port only, outside the ``prof_``
                                  namespace and on every profiled cell:
                                  {"samples": how many samples the
                                  trace's busy time per step B clamped
                                  because it exceeded their wall W (their
                                  device part is W, their host part 0),
                                  "busy_over_wall_max": the largest B / W}
                                  (0 and 0.0 when the trace failed); a
                                  large B / W says the traced steps ran
                                  longer than the timed ones

Coverage annotations (still schema v1; step cells of a
``BenchmarkRunner(coverage=True)``, serial and in-process only):

    extra["cov_primitives"]     int   distinct torch API functions the
                                  cell's step calls (``core/coverage``:
                                  one run of the step under a
                                  ``TorchFunctionMode``, each kernel call
                                  one name; cached per scenario) — the
                                  reference counts jaxpr primitives here
    extra["cov_new_primitives"] int   of those, how many this cell added
                                  to the runner's suite-union frontier
                                  (first cell of a sweep pays the whole
                                  union; later cells count marginal
                                  coverage — the paper's breadth metric
                                  as a per-cell number).  The running
                                  union size is the
                                  ``fleet_cov_union_primitives`` gauge.
                                  A pass that raises makes the cell an
                                  error record (the reference drops it).

``ResultStore`` — an append-only JSONL run log plus an atomically
rewritten latest-pointer JSON (a directory, or a ``*.json`` path with the
log beside it), safe for concurrent appenders.
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from typing import Any, Dict, Iterator, List, Optional

try:
    import fcntl
except ImportError:          # non-POSIX: fall back to best-effort updates
    fcntl = None  # type: ignore[assignment]

SCHEMA_VERSION = 1


@dataclasses.dataclass
class RunResult:
    name: str
    bench: str
    arch: str
    task: str
    batch: int
    seq: int
    dtype: str
    mode: str
    status: str = "ok"
    median_us: float = 0.0
    mean_us: float = 0.0
    p10_us: float = 0.0
    p90_us: float = 0.0
    compile_us: float = 0.0
    host_peak_bytes: int = 0
    device_bytes_delta: int = 0
    runs: int = 0
    wall_s: float = 0.0
    cache: Dict[str, bool] = dataclasses.field(default_factory=dict)
    ts: float = 0.0
    error: Optional[str] = None
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)
    schema: int = SCHEMA_VERSION

    @classmethod
    def from_measurement(cls, scenario, m, *, wall_s: float = 0.0,
                         cache: Optional[Dict[str, bool]] = None,
                         extra: Optional[Dict[str, Any]] = None) -> "RunResult":
        return cls(name=scenario.name, bench=scenario.bench,
                   arch=scenario.arch, task=scenario.task,
                   batch=scenario.batch, seq=scenario.seq,
                   dtype=scenario.dtype, mode=scenario.mode,
                   status="ok", median_us=m.median_us, mean_us=m.mean_us,
                   p10_us=m.p10_us, p90_us=m.p90_us, compile_us=m.compile_us,
                   host_peak_bytes=m.host_peak_bytes,
                   device_bytes_delta=m.device_bytes_delta, runs=m.runs,
                   wall_s=wall_s, cache=dict(cache or {}),
                   ts=time.time(), extra=dict(extra or {}))

    @classmethod
    def from_error(cls, scenario, error: str, *, wall_s: float = 0.0) -> "RunResult":
        return cls(name=scenario.name, bench=scenario.bench,
                   arch=scenario.arch, task=scenario.task,
                   batch=scenario.batch, seq=scenario.seq,
                   dtype=scenario.dtype, mode=scenario.mode,
                   status="error", error=error, wall_s=wall_s, ts=time.time())

    def metrics(self) -> Dict[str, float]:
        """The regression-CI metric view of this record."""
        return {"median_us": self.median_us,
                "host_peak_bytes": float(self.host_peak_bytes),
                "device_bytes_delta": float(self.device_bytes_delta)}

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "RunResult":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


class ResultStore:
    """JSONL run log + latest-pointer map, atomic on update and safe for
    concurrent appenders (threads in one process AND separate processes)."""

    def __init__(self, path: str):
        if path.endswith(".json"):
            self.latest_path = path
            self.log_path = path[: -len(".json")] + ".jsonl"
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        else:
            os.makedirs(path, exist_ok=True)
            self.latest_path = os.path.join(path, "latest.json")
            self.log_path = os.path.join(path, "runs.jsonl")
        self.lock_path = self.latest_path + ".lock"
        #: torn/corrupt log lines skipped by the last ``history()`` replay
        self.corrupt_lines = 0
        self._tlock = threading.Lock()
        self.latest: Dict[str, dict] = {}
        if os.path.exists(self.latest_path):
            with open(self.latest_path) as f:
                self.latest = json.load(f)

    def append(self, record, *, advance_latest: bool = True) -> dict:
        """Append one record (RunResult or plain dict with a "name" key) to
        the log and move the latest pointer; returns the stored dict.

        ``advance_latest=False`` appends to the history log only — for
        time-series points (``MetricStore.log_result``) that must not
        shadow the latest-pointer view other readers key baselines on."""
        rec = record.to_dict() if hasattr(record, "to_dict") else dict(record)
        rec.setdefault("schema", SCHEMA_VERSION)
        rec.setdefault("ts", time.time())
        # one O_APPEND write syscall per record: concurrent appenders never
        # interleave bytes within a line
        line = (json.dumps(rec) + "\n").encode()
        fd = os.open(self.log_path, os.O_WRONLY | os.O_CREAT | os.O_APPEND,
                     0o644)
        try:
            os.write(fd, line)
        finally:
            os.close(fd)
        if advance_latest:
            self._advance_latest(rec)
        return rec

    def _advance_latest(self, rec: dict) -> None:
        """Move the latest pointer under an exclusive lock, merging with
        whatever other writers put on disk since we last read it."""
        with self._tlock:
            lock_fd = os.open(self.lock_path,
                              os.O_WRONLY | os.O_CREAT, 0o644)
            try:
                if fcntl is not None:
                    fcntl.flock(lock_fd, fcntl.LOCK_EX)
                disk: Dict[str, dict] = {}
                if os.path.exists(self.latest_path):
                    try:
                        with open(self.latest_path) as f:
                            disk = json.load(f)
                    except ValueError:
                        disk = {}
                merged = {**self.latest, **disk}
                merged[rec["name"]] = rec
                self.latest = merged
                tmp = f"{self.latest_path}.{os.getpid()}.tmp"
                with open(tmp, "w") as f:
                    json.dump(merged, f, indent=1)
                os.replace(tmp, self.latest_path)
            finally:
                os.close(lock_fd)

    def latest_result(self, name: str) -> Optional[RunResult]:
        rec = self.latest.get(name)
        return None if rec is None else RunResult.from_dict(rec)

    def history(self, name: Optional[str] = None) -> Iterator[dict]:
        """Replay the append log (optionally filtered to one scenario).

        Torn/truncated lines — a writer killed mid-append, a partial tail
        from a crash — are skipped, not fatal; ``self.corrupt_lines`` holds
        the count from the latest replay."""
        self.corrupt_lines = 0
        if not os.path.exists(self.log_path):
            return
        with open(self.log_path, errors="replace") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    self.corrupt_lines += 1
                    continue
                if not isinstance(rec, dict):
                    self.corrupt_lines += 1
                    continue
                if name is None or rec.get("name") == name:
                    yield rec

    def results(self) -> List[RunResult]:
        """All latest records that parse as RunResults, sorted by name."""
        return [RunResult.from_dict(r) for _, r in sorted(self.latest.items())
                if isinstance(r, dict) and "arch" in r]
