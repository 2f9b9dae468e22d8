"""Cluster dispatch strategy glue for ``BenchmarkRunner.run_matrix`` (port
of ``repro.runner.cluster.scheduler``).

``ClusterScheduler`` mirrors the ``ShardScheduler`` interface (``run`` /
``close``) so the runner can treat cluster dispatch exactly like the
single-host pool, and owns the two deployment shapes behind one spec
string:

    "local:N"      bind a coordinator to an ephemeral localhost port and
                   spawn N ``worker --connect`` subprocesses against it —
                   the whole subsystem on one machine, used by the tests
                   and ``chip_smoke.py``;
    "HOST:PORT"    bind the coordinator to that address and wait for
                   externally-launched workers (other hosts running
                   ``python -m repro_torch.runner.worker --connect
                   HOST:PORT --device D``)
                   to register.

Local workers run on the runner's device and take the pool's
measurement-fence flock (``pool.measure_lock_path``: one per device of the
host, so ``local:N`` and pool workers sharing a card fence against each
other); remote workers fence only against themselves, since hosts share
no card.  Local worker
stdout+stderr go to per-worker log files that are removed on ``close()``.
"""
from __future__ import annotations

import os
import subprocess
import sys
import tempfile
from typing import Callable, List, Optional, Sequence, Tuple

from repro_torch.runner.cluster.coordinator import Coordinator
from repro_torch.runner.pool import _subprocess_env, measure_lock_path
from repro_torch.runner.results import RunResult
from repro_torch.runner.scenario import Scenario


def parse_cluster_spec(spec: str) -> Tuple[str, str]:
    """``("local", "N")`` or ``("bind", "HOST:PORT")``; raises ValueError
    on anything else (including a bare hostname with no port)."""
    spec = (spec or "").strip()
    kind, _, rest = spec.partition(":")
    if kind == "local":
        if not rest.isdigit() or int(rest) < 1:
            raise ValueError(f"cluster spec {spec!r}: local:N needs N >= 1")
        return "local", rest
    if _ and rest.isdigit():
        return "bind", spec
    raise ValueError(f"cluster spec {spec!r}: expected 'local:N' or "
                     f"'HOST:PORT'")


class ClusterScheduler:
    """Dispatch scenario batches across socket-connected cluster workers."""

    def __init__(self, spec: str, *, runs: int = 5, warmup: int = 1,
                 compile_warmup: int = 3, reuse: bool = True,
                 measure_fence: bool = True, device: str = "cuda",
                 matmul_precision: str = "",
                 timeout: float = 1200.0,
                 heartbeat_timeout: float = 30.0,
                 connect_timeout: float = 120.0, capacity: int = 1):
        self.spec = spec
        kind, val = parse_cluster_spec(spec)
        bind = "127.0.0.1:0" if kind == "local" else val
        self.coordinator = Coordinator(bind=bind, timeout=timeout,
                                       heartbeat_timeout=heartbeat_timeout,
                                       connect_timeout=connect_timeout,
                                       device=device)
        self.procs: List[subprocess.Popen] = []
        self._log_paths: List[str] = []
        self._base_argv: List[str] = []
        self._env: dict = {}
        self.measure_lock_path = ""
        if kind == "local":
            argv = [sys.executable, "-m", "repro_torch.runner.worker",
                    "--connect", self.coordinator.address,
                    "--runs", str(runs), "--warmup", str(warmup),
                    "--compile-warmup", str(compile_warmup),
                    "--device", device]
            if matmul_precision:
                argv += ["--matmul-precision", matmul_precision]
            if capacity > 1:
                # pipelined dispatch: the worker advertises capacity K at
                # register time, so the coordinator keeps K cells of its
                # group in flight
                argv += ["--capacity", str(capacity)]
            if not reuse:
                argv.append("--no-reuse")
            if measure_fence and reuse:
                # same-host workers: the pool's flock fence
                self.measure_lock_path = measure_lock_path(device)
                argv += ["--measure-lock", self.measure_lock_path]
            self._base_argv = argv
            self._env = _subprocess_env()
            for i in range(int(val)):
                proc, log = self._spawn(i)
                self.procs.append(proc)
                self._log_paths.append(log)

    def _spawn(self, i: int):
        fd, log = tempfile.mkstemp(suffix=".log", prefix=f"repro_torch_cluster{i}_")
        proc = subprocess.Popen(self._base_argv + ["--host", f"local{i}"],
                                env=self._env, stdin=subprocess.DEVNULL,
                                stdout=fd, stderr=subprocess.STDOUT)
        os.close(fd)
        return proc, log

    def _respawn_dead(self) -> None:
        """Replace local workers that died (crashy cell took the process)
        before dispatching a new batch — the cluster analogue of the pipe
        pool's per-cell respawn, at run granularity.  A fleet that dies
        ENTIRELY mid-run still drains to error records after the
        coordinator's connect_timeout; the replacements catch the next
        ``run()`` call (nightly-CI persistence, not mid-run rescue)."""
        for i, proc in enumerate(self.procs):
            if proc.poll() is None:
                continue
            old_log = self._log_paths[i]
            if old_log and os.path.exists(old_log):
                try:
                    os.remove(old_log)
                except OSError:
                    pass
            self.procs[i], self._log_paths[i] = self._spawn(i)

    @property
    def address(self) -> str:
        return self.coordinator.address

    def worker_pids(self) -> List[int]:
        """PIDs of the locally-spawned workers (empty for bind mode) —
        the smoke gate's no-orphans check reads these before close()."""
        return [p.pid for p in self.procs]

    # ---- lifecycle -------------------------------------------------------

    def close(self) -> None:
        # shutdown messages first (clean worker exits), then reap hard
        self.coordinator.close()
        for proc in self.procs:
            try:
                proc.wait(5)
            except subprocess.TimeoutExpired:
                proc.terminate()
                try:
                    proc.wait(5)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()
        self.procs = []
        for path in self._log_paths:
            if path and os.path.exists(path):
                try:
                    os.remove(path)
                except OSError:
                    pass
        self._log_paths = []
        self.measure_lock_path = ""

    def __enter__(self) -> "ClusterScheduler":
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
            tracer=None, trace_parent=None, extras=None):
        """Dispatch one batch through the coordinator; returns
        ``(results_in_input_order, run_stats)`` — same contract as
        ``ShardScheduler.run`` (including the tracer/extras stitching
        knobs), with ``extra["host"]`` instead of ``extra["shard"]`` on
        every record."""
        if self.procs:
            self._respawn_dead()
        return self.coordinator.run(scenarios, hooks=hooks, runs=runs,
                                    warmup=warmup, profile=profile,
                                    on_result=on_result, tracer=tracer,
                                    trace_parent=trace_parent,
                                    extras=extras)
