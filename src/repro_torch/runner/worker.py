"""Subprocess worker for isolated scenario execution (port of
``repro.runner.worker``).

Three modes, one cell-execution path (``_run_cell``), every one on the
device ``--device`` names (default ``cuda``; the dispatchers forward
their runner's device, and a worker never moves to the CPU on its own):

Single-shot mode (``BenchmarkRunner(isolate=True)``):

    python -m repro_torch.runner.worker --scenario '{"arch": "gemma-2b", ...}' \\
        --runs 3 --warmup 1 --compile-warmup 3 --device cuda --json out.json \\
        [--no-reuse] [--profile] [--slowdown-s S --leak-bytes N]

Runs ONE scenario in this interpreter via an in-process BenchmarkRunner and
writes ``{"result": <RunResult>, "stats": <RunnerStats>}`` JSON to
``--json``.  The parent treats a crash or timeout of this process as an
error record: fault containment per cell.

Pool mode (``--serve``; the ``run_matrix(..., jobs=N)`` sharded dispatch,
see ``runner/pool.py``): JSONL jobs on stdin, one reply per job on the
original stdout (fd 1 is pointed at stderr first, so stray prints never
corrupt the protocol), exiting 0 on stdin EOF.

Cluster mode (``--connect HOST:PORT``; the ``run_matrix(...,
cluster=...)`` dispatch, see ``runner/cluster/``): the same loop over a
TCP socket.  It registers first (``--host`` id, ``--capacity``), before
the runner is built (CUDA initialisation and loading the kernel
libraries, whose first build is tens of seconds of ``nvcc``), and
heartbeats from a side thread, so the coordinator can tell a long build
from a dead host.

``--serve`` serves the *pool protocol*; ``Scenario(task="serve")`` is the
serving *workload* (``launch/serve.py``).  Either transport runs cells of
any task.

``--measure-lock PATH`` enables the *measurement fence* (one flock per
device of the host, ``pool.measure_lock_path``): each cell does a warm
pass (build, first calls, threading), then its timed loop under an
exclusive flock on PATH.  On the CPU the warm pass runs unfenced and
overlaps other workers, as in the reference.  On a card it runs under the
flock as well: the warm pass launches the cell's kernels and library
calls on the card another worker may be timing on, and without MPS the
card time-slices between processes, so every launch of a cell is fenced.
The fenced re-measure reports the warm pass's compile_us/cache provenance
and counts as ONE logical execution in ``RunnerStats``.  Requires the
cache (ignored under ``--no-reuse``).

**A CUDA error ends the worker.**  After an illegal address or a
device-side assert, every later CUDA call of the process fails.  So when
a cell fails with a CUDA error (its error text names one, or the card
reports one when probed), the pool and cluster worker first send that
cell's error record, marked ``exiting``, and then exit with code 3: the
pool respawns it for the rest of its group, the coordinator requeues the
rest.  Any other failure stays an error record in a live worker.  The
single-shot worker ends after its one cell anyway and writes its record.

The regression-hook parameters are plain numbers so injected-fault runs
can be isolated, sharded and clustered too.

**Each worker compiles its own cells.**  A job carries a scenario, never
a compiled step: the worker's runner compiles a ``jit*`` cell in this
process (``harness.compile_step``), and its Dynamo cache lives and dies
with it.  A graph another process compiled loads from Inductor's disk
cache: the dispatcher gives each worker the cache folders
(``harness.compile_env``) and, in its arguments, its float32 matmul
precision, which the cache key holds (``--matmul-precision``).
A cell's record carries its process's ``compile_budget``.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
import sys
import threading

try:
    import fcntl
except ImportError:          # non-POSIX: fence degrades to unfenced runs
    fcntl = None  # type: ignore[assignment]

#: the exit code of a worker that leaves after a CUDA error
CUDA_FAULT_EXIT = 3

# torch's "CUDA error: ..." and "CUDA out of memory", the port's kernels'
# "launch failed: CUDA error N", cuBLAS's status codes
_CUDA_FAULT = re.compile(r"CUDA error|CUDA out of memory|CUBLAS_STATUS_|cudaError")


@contextlib.contextmanager
def _file_lock(path):
    if not path or fcntl is None:
        yield
        return
    fd = os.open(path, os.O_WRONLY | os.O_CREAT, 0o644)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX)
        yield
    finally:
        os.close(fd)


def _load_kernels() -> None:
    """Build (once per source hash, into the checkout's ``build/``) and
    load every kernel library before the first cell, outside the fence:
    a first build is tens of seconds of ``nvcc`` that need not hold the
    card's lock.  Concurrent builds by two workers are safe
    (``kernels/build.py`` replaces the library atomically)."""
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.rglru import kernel as rk
    from repro_torch.kernels.ssd import kernel as sk
    for load in (fa.library, fa.bwd_library, sk.library, rk.library):
        load()


def _build_runner(args):
    import torch
    from repro_torch.runner.runner import BenchmarkRunner
    if args.matmul_precision:
        torch.backends.cuda.matmul.fp32_precision = args.matmul_precision
    runner = BenchmarkRunner(runs=args.runs, warmup=args.warmup,
                             compile_warmup=args.compile_warmup,
                             reuse=args.reuse, device=args.device)
    if runner.device.type == "cuda":
        _load_kernels()
    return runner


def _hook_from(slowdown_s: float, leak_bytes: int, device):
    """The dispatcher's hook parameters as a hook that leaks on the
    worker's device."""
    if not (slowdown_s or leak_bytes):
        return None
    from repro_torch.core.harness import RegressionHook
    return RegressionHook(slowdown_s=slowdown_s, leak_bytes=leak_bytes, device=device)


def _run_cell(runner, scenario, hook, runs, warmup, lock_path,
              profile=False, extra=None):
    """One cell, with the measurement fence when a lock path is given:
    the timed loop under the exclusive lock, and on a card the warm pass
    too (on the CPU the warm pass overlaps other workers)."""
    if not (lock_path and runner.reuse):
        return runner.run(scenario, hook=hook, runs=runs, warmup=warmup,
                          record=False, profile=profile, extra=extra)
    # serve cells follow the same protocol: the warm pass replays the trace
    # once on a fresh engine, the fenced re-run replays it on the warm one;
    # a profiled warm pass pays the cost pass (cached per step or engine)
    warm_fence = _file_lock(lock_path) if runner.device.type == "cuda" \
        else contextlib.nullcontext()
    with warm_fence:
        warm = runner.run(scenario, runs=1, warmup=0, record=False,
                          profile=profile, extra=extra)
    if warm.status != "ok":
        return warm
    with _file_lock(lock_path):
        rr = runner.run(scenario, hook=hook, runs=runs, warmup=warmup,
                        record=False, profile=profile, extra=extra)
    if rr.status == "ok":
        # the fenced re-measure hit the warm pass's cache: report the
        # cell's true build/first-call provenance instead
        rr.compile_us = warm.compile_us
        rr.cache = warm.cache
    # keep the ledger at one logical execution per cell — the warm pass
    # is protocol, not workload
    runner.stats.scenarios_run -= 1
    runner.stats.executable_cache_hits -= 1
    return rr


def _cuda_fault(runner, rr) -> bool:
    """Whether a failed cell failed with a CUDA error: its text names one,
    or, on a card, the card reports one (a sticky error fails the probe)."""
    if rr.status != "error":
        return False
    if _CUDA_FAULT.search(rr.error or ""):
        return True
    if runner.device.type != "cuda":
        return False
    import torch
    try:
        torch.cuda.synchronize(runner.device)
    except Exception:  # noqa: BLE001 — any failure of the probe: the context is gone
        return True
    return False


def _handle_job(runner, msg: dict, args) -> dict:
    """One ``run`` request -> its ``result`` reply (shared by the pool and
    cluster loops).  The cumulative stats ride along with every result;
    a job's ``cell`` id is echoed back; ``exiting`` marks a CUDA error,
    after which the caller exits."""
    from repro_torch.fleet.metrics import registry as metrics_registry
    from repro_torch.runner.scenario import Scenario
    scenario = Scenario.from_dict(msg["scenario"])
    hook_params = msg.get("hook") or {}
    hook = _hook_from(hook_params.get("slowdown_s", 0.0),
                      hook_params.get("leak_bytes", 0), runner.device)
    rr = _run_cell(runner, scenario, hook, msg.get("runs"),
                   msg.get("warmup"), args.measure_lock,
                   profile=bool(msg.get("profile") or args.profile),
                   extra=msg.get("extra"))
    reply = {"op": "result", "result": rr.to_dict(),
             "stats": runner.stats.to_dict(),
             # this process's metrics registry as flat cumulative counters,
             # delta-merged by the dispatcher exactly like the stats
             "metrics": metrics_registry().counters_cumulative()}
    if "cell" in msg:
        reply["cell"] = msg["cell"]
    if _cuda_fault(runner, rr):
        reply["exiting"] = True
    return reply


def _serve_pool(args) -> int:
    """Pool mode: persistent batch loop — JSONL requests on stdin, replies
    on the original stdout; workload output is rerouted to stderr."""
    proto = os.fdopen(os.dup(sys.stdout.fileno()), "w", buffering=1)
    os.dup2(sys.stderr.fileno(), sys.stdout.fileno())

    runner = _build_runner(args)
    for line in sys.stdin:
        line = line.strip()
        if not line:
            continue
        reply = _handle_job(runner, json.loads(line), args)
        proto.write(json.dumps(reply) + "\n")
        proto.flush()
        if reply.get("exiting"):
            return CUDA_FAULT_EXIT
    return 0


def _serve_cluster(args) -> int:
    """Cluster mode: connect to the coordinator, register (host id +
    capacity), heartbeat from a side thread, and run jobs until a
    ``shutdown`` message or socket EOF."""
    import socket

    from repro_torch.runner.protocol import Channel

    host, _, port = args.connect.rpartition(":")
    sock = socket.create_connection((host or "127.0.0.1", int(port)),
                                    timeout=30)
    sock.settimeout(None)
    chan = Channel.over_socket(sock)
    host_id = args.host or f"{socket.gethostname()}-{os.getpid()}"
    # floor the ping interval: --heartbeat 0 would busy-loop the side
    # thread into flooding the coordinator
    args.heartbeat = max(0.5, args.heartbeat)
    # register BEFORE the runner is built (CUDA initialisation, the kernel
    # libraries' first build), with the heartbeat interval, so the
    # coordinator sees this worker and scales its silence bound to it
    chan.send({"op": "register", "host": host_id,
               "capacity": max(1, args.capacity),
               "heartbeat": args.heartbeat})

    stop = threading.Event()

    def _heartbeat() -> None:
        while not stop.wait(args.heartbeat):
            try:
                chan.send({"op": "ping"})
            except OSError:
                return             # coordinator gone: main loop sees EOF

    beat = threading.Thread(target=_heartbeat, name="heartbeat", daemon=True)
    beat.start()
    try:
        runner = _build_runner(args)
        while True:
            msg = chan.recv(timeout=60.0)
            if msg is None:
                if chan.eof:
                    return 0       # coordinator closed: clean exit
                continue           # idle between batches
            op = msg.get("op")
            if op == "shutdown":
                return 0
            if op != "run":
                continue
            reply = _handle_job(runner, msg, args)
            try:
                chan.send(reply)
            except OSError:
                return 0           # coordinator gone mid-reply
            if reply.get("exiting"):
                return CUDA_FAULT_EXIT
    finally:
        stop.set()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenario", help="Scenario JSON dict (single-shot mode)")
    ap.add_argument("--serve", action="store_true",
                    help="pool mode: persistent worker, JSONL requests on "
                         "stdin, replies on stdout (unrelated to the "
                         "task=\"serve\" workload)")
    ap.add_argument("--connect", default="",
                    help="cluster mode: HOST:PORT of a coordinator "
                         "(repro_torch.runner.cluster) to register with and "
                         "pull jobs from over TCP")
    ap.add_argument("--host", default="",
                    help="cluster host id reported at registration and in "
                         "extra['host'] (default: <hostname>-<pid>)")
    ap.add_argument("--capacity", type=int, default=1,
                    help="cluster mode: max in-flight cells the "
                         "coordinator may pipeline to this worker")
    ap.add_argument("--heartbeat", type=float, default=5.0,
                    help="cluster mode: seconds between liveness pings")
    ap.add_argument("--device", default="cuda",
                    help="the device every cell runs on (the dispatcher's); "
                         "a card asked for and absent fails the worker")
    ap.add_argument("--matmul-precision", default="",
                    help="float32 matmul precision "
                         "(torch.backends.cuda.matmul.fp32_precision)")
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--warmup", type=int, default=1)
    ap.add_argument("--compile-warmup", type=int, default=3,
                    help="extra warmup after a fresh build (parent's setting)")
    ap.add_argument("--no-reuse", dest="reuse", action="store_false",
                    default=True, help="disable build/step caching")
    ap.add_argument("--profile", action="store_true",
                    help="measured profiling: record extra['prof_*'] "
                         "(timeline + op-class attribution) per cell")
    ap.add_argument("--measure-lock", default="",
                    help="flock path of the measurement fence (pool/cluster "
                         "modes; fences same-host workers only)")
    ap.add_argument("--slowdown-s", type=float, default=0.0)
    ap.add_argument("--leak-bytes", type=int, default=0)
    ap.add_argument("--json", help="output path (single-shot mode)")
    args = ap.parse_args(argv)

    if args.serve and args.connect:
        ap.error("--serve (pipe pool) and --connect (cluster socket) are "
                 "mutually exclusive transports")
    if args.serve:
        return _serve_pool(args)
    if args.connect:
        return _serve_cluster(args)
    if not (args.scenario and args.json):
        ap.error("single-shot mode needs --scenario and --json "
                 "(or use --serve / --connect)")

    from repro_torch.runner.scenario import Scenario

    scenario = Scenario.from_dict(json.loads(args.scenario))
    runner = _build_runner(args)
    rr = runner.run(scenario, hook=_hook_from(args.slowdown_s, args.leak_bytes,
                                              runner.device),
                    record=False, profile=args.profile)
    with open(args.json, "w") as f:
        json.dump({"result": rr.to_dict(), "stats": runner.stats.to_dict()}, f)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
