"""The cluster coordinator: multi-host scenario dispatch over TCP (port of
``repro.runner.cluster.coordinator``).

``Coordinator`` listens on a socket and speaks the shared JSONL protocol
(``runner/protocol.py``) with ``python -m repro_torch.runner.worker
--connect HOST:PORT`` processes.  Workers register with a host id +
capacity; scenarios are scheduled as the same build-key groups the
single-host pool uses (``runner/pool.rank_groups``), but placement
is **fully dynamic**: every group sits in a central deque and an idle
worker *steals* the next one — no static assignment at all, because
across heterogeneous hosts the task-weight guesses are even less
trustworthy than across local processes.  A worker owns its stolen group
until the group is drained (its arch-build/executable caches stay hot),
receiving up to ``capacity`` pipelined cells of that group at a time.

Failure detection is heartbeat-based: a worker thread pings every few
seconds even while a cell computes, so the coordinator can tell a long
XLA compile (pings flowing, cell deadline not yet reached) from a dead
host or partitioned network (silence).  On failure — EOF, heartbeat
silence past ``heartbeat_timeout``, or an in-flight cell past the
per-cell ``timeout`` — the worker's in-flight cells become error records
and the *unsent remainder of its group goes back on the deque*, to be
re-stolen by a surviving worker; the run completes as long as one worker
survives.  If every worker is gone and none (re)connects within
``connect_timeout``, the remaining cells become error records rather
than hanging the sweep — ``run()`` never raises for cluster faults.
A worker whose cell failed with a CUDA error replies with ``exiting`` and
leaves: its result is kept, and the rest of its group goes back on the
deque at once, without waiting for the EOF.

The coordinator is persistent across ``run()`` calls (the cluster
analogue of the pool's warm workers): connections live until ``close()``,
which sends every worker a ``shutdown`` message.  Workers may connect at
any time, including mid-run — late joiners steal from whatever is left.
"""
from __future__ import annotations

import collections
import select
import socket
import time
from typing import Callable, Deque, Dict, List, Optional, Sequence, Tuple

from repro_torch.fleet.metrics import registry as metrics_registry
from repro_torch.runner.pool import rank_groups
from repro_torch.runner.protocol import Channel, job_message, stats_delta
from repro_torch.runner.results import RunResult
from repro_torch.runner.scenario import Scenario
from repro_torch.telemetry.spans import NULL_TRACER, Tracer, group_label


class _WorkerConn:
    """One connected cluster worker: its channel + scheduling state."""

    def __init__(self, chan: Channel, addr: str):
        self.chan = chan
        self.addr = addr
        self.host = ""                 # set by the register message
        self.capacity = 1
        self.registered = False
        self.silence_bound = 0.0       # heartbeat-aware, set at register
        self.last_seen = time.monotonic()
        self.connected_at = self.last_seen
        self.stats_seen: Dict[str, int] = {}
        # same delta-merge protocol for the worker's metrics registry
        # (flat cumulative counters; see repro_torch.fleet.metrics)
        self.metrics_seen: Dict[str, float] = {}
        # the group this worker currently owns (unsent cell indices) and
        # its in-flight cells (index -> dispatch time, for deadlines)
        self.group: List[int] = []
        self.inflight: Dict[int, float] = {}
        self.gspan = None              # open group span (traced runs)

    def ident(self) -> str:
        return self.host or self.addr


class Coordinator:
    """Listen for cluster workers and dispatch scenario batches to them."""

    def __init__(self, bind: str = "127.0.0.1:0", *,
                 heartbeat_timeout: float = 30.0, timeout: float = 1200.0,
                 connect_timeout: float = 120.0, device: str = "cuda"):
        host, _, port = bind.rpartition(":")
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host or "127.0.0.1", int(port or 0)))
        self._listener.listen(64)
        lhost, lport = self._listener.getsockname()[:2]
        #: what workers ``--connect`` to (the ephemeral port resolved)
        self.address = f"{lhost}:{lport}"
        self.heartbeat_timeout = heartbeat_timeout
        self.timeout = timeout
        self.connect_timeout = connect_timeout
        # the device its workers run on: stamps the records it makes itself
        self.device = device
        self._conns: List[_WorkerConn] = []
        self._closed = False
        # per-run tracing state (set by run(); defaults keep every path
        # trace-free when the caller passed no tracer)
        self._tr: Tracer = NULL_TRACER
        self._troot = None
        self._extras: Dict[str, dict] = {}
        self._dspans: Dict[int, object] = {}   # cell idx -> dispatch span

    # ---- lifecycle -------------------------------------------------------

    def workers(self) -> List[str]:
        """Host ids of the currently registered workers."""
        return [c.ident() for c in self._conns if c.registered]

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        for conn in self._conns:
            try:
                conn.chan.send({"op": "shutdown"})
            except OSError:
                pass
            conn.chan.close()
        self._conns = []
        try:
            self._listener.close()
        except OSError:
            pass

    def __enter__(self) -> "Coordinator":
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
            tracer: Optional[Tracer] = None, trace_parent=None,
            extras: Optional[Dict[str, dict]] = None):
        """Run every scenario across the connected workers; returns
        ``(results_in_input_order, run_stats)``.  Results carry
        ``extra["host"]`` (the worker's registered host id) and
        ``extra["isolated"]`` — see ``runner/results.py``.

        ``tracer``/``trace_parent`` stitch the dispatch into the caller's
        trace exactly like the pool: one ``group:`` span per stolen group
        (on the owning worker's connection), one ``dispatch:`` span per
        cell whose context rides the job so the worker's spans come back
        nested under it.  ``extras`` maps scenario name -> extra dict
        forwarded with each job."""
        from repro_torch.runner.runner import RunnerStats
        self._tr = tracer or NULL_TRACER
        self._troot = trace_parent
        self._extras = extras or {}
        self._dspans = {}
        queue: Deque[List[int]] = collections.deque(
            list(idxs) for idxs, _ in rank_groups(scenarios))
        results: List[Optional[RunResult]] = [None] * len(scenarios)
        run_stats = RunnerStats()
        ctx = (scenarios, hooks or {}, runs, warmup, profile, on_result)
        now = time.monotonic()
        for conn in self._conns:
            conn.last_seen = now       # idle between runs is not a fault
        last_alive = now
        done = [0]
        # drain everything buffered while idle between runs — dead-peer
        # EOFs, pings, registrations of workers that connected in the
        # meantime — and reap the casualties BEFORE the first feed: a
        # worker that died idle must not be handed a cell that instantly
        # becomes a spurious error record
        while self._poll(0.0, queue, ctx, results, run_stats, done):
            pass
        self._reap_failures(queue, ctx, results, run_stats, done)
        # feed the (live) workers that stayed connected from previous runs
        for conn in list(self._conns):
            self._feed(conn, queue, ctx)
        while done[0] < len(scenarios):
            self._poll(0.5, queue, ctx, results, run_stats, done)
            self._reap_failures(queue, ctx, results, run_stats, done)
            if any(c.registered for c in self._conns):
                last_alive = time.monotonic()
            elif time.monotonic() - last_alive > self.connect_timeout:
                # every worker is gone and nobody reconnected: error out
                # the remaining cells instead of hanging the sweep
                self._drain_unrunnable(queue, ctx, results, run_stats, done)
        if self._tr.enabled:
            # seal whatever is still open (groups whose tail just finished,
            # dispatch slots orphaned by an off-protocol worker)
            for conn in self._conns:
                if conn.gspan is not None:
                    self._tr.finish(conn.gspan)
                    conn.gspan = None
            for ds in self._dspans.values():
                ds.set(error="unresolved at run end")
                self._tr.finish(ds)
            self._dspans = {}
        return [r for r in results if r is not None], run_stats

    def _poll(self, wait: float, queue, ctx, results, run_stats,
              done) -> bool:
        """One select pass: accept connections, pump readable channels,
        handle their messages.  Returns whether anything was ready (the
        pre-feed drain loops on this; eof channels are excluded so the
        loop terminates — _reap_failures retires them)."""
        channels = {c.chan.fileno(): c for c in self._conns
                    if not c.chan.eof}
        ready, _, _ = select.select(
            [self._listener] + list(channels), [], [], wait)
        for r in ready:
            if r is self._listener:
                self._accept()
                continue
            conn = channels.get(r)
            if conn is None:
                continue
            try:
                msgs = conn.chan.pump()
                if msgs:
                    now = time.monotonic()
                    if conn.registered:
                        # silence since the last message from this worker —
                        # the live heartbeat-gap distribution
                        metrics_registry().observe(
                            "cluster_heartbeat_gap_seconds",
                            now - conn.last_seen)
                    conn.last_seen = now
                for msg in msgs:
                    self._handle(conn, msg, queue, ctx, results,
                                 run_stats, done)
            except Exception as e:  # noqa: BLE001 — a stray client
                # (port scan, HTTP probe) or a buggy worker sending
                # non-protocol bytes costs ITS connection, never the
                # sweep: run() must not raise for cluster faults
                if conn in self._conns:
                    self._retire(conn,
                                 f"cluster worker {conn.ident()} "
                                 f"protocol error: {e!r}",
                                 queue, ctx, results, run_stats, done)
        return bool(ready)

    # ---- connection handling ---------------------------------------------

    def _accept(self) -> None:
        try:
            sock, addr = self._listener.accept()
        except OSError:
            return
        sock.setblocking(True)
        self._conns.append(
            _WorkerConn(Channel.over_socket(sock), f"{addr[0]}:{addr[1]}"))

    def _handle(self, conn: _WorkerConn, msg: dict, queue, ctx,
                results, run_stats, done) -> None:
        op = msg.get("op")
        if op == "register":
            conn.host = str(msg.get("host") or conn.addr)
            # clamp capacity: an absurd value from a buggy/hostile client
            # would absorb the whole queue into one dead-air connection
            # (and enough unread job bytes could even block sendall); 16
            # in-flight cells is far beyond any useful pipelining depth
            conn.capacity = min(16, max(1, int(msg.get("capacity") or 1)))
            # a worker pinging slower than our default silence bound is
            # healthy, not dead: honor its declared interval with margin
            beat = float(msg.get("heartbeat") or 0.0)
            conn.silence_bound = max(self.heartbeat_timeout, 3.0 * beat)
            conn.registered = True
            self._feed(conn, queue, ctx)
        elif op == "ping":
            pass                       # last_seen already advanced
        elif op == "result":
            self._on_result(conn, msg, queue, ctx, results, run_stats, done)

    def _on_result(self, conn: _WorkerConn, msg: dict, queue, ctx,
                   results, run_stats, done) -> None:
        scenarios, _, _, _, _, on_result = ctx
        idx = msg.get("cell")
        t0 = conn.inflight.pop(idx, None) if isinstance(idx, int) else None
        if t0 is None or not (0 <= idx < len(scenarios)) \
                or results[idx] is not None:
            # a result we can't match to an in-flight cell (missing/bogus
            # id, duplicate) means the worker is off-protocol: retire it
            # NOW — silently dropping the message would leave the real
            # in-flight entry ticking toward the 1200s cell timeout
            self._retire(conn,
                         f"cluster worker {conn.ident()} sent an "
                         f"unmatched result (cell {idx!r})",
                         queue, ctx, results, run_stats, done)
            return
        rr = RunResult.from_dict(msg["result"])
        rr.wall_s = time.monotonic() - t0 if t0 else rr.wall_s
        # cells pipelined behind this one (capacity > 1) were queued, not
        # executing: their per-cell deadline starts now, at the head
        now = time.monotonic()
        for pending in conn.inflight:
            conn.inflight[pending] = now
        delta = stats_delta(msg.get("stats"), conn.stats_seen)
        if delta:
            run_stats.merge(delta)
        if msg.get("metrics"):
            metrics_registry().merge_cumulative(
                stats_delta(msg["metrics"], conn.metrics_seen))
        metrics_registry().set_gauge(
            f"cluster_inflight_{conn.ident()}", len(conn.inflight))
        ds = self._dspans.pop(idx, None)
        if ds is not None:
            self._tr.ingest(msg.get("spans"), proc=conn.ident())
            ds.set(status=rr.status)
            self._tr.finish(ds)
            rr.extra.setdefault("span_trace", self._tr.trace_id)
            rr.extra["span_dispatch"] = ds.span_id
        self._finish(conn.ident(), idx, rr, results, done, on_result)
        if msg.get("exiting"):
            # a CUDA error: the worker leaves after this reply.  Cells
            # pipelined behind this one never ran: back to its group, and
            # the group back on the deque for a survivor
            conn.group = sorted(conn.inflight) + conn.group
            conn.inflight = {}
            self._retire(conn, f"cluster worker {conn.ident()} exited after "
                               f"a CUDA error", queue, ctx, results, run_stats, done)
            return
        self._feed(conn, queue, ctx)

    def _finish(self, host: str, idx: int, rr: RunResult,
                results, done, on_result) -> None:
        from repro_torch.runner.runner import stamp
        if host:
            rr.extra["host"] = host
        rr.extra["isolated"] = True
        # backstop for records the worker never produced (retire/drain
        # errors): dispatch-side extras + coordinator provenance.  Worker
        # results arrive already annotated/stamped; setdefault keeps the
        # worker's (correct-host) values
        ex = self._extras.get(rr.name)
        if ex:
            for k, v in ex.items():
                rr.extra.setdefault(k, v)
        stamp(rr, self.device)
        results[idx] = rr
        done[0] += 1
        try:
            if on_result is not None:
                on_result(rr)
        except Exception:  # noqa: BLE001 — a failing store append must not
            pass           # kill the dispatch loop; the result is returned

    def _feed(self, conn: _WorkerConn, queue, ctx) -> None:
        """Send the worker cells of its current group up to its capacity,
        stealing the next ranked group from the deque when it runs dry."""
        scenarios, hooks, runs, warmup, profile, _ = ctx
        if not conn.registered:
            return
        while len(conn.inflight) < conn.capacity:
            if not conn.group:
                if not queue:
                    return
                conn.group = queue.popleft()    # steal the next group
                reg = metrics_registry()
                reg.inc("cluster_steals_total")
                reg.set_gauge("cluster_queue_depth", len(queue))
                if self._tr.enabled:
                    if conn.gspan is not None:
                        self._tr.finish(conn.gspan)
                    key = scenarios[conn.group[0]].build_key()
                    conn.gspan = self._tr.start(
                        "group:" + group_label(key), parent=self._troot,
                        kind="group", host=conn.ident(),
                        cells=len(conn.group))
            idx = conn.group.pop(0)
            sc = scenarios[idx]
            hook = hooks.get(sc.name) or hooks.get(sc.bench)
            ds = None
            if self._tr.enabled:
                ds = self._tr.start("dispatch:" + sc.name, kind="dispatch",
                                    parent=conn.gspan, cell=sc.name,
                                    host=conn.ident())
            try:
                conn.chan.send(job_message(sc, runs=runs, warmup=warmup,
                                           profile=profile, hook=hook,
                                           cell=idx,
                                           trace=self._tr.context(ds),
                                           extra=self._extras.get(sc.name)))
            except OSError:
                # send failed: the cell was never dispatched — put it back
                # and let _reap_failures retire the connection (the unsent
                # dispatch span is simply dropped: never recorded)
                conn.group.insert(0, idx)
                conn.chan.eof = True
                return
            if ds is not None:
                self._dspans[idx] = ds
            conn.inflight[idx] = time.monotonic()

    # ---- failure handling ------------------------------------------------

    def _reap_failures(self, queue, ctx, results, run_stats, done) -> None:
        now = time.monotonic()
        for conn in list(self._conns):
            reason = None
            if conn.chan.eof:
                reason = f"cluster worker {conn.ident()} disconnected"
            elif (conn.registered
                  and now - conn.last_seen > (conn.silence_bound
                                              or self.heartbeat_timeout)):
                reason = (f"cluster worker {conn.ident()} heartbeat lost "
                          f"({conn.silence_bound:.0f}s silence)")
            elif (not conn.registered
                  and now - conn.connected_at > self.heartbeat_timeout):
                # registration deadline from ACCEPT time, not last_seen: a
                # stray client that keeps sending valid-but-unregistered
                # JSON (pings, unknown ops) must still be reaped, or its
                # fd leaks into every select() for the coordinator's
                # whole persistent lifetime
                reason = (f"cluster worker {conn.ident()} never registered "
                          f"({self.heartbeat_timeout:.0f}s since connect)")
            elif any(now - t0 > self.timeout
                     for t0 in conn.inflight.values()):
                reason = (f"cluster worker {conn.ident()} cell timed out "
                          f"after {self.timeout:.0f}s")
            if reason:
                self._retire(conn, reason, queue, ctx, results, run_stats,
                             done)

    def _retire(self, conn: _WorkerConn, reason: str, queue, ctx,
                results, run_stats, done) -> None:
        """Dead worker: error records for its in-flight cells, its group's
        unsent remainder back on the deque for a survivor to re-steal."""
        scenarios, _, _, _, _, on_result = ctx
        self._conns.remove(conn)
        conn.chan.close()
        metrics_registry().inc("cluster_retires_total")
        now = time.monotonic()
        for idx, t0 in sorted(conn.inflight.items()):
            if results[idx] is not None:
                continue
            rr = RunResult.from_error(scenarios[idx],
                                      f"{reason} (cell in flight)",
                                      wall_s=now - t0)
            run_stats.scenarios_run += 1
            run_stats.errors += 1
            ds = self._dspans.pop(idx, None)
            if ds is not None:
                ds.set(status="error", error=reason[:200])
                self._tr.finish(ds)
                rr.extra.setdefault("span_trace", self._tr.trace_id)
                rr.extra["span_dispatch"] = ds.span_id
            self._finish(conn.ident(), idx, rr, results, done, on_result)
        conn.inflight = {}
        if conn.gspan is not None:
            self._tr.finish(conn.gspan)
            conn.gspan = None
        if conn.group:
            queue.appendleft(conn.group)        # re-stolen next
            conn.group = []
        # the freed work may be stealable right now by an idle survivor
        for other in self._conns:
            self._feed(other, queue, ctx)

    def _drain_unrunnable(self, queue, ctx, results, run_stats,
                          done) -> None:
        scenarios, _, _, _, _, on_result = ctx
        reason = (f"no cluster workers connected within "
                  f"{self.connect_timeout:.0f}s")
        pending = [idx for group in queue for idx in group]
        queue.clear()
        for idx in pending:
            if results[idx] is not None:
                continue
            run_stats.scenarios_run += 1
            run_stats.errors += 1
            self._finish("", idx, RunResult.from_error(scenarios[idx], reason),
                         results, done, on_result)
