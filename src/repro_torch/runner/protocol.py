"""The JSONL job/result protocol shared by every worker transport (a copy
of ``repro.runner.protocol``, which imports no JAX, plus one field: a
result's ``exiting``).

One wire format, two transports:

* **pipe** — ``repro_torch.runner.pool`` talks to ``worker --serve``
  subprocesses over their stdin/stdout pipes (single-host sharded
  dispatch);
* **socket** — ``repro_torch.runner.cluster`` talks to ``worker --connect``
  processes over TCP (multi-host dispatch), same messages plus a
  registration/heartbeat layer.

Every message is one JSON object per ``\\n``-terminated line.  Kinds
(``msg["op"]``):

    run       dispatcher -> worker   {"op": "run", "scenario": {...},
                                      "runs": R?, "warmup": W?,
                                      "profile": bool, "hook": {...}?,
                                      "cell": i?, "trace": {...}?,
                                      "extra": {...}?}
                                     ``trace`` is a span context
                                     ({"trace_id", "parent"}) — the
                                     reference's worker traces the cell
                                     under that parent span and ships
                                     its spans back with the result; the
                                     port's runner has no span sites yet
                                     (ROADMAP item 12), so its worker
                                     sends none;
                                     ``extra`` is merged into the
                                     result's extras by the worker
                                     (dispatch-side annotations, e.g.
                                     ``slots_fallback``).
    result    worker -> dispatcher   {"op": "result", "result": <RunResult>,
                                      "stats": <RunnerStats>,
                                      "metrics": {...}?, "cell": i?,
                                      "spans": [...]?, "exiting": true?}
                                     ``stats`` is the worker's CUMULATIVE
                                     counter snapshot (the dispatcher
                                     delta-merges, see ``stats_delta``);
                                     ``metrics`` is the worker's metrics
                                     registry as flat cumulative counters
                                     (``repro_torch.fleet.metrics
                                     .counters_cumulative``), delta-merged
                                     by the dispatcher with the same
                                     ``stats_delta`` arithmetic into its
                                     own registry; ``cell`` echoes the
                                     job's id so a pipelined dispatcher
                                     can match results to cells; ``spans``
                                     (only when the job carried ``trace``)
                                     is the worker-side span export for
                                     the dispatcher to stitch into its
                                     trace; ``exiting`` (port only) says
                                     the cell failed with a CUDA error
                                     and the worker exits after this
                                     reply, so the dispatcher sends it
                                     nothing more (the pool respawns it,
                                     the coordinator requeues the rest of
                                     its group).
    register  worker -> dispatcher   {"op": "register", "host": str,
                                      "capacity": int}   (socket only:
                                     first message after connecting)
    ping      worker -> dispatcher   {"op": "ping"}      (socket only:
                                     heartbeat while a cell runs, so the
                                     coordinator can tell a long compile
                                     from a dead host)
    shutdown  dispatcher -> worker   {"op": "shutdown"}  (socket only;
                                     pipe workers exit on stdin EOF)

``Channel`` is the shared endpoint: line-buffered JSONL over either a
(read fd, write callable) pipe pair or a connected socket, with blocking
``recv`` (timeout-aware) for the sequential pool/worker loops and
non-blocking ``pump`` for the coordinator's select loop.  Sends are
locked, so a worker's heartbeat thread can share the channel with its
job loop.
"""
from __future__ import annotations

import json
import os
import select
import socket
import threading
import time
from typing import Callable, Dict, List, Optional

#: bytes read per syscall when draining a channel
_CHUNK = 1 << 16


def encode(msg: dict) -> bytes:
    """One protocol line (the only framing: ``\\n``-terminated JSON)."""
    return (json.dumps(msg) + "\n").encode()


class LineBuffer:
    """Accumulate raw bytes, yield complete JSON messages."""

    def __init__(self):
        self._buf = b""

    def feed(self, chunk: bytes) -> List[dict]:
        """Parsed messages completed by ``chunk`` (in arrival order).
        Raises ``ValueError`` on a line that is not a JSON object — a
        corrupt transport, not a protocol message."""
        self._buf += chunk
        out: List[dict] = []
        while b"\n" in self._buf:
            line, self._buf = self._buf.split(b"\n", 1)
            if not line.strip():
                continue
            msg = json.loads(line)
            if not isinstance(msg, dict):
                raise ValueError(f"protocol line is not an object: {msg!r}")
            out.append(msg)
        return out


class Channel:
    """One protocol endpoint over a pipe pair or a socket.

    ``eof`` turns True once the peer closes its write side; ``recv``
    returns ``None`` on both timeout and EOF (check ``eof`` to tell them
    apart — the pool treats both as a dead worker, the coordinator
    requeues work only on real EOF/heartbeat loss)."""

    def __init__(self, read_fd: int, write: Callable[[bytes], None], *,
                 sock: Optional[socket.socket] = None):
        self._read_fd = read_fd
        self._write = write
        self._sock = sock
        self._lines = LineBuffer()
        self._pending: List[dict] = []
        self._send_lock = threading.Lock()
        self.eof = False

    @classmethod
    def over_pipes(cls, stdout, stdin) -> "Channel":
        """A subprocess endpoint: read its stdout pipe, write its stdin."""
        def write(data: bytes) -> None:
            stdin.write(data)
            stdin.flush()
        return cls(stdout.fileno(), write)

    @classmethod
    def over_socket(cls, sock: socket.socket) -> "Channel":
        return cls(sock.fileno(), sock.sendall, sock=sock)

    def fileno(self) -> int:
        return self._read_fd

    def send(self, msg: dict) -> None:
        with self._send_lock:
            self._write(encode(msg))

    def pump(self) -> List[dict]:
        """Non-blocking drain: one read syscall, return the messages it
        completed (possibly none).  Call when select() reports the fd
        readable; sets ``eof`` instead of raising when the peer closed."""
        if self.eof:
            return []
        try:
            chunk = os.read(self._read_fd, _CHUNK)
        except OSError:
            chunk = b""
        if not chunk:
            self.eof = True
            return []
        return self._lines.feed(chunk)

    def recv(self, timeout: float) -> Optional[dict]:
        """Blocking: the next message, or None on timeout/EOF."""
        deadline = time.monotonic() + timeout
        while not self._pending:
            if self.eof:
                return None
            left = deadline - time.monotonic()
            if left <= 0:
                return None
            ready, _, _ = select.select([self._read_fd], [], [],
                                        min(left, 1.0))
            if ready:
                self._pending.extend(self.pump())
        return self._pending.pop(0)

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
        self.eof = True


# ---- message construction shared by the dispatchers -----------------------

def job_message(scenario, *, runs: Optional[int], warmup: Optional[int],
                profile: bool, hook=None,
                cell: Optional[int] = None,
                trace: Optional[dict] = None,
                extra: Optional[dict] = None) -> dict:
    """One ``run`` job.  Regression hooks cross the process/host boundary
    as their plain parameters (``slowdown_s``/``leak_bytes``); custom
    ``RegressionHook`` subclasses with dispatcher-process behaviour
    cannot.  ``trace`` is the dispatcher's span context (see module
    docstring); ``extra`` rides to the worker and is merged into the
    result's extras before it is measured/recorded."""
    msg: Dict = {"op": "run", "scenario": scenario.to_dict(),
                 "runs": runs, "warmup": warmup, "profile": profile}
    if hook is not None:
        msg["hook"] = {"slowdown_s": getattr(hook, "slowdown_s", 0.0),
                       "leak_bytes": getattr(hook, "leak_bytes", 0)}
    if cell is not None:
        msg["cell"] = cell
    if trace is not None:
        msg["trace"] = trace
    if extra:
        msg["extra"] = extra
    return msg


def stats_delta(cumulative: Optional[dict],
                seen: Dict[str, int]) -> Dict[str, int]:
    """The new work since the last result from this worker.  Workers ship
    their CUMULATIVE ``RunnerStats`` with every result (no window where a
    completed cell's builds are lost to a dying worker); the dispatcher
    keeps the last snapshot per worker *process* and merges only the
    difference.  Mutates ``seen`` to the new snapshot."""
    if not cumulative:
        return {}
    delta = {k: max(0, v - seen.get(k, 0)) for k, v in cumulative.items()}
    seen.clear()
    seen.update(cumulative)
    return delta
