"""Low-overhead distributed span tracing for the benchmark runner (a copy
of ``repro.telemetry.spans``, which imports no JAX).  The port's pool and
coordinator take a ``Tracer``; the runner refuses ``tracer=`` and has no
span sites until span tracing is ported (ROADMAP Queue 1, item 12).

One trace covers one ``run_matrix`` call regardless of transport.  The
span hierarchy is::

    matrix                          (coordinator lane)
      group:<build-key>             (one per build-key group)
        cell:<scenario>             (serial) or
        dispatch:<scenario>         (pool / cluster dispatch slot)
          cell:<scenario>           (worker lane, stitched by trace ctx)
            build / compile / warm / measure / attribute   (phases)
              admit_wave / decode_step                     (serve only)

Design constraints:

- **Cheap when off.**  ``Tracer(enabled=False)`` (the module singleton
  ``NULL_TRACER``) makes ``span()`` yield a shared no-op object without
  allocating; instrumented code never branches on anything else.
- **Thread-safe.**  The shard pool drives one thread per worker; spans
  append under a lock and the implicit parent stack is thread-local.
- **Wire-friendly.**  A span context is two strings
  (``{"trace_id", "parent"}``) carried by the JSONL job protocol; a
  worker builds a private ``Tracer`` seeded with them, runs the cell,
  and ships ``export()`` back in the result message.  The dispatcher
  ``ingest()``s those dicts under the worker's lane so the stitched
  timeline nests worker cells beneath their coordinator dispatch span.

Timestamps are wall-clock (``time.time()``) so same-host processes
share a base; durations come from paired wall reads, which is plenty at
the >=microsecond scale of benchmark phases.
"""
from __future__ import annotations

import collections
import itertools
import json
import os
import sys
import threading
import time
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple, Union

__all__ = [
    "Span",
    "Tracer",
    "NULL_TRACER",
    "group_label",
    "warn",
    "recent_warnings",
]


def _new_prefix() -> str:
    # unique across processes (pid) and across Tracer instances within a
    # process (urandom); span ids are then "<prefix>.<counter>"
    return f"{os.getpid():x}-{os.urandom(3).hex()}"


def group_label(build_key: Tuple) -> str:
    """Human-readable label for a ``Scenario.build_key()`` tuple."""
    return "/".join(str(p) for p in build_key if p not in (None, False, ""))


class Span:
    """One timed region.  Mutable until :meth:`Tracer.finish` seals it."""

    __slots__ = ("name", "span_id", "parent_id", "kind", "proc", "tid",
                 "ts", "dur_s", "attrs", "_t0")

    def __init__(self, name: str, span_id: str, parent_id: Optional[str],
                 kind: str, proc: str, tid: int, ts: float,
                 attrs: Optional[Dict[str, Any]] = None):
        self.name = name
        self.span_id = span_id
        self.parent_id = parent_id
        self.kind = kind
        self.proc = proc
        self.tid = tid
        self.ts = ts              # wall-clock start (time.time())
        self.dur_s = 0.0
        self.attrs = attrs or {}
        self._t0 = 0.0            # perf_counter at start, 0 when retroactive

    def set(self, **attrs: Any) -> "Span":
        self.attrs.update(attrs)
        return self

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {
            "name": self.name,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "kind": self.kind,
            "proc": self.proc,
            "tid": self.tid,
            "ts": self.ts,
            "dur_s": self.dur_s,
        }
        if self.attrs:
            d["attrs"] = self.attrs
        return d


class _NoopSpan:
    """Shared do-nothing span handed out by disabled tracers."""

    __slots__ = ()
    name = ""
    span_id = ""
    parent_id = None
    kind = ""
    proc = ""
    tid = 0
    ts = 0.0
    dur_s = 0.0
    attrs: Dict[str, Any] = {}

    def set(self, **attrs: Any) -> "_NoopSpan":
        return self

    def to_dict(self) -> Dict[str, Any]:
        return {}


_NOOP = _NoopSpan()


class _SpanCtx:
    """Context manager returned by :meth:`Tracer.span` (one allocation,
    reused for the with-statement protocol only)."""

    __slots__ = ("_tracer", "_span")

    def __init__(self, tracer: "Tracer", span: Union[Span, _NoopSpan]):
        self._tracer = tracer
        self._span = span

    def __enter__(self) -> Union[Span, _NoopSpan]:
        return self._span

    def __exit__(self, exc_type, exc, tb) -> None:
        if self._span is not _NOOP:
            if exc is not None:
                self._span.set(error=f"{exc_type.__name__}: {exc}"[:200])
            self._tracer.finish(self._span)


class Tracer:
    """Collects spans for one process's view of a trace.

    ``enabled=False`` turns every entry point into a near-free no-op so
    the instrumented hot path costs one attribute load + branch.
    """

    def __init__(self, *, enabled: bool = True, trace_id: Optional[str] = None,
                 proc: str = "coordinator", root_parent: Optional[str] = None):
        self.enabled = enabled
        self.proc = proc
        self.trace_id = trace_id or _new_prefix()
        self.root_parent = root_parent   # default parent when stack empty
        self._prefix = _new_prefix()
        self._counter = itertools.count(1)
        self._lock = threading.Lock()
        self._spans: List[Span] = []
        self._by_id: Dict[str, Span] = {}
        self._tls = threading.local()

    # -- trace lifecycle ------------------------------------------------

    def begin_trace(self) -> str:
        """Start a fresh trace id (one per ``run_matrix`` call).

        Spans already collected are kept — a multi-matrix session
        exports them all in one file, each tree under its own root.
        """
        self.trace_id = _new_prefix()
        return self.trace_id

    # -- span creation --------------------------------------------------

    def _stack(self) -> List[Span]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def _next_id(self) -> str:
        return f"{self._prefix}.{next(self._counter)}"

    def start(self, name: str, *, kind: str = "span",
              parent: Union[Span, str, None] = None,
              **attrs: Any) -> Union[Span, _NoopSpan]:
        """Open a span without touching the implicit stack (for async
        open/close across callbacks, e.g. coordinator dispatch slots)."""
        if not self.enabled:
            return _NOOP
        pid = self._resolve_parent(parent)
        sp = Span(name, self._next_id(), pid, kind, self.proc,
                  threading.get_ident(), time.time(), attrs or None)
        sp._t0 = time.perf_counter()
        return sp

    def finish(self, span: Union[Span, _NoopSpan],
               end_ts: Optional[float] = None) -> None:
        if span is _NOOP or not isinstance(span, Span):
            return
        if end_ts is not None:
            span.dur_s = max(0.0, end_ts - span.ts)
        elif span._t0:
            span.dur_s = time.perf_counter() - span._t0
        else:
            span.dur_s = max(0.0, time.time() - span.ts)
        self._record(span)
        st = self._stack()
        if st and st[-1] is span:
            st.pop()

    def span(self, name: str, *, kind: str = "span",
             parent: Union[Span, str, None] = None, **attrs: Any) -> _SpanCtx:
        """Context manager: open on enter, seal on exit.  Nested calls on
        the same thread parent to the enclosing span automatically."""
        if not self.enabled:
            return _SpanCtx(self, _NOOP)
        sp = self.start(name, kind=kind, parent=parent, **attrs)
        self._stack().append(sp)          # type: ignore[arg-type]
        return _SpanCtx(self, sp)

    def add(self, name: str, *, ts: float, dur_s: float,
            parent: Union[Span, str, None] = None, kind: str = "phase",
            tid: Optional[int] = None, **attrs: Any) -> Union[Span, _NoopSpan]:
        """Record a span retroactively from captured wall timestamps
        (phase events logged by the harness / serve engine)."""
        if not self.enabled:
            return _NOOP
        pid = self._resolve_parent(parent)
        ptid = tid
        if ptid is None:
            psp = self._by_id.get(pid) if pid else None
            ptid = psp.tid if psp is not None else threading.get_ident()
        sp = Span(name, self._next_id(), pid, kind, self.proc, ptid, ts,
                  attrs or None)
        sp.dur_s = max(0.0, dur_s)
        self._record(sp)
        return sp

    def _resolve_parent(self, parent: Union[Span, str, None]) -> Optional[str]:
        if parent is not None:
            if isinstance(parent, str):
                return parent
            return getattr(parent, "span_id", None) or None
        st = self._stack()
        if st:
            return st[-1].span_id
        return self.root_parent

    def _record(self, span: Span) -> None:
        with self._lock:
            self._spans.append(span)
            self._by_id[span.span_id] = span

    # -- stitching ------------------------------------------------------

    def context(self, span: Union[Span, _NoopSpan, None] = None
                ) -> Optional[Dict[str, str]]:
        """Wire context for a job message: ``{"trace_id", "parent"}``."""
        if not self.enabled:
            return None
        parent = getattr(span, "span_id", "") if span is not None else ""
        return {"trace_id": self.trace_id, "parent": parent or ""}

    def ingest(self, span_dicts: Optional[Iterable[Dict[str, Any]]],
               proc: Optional[str] = None) -> int:
        """Adopt spans exported by a remote process, relabelling their
        lane to *proc* (the dispatcher knows the worker's identity)."""
        if not self.enabled or not span_dicts:
            return 0
        n = 0
        for d in span_dicts:
            if not isinstance(d, dict) or "span_id" not in d:
                continue
            sp = Span(str(d.get("name", "?")), str(d["span_id"]),
                      d.get("parent_id") or None, str(d.get("kind", "span")),
                      proc or str(d.get("proc", "remote")),
                      int(d.get("tid", 0)), float(d.get("ts", 0.0)),
                      dict(d.get("attrs") or {}))
            sp.dur_s = float(d.get("dur_s", 0.0))
            self._record(sp)
            n += 1
        return n

    def group(self, name: str, child_ids: Sequence[str], *,
              parent: Union[Span, str, None] = None,
              **attrs: Any) -> Union[Span, _NoopSpan]:
        """Synthesize a span covering *child_ids* and re-parent them to
        it (serial cells interleave across build keys, so group spans
        are stitched after the fact)."""
        if not self.enabled:
            return _NOOP
        with self._lock:
            kids = [self._by_id[c] for c in child_ids if c in self._by_id]
        if not kids:
            return _NOOP
        t0 = min(k.ts for k in kids)
        t1 = max(k.ts + k.dur_s for k in kids)
        sp = self.add(name, ts=t0, dur_s=t1 - t0, parent=parent,
                      kind="group", cells=len(kids), **attrs)
        for k in kids:
            k.parent_id = sp.span_id
        return sp

    # -- export ---------------------------------------------------------

    def export(self) -> List[Dict[str, Any]]:
        with self._lock:
            spans = sorted(self._spans, key=lambda s: s.ts)
        return [s.to_dict() for s in spans]

    def find(self, span_id: str) -> Optional[Span]:
        return self._by_id.get(span_id)

    @property
    def spans(self) -> List[Span]:
        with self._lock:
            return list(self._spans)

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self._by_id.clear()


NULL_TRACER = Tracer(enabled=False)


# -- structured warnings ------------------------------------------------

_RECENT_WARNINGS: "collections.deque[Dict[str, Any]]" = collections.deque(
    maxlen=64)


def warn(event: str, **fields: Any) -> Dict[str, Any]:
    """Emit a structured warning: one JSON line on stderr, retained in a
    small ring for tests/introspection.  Returns the payload."""
    payload = {"telemetry": "warn", "event": event, "ts": time.time(),
               **fields}
    _RECENT_WARNINGS.append(payload)
    try:
        print("[telemetry] " + json.dumps(payload, sort_keys=True,
                                          default=str), file=sys.stderr)
    except Exception:
        pass
    return payload


def recent_warnings(event: Optional[str] = None) -> List[Dict[str, Any]]:
    """Warnings emitted by this process, newest last."""
    return [w for w in _RECENT_WARNINGS
            if event is None or w.get("event") == event]
