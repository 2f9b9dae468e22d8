"""Load-generation helpers for ``task="loadgen"`` cells (port of
``repro.runner.loadgen``).

A loadgen cell replays a (shard of a) deterministic trace against the
continuous-batching serve engine at a scaled *offered load*, so a matrix
sweeping ``loads=(0.5, 1.0, 2.0, 4.0)`` measures a TTFT/p99-vs-load
curve; sweeping ``splits=("0/2", "1/2")`` across workers replays trace
shards against as many engines as the pool has workers.

Both transforms act on the generated ``Request`` list, never on the
spec: the prompt tokens stay a pure function of (trace spec, weights), so
shard digests are stable and a sharded run's union equals the unsharded
trace.

``find_knee`` post-processes a measured curve: offered load is swept up,
throughput saturates, and the knee is the last point whose marginal
throughput gain over the previous point still exceeds ``KNEE_GAIN``.

``auto_slots`` turns a persisted measured curve into a slot count, so
``ScenarioMatrix(slots=("auto",))`` picks the decode batch width from the
measured knee.  The port reads its own curve: ``CURVE_PATH`` (under the
generated ``results/``) or ``$REPRO_TORCH_LOADGEN_CURVE``, in the
reference's file layout, so that a curve the JAX package measured never
shapes a matrix of the port.
"""
from __future__ import annotations

import json
import math
import os
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.runner.traces import Request
from repro_torch.telemetry.spans import warn

#: marginal-throughput-gain threshold that defines saturation
KNEE_GAIN = 0.05

#: schema tag of the curve file (the reference's layout); a file with
#: another tag is *stale* and ``auto_slots`` falls back to the default
CURVE_SCHEMA = 2

#: environment override for the curve location (tests, ad-hoc curves)
CURVE_PATH_ENV = "REPRO_TORCH_LOADGEN_CURVE"

#: the port's default curve location (``results/`` is generated state)
CURVE_PATH = os.path.join("results", "torch", "loadgen_curve.json")

#: fallback slot count when no usable curve exists (the Scenario default)
DEFAULT_SLOTS = 4

#: autoscaler bounds and headroom: the measured width is scaled by
#: HEADROOM/knee_load and clamped to [1, AUTO_SLOTS_MAX]
AUTO_SLOTS_MAX = 16
AUTO_SLOTS_HEADROOM = 1.25


def auto_slots_info(arch: str, curve_path: Optional[str] = None,
                    default: int = DEFAULT_SLOTS) -> Tuple[int, str]:
    """``(slots, fallback_reason)`` for ``arch`` from the measured curve.

    The reason is ``""`` when the knee policy ran, else one of
    ``"missing"`` (no curve file), ``"unreadable"`` (not valid JSON),
    ``"stale-schema"`` (another layout than ``CURVE_SCHEMA``),
    ``"foreign-arch"`` (a curve of another arch) or ``"degenerate-curve"``
    (no usable knee or slot count).  Every fallback emits one structured
    ``warn("slots_fallback", ...)`` line.
    """
    path = curve_path or os.environ.get(CURVE_PATH_ENV) or CURVE_PATH

    def fallback(reason: str) -> Tuple[int, str]:
        warn("slots_fallback", arch=arch, path=path, reason=reason,
             slots=default)
        return default, reason

    try:
        with open(path, encoding="utf-8") as f:
            data = json.load(f)
    except OSError:
        return fallback("missing")
    except ValueError:
        return fallback("unreadable")
    if not isinstance(data, dict) or data.get("schema") != CURVE_SCHEMA:
        return fallback("stale-schema")
    if data.get("arch") != arch:
        return fallback("foreign-arch")
    knee = ((data.get("curves") or {}).get("batched") or {}).get("knee") or {}
    knee_load = knee.get("knee_load") or 0.0
    measured = data.get("slots") or 0
    if knee_load <= 0 or measured <= 0:
        return fallback("degenerate-curve")
    target = measured * AUTO_SLOTS_HEADROOM / knee_load
    return max(1, min(AUTO_SLOTS_MAX, int(math.ceil(target)))), ""


def auto_slots(arch: str, curve_path: Optional[str] = None,
               default: int = DEFAULT_SLOTS) -> int:
    """Knee-driven slot count for ``arch`` from the measured load curve:
    the measured width times ``AUTO_SLOTS_HEADROOM`` over the batched
    admission's knee load, clamped to [1, ``AUTO_SLOTS_MAX``]; ``default``
    where ``auto_slots_info`` falls back (and says why)."""
    return auto_slots_info(arch, curve_path, default)[0]


def parse_split(split: str) -> Tuple[int, int]:
    """``"i/n"`` -> (i, n), validated (0 <= i < n, n >= 1)."""
    try:
        i_s, n_s = split.split("/")
        i, n = int(i_s), int(n_s)
    except ValueError:
        raise ValueError(f"split must be 'i/n', got {split!r}") from None
    if n < 1 or not (0 <= i < n):
        raise ValueError(f"split {split!r} needs 0 <= i < n")
    return i, n


def shard_requests(requests: List[Request], split: str) -> List[Request]:
    """Shard ``i/n``: keep every n-th request by rid order, starting at i.
    Deterministic in the request ids alone, so the n shards partition the
    trace exactly."""
    if not split:
        return requests
    i, n = parse_split(split)
    by_rid = sorted(requests, key=lambda r: r.rid)
    keep = {r.rid for j, r in enumerate(by_rid) if j % n == i}
    return [r for r in requests if r.rid in keep]


def scale_arrivals(requests: List[Request], load: float) -> List[Request]:
    """Offered load: ``arrival' = floor(arrival / load)`` on the virtual
    arrival clock, in place (load 1.0 is the identity); returns the list.
    Tokens are unaffected: each request's output depends on its prompt
    alone."""
    if load <= 0:
        raise ValueError(f"load must be > 0, got {load}")
    if load != 1.0:
        for r in requests:
            r.arrival_step = int(math.floor(r.arrival_step / load))
    return requests


def find_knee(points: Sequence[Dict[str, float]]) -> Dict[str, float]:
    """The saturation knee of a measured load curve: ``points`` carry
    ``load`` and ``tok_per_s``; returns ``{"knee_load", "knee_tok_s"}`` of
    the highest load whose step from the previous one still bought a
    ``KNEE_GAIN`` marginal throughput gain (every step scanned).  With no
    such step the first point is the knee."""
    pts = sorted(points, key=lambda p: p["load"])
    if not pts:
        return {"knee_load": 0.0, "knee_tok_s": 0.0}
    knee = pts[0]
    for prev, cur in zip(pts, pts[1:]):
        base = prev["tok_per_s"]
        gain = (cur["tok_per_s"] - base) / base if base > 0 else 0.0
        if gain >= KNEE_GAIN:
            knee = cur
    return {"knee_load": float(knee["load"]),
            "knee_tok_s": float(knee["tok_per_s"])}
