"""Deterministic request-trace generation for serving scenarios.

A copy of ``repro.runner.traces`` (numpy only), kept in the port so the
port imports nothing of the reference; the two must generate identical
requests from one spec, which the parity tests check.

A *trace* is the load profile a serve cell (``Scenario(task="serve")``)
replays: a list of requests with prompts, output budgets, and arrival
times.  Arrival time is expressed in **decode steps** (virtual time), not
wall seconds: the continuous-batching engine admits a request once its
``arrival_step`` has passed, so which requests share slots — and therefore
the exact tokens generated — depends only on (profile, seed), never on
host speed.  That is what makes the acceptance invariant possible: the
same trace produces byte-identical token outputs whether the cell runs
serially in-process or sharded across worker subprocesses.

Arrival profiles (``PROFILES``):

    uniform   every request available at step 0, fixed output budget —
              the closed-loop saturation workload;
    bursty    Poisson arrivals: exponential inter-arrival gaps in
              decode-step time, fixed output budget — the open-loop
              production shape where queues actually form;
    mixed     Poisson arrivals AND per-request output budgets drawn from
              a discrete distribution in [max(1, max_new//2), 2*max_new]
              — staggers slot completion, stressing continuous refill.

Prompt-length profiles (``PROMPT_PROFILES``, the second half of a
``"arrival+length"`` trace axis, e.g. ``trace="bursty+bimodal"``):

    fixed     every prompt is exactly ``prompt_len`` tokens (default);
    uniform   lengths drawn uniformly in [max(1, P//2), 2P];
    bimodal   a chat-vs-document mix: half the requests at P//2, half
              at 2P;
    longtail  mostly short with a heavy tail: P//2 scaled by a Pareto
              draw, clipped to 4P — the production shape where one long
              prompt ties up a slot while short ones queue.

The engine tracks per-slot KV positions, so one trace can mix prompt
lengths freely — each admitted prompt is written at its own offset and
decoded against its own position vector (see ``repro_torch.launch.serve``).

Determinism layout: every component draws from its OWN seeded stream
(lengths / arrivals / budgets / prompt content), so fixing one component
explicitly (a captured trace) never shifts another's draws.  Prompt
*content* is a pure function of (seed, lengths): a spec that records the
seed and the per-request lengths — what ``capture_spec`` emits from a
live run — regenerates byte-identical prompts without storing tokens.

A spec is also the *recorded trace* format: ``save_spec``/``load_spec``
round-trip a TraceSpec through JSON, and a serve scenario can name one
with ``trace="file:PATH"`` — production-shaped load captured once (via
``ServeEngine.capture`` / ``capture_spec``) or synthesized offline
becomes an ordinary scenario axis, replayed with the same determinism
guarantees as the generative profiles.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import List, Optional, Sequence, Tuple

import numpy as np

PROFILES = ("uniform", "bursty", "mixed")

PROMPT_PROFILES = ("fixed", "uniform", "bimodal", "longtail")

# per-component RNG stream keys: each draw category gets an independent
# default_rng([seed, KEY]) so explicit overrides (captured traces) never
# shift the other components' streams
_STREAM_LEN, _STREAM_ARRIVAL, _STREAM_BUDGET, _STREAM_CONTENT = 11, 13, 17, 19


def split_trace(trace: str) -> Tuple[str, str]:
    """Split a scenario trace-axis value ``"arrival[+length]"`` into its
    (arrival profile, prompt-length profile) halves; the length half
    defaults to ``"fixed"``."""
    arrival, _, plen = trace.partition("+")
    return arrival, (plen or "fixed")


@dataclasses.dataclass
class Request:
    """One serving request; field order is stable public API (positional
    construction ``Request(rid, prompt, max_new)`` predates traces)."""
    rid: int
    prompt: np.ndarray            # (P,) int32
    max_new: int
    arrival_step: int = 0         # decode step at which it becomes admissible
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    # wall-clock timestamps stamped by the serve engine (0.0 = never)
    t_arrival: float = 0.0        # loop clock reached arrival_step
    t_first: float = 0.0          # first token emitted (prefill argmax)
    t_done: float = 0.0           # final token emitted


@dataclasses.dataclass(frozen=True)
class TraceSpec:
    """Everything needed to regenerate a trace deterministically.

    The three optional tuples pin a component explicitly (one value per
    request, rid order); empty means "draw from the profile".  A captured
    trace pins all three, leaving only prompt *content* to the seeded
    content stream — which depends only on (seed, lengths), so the replay
    is byte-identical to the captured run.
    """
    profile: str
    requests: int
    prompt_len: int               # base prompt length (exact for "fixed")
    max_new: int                  # base output budget (cap: 2x for "mixed")
    seed: int = 0
    prompt_profile: str = "fixed"
    prompt_lens: Tuple[int, ...] = ()   # explicit per-request prompt lengths
    arrivals: Tuple[int, ...] = ()      # explicit per-request arrival steps
    budgets: Tuple[int, ...] = ()       # explicit per-request output budgets
    source: str = ""              # provenance (e.g. "capture:<cell name>")

    def __post_init__(self):
        if self.profile not in PROFILES:
            raise ValueError(f"unknown trace profile {self.profile!r} "
                             f"(known: {PROFILES})")
        if self.prompt_profile not in PROMPT_PROFILES:
            raise ValueError(
                f"unknown prompt-length profile {self.prompt_profile!r} "
                f"(known: {PROMPT_PROFILES})")
        if self.requests < 1 or self.prompt_len < 1 or self.max_new < 1:
            raise ValueError(f"degenerate trace spec {self}")
        # JSON round-trips tuples as lists; renormalize so specs stay
        # hashable and == across a save/load cycle
        for f in ("prompt_lens", "arrivals", "budgets"):
            v = getattr(self, f)
            if not isinstance(v, tuple):
                object.__setattr__(self, f, tuple(int(x) for x in v))
                v = getattr(self, f)
            if v and len(v) != self.requests:
                raise ValueError(f"{f} pins {len(v)} values for "
                                 f"{self.requests} requests")
            if any(x < (0 if f == "arrivals" else 1) for x in v):
                raise ValueError(f"degenerate {f} in {self}")

    @property
    def max_new_cap(self) -> int:
        """Largest output budget any single request of this spec can carry
        (the "mixed" profile draws budgets up to 2x the base).  NOTE: this
        bounds one request, not the KV cache — size engines with
        ``cache_len_bound()``, which covers the whole replay."""
        if self.budgets:
            return max(self.budgets)
        return 2 * self.max_new if self.profile == "mixed" else self.max_new


def default_max_new(prompt_len: int) -> int:
    """The scenario-derived base output budget (seq axis -> prompt len)."""
    return max(4, prompt_len // 2)


def _draw_lengths(spec: TraceSpec) -> np.ndarray:
    if spec.prompt_lens:
        return np.asarray(spec.prompt_lens, np.int64)
    P, n = spec.prompt_len, spec.requests
    if spec.prompt_profile == "fixed":
        return np.full(n, P, np.int64)
    rng = np.random.default_rng([spec.seed, _STREAM_LEN])
    if spec.prompt_profile == "uniform":
        return rng.integers(max(1, P // 2), 2 * P + 1, n)
    if spec.prompt_profile == "bimodal":
        return rng.choice([max(1, P // 2), 2 * P], n)
    # longtail: short head, Pareto-scaled tail clipped at 4P
    base = max(1, P // 2)
    lens = base * (1.0 + rng.pareto(2.0, n))
    return np.clip(lens.astype(np.int64), base, 4 * P)


def generate(spec: TraceSpec, vocab: int) -> List[Request]:
    """Expand a spec into concrete requests, sorted by (arrival, rid).

    Each component (lengths, arrivals, budgets, prompt content) draws
    from its own seeded stream in a fixed order, so a spec is a pure
    function of its fields — the worker subprocess regenerating the trace
    from the scenario gets the same requests the in-process path would,
    and a captured spec (explicit lengths/arrivals/budgets) regenerates
    the exact prompts of the run it was captured from.
    """
    n = spec.requests
    lens = _draw_lengths(spec)
    if spec.arrivals:
        arrivals = np.asarray(spec.arrivals, np.int64)
    else:
        arrivals = np.zeros(n, np.int64)
        if spec.profile in ("bursty", "mixed"):
            # Poisson process in decode-step time: the mean gap is half an
            # output budget, so bursts overlap in-flight requests and lulls
            # briefly drain the slots — both admission paths get exercised
            rng = np.random.default_rng([spec.seed, _STREAM_ARRIVAL])
            gaps = rng.exponential(scale=max(1.0, spec.max_new / 2.0), size=n)
            arrivals = np.floor(np.cumsum(gaps) - gaps[0]).astype(np.int64)
    if spec.budgets:
        budgets = np.asarray(spec.budgets, np.int64)
    else:
        budgets = np.full(n, spec.max_new, np.int64)
        if spec.profile == "mixed":
            rng = np.random.default_rng([spec.seed, _STREAM_BUDGET])
            budgets = rng.integers(max(1, spec.max_new // 2),
                                   spec.max_new_cap + 1, n)
    # prompt content: one stream, rid order — a function of (seed, lens)
    # only, which is the capture-fidelity invariant
    crng = np.random.default_rng([spec.seed, _STREAM_CONTENT])
    prompts = [crng.integers(0, vocab, (int(L),),
                             dtype=np.int64).astype(np.int32) for L in lens]
    reqs = [Request(rid=i, prompt=prompts[i], max_new=int(budgets[i]),
                    arrival_step=int(arrivals[i]))
            for i in range(n)]
    reqs.sort(key=lambda r: (r.arrival_step, r.rid))
    return reqs


def capture_spec(requests: Sequence[Request], *, seed: int = 0,
                 source: str = "") -> TraceSpec:
    """A replayable TraceSpec from a live run's requests — the serve
    engine's capture output.

    Pins lengths/arrivals/budgets explicitly; prompt *content* rides on
    the seed (pass the seed the requests were generated with — content is
    a pure function of (seed, lengths), see ``generate``), so the
    captured spec replays the original run byte-for-byte through the
    ordinary ``save_spec`` / ``trace="file:PATH"`` machinery."""
    reqs = sorted(requests, key=lambda r: r.rid)
    if not reqs:
        raise ValueError("cannot capture an empty request list")
    lens = [len(r.prompt) for r in reqs]
    return TraceSpec(
        profile="uniform", requests=len(reqs),
        prompt_len=int(np.median(lens)) or 1,
        max_new=max(r.max_new for r in reqs), seed=seed,
        prompt_lens=tuple(lens),
        arrivals=tuple(r.arrival_step for r in reqs),
        budgets=tuple(r.max_new for r in reqs),
        source=source)


def cache_len_bound(requests: Sequence[Request], *, prefix: int = 0) -> int:
    """KV-cache length the serve engine needs for a trace.

    Per-slot position tracking means a slot's positions rewind on refill:
    a request occupies positions ``[0, prefix + len(prompt) + max_new)``
    of its row regardless of how many replays/refills came before, so the
    bound is the largest single-request footprint — no lockstep slack.
    (The final emitted token is never written back, so this carries one
    position of slack by construction; the engine's exhaustion guard
    fires at exactly bound - 2.)  ``prefix`` covers non-token prefill
    rows (the vlm patch prefix).
    """
    return prefix + max(len(r.prompt) + r.max_new for r in requests)


def tokens_by_rid(requests: Sequence[Request]) -> List[List[int]]:
    """Generated tokens in rid order — the canonical output view used for
    the serial-vs-sharded determinism check."""
    return [list(r.out) for r in sorted(requests, key=lambda r: r.rid)]


def tokens_digest(tokens: Sequence[Sequence[int]]) -> str:
    """Stable digest of generated tokens (rid-ordered list of lists)."""
    payload = json.dumps([list(t) for t in tokens], separators=(",", ":"))
    return hashlib.sha256(payload.encode()).hexdigest()


#: scenario ``trace`` prefix selecting a recorded spec file over a
#: generative profile name
FILE_PREFIX = "file:"

#: schema tag written by save_spec / required by load_spec
SPEC_SCHEMA = 1

#: TraceSpec fields a spec file may omit (they default) — everything a
#: pre-capture save_spec file wouldn't have written
_OPTIONAL_FIELDS = ("prompt_profile", "prompt_lens", "arrivals", "budgets",
                    "source")


def save_spec(spec: TraceSpec, path: str) -> str:
    """Write a TraceSpec as JSON (``{"trace_spec": 1, ...fields}``) —
    the recorded-trace format ``trace="file:PATH"`` serve scenarios
    replay.  A spec IS the trace: ``generate()`` is a pure function of
    its fields, so persisting the spec persists the exact requests
    (prompts, budgets, arrivals) without storing token arrays.  Optional
    fields at their defaults are omitted, so synthetic specs keep the
    compact pre-capture file shape."""
    d = dataclasses.asdict(spec)
    for f in dataclasses.fields(TraceSpec):
        if f.name in _OPTIONAL_FIELDS and d[f.name] == f.default:
            del d[f.name]
    with open(path, "w") as f:
        json.dump({"trace_spec": SPEC_SCHEMA, **d}, f, indent=1)
    return path


def load_spec(path: str) -> TraceSpec:
    """Read a ``save_spec`` file back into a (validated) TraceSpec.

    Strict on shape: every required spec field must be present and no
    unknown keys — a misspelled or renamed key in a hand-edited file must
    fail loudly here, not silently replay a default workload under the
    intended trace's name.  The capture-era optional fields
    (``prompt_profile``/``prompt_lens``/``arrivals``/``budgets``/
    ``source``) may be absent (pre-capture files)."""
    with open(path) as f:
        d = json.load(f)
    if not isinstance(d, dict) or d.get("trace_spec") != SPEC_SCHEMA:
        raise ValueError(f"{path}: not a trace-spec file "
                         f"(want trace_spec={SPEC_SCHEMA}, "
                         f"got {d.get('trace_spec') if isinstance(d, dict) else type(d).__name__})")
    fields = {f.name for f in dataclasses.fields(TraceSpec)}
    required = fields - set(_OPTIONAL_FIELDS)
    given = set(d) - {"trace_spec"}
    if not required <= given or not given <= fields:
        raise ValueError(f"{path}: trace-spec fields don't match "
                         f"(missing: {sorted(required - given)}, "
                         f"unknown: {sorted(given - fields)})")
    return TraceSpec(**{k: d[k] for k in given})


def spec_for_scenario(scenario, *, seed: Optional[int] = None) -> TraceSpec:
    """The TraceSpec a serve/loadgen scenario denotes.

    ``trace="file:PATH"`` replays a recorded spec: the file defines the
    whole workload (request count, prompt lengths, budgets, seed) and the
    scenario's ``batch``/``seq`` axes are advisory labels only.  The file
    must exist on the host that RUNS the cell — under cluster dispatch
    that is the worker, so recorded traces need a shared or replicated
    path.  Otherwise ``trace`` names a generative profile
    (``"arrival[+length]"``, e.g. ``"bursty+bimodal"``): batch -> request
    count, seq -> base prompt length, output budget derived from the
    prompt length."""
    if scenario.trace.startswith(FILE_PREFIX):
        return load_spec(scenario.trace[len(FILE_PREFIX):])
    arrival, plen_profile = split_trace(scenario.trace)
    return TraceSpec(profile=arrival, requests=scenario.batch,
                     prompt_len=scenario.seq,
                     max_new=default_max_new(scenario.seq),
                     seed=0 if seed is None else seed,
                     prompt_profile=plen_profile)
