"""Continuous-batching inference serving engine (port of
``repro.launch.serve``: the ``task="serve"`` workload).

A request queue with virtual-time arrivals, a batched prefill admission
stage, and a batched decode loop with per-slot completion and refill.  It
runs reduced configs on the CPU (tests) and full configs on the card
through the same code; on the card every attention layer (the encdec
family's encoder and cross attention included) is the hand-written
flash-attention kernel, and every prefill of a Mamba-2 or RG-LRU layer
its hand-written scan kernel.  The vlm family's patch prefix and the
encdec family's frames are zeros at admission (their front ends are
stubs, as in the reference); a vlm slot's positions start past the
prefix.

Admission: each loop iteration admits one *wave* — every waiting request
paired with a free slot — through one prefill call per prompt-length
bucket (``admission="batched"``, the default).  Prompts are right-padded
into power-of-two buckets and row counts rounded to powers of two;
per-row masks and gathers in the model make padded rows exact, so tokens
equal those of ``admission="single"`` (one exact-length call per request).

Compiled, as the reference jits: with ``compiled=True`` (the default, and
the CLI's) the decode step and the admission call run through
``harness.compile_step`` (TorchInductor on the card, ``aot_eager`` on the
CPU, static shapes, no fallback), each engine with code objects of its
own (``_own_code``), so that its compiled graphs and Dynamo's recompile
count are its own, as each of the reference's engines holds its own
``jax.jit`` caches.  The admission call is keyed by its (rows, padded
length) shape alone: its slot scatter takes a per-slot source row and
mask of the engine's width.  ``compiled=False`` runs both uncompiled (the
harness phases that compare the two).

"Donation" in the reference is the port's in-place update: with
``donate=True`` the decode step and the admission scatter write into the
live KV cache; with ``donate=False`` each works on a copy, made outside
the compiled call, which the engine then keeps.  ``admit_shapes`` records
which (rows, padded length) prefill shapes ran; ``admit_new_shapes`` is
the frames Dynamo compiled during a replay (on an uncompiled engine, the
shapes first admitted in it).

``run(..., phase_log=...)`` is the reference's profiler hook (one
``(dispatch_s, device_s)`` split per decode step; the device part from a
kernel trace of decode steps outside the replay, ``decode_probe``).  The
reference's fleet-metrics calls and its tracing hook (``span_log``) wait
for ``fleet/`` and ``telemetry/`` (ROADMAP Queue 1, item 12).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b \\
        --requests 16 --slots 4 --prompt-len 32 --trace bursty
"""
from __future__ import annotations

import argparse
import contextlib
import time
import types
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.harness import clone_tree, compile_step, dynamo_counts
from repro_torch.core.suite import Built, build_arch
from repro_torch.device import DeviceLike
from repro_torch.models import build_model
from repro_torch.models.layers import map_defs
from repro_torch.runner.latency import latency_summary
from repro_torch.runner.traces import (Request, TraceSpec, cache_len_bound,
                                       capture_spec, generate, save_spec,
                                       tokens_by_rid, tokens_digest)

#: smallest padded prompt-length bucket for batched admission; buckets
#: double from here
ADMIT_MIN_BUCKET = 8

#: valid values of the engine's ``admission`` policy flag
ADMISSIONS = ("batched", "single")


def _own_code(method):
    """``method`` on a copy of its function with a code object of its own:
    Dynamo keeps compiled graphs, and counts compiles against
    ``harness.RECOMPILE_LIMIT``, per code object, so each engine's count
    is bounded by its own shapes and its calls check only its own guards."""
    fn = method.__func__
    own = types.FunctionType(fn.__code__.replace(), fn.__globals__, fn.__name__,
                             fn.__defaults__, fn.__closure__)
    return types.MethodType(own, method.__self__)


class ServeEngine:
    """Slot-based continuous batching over a shared decode step.

    ``built`` is a ``repro_torch.core.suite.Built`` (config + model, the
    model on its device).  ``run()`` resets all per-trace state, so one
    engine can replay any number of traces.

    Admission prefills waiting requests into the live cache: each wave
    groups every admissible queued request by padded prompt-length bucket
    and runs one call per group — prefill on a fresh k-row mini cache,
    per-row last-valid-position argmax, then a row scatter into the target
    slots (the per-slot ``len`` vectors land each row at its own prompt
    length).
    """

    def __init__(self, built: Built, *, slots: int, max_len: int,
                 donate: bool = True, admission: str = "batched",
                 compiled: bool = True):
        if admission not in ADMISSIONS:
            raise ValueError(f"unknown admission {admission!r} "
                             f"(known: {ADMISSIONS})")
        self.cfg = built.cfg
        self.model = built.model
        self.device = built.model.device
        self.slots = slots
        self.max_len = max_len
        self.donate = donate
        self.admission = admission
        self.compiled = compiled
        if compiled:
            self._admit = compile_step(_own_code(self._admit_impl), self.device)
            self._decode_call = compile_step(_own_code(self._decode_impl), self.device)
        else:
            self._admit, self._decode_call = self._admit_impl, self._decode_impl
        # vlm prefill writes n_prefix patch positions ahead of the prompt,
        # so a slot's cache position starts past the prefix after admission
        self._prefix = built.cfg.n_prefix if built.cfg.family == "vlm" else 0
        # per-leaf batch axis of every cache leaf, from the declared axes
        self._cache_axes = map_defs(lambda d: d.axes.index("cache_batch"),
                                    self.model.cache_defs(slots, max_len))
        # distinct (rows, padded_len) prefill shapes ever admitted
        self._admit_shapes: set = set()
        self._reset()

    def _reset(self) -> None:
        self.cache = self.model.init_cache(self.slots, self.max_len)
        self.slot_req: List[Optional[Request]] = [None] * self.slots
        # host-side mirror of the per-layer "len" vectors: admission sets a
        # row to prefix + prompt_len, every decode step advances all rows.
        # Guarded in run(): an *active* row overflowing max_len would have
        # its KV write clamped to the cache edge, corrupting attention.
        self.slot_pos = np.zeros(self.slots, np.int32)
        self.steps = 0
        self._admit_calls = 0
        self._admit_batches: List[int] = []

    # ---- batched admission ------------------------------------------------

    def _bucket(self, n: int) -> int:
        """Padded prompt length for an ``n``-token prompt."""
        if self.admission == "single":
            return n
        b = ADMIT_MIN_BUCKET
        while b < n:
            b *= 2
        return min(b, self.max_len - self._prefix)

    def _admit_impl(self, tokens: torch.Tensor, lengths: torch.Tensor,
                    src: torch.Tensor, mask: torch.Tensor, mini: dict,
                    cache: dict) -> torch.Tensor:
        """One admission call: prefill ``tokens`` (kb, Lpad) with valid
        prefixes ``lengths`` (kb,) into ``mini``, a fresh kb-row cache,
        then write mini row ``src[s]`` into cache row ``s`` wherever
        ``mask[s]`` (every leaf along its declared ``cache_batch`` axis: the
        encdec family's cross keys and values too), in place.  ``src`` and
        ``mask`` span the engine's slots, so the call's shapes are (kb,
        Lpad) alone.  ``mini`` comes from outside the call: under Inductor
        the writes that the layers' nested compile regions make into a
        cache created inside the graph were lost.  Returns each mini row's
        first token."""
        kb = tokens.shape[0]
        batch = {"tokens": tokens}
        cfg, dev = self.cfg, tokens.device
        # the stubbed front ends' inputs are zeros at serving time
        if cfg.family == "vlm":
            batch["patch_embeds"] = torch.zeros(kb, cfg.n_prefix, cfg.d_model, device=dev)
        if cfg.family == "encdec":
            batch["frames"] = torch.zeros(kb, cfg.enc_seq, cfg.d_model, device=dev)
        logits, mini = self.model.prefill(batch, mini, lengths=lengths)
        first = logits[:, 0].argmax(dim=-1).to(torch.int32)

        def scatter(big, small, ax):
            shape = [1] * big.ndim
            shape[ax] = self.slots
            rows = small.index_select(ax, src).to(big.dtype)
            big.copy_(torch.where(mask.reshape(shape), rows, big))

        def walk(big, small, ax):
            if isinstance(big, torch.Tensor):
                scatter(big, small, ax)
            else:
                for k in big:
                    walk(big[k], small[k], ax[k])

        walk(cache, mini, self._cache_axes)
        return first

    def _admit_wave(self, pairs: List[Tuple[int, Request]]) -> List[int]:
        """Admit a wave of (slot, request) pairs; returns their first
        tokens in pair order."""
        if self.admission == "single":
            grouped = [[pr] for pr in pairs]
        else:
            by_bucket: Dict[int, List[Tuple[int, Request]]] = {}
            for pr in pairs:
                by_bucket.setdefault(self._bucket(len(pr[1].prompt)),
                                     []).append(pr)
            grouped = [by_bucket[b] for b in sorted(by_bucket)]
        first_by_slot: Dict[int, int] = {}
        dev = self.device
        for grp in grouped:
            lpad = self._bucket(max(len(r.prompt) for _, r in grp))
            kb = len(grp)
            if self.admission == "batched":
                kb = 1 << (kb - 1).bit_length()   # round rows to pow2
            tokens = np.zeros((kb, lpad), np.int32)
            # dummy rows keep lengths=lpad (never copied into the cache)
            lengths = np.full((kb,), lpad, np.int32)
            for i, (_, r) in enumerate(grp):
                tokens[i, : len(r.prompt)] = r.prompt
                lengths[i] = len(r.prompt)
            src = np.zeros((self.slots,), np.int64)
            mask = np.zeros((self.slots,), bool)
            for i, (s, _) in enumerate(grp):
                src[s], mask[s] = i, True
            # jit (no donation): the call writes into a copy, made outside it
            cache = self.cache if self.donate else clone_tree(self.cache)
            first = self._admit(torch.from_numpy(tokens).to(dev),
                                torch.from_numpy(lengths).to(dev),
                                torch.from_numpy(src).to(dev),
                                torch.from_numpy(mask).to(dev),
                                self.model.init_cache(kb, self.max_len), cache)
            self.cache = cache
            first = first.cpu().numpy()
            self._admit_calls += 1
            self._admit_batches.append(len(grp))
            self._admit_shapes.add((kb, lpad))
            for i, (s, r) in enumerate(grp):
                self.slot_req[s] = r
                self.slot_pos[s] = self._prefix + len(r.prompt)
                first_by_slot[s] = int(first[i])
        return [first_by_slot[s] for s, _ in pairs]

    def _decode_impl(self, toks: torch.Tensor, cache: dict):
        return self.model.decode_step(toks, cache)

    def _decode(self, toks: torch.Tensor) -> torch.Tensor:
        # jit (no donation): the step writes into a copy, made outside it
        cache = self.cache if self.donate else clone_tree(self.cache)
        logits, self.cache = self._decode_call(toks, cache)
        return logits

    @contextlib.contextmanager
    def decode_probe(self, requests: List[Request]):
        """A decode step of ``requests``' replay, for the profiler: resets
        the engine, admits the trace's first wave (its first ``slots``
        requests by arrival, untimed) and yields ``(step, room)``:
        ``step()`` runs one decode step over every slot and its argmax
        readback, as ``run()`` does, returns the step's logits, and may be
        called ``room`` times
        before an admitted row's cache is full.  On exit the engine is
        reset, its record of admitted shapes as it was; the requests are
        not touched."""
        shapes = set(self._admit_shapes)
        self._reset()
        try:
            first = sorted(requests, key=lambda r: (r.arrival_step, r.rid))[: self.slots]
            pairs = list(enumerate(first))
            next_tok = np.zeros(self.slots, np.int32)
            next_tok[: len(pairs)] = self._admit_wave(pairs)
            toks = torch.from_numpy(next_tok[:, None].copy()).to(self.device)
            room = int(min(self.max_len - self.slot_pos[s] for s, _ in pairs))

            def step():
                logits = self._decode(toks)
                logits[:, 0].argmax(dim=-1).cpu()
                return logits

            yield step, room
        finally:
            self._admit_shapes = shapes
            self._reset()

    def run(self, requests: List[Request], *, hook=None,
            phase_log: Optional[list] = None,
            device_trace: Optional[dict] = None) -> Dict[str, Any]:
        """Replay a trace; returns throughput + raw latency samples.

        Admission is driven by the decode-step counter (virtual time): a
        request with ``arrival_step=k`` can be admitted only once ``k``
        decode steps have elapsed (the counter fast-forwards when slots
        drain), so every generated token is deterministic regardless of
        host or device speed.  Wall-clock timestamps are taken after the
        device work they time has finished (the argmax readback waits for
        it).  ``hook`` is an optional ``RegressionHook`` fired once per
        decode step.

        ``phase_log`` is the profiler hook: one ``(dispatch_s, device_s)``
        tuple per batched decode step, split as ``harness.measure`` splits
        a step — the device part min(B, W) of the step's wall W, B the
        busy time per decode step that a kernel trace of up to 3 decode
        steps from ``decode_probe`` measures after the replay, untimed
        (its busy and class times, or its error, go into
        ``device_trace``).  Admission and prefill stay outside the decode
        steps.  Without a log nothing is traced.
        """
        self._reset()
        shapes0 = len(self._admit_shapes)
        frames0 = dynamo_counts()["frames"]
        upcoming = sorted(requests, key=lambda r: (r.arrival_step, r.rid))
        for r in upcoming:
            r.out, r.done = [], False
            r.t_arrival = r.t_first = r.t_done = 0.0
        waiting: List[Request] = []
        next_tok = np.zeros(self.slots, np.int32)
        step = active = done_count = tokens_out = 0
        total = len(upcoming)
        ttft_s: List[float] = []
        tok_lat_s: List[float] = []
        qdepth: List[int] = []
        step_walls: List[float] = []
        t0 = time.perf_counter()
        while done_count < total:
            now = time.perf_counter()
            while upcoming and upcoming[0].arrival_step <= step:
                req = upcoming.pop(0)
                req.t_arrival = now
                waiting.append(req)
            if active == 0 and not waiting:
                # slots drained before the next burst: fast-forward the
                # virtual clock to the next arrival
                step = upcoming[0].arrival_step
                continue
            if waiting:
                free = [s for s in range(self.slots)
                        if self.slot_req[s] is None or self.slot_req[s].done]
                pairs = list(zip(free, waiting))
                if pairs:
                    del waiting[: len(pairs)]
                    firsts = self._admit_wave(pairs)
                    tnow = time.perf_counter()
                    for (s, req), tok in zip(pairs, firsts):
                        req.out.append(tok)
                        tokens_out += 1
                        req.t_first = tnow
                        ttft_s.append(tnow - req.t_arrival)
                        next_tok[s] = tok
                        active += 1
                        if len(req.out) >= req.max_new:  # budget of 1: done
                            req.done = True              # at prefill
                            req.t_done = tnow
                            active -= 1
                            done_count += 1
            qdepth.append(len(waiting))
            if active == 0:
                step += 1
                continue
            for s in range(self.slots):
                req = self.slot_req[s]
                if req is None or req.done:
                    continue   # idle rows may overflow harmlessly (clamped
                    #            write, row fully rewritten at next admit)
                if self.slot_pos[s] + 1 > self.max_len:
                    raise RuntimeError(
                        f"KV cache exhausted: slot {s} (rid {req.rid}) at "
                        f"position {int(self.slot_pos[s])} with max_len "
                        f"{self.max_len} — size the engine with "
                        f"traces.cache_len_bound() for the trace")
            ts = time.perf_counter()
            toks = torch.from_numpy(next_tok[:, None].copy()).to(self.device)
            logits = self._decode(toks)
            nxt = logits[:, 0].argmax(dim=-1).cpu().numpy()
            if phase_log is not None:
                step_walls.append(time.perf_counter() - ts)
            if hook is not None:
                hook.fire()   # inside the timed sample, like harness.measure
            dt = time.perf_counter() - ts
            self.steps += 1
            step += 1
            self.slot_pos += 1   # decode advances every row's len vector
            for s in range(self.slots):
                req = self.slot_req[s]
                if req is None or req.done:
                    continue
                req.out.append(int(nxt[s]))
                tokens_out += 1
                tok_lat_s.append(dt)
                next_tok[s] = nxt[s]
                if len(req.out) >= req.max_new:
                    req.done = True
                    req.t_done = time.perf_counter()
                    active -= 1
                    done_count += 1
        wall = time.perf_counter() - t0
        # compiled: Dynamo's own count of the frames this replay compiled
        # (a new admission shape, or the decode step's first call)
        new_shapes = (dynamo_counts()["frames"] - frames0 if self.compiled
                      else len(self._admit_shapes) - shapes0)
        ab = self._admit_batches
        out = {"requests": total, "decode_steps": self.steps,
               "tokens": tokens_out, "wall_s": wall,
               "tok_per_s": tokens_out / wall if wall else 0.0,
               "ttft_s": ttft_s, "tok_lat_s": tok_lat_s,
               "queue_depth_mean": (sum(qdepth) / len(qdepth)) if qdepth else 0.0,
               "queue_depth_max": max(qdepth) if qdepth else 0,
               "admission": self.admission,
               "admit_calls": self._admit_calls,
               "admit_batch_mean": (sum(ab) / len(ab)) if ab else 0.0,
               "admit_batch_max": max(ab) if ab else 0,
               "admit_shapes": sorted(list(s) for s in self._admit_shapes),
               # shapes first compiled (uncompiled: first run) in this replay
               "admit_new_shapes": new_shapes,
               "tokens_by_rid": tokens_by_rid(requests)}
        if phase_log is not None:
            from repro_torch.profiler.attribution import trace_phases
            with self.decode_probe(requests) as (step, room):
                trace_phases(step, min(3, room), step_walls, phase_log, device_trace,
                             self.device)
        return out

    def capture(self, requests: List[Request], *, seed: int = 0,
                source: str = "live") -> TraceSpec:
        """A replayable ``TraceSpec`` of a served trace."""
        return capture_spec(requests, seed=seed, source=source)


def summarize_metrics(out: Dict[str, Any]) -> Dict[str, Any]:
    """The well-known serve metric keys (see ``runner/results.py``) from an
    engine ``run()`` payload: TTFT / per-token latency p50/p95/p99 in us,
    throughput, queue depth, admission counters, and the token digest."""
    summary: Dict[str, Any] = {
        "tok_per_s": out["tok_per_s"],
        "decode_steps": out["decode_steps"],
        "queue_depth_mean": out["queue_depth_mean"],
        "queue_depth_max": out["queue_depth_max"],
        "tokens_digest": tokens_digest(out["tokens_by_rid"]),
    }
    for k in ("admission", "admit_calls", "admit_batch_mean",
              "admit_batch_max", "admit_shapes"):
        if k in out:
            summary[k] = out[k]
    summary.update(latency_summary(out["ttft_s"], "ttft", scale=1e6))
    summary.update(latency_summary(out["tok_lat_s"], "tok_lat", scale=1e6))
    return summary


def built_for_cfg(cfg, seed: int = 0, *, device: DeviceLike = "cuda") -> Built:
    """Build (model with random weights from ``seed``) for an already
    resolved config — the path of the ``Server`` shim and the ``--full``
    CLI (the runner caches reduced builds instead)."""
    return Built(cfg=cfg, model=build_model(cfg, device=device, seed=seed))


class Server(ServeEngine):
    """Compat shim over ``ServeEngine`` for direct callers: builds the
    model from a config."""

    def __init__(self, cfg, *, slots: int, max_len: int, seed: int = 0,
                 admission: str = "batched", device: DeviceLike = "cuda"):
        super().__init__(built_for_cfg(cfg, seed, device=device), slots=slots,
                         max_len=max_len, admission=admission)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--trace", default="uniform",
                    help="load profile: uniform | bursty | mixed")
    ap.add_argument("--prompt-profile", default="fixed",
                    help="prompt-length profile: fixed | uniform | bimodal "
                         "| longtail")
    ap.add_argument("--capture", default="",
                    help="write a replayable TraceSpec of this run to PATH")
    ap.add_argument("--admission", default="batched", choices=ADMISSIONS,
                    help="prefill admission policy: batched (bucketed "
                         "multi-request prefill) | single (per-request "
                         "baseline)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--full", action="store_true",
                    help="the arch's full published config, not reduced()")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain PyTorch path")
    args = ap.parse_args(argv)
    from repro_torch.configs import get_arch
    if args.full:
        built = built_for_cfg(get_arch(args.arch), args.seed, device=args.device)
    else:
        built = build_arch(args.arch, device=args.device)
    spec = TraceSpec(profile=args.trace, requests=args.requests,
                     prompt_len=args.prompt_len, max_new=args.max_new,
                     seed=args.seed, prompt_profile=args.prompt_profile)
    reqs = generate(spec, vocab=built.cfg.vocab)
    prefix = built.cfg.n_prefix if built.cfg.family == "vlm" else 0
    engine = ServeEngine(built, slots=args.slots,
                         max_len=cache_len_bound(reqs, prefix=prefix),
                         admission=args.admission)
    out = engine.run(reqs)
    m = summarize_metrics(out)
    if args.capture:
        save_spec(engine.capture(reqs, seed=args.seed,
                                 source=f"cli:{args.arch}"), args.capture)
        print(f"captured trace spec -> {args.capture}")
    print(f"served {args.requests} requests ({args.trace}): {out['tokens']} tokens "
          f"in {out['wall_s']:.2f}s ({m['tok_per_s']:.1f} tok/s, "
          f"{out['decode_steps']} steps, {args.admission} admission: "
          f"{out['admit_calls']} prefill calls) on {engine.device}")
    print(f"  ttft_us    p50={m.get('ttft_p50', 0):.0f} "
          f"p95={m.get('ttft_p95', 0):.0f} p99={m.get('ttft_p99', 0):.0f}")
    print(f"  tok_lat_us p50={m.get('tok_lat_p50', 0):.0f} "
          f"p95={m.get('tok_lat_p95', 0):.0f} p99={m.get('tok_lat_p99', 0):.0f}")
    print(f"  queue_depth mean={m['queue_depth_mean']:.2f} max={m['queue_depth_max']}")
    print(f"  tokens_digest={m['tokens_digest']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
