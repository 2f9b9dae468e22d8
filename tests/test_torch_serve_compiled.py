"""The serving engine compiled (``ServeEngine(compiled=True)``: its decode
step and admission through ``harness.compile_step``, ``aot_eager`` on the
CPU) against the uncompiled engine and the reference's jitted engine:
tokens bitwise and no graph break, admission compiled per bucket and not
per prompt length, a runner that serves two archs and sweeps both
admission policies inside Dynamo's recompile limit, ``jit`` leaving the
caller's cache untouched, and a timed replay that compiles folded into
``compile_us`` and measured again."""
import pytest
import torch

from repro.core.suite import build_arch as ref_build_arch
from repro.launch.serve import ServeEngine as RefEngine
from repro_torch.core import harness
from repro_torch.core.suite import build_arch
from repro_torch.launch import serve
from repro_torch.launch.serve import ADMIT_MIN_BUCKET, ServeEngine
from repro_torch.runner.runner import BenchmarkRunner
from repro_torch.runner.scenario import Scenario, ScenarioMatrix
from repro_torch.runner.traces import TraceSpec, cache_len_bound, generate

# tiny shapes: one intra-op thread each, as the suite runs in parallel workers
torch.set_num_threads(1)

BURSTY = TraceSpec(profile="bursty", requests=6, prompt_len=8, max_new=4,
                   prompt_profile="bimodal")


@pytest.mark.parametrize("arch", ["gemma-2b", "mamba2-2.7b", "recurrentgemma-9b"])
def test_compiled_engine_serves_the_uncompiled_tokens_with_no_graph_break(arch):
    built = build_arch(arch, device="cpu")
    reqs = generate(BURSTY, vocab=built.cfg.vocab)
    max_len = cache_len_bound(reqs)
    c0 = harness.dynamo_counts()
    compiled = ServeEngine(built, slots=4, max_len=max_len)
    assert compiled.compiled
    first = compiled.run(reqs)
    c1 = harness.dynamo_counts()
    again = compiled.run(reqs)
    c2 = harness.dynamo_counts()
    plain = ServeEngine(built, slots=4, max_len=max_len, compiled=False).run(reqs)
    assert first["tokens_by_rid"] == again["tokens_by_rid"] == plain["tokens_by_rid"]
    # the decode step and one admission call per shape, each one frame
    shapes = len(first["admit_shapes"])
    assert c1["frames"] - c0["frames"] == c1["graphs"] - c0["graphs"] == shapes + 1
    assert first["admit_new_shapes"] == shapes + 1
    assert c1["graph_breaks"] == c0["graph_breaks"]
    # the replay ran compiled graphs only, and compiled nothing new
    assert again["admit_new_shapes"] == 0 and c2["frames"] == c1["frames"]
    calls = again["decode_steps"] + sum(1 for _ in again["admit_shapes"])
    assert c2["graph_calls"] - c1["graph_calls"] >= calls
    assert plain["admit_new_shapes"] == shapes   # uncompiled: the shape record


def test_compiled_engine_matches_the_references_jitted_engine():
    built = build_arch("gemma-2b", device="cpu")
    reqs = generate(BURSTY, vocab=built.cfg.vocab)
    out = ServeEngine(built, slots=4, max_len=cache_len_bound(reqs)).run(reqs)
    ref_reqs = generate(BURSTY, vocab=built.cfg.vocab)
    ref = RefEngine(ref_build_arch("gemma-2b"), slots=4,
                    max_len=cache_len_bound(ref_reqs)).run(ref_reqs)
    assert out["tokens_by_rid"] == ref["tokens_by_rid"]
    assert out["admit_shapes"] == ref["admit_shapes"]


def test_batched_admission_compiles_per_bucket_not_per_length():
    """The reference's ``tests/test_admission.py`` case, compiled: a
    longtail trace with many distinct prompt lengths compiles a handful of
    (rows, padded length) admission graphs; single admission one a length."""
    reqs = generate(TraceSpec("uniform", 16, 24, 2, seed=5, prompt_profile="longtail"),
                    vocab=500)
    distinct = {len(r.prompt) for r in reqs}
    assert len(distinct) >= 5
    built = build_arch("gemma-2b", device="cpu")
    eng = ServeEngine(built, slots=4, max_len=cache_len_bound(reqs))
    out = eng.run(reqs)
    shapes = [tuple(s) for s in out["admit_shapes"]]
    assert out["admit_batch_max"] >= 2
    assert len(shapes) < len(distinct)
    assert out["admit_new_shapes"] == len(shapes) + 1     # and the decode step
    for rows, lpad in shapes:
        assert rows & (rows - 1) == 0
        assert lpad == eng.max_len or (lpad & (lpad - 1) == 0 and lpad >= ADMIT_MIN_BUCKET)
    single = ServeEngine(built, slots=4, max_len=cache_len_bound(reqs), admission="single")
    out_s = single.run(reqs)
    assert len(out_s["admit_shapes"]) == len(distinct)
    assert out_s["admit_new_shapes"] == len(distinct) + 1
    assert out_s["tokens_by_rid"] == out["tokens_by_rid"]


def test_a_runner_serving_two_archs_then_sweeping_both_policies_stays_under_the_limit(
        monkeypatch):
    """Each engine compiles on code objects of its own, so the compiles of
    many engines in one process never add up to ``RECOMPILE_LIMIT`` on one
    code object.  The limit is lowered to 8 here, above any one engine's
    compiles (at most 6) and below the process's (22)."""
    from torch import _dynamo
    limit = harness.RECOMPILE_LIMIT
    monkeypatch.setattr(harness, "RECOMPILE_LIMIT", 8)
    runner = BenchmarkRunner(device="cpu", runs=1, warmup=0, compile_warmup=0)
    serve_cells = ScenarioMatrix(archs=("gemma-2b", "mamba2-2.7b"), tasks=("serve",),
                                 batches=(6,), seqs=(8,),
                                 traces=("bursty+bimodal", "uniform+longtail"))
    sweep = ScenarioMatrix(archs=("gemma-2b",), tasks=("loadgen",), batches=(8,), seqs=(8,),
                           traces=("bursty+longtail",), loads=(0.5, 2.0, 8.0),
                           admissions=("batched", "single"))
    c0 = harness.dynamo_counts()
    try:
        out = runner.run_matrix(serve_cells) + runner.run_matrix(sweep)
        assert _dynamo.config.recompile_limit == 8
    finally:
        _dynamo.config.recompile_limit = limit
    assert all(rr.status == "ok" for rr in out), [rr.error for rr in out if rr.error]
    assert harness.dynamo_counts()["frames"] - c0["frames"] > 8
    per_engine = [len(e._admit_shapes) + 1 for e in runner._serve_engines.values()]
    assert len(per_engine) == 5 and max(per_engine) <= 8
    assert all(rr.extra["compiled"] for rr in out)
    assert len({rr.extra["tokens_digest"] for rr in out if rr.task == "loadgen"}) == 1


def test_inductor_keeps_the_admissions_cache_writes(monkeypatch):
    """The admission under TorchInductor (the card's backend, here its CPU
    code), fp32: the cache rows it writes, and so the tokens, are the
    uncompiled engine's.  With the mini cache created inside the compiled call,
    Inductor lost the writes the layers' nested compile regions made into
    it (``aot_eager`` kept them)."""
    monkeypatch.setitem(harness.COMPILE_BACKENDS, "cpu", "inductor")
    monkeypatch.setattr(harness, "_BACKENDS", {})
    built = build_arch("mamba2-2.7b", {"compute_dtype": torch.float32}, "cpu")
    reqs = generate(TraceSpec(profile="uniform", requests=4, prompt_len=8, max_new=3),
                    vocab=built.cfg.vocab)
    outs = {}
    for compiled in (True, False):
        eng = ServeEngine(built, slots=4, max_len=cache_len_bound(reqs), compiled=compiled)
        outs[compiled] = (eng.run(reqs)["tokens_by_rid"], eng.cache)
    assert outs[True][0] == outs[False][0]
    assert torch.equal(outs[True][1]["blocks"]["len"], outs[False][1]["blocks"]["len"])
    assert torch.allclose(outs[True][1]["blocks"]["ssm"], outs[False][1]["blocks"]["ssm"],
                          atol=1e-5)


@pytest.mark.parametrize("arch", ["gemma-2b", "whisper-large-v3"])
def test_jit_leaves_the_callers_cache_untouched(arch):
    built = build_arch(arch, device="cpu")
    reqs = generate(BURSTY, vocab=built.cfg.vocab)
    eng = ServeEngine(built, slots=4, max_len=cache_len_bound(reqs), donate=False)
    eng.run(reqs)                                # compiles
    with eng.decode_probe(reqs) as (step, _):
        held = eng.cache                         # after the probe's admission
        before = harness.clone_tree(held)
        step()
        assert eng.cache is not held
    leaves = []

    def walk(a, b):
        if isinstance(a, torch.Tensor):
            leaves.append(torch.equal(a, b))
        else:
            for k in a:
                walk(a[k], b[k])
    walk(held, before)
    assert leaves and all(leaves)
    # and an admission into a copy too: the live cache object stays as it was
    eng._reset()
    held, before = eng.cache, harness.clone_tree(eng.cache)
    eng._admit_wave([(0, reqs[0])])
    assert eng.cache is not held
    leaves.clear()
    walk(held, before)
    assert all(leaves)


def test_donated_engine_writes_the_live_cache_in_place():
    built = build_arch("gemma-2b", device="cpu")
    reqs = generate(BURSTY, vocab=built.cfg.vocab)
    eng = ServeEngine(built, slots=4, max_len=cache_len_bound(reqs), donate=True)
    eng.run(reqs)
    eng._reset()
    held = eng.cache
    eng._admit_wave([(1, reqs[0])])
    assert eng.cache is held
    assert held["blocks"]["len"][:, 1].tolist() == [len(reqs[0].prompt)] * built.cfg.n_layers


def test_a_replay_that_compiles_is_folded_into_compile_us_and_measured_again(monkeypatch):
    """Load 8 reaches an admission shape that load 0.5's replays never
    compiled: the measured replay paid that compile, its wall goes into
    ``compile_us``, and the cell is measured again; a second replay that
    still compiles makes the cell an error record."""
    runner = BenchmarkRunner(device="cpu", runs=1, warmup=0, compile_warmup=0)
    low = runner.run(Scenario(arch="gemma-2b", task="loadgen", batch=8, seq=8,
                              trace="bursty+bimodal", load=0.5))
    assert low.status == "ok", low.error
    replays = []
    real_run = ServeEngine.run

    def counting_run(self, reqs, **kw):
        out = real_run(self, reqs, **kw)
        replays.append(out["admit_new_shapes"])
        return out
    monkeypatch.setattr(ServeEngine, "run", counting_run)
    high = runner.run(Scenario(arch="gemma-2b", task="loadgen", batch=8, seq=8,
                               trace="bursty+bimodal", load=8.0))
    assert high.status == "ok", high.error
    assert high.cache["executable_reused"]           # the same engine, no warm replay
    assert replays[0] > 0 and replays[1:] == [0]     # compiled, then measured again
    assert high.compile_us > 0
    assert [tuple(s) for s in high.extra["admit_shapes"]] != \
        [tuple(s) for s in low.extra["admit_shapes"]]
    assert high.extra["tokens_digest"] == low.extra["tokens_digest"]

    def always_new(self, reqs, **kw):
        return dict(real_run(self, reqs, **kw), admit_new_shapes=1)
    monkeypatch.setattr(ServeEngine, "run", always_new)
    bad = runner.run(Scenario(arch="gemma-2b", task="loadgen", batch=8, seq=8,
                              trace="bursty+bimodal", load=1.0))
    assert bad.status == "error" and "compiled again" in bad.error


def test_the_cli_serves_compiled(capsys):
    assert serve.main(["--arch", "gemma-2b", "--requests", "4", "--prompt-len", "8",
                       "--max-new", "3", "--device", "cpu"]) == 0
    assert "tokens_digest=" in capsys.readouterr().out
