"""The port's load generator (``repro_torch.runner.loadgen``) and its
``task="loadgen"`` cells on the CPU, against the reference
(``repro.runner.loadgen``, ``repro.runner.BenchmarkRunner``) on the same
inputs: the trace transforms, the knee, the knee-driven ``slots="auto"``
resolver with each fallback, the matrix's ``slots="auto"`` expansion, a
reduced fp32 gemma-2b cell's tokens, tokens that do not change with the
load, and the union of a trace's shards across two workers."""
import json
import os

import pytest
import torch

from repro.runner import loadgen as ref_loadgen
from repro.runner import scenario as ref_scenario
from repro.runner import traces as ref_traces
from repro.runner.runner import BenchmarkRunner as RefRunner
from repro_torch.runner import loadgen, traces
from repro_torch.runner.runner import BenchmarkRunner
from repro_torch.runner.scenario import Scenario, ScenarioMatrix
from repro_torch.telemetry.spans import recent_warnings

# tiny shapes: one intra-op thread each, as the suite runs in parallel workers
torch.set_num_threads(1)

#: the reference's fast load sweep (``benchmarks/loadgen_curve.py``)
SWEEP = dict(arch="gemma-2b", task="loadgen", batch=8, seq=8, slots=4,
             trace="bursty+bimodal")
LOADS = (0.5, 1.0, 2.0, 4.0)


@pytest.fixture(scope="module")
def runner():
    return BenchmarkRunner(device="cpu", runs=1, warmup=0, compile_warmup=0)


@pytest.mark.parametrize("split", ["0/1", "0/2", "1/2", "2/3", "", "2/2", "-1/2", "1/0",
                                   "a/b", "1", "1/2/3"])
def test_parse_split_matches_reference(split):
    def outcome(fn):
        try:
            return fn(split)
        except ValueError as e:
            return type(e)
    assert outcome(loadgen.parse_split) == outcome(ref_loadgen.parse_split)


@pytest.mark.parametrize("split,load", [("", 1.0), ("0/2", 2.0), ("1/2", 0.5),
                                        ("2/3", 4.0), ("0/4", 1.5)])
def test_shard_and_scale_match_reference(split, load):
    spec = dict(profile="bursty", requests=9, prompt_len=8, max_new=6,
                prompt_profile="bimodal")
    port = loadgen.scale_arrivals(loadgen.shard_requests(
        traces.generate(traces.TraceSpec(**spec), vocab=300), split), load)
    ref = ref_loadgen.scale_arrivals(ref_loadgen.shard_requests(
        ref_traces.generate(ref_traces.TraceSpec(**spec), vocab=300), split), load)
    assert [(r.rid, r.arrival_step, r.prompt.tolist()) for r in port] == \
        [(r.rid, r.arrival_step, r.prompt.tolist()) for r in ref]


def test_scale_arrivals_refuses_a_load_of_zero():
    for mod in (loadgen, ref_loadgen):
        with pytest.raises(ValueError):
            mod.scale_arrivals([], 0.0)


@pytest.mark.parametrize("points", [
    [],
    [dict(load=1.0, tok_per_s=10.0)],
    [dict(load=0.5, tok_per_s=10.0), dict(load=1.0, tok_per_s=19.0),
     dict(load=2.0, tok_per_s=19.5), dict(load=4.0, tok_per_s=19.6)],
    # a noisy plateau mid-curve does not end the search
    [dict(load=4.0, tok_per_s=30.0), dict(load=0.5, tok_per_s=10.0),
     dict(load=1.0, tok_per_s=10.2), dict(load=2.0, tok_per_s=20.0)],
    [dict(load=0.5, tok_per_s=0.0), dict(load=1.0, tok_per_s=5.0)],
])
def test_find_knee_matches_reference(points):
    assert loadgen.find_knee(points) == ref_loadgen.find_knee(points)


def _curve(path, **over):
    data = {"schema": loadgen.CURVE_SCHEMA, "arch": "gemma-2b", "slots": 4,
            "curves": {"batched": {"knee": {"knee_load": 2.0, "knee_tok_s": 100.0}}}}
    data.update(over)
    with open(path, "w") as f:
        json.dump(data, f)
    return str(path)


CURVES = {
    "knee_2": dict(),
    "knee_1": dict(curves={"batched": {"knee": {"knee_load": 1.0}}}),
    "knee_quarter": dict(curves={"batched": {"knee": {"knee_load": 0.25}}}),
    "stale-schema": dict(schema=1),
    "foreign-arch": dict(arch="mamba2-2.7b"),
    "degenerate-curve": dict(curves={"batched": {"knee": {"knee_load": 0.0}}}),
    "degenerate-slots": dict(slots=0),
}


@pytest.mark.parametrize("case", sorted(CURVES) + ["missing", "unreadable"])
def test_auto_slots_info_matches_reference_and_names_each_fallback(case, tmp_path):
    path = tmp_path / "curve.json"
    if case == "unreadable":
        path.write_text("{not json")
    elif case != "missing":
        _curve(path, **CURVES[case])
    n_warn = len(recent_warnings("slots_fallback"))
    got = loadgen.auto_slots_info("gemma-2b", str(path))
    assert got == ref_loadgen.auto_slots_info("gemma-2b", str(path))
    assert loadgen.auto_slots("gemma-2b", str(path)) == got[0]
    if got[1]:
        assert got[0] == loadgen.DEFAULT_SLOTS
        assert case.startswith(got[1]) or got[1] == "degenerate-curve"
        last = recent_warnings("slots_fallback")[-1]
        assert (last["reason"], last["arch"], last["path"]) == (got[1], "gemma-2b", str(path))
    else:
        assert len(recent_warnings("slots_fallback")) == n_warn


def test_the_port_reads_its_own_curve_not_the_references(tmp_path, monkeypatch):
    """A curve under the reference's variable never shapes a port matrix."""
    monkeypatch.delenv(loadgen.CURVE_PATH_ENV, raising=False)
    monkeypatch.setenv("REPRO_LOADGEN_CURVE", _curve(tmp_path / "ref.json"))
    monkeypatch.chdir(tmp_path)
    assert loadgen.CURVE_PATH_ENV != ref_loadgen.CURVE_PATH_ENV
    assert ref_loadgen.auto_slots_info("gemma-2b") == (3, "")
    assert loadgen.auto_slots_info("gemma-2b") == (loadgen.DEFAULT_SLOTS, "missing")
    os.makedirs(os.path.dirname(loadgen.CURVE_PATH))
    _curve(loadgen.CURVE_PATH, curves={"batched": {"knee": {"knee_load": 0.5}}})
    assert loadgen.auto_slots_info("gemma-2b") == (10, "")


@pytest.mark.parametrize("case", ["knee_2", "foreign-arch", "missing"])
def test_auto_slots_matrix_expands_as_the_reference(case, tmp_path, monkeypatch):
    path = str(tmp_path / "curve.json")
    if case != "missing":
        _curve(path, **CURVES[case])
    monkeypatch.setenv(loadgen.CURVE_PATH_ENV, path)
    monkeypatch.setenv(ref_loadgen.CURVE_PATH_ENV, path)
    axes = dict(archs=("gemma-2b", "mamba2-2.7b"), tasks=("serve", "loadgen", "infer_prefill"),
                slots=("auto", 2), loads=(1.0, 2.0), admissions=("batched", "single"))
    port, ref = ScenarioMatrix(**axes), ref_scenario.ScenarioMatrix(**axes)
    assert [s.to_dict() for s in port] == [s.to_dict() for s in ref]
    assert port.slots_fallback() == ref.slots_fallback()
    # a curve resolves its own arch's cells; the other arch's fall back
    fb = port.slots_fallback()
    assert any(n.startswith("gemma-2b/") for n in fb) == (case != "knee_2")
    assert any(n.startswith("mamba2-2.7b/") for n in fb) == (case != "foreign-arch")


def test_run_matrix_attaches_slots_fallback_to_each_auto_cell(tmp_path, monkeypatch, runner):
    monkeypatch.setenv(loadgen.CURVE_PATH_ENV, str(tmp_path / "none.json"))
    matrix = ScenarioMatrix(archs=("gemma-2b",), tasks=("serve",), batches=(2,), seqs=(8,),
                            slots=("auto", 2))
    out = runner.run_matrix(matrix)
    assert [rr.status for rr in out] == ["ok", "ok"]
    assert [rr.extra.get("slots_fallback") for rr in out] == ["missing", None]
    assert out[0].extra["slots"] == loadgen.DEFAULT_SLOTS


def test_loadgen_cell_matches_the_references_tokens(runner):
    sc = dict(SWEEP, load=2.0)
    rr = runner.run(Scenario(**sc))
    ref = RefRunner(runs=1, warmup=0).run(ref_scenario.Scenario(**sc), record=False)
    assert rr.status == "ok" and ref.status == "ok", (rr.error, ref.error)
    assert rr.name == ref.name
    assert rr.extra["tokens_digest"] == ref.extra["tokens_digest"]
    assert rr.extra["tokens"] == ref.extra["tokens"]
    assert (rr.extra["offered_load"], rr.extra["split"]) == (2.0, "")
    assert rr.extra["compiled"]


def test_tokens_do_not_change_with_the_load_or_the_policy(runner):
    matrix = ScenarioMatrix(archs=(SWEEP["arch"],), tasks=("loadgen",),
                            batches=(SWEEP["batch"],), seqs=(SWEEP["seq"],),
                            slots=(SWEEP["slots"],), traces=(SWEEP["trace"],), loads=LOADS,
                            admissions=("batched", "single"))
    out = runner.run_matrix(matrix)
    assert all(rr.status == "ok" for rr in out), [rr.error for rr in out]
    assert len({rr.extra["tokens_digest"] for rr in out}) == 1
    assert sorted(rr.extra["offered_load"] for rr in out) == sorted(LOADS * 2)
    # a higher load queues more requests at once: batched admission batches
    batched = {rr.extra["offered_load"]: rr for rr in out
               if rr.extra["admission"] == "batched"}
    assert batched[4.0].extra["admit_batch_max"] >= batched[0.5].extra["admit_batch_max"]
    knee = loadgen.find_knee([{"load": rr.extra["offered_load"],
                               "tok_per_s": rr.extra["tok_per_s"]}
                              for rr in batched.values()])
    assert knee["knee_load"] in LOADS


def test_shards_across_two_workers_union_to_the_whole(runner, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    whole = runner.run(Scenario(**SWEEP, load=2.0))
    n = SWEEP["batch"]
    matrix = ScenarioMatrix(archs=(SWEEP["arch"],), tasks=("loadgen",),
                            batches=(n,), seqs=(SWEEP["seq"],), slots=(SWEEP["slots"],),
                            traces=(SWEEP["trace"],), loads=(2.0,), splits=("0/2", "1/2"))
    sharded = BenchmarkRunner(device="cpu", runs=1, warmup=0, compile_warmup=0, jobs=2)
    try:
        shards = sharded.run_matrix(matrix)
    finally:
        sharded.close()
    assert [rr.status for rr in shards] == ["ok", "ok"], [rr.error for rr in shards]
    assert sorted(rr.extra["split"] for rr in shards) == ["0/2", "1/2"]
    assert all(rr.extra.get("isolated") for rr in shards)
    union = {}
    for rr in shards:
        i, k = loadgen.parse_split(rr.extra["split"])
        # each shard's tokens are in rid order of its own rids
        union.update(zip(range(i, n, k), rr.extra["tokens"]))
    assert [union[rid] for rid in range(n)] == whole.extra["tokens"]
    with pytest.raises(ValueError):
        Scenario(**SWEEP, split="02")
    empty = runner.run(Scenario(**dict(SWEEP, batch=1), split="1/2"))
    assert empty.status == "error" and "empty shard" in empty.error
