"""The port's runner, suite, harness, scenarios, results and the copied
numpy-only modules, on the CPU, against the reference where one exists."""
import dataclasses
import os

import numpy as np
import pytest
import torch

from repro.runner import latency as ref_latency
from repro.runner import scenario as ref_scenario
from repro.runner import traces as ref_traces
from repro.runner.results import RunResult as RefRunResult
from repro_torch.core import harness
from repro_torch.core.suite import build_arch, get_benchmark
from repro_torch.runner import latency, scenario, traces
from repro_torch.runner.results import ResultStore, RunResult
from repro_torch.runner.runner import BenchmarkRunner
from repro_torch.runner.scenario import Scenario, ScenarioMatrix

# tiny shapes: one intra-op thread each, as the suite runs in parallel workers
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def runner():
    return BenchmarkRunner(device="cpu", runs=2, warmup=0, compile_warmup=0)


@pytest.mark.parametrize("task", ["infer_prefill", "infer_decode", "serve"])
def test_runner_cells_are_ok_with_reference_record_fields(runner, task):
    rr = runner.run(Scenario(arch="gemma-2b", task=task, batch=1, seq=8))
    assert rr.status == "ok", rr.error
    assert rr.median_us > 0 and rr.runs > 0
    assert rr.extra["prov_framework"] == "torch" and rr.extra["prov_device"] == "cpu"
    assert [f.name for f in dataclasses.fields(RunResult)] == \
        [f.name for f in dataclasses.fields(RefRunResult)]
    assert set(rr.to_dict()) == {f.name for f in dataclasses.fields(RefRunResult)}
    if task == "serve":
        assert rr.extra["tokens_digest"] and rr.extra["ttft_p50"] > 0


def test_unported_tasks_and_modes_come_back_as_error_records(runner):
    """Every compiler mode runs now (``tests/test_torch_compilers.py``);
    the loadgen task is still refused, as an error record naming its
    ROADMAP item."""
    rr = runner.run(Scenario(arch="gemma-2b", task="loadgen", batch=1, seq=8))
    assert rr.status == "error" and "ROADMAP" in rr.error and "loadgen" in rr.error
    assert rr.name == "gemma-2b/loadgen/b1/s8/fp32/jit_donated/x4/uniform/L1"
    assert rr.extra["prov_framework"] == "torch"


@pytest.mark.parametrize("option", [dict(tracer=object()), dict(coverage=True)])
def test_unported_runner_options_raise(option):
    """Span tracing is still refused; coverage, refused until it was
    ported, is accepted (its cells: ``tests/test_torch_coverage.py``)."""
    if "coverage" in option:
        assert BenchmarkRunner(device="cpu", **option).coverage
        return
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        BenchmarkRunner(device="cpu", **option)


@pytest.mark.parametrize("option", [dict(isolate=True), dict(jobs=2),
                                    dict(cluster="local:2"), dict(jobs=4, profile=True)])
def test_dispatch_options_run_a_cell_ok(option, monkeypatch):
    """Each dispatch option, once refused, runs one cell on the CPU, in a
    worker subprocess on the runner's device."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    r = BenchmarkRunner(device="cpu", runs=1, warmup=0, compile_warmup=0, **option)
    sc = Scenario(arch="gemma-2b", task="infer_prefill", batch=1, seq=8)
    try:
        if option.get("isolate"):
            (rr,) = [r.run(sc)]
        else:
            (rr,) = r.run_matrix(ScenarioMatrix(archs=("gemma-2b",), tasks=("infer_prefill",),
                                                batches=(1,), seqs=(8,)))
    finally:
        r.close()
    assert rr.status == "ok", rr.error
    assert rr.name == sc.name and rr.extra["isolated"] and rr.extra["prov_device"] == "cpu"
    assert ("prof_util" in rr.extra) == bool(option.get("profile"))
    assert r.worker_pids() == []


def test_entry_points_default_to_the_card():
    """Without a card, the CUDA default raises instead of running on the
    CPU; with one, the suite builds on it."""
    if torch.cuda.is_available():
        assert build_arch("gemma-2b").model.device.type == "cuda"
        return
    for call in (lambda: build_arch("gemma-2b"), lambda: BenchmarkRunner()):
        with pytest.raises(RuntimeError, match="is_available"):
            call()


def test_donated_decode_threads_the_cache_and_undonated_copies_it():
    built = build_arch("gemma-2b", {"n_layers": 1}, device="cpu")
    step, args, donate = get_benchmark("gemma-2b", "infer_decode").make(
        batch=1, seq=4, built=built)
    cache = args[2]
    assert cache["blocks"]["len"].tolist() == [[4]]
    harness.measure("undonated", step, args, runs=2, warmup=0,
                    jitted=harness.prepare(step, (), mutable=donate))
    assert cache["blocks"]["len"].tolist() == [[4]]
    final = []
    harness.measure("donated", step, args, donate, runs=2, warmup=0,
                    jitted=harness.prepare(step, donate, mutable=donate),
                    final_args=final)
    assert cache["blocks"]["len"].tolist() == [[7]]     # 1 first call + 2 runs
    assert final[0][2] is cache


@pytest.mark.parametrize("kw", [
    dict(arch="gemma-2b", task="infer_decode", batch=4, seq=128, dtype="bf16"),
    dict(arch="gemma-2b", task="serve", batch=8, seq=32, trace="bursty+bimodal"),
    dict(arch="gemma-2b", task="serve", admission="single", mode="jit"),
    dict(arch="gemma-2b", task="loadgen", split="0/2", load=2.0),
])
def test_scenarios_match_reference_names_and_keys(kw):
    port, ref = Scenario(**kw), ref_scenario.Scenario(**kw)
    assert (port.name, port.bench, port.build_key()) == (ref.name, ref.bench, ref.build_key())
    assert port.to_dict() == ref.to_dict()


def test_scenario_validation_and_matrix_match_reference():
    for bad in (dict(task="nope"), dict(task="serve", mode="eager"),
                dict(task="infer_prefill", slots=2)):
        with pytest.raises(ValueError):
            Scenario(arch="gemma-2b", **bad)
        with pytest.raises(ValueError):
            ref_scenario.Scenario(arch="gemma-2b", **bad)
    axes = dict(archs=("gemma-2b",), tasks=("infer_prefill", "serve"),
                modes=("eager", "jit"), traces=("uniform", "bursty"),
                exclude=("bursty",))
    assert [s.name for s in ScenarioMatrix(**axes)] == \
        [s.name for s in ref_scenario.ScenarioMatrix(**axes)]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ScenarioMatrix(archs=("gemma-2b",), tasks=("serve",), slots=("auto",)).expand()


def test_run_matrix_runs_serially_and_records(tmp_path):
    store = ResultStore(str(tmp_path / "store"))
    r = BenchmarkRunner(store, device="cpu", runs=1, warmup=0, compile_warmup=0)
    out = r.run_matrix(ScenarioMatrix(archs=("gemma-2b",), tasks=("infer_prefill",),
                                      batches=(1,), seqs=(8,)))
    assert [rr.status for rr in out] == ["ok"]
    again = ResultStore(str(tmp_path / "store"))
    assert again.latest_result(out[0].name).extra["prov_framework"] == "torch"
    assert len(list(again.history())) == 1


@pytest.mark.parametrize("spec", [
    dict(profile="uniform", requests=5, prompt_len=9, max_new=4),
    dict(profile="bursty", requests=7, prompt_len=12, max_new=6, prompt_profile="bimodal"),
    dict(profile="mixed", requests=6, prompt_len=8, max_new=5, seed=3,
         prompt_profile="longtail"),
])
def test_copied_traces_and_latency_equal_reference(spec, tmp_path):
    port = traces.generate(traces.TraceSpec(**spec), vocab=300)
    ref = ref_traces.generate(ref_traces.TraceSpec(**spec), vocab=300)
    assert [(r.rid, r.prompt.tolist(), r.max_new, r.arrival_step) for r in port] == \
        [(r.rid, r.prompt.tolist(), r.max_new, r.arrival_step) for r in ref]
    assert traces.cache_len_bound(port) == ref_traces.cache_len_bound(ref)
    for r in port:
        r.out = [r.rid, 7]
    toks = traces.tokens_by_rid(port)
    assert traces.tokens_digest(toks) == ref_traces.tokens_digest(toks)
    cap = traces.capture_spec(port, seed=spec.get("seed", 0))
    path = traces.save_spec(cap, os.path.join(tmp_path, "t.json"))
    assert ref_traces.load_spec(path).prompt_lens == cap.prompt_lens
    vals = np.random.default_rng(0).random(11).tolist()
    assert latency.latency_summary(vals, "x", scale=1e6) == \
        ref_latency.latency_summary(vals, "x", scale=1e6)
    sc = dict(arch="gemma-2b", task="serve", batch=5, seq=16, trace="bursty+uniform")
    assert dataclasses.asdict(traces.spec_for_scenario(scenario.Scenario(**sc))) == \
        dataclasses.asdict(ref_traces.spec_for_scenario(ref_scenario.Scenario(**sc)))
