"""The compiler modes through the runner, on the CPU (``aot_eager``),
against the reference: each mode's record against the reference
runner's record of the same ``Scenario.name``, field for field (a
profiled eager cell's ``prof_skipped`` among them); ``ratio_table`` and
``compare_modes`` against the reference's on the same records; no
recompile across a cell's warm and timed calls, an error record at
Dynamo's recompile limit, and a cost pass that leaves later cells
compiled; ``op_class`` on Inductor's kernel names.

Tolerances: ratios equal to the reference's to 1e-12 (the same
arithmetic on the same numbers); the records' protocol fields exactly.
"""
import dataclasses

import pytest
import torch
from torch import _dynamo

from repro.core import compilers as ref_compilers
from repro.runner.runner import BenchmarkRunner as RefRunner
from repro.runner.scenario import Scenario as RefScenario
from repro_torch.core import compilers, harness
from repro_torch.core.harness import dynamo_counts
from repro_torch.core.hloanalysis import op_class
from repro_torch.core.suite import get_benchmark
from repro_torch.runner.results import RunResult
from repro_torch.runner.runner import BenchmarkRunner
from repro_torch.runner.scenario import MODES, Scenario

torch.set_num_threads(1)

CELL = dict(arch="gemma-2b", task="infer_prefill", batch=1, seq=8)
SAME = ("name", "bench", "arch", "task", "batch", "seq", "dtype", "mode", "status",
        "runs", "schema", "cache")


@pytest.fixture(scope="module")
def records():
    """Both packages' records of the gemma-2b prefill cell in every mode
    (eager and jit profiled)."""
    port = BenchmarkRunner(device="cpu", runs=2, warmup=0, compile_warmup=0)
    ref = RefRunner(runs=2, warmup=0, compile_warmup=0)
    out = {}
    for mode in MODES:
        prof = mode in ("eager", "jit")
        out[mode] = (port.run(Scenario(**CELL, mode=mode), profile=prof),
                     ref.run(RefScenario(**CELL, mode=mode), profile=prof))
    return out


@pytest.mark.parametrize("mode", MODES)
def test_each_mode_meets_the_reference_record(records, mode):
    rr, want = records[mode]
    assert rr.status == want.status == "ok", (rr.error, want.error)
    assert [f.name for f in dataclasses.fields(RunResult)] == list(want.to_dict())
    for field in SAME:
        assert getattr(rr, field) == getattr(want, field), field
    assert rr.p10_us <= rr.median_us <= rr.p90_us
    if mode == "eager":
        assert rr.compile_us == want.compile_us == 0.0
        assert rr.device_bytes_delta == want.device_bytes_delta == 0
        assert rr.extra["prof_skipped"] == want.extra["prof_skipped"] == "eager"
        assert not any(k.startswith("prof_") and k != "prof_skipped" for k in rr.extra)
    elif rr.cache["executable_reused"]:
        assert rr.compile_us == want.compile_us == 0.0
    else:
        assert rr.compile_us > 0 and want.compile_us > 0
    if mode == "jit":
        assert {k for k in rr.extra if k.startswith("prof_")} == \
            {k for k in want.extra if k.startswith("prof_")}
        assert rr.extra["prof_class_us"]["attention"] > 0


def test_ratio_table_matches_the_reference_on_the_same_records(records):
    for side in (0, 1):
        results = {"gemma-2b/infer_prefill": {m: records[m][side] for m in MODES}}
        got = compilers.ratio_table(results, base="jit")
        want = ref_compilers.ratio_table(results, base="jit")
        assert [r.keys() for r in got] == [r.keys() for r in want]
        for g, w in zip(got, want):
            for key, value in w.items():
                assert g[key] == pytest.approx(value, rel=1e-12, abs=0), key
        assert {r["mode"] for r in got} == set(MODES) - {"jit"}


class _Replay:
    """A runner that answers each scenario with a recorded result."""

    def __init__(self, by_mode):
        self.by_mode = by_mode

    def run(self, sc, runs=None):
        return self.by_mode[sc.mode]


def test_compare_modes_matches_the_reference_on_the_same_records(records):
    for side in (0, 1):
        replay = _Replay({m: records[m][side] for m in MODES})
        bench = get_benchmark("gemma-2b", "infer_prefill")
        got = compilers.compare_modes(bench, batch=1, seq=8, runner=replay)
        want = ref_compilers.compare_modes(bench, batch=1, seq=8, runner=replay)
        assert list(got) == list(want) == list(MODES)
        for mode in MODES:
            assert got[mode].to_dict() == want[mode].to_dict()
    failed = _Replay({m: RunResult.from_error(Scenario(**CELL, mode=m), "boom")
                      for m in MODES})
    with pytest.raises(RuntimeError, match="boom"):
        compilers.compare_modes(get_benchmark("gemma-2b", "infer_prefill"), batch=1,
                                seq=8, runner=failed)


def test_no_timed_call_recompiles_and_reruns_compile_nothing():
    runner = BenchmarkRunner(device="cpu", runs=3, warmup=1, compile_warmup=1)
    sc = Scenario(arch="gemma-2b", task="infer_decode", batch=1, seq=8, mode="jit_donated")
    c0 = dynamo_counts()
    first = runner.run(sc)
    c1 = dynamo_counts()
    again = runner.run(sc)
    c2 = dynamo_counts()
    assert first.status == again.status == "ok", (first.error, again.error)
    assert c1["frames"] - c0["frames"] <= 1 and c2["frames"] == c1["frames"]
    assert c2["graph_calls"] - c1["graph_calls"] == 1 + 1 + 3   # first, warm, timed
    assert again.compile_us == 0.0 and again.cache["executable_reused"]


def test_the_recompile_limit_is_an_error_record_not_an_uncompiled_run(monkeypatch):
    """Past Dynamo's limit on compiles of one step (every cell of a task
    shares it), the cell fails: nothing runs uncompiled under a jit
    name.  The limit is lowered to 1 here (``RECOMPILE_LIMIT`` is 64),
    from an empty Dynamo cache (earlier tests compiled the same step)."""
    _dynamo.reset()
    monkeypatch.setattr(harness, "RECOMPILE_LIMIT", 1)
    runner = BenchmarkRunner(device="cpu", runs=1, warmup=0, compile_warmup=0)
    cells = [Scenario(arch="gemma-2b", task="infer_decode", batch=b, seq=8, mode="jit")
             for b in (5, 6, 7)]
    first = runner.run(cells[0])
    for sc in cells[1:]:
        rr = runner.run(sc)
        if rr.status == "error":
            break
    monkeypatch.undo()
    harness.compile_step(lambda: None, "cpu")       # the limit back at 64
    assert _dynamo.config.recompile_limit == harness.RECOMPILE_LIMIT
    assert first.status == "ok", first.error
    assert rr.status == "error" and "recompile" in rr.error.lower(), rr.error


def test_a_profiled_cell_leaves_the_next_cells_compiled():
    """The cost pass runs the step under a dispatch mode; Dynamo entered
    there would leave the step's code uncompiled for every later cell of
    the task (the unrolled build here), which the graph-call check then
    refuses.  ``compile_step`` runs the pass's call uncompiled."""
    runner = BenchmarkRunner(device="cpu", runs=1, warmup=0, compile_warmup=0)
    for mode in ("jit", "jit_unrolled"):
        c0 = dynamo_counts()
        rr = runner.run(Scenario(**CELL, mode=mode), profile=True)
        assert rr.status == "ok", rr.error
        assert "prof_error" not in rr.extra
        assert dynamo_counts()["graph_calls"] - c0["graph_calls"] >= 2


@pytest.mark.parametrize("name,cls", [
    ("triton_poi_fused__to_copy_add_mul_0", "elementwise"),
    ("triton_poi_fused_addmm_gelu_3", "elementwise"),
    ("triton_red_fused__to_copy_mean_pow_rsqrt_1", "other"),
    ("triton_per_fused_add_mean_mul_pow_2", "other"),
    ("triton_tem_fused_mm_4", "matmul"),
    ("extern_kernels.mm", "matmul"),
    ("extern_kernels.bmm", "matmul"),
    ("fa_fwd_tc_kernel<128, 2>", "attention"),
    ("aten::add", "elementwise"),
])
def test_op_class_names_inductors_kernels(name, cls):
    assert op_class(name) == cls
