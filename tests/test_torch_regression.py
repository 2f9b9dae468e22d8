"""The port's perf-CI modules on the CPU, against the reference's.

* ``core/regression``: the same update, detect and bisect sequence gives
  equal ``Issue`` dicts, the same culprit and the same trace in both
  packages, and a store written by either reads the same in the other;
* ``core/roofline``: the same counts give the same ``Roofline``; the
  port's ``model_flops_estimate`` equals the reference's for all eight
  archs at every shape of ``SHAPES``;
* ``core/breakdown``: the same cells give the same rows and domain table;
  a profiled port record gives the reference's measured row; the port's
  analytic cells (``analyze_step`` + ``roofline_from_cost``) are rows;
* ``core/ci``: a CPU runner's nightly run files an injected slowdown, a
  refused cell as a ``status`` issue, and builds the reference's matrix.

No assertion here rests on one wall-clock reading: the injected slowdown
is added to every timed sample, and a clean night's drift is bounded the
way ``tests/test_system.py`` bounds it.
"""
import dataclasses

import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import SHAPES as REF_SHAPES
from repro.core import ci as ref_ci
from repro.core.breakdown import breakdown_rows as ref_breakdown_rows
from repro.core.breakdown import domain_table as ref_domain_table
from repro.core.breakdown import measured_breakdown_rows as ref_measured_rows
from repro.core.hardware import HardwareProfile as RefHardwareProfile
from repro.core.hloanalysis import HloCost as RefHloCost
from repro.core.regression import Commit as RefCommit
from repro.core.regression import MetricStore as RefMetricStore
from repro.core.regression import bisect_commits as ref_bisect
from repro.core.regression import detect as ref_detect
from repro.core.roofline import model_flops_estimate as ref_model_flops
from repro.core.roofline import roofline_from_cost as ref_roofline
from repro_torch.configs import ARCHS, SHAPES
from repro_torch.core import ci
from repro_torch.core.breakdown import (analytic_cells, breakdown_rows, domain_table,
                                        measured_breakdown_rows)
from repro_torch.core.hardware import DEFAULT_HW
from repro_torch.core.harness import RegressionHook
from repro_torch.core.hloanalysis import HloCost
from repro_torch.core.regression import (METRICS, THRESHOLD, Commit, MetricStore,
                                         bisect_commits, detect)
from repro_torch.core.roofline import Roofline, model_flops_estimate, roofline_from_cost
from repro_torch.core.suite import get_benchmark
from repro_torch.runner import BenchmarkRunner, Scenario
from repro_torch.runner.results import RunResult

torch.set_num_threads(1)

PORT_ARCHS = sorted(ARCHS)


# ---- regression -------------------------------------------------------------

def test_constants_are_the_references():
    from repro.core import regression as ref
    assert THRESHOLD == ref.THRESHOLD == 0.07 and METRICS == ref.METRICS


def _sequence(store_cls, detect_fn, path):
    """One baseline night of three benchmarks, then observations around
    the threshold on each metric; -> the issues as dicts."""
    store = store_cls(str(path))
    store.update("a/train", {"median_us": 100.0, "host_peak_bytes": 1000,
                             "device_bytes_delta": 0})
    store.update("b/infer_decode", {"median_us": 250.0, "host_peak_bytes": 4096,
                                    "device_bytes_delta": 1 << 20})
    store.update("a/train", {"median_us": 101.0, "host_peak_bytes": 1000,
                             "device_bytes_delta": 64})
    out = []
    for bench, obs, kw in (
            ("a/train", {"median_us": 106.0}, {}),
            ("a/train", {"median_us": 120.0, "host_peak_bytes": 1071,
                         "device_bytes_delta": 70}, {}),
            ("b/infer_decode", {"median_us": 268.0, "host_peak_bytes": 4096,
                                "device_bytes_delta": 3 << 20}, {}),
            ("b/infer_decode", {"median_us": 268.0}, {"threshold": 0.05}),
            ("b/infer_decode", {"device_bytes_delta": 9 << 20},
             {"metrics": ("median_us",)}),
            ("c/new", {"median_us": 1e9}, {})):
        out.append([i.to_dict() for i in detect_fn(store, bench, obs, **kw)])
    return out, store


def test_detect_gives_the_references_issues(tmp_path):
    got, _ = _sequence(MetricStore, detect, tmp_path / "port.json")
    want, _ = _sequence(RefMetricStore, ref_detect, tmp_path / "ref.json")
    assert got == want
    assert [len(i) for i in got] == [0, 3, 2, 1, 0, 0]


@pytest.mark.parametrize("culprit", [0, 5, 7, 11, None])
def test_bisection_finds_the_references_culprit(culprit):
    """12 commits of a day; from ``culprit`` on the median is 30% slower
    (None: no commit regressed)."""
    def runner(factor):
        return lambda bench: {"median_us": 100.0 * factor}

    results = []
    for commit_cls, bisect in ((Commit, bisect_commits), (RefCommit, ref_bisect)):
        commits = [commit_cls(sha=f"c{i:02d}", timestamp=i,
                              run=runner(1.3 if culprit is not None and i >= culprit else 1.0))
                   for i in reversed(range(12))]          # sorted by timestamp inside
        trace = []
        found = bisect(commits, "bench/a", "median_us", 100.0, trace=trace)
        results.append((None if found is None else found.sha, trace))
    assert results[0] == results[1]
    sha, trace = results[0]
    assert sha == (None if culprit is None else f"c{culprit:02d}")
    assert len(trace) <= 5                      # ceil(log2 12) + 1 measures


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_a_store_reads_the_same_in_both_packages(tmp_path, writer):
    path = str(tmp_path / "metrics.json")
    write_cls, read_cls = ((MetricStore, RefMetricStore) if writer == "port"
                           else (RefMetricStore, MetricStore))
    w = write_cls(path)
    w.update("gemma-2b/train", {"median_us": 1234.5, "host_peak_bytes": 10,
                                "device_bytes_delta": 0})
    w.update("mamba2-2.7b/infer_decode", {"median_us": 77.0, "host_peak_bytes": 3,
                                          "device_bytes_delta": 512})
    w.update("gemma-2b/train", {"median_us": 1200.0, "host_peak_bytes": 12,
                                "device_bytes_delta": 0})
    rr = RunResult(name="gemma-2b/train/b2/s64/fp32/jit_donated", bench="gemma-2b/train",
                   arch="gemma-2b", task="train", batch=2, seq=64, dtype="fp32",
                   mode="jit_donated", status="ok", median_us=1250.0, ts=5.0)
    w.log_result(rr)
    r = read_cls(path)
    assert r.data == w.data
    assert r.data["gemma-2b/train"]["median_us"] == 1200.0
    for bench in ("gemma-2b/train", "mamba2-2.7b/infer_decode"):
        assert r.baseline(bench) == w.baseline(bench)
        assert list(r.history(bench)) == list(w.history(bench))
    assert len(list(r.history("gemma-2b/train"))) == 2
    assert list(r.history(rr.name)) == list(w.history(rr.name))
    assert r.baseline(rr.name) is None       # a logged result is no baseline


# ---- roofline ---------------------------------------------------------------

def _ref_h100():
    return RefHardwareProfile(**dataclasses.asdict(DEFAULT_HW))


@pytest.mark.parametrize("flops,nbytes,coll", [(1e12, 1e9, 1e8), (1e9, 1e11, 0.0),
                                               (1e9, 1e6, 1e12), (0.0, 0.0, 0.0)])
def test_roofline_matches_the_reference(flops, nbytes, coll):
    costs = []
    for cls_ in (HloCost, RefHloCost):
        c = cls_()
        c.tally_flops("matmul", flops)
        c.tally_bytes("elementwise", nbytes)
        c.collective_bytes = coll
        c.collective_counts = {"all-reduce": 2} if coll else {}
        c.collective_bytes_by_op = {"all-reduce": coll} if coll else {}
        costs.append(c)
    kw = dict(arch="gemma-2b", shape="train_4k", mesh="1", chips=4, model_flops=5e11)
    got = roofline_from_cost(costs[0], **kw)
    want = ref_roofline(costs[1], hw=_ref_h100(), **kw)
    assert got.to_dict() == want.to_dict()
    assert got.hw == "h100_sxm" and Roofline.__dataclass_fields__["hw"].default == "h100_sxm"
    assert got.compute_s == pytest.approx(flops / DEFAULT_HW.peak_flops_bf16)


@pytest.mark.parametrize("arch", PORT_ARCHS)
def test_model_flops_match_the_reference(arch):
    assert set(SHAPES) == set(REF_SHAPES)
    kinds = set()
    for name in sorted(SHAPES):
        got = model_flops_estimate(ARCHS[arch], SHAPES[name])
        want = ref_model_flops(REF_ARCHS[arch], REF_SHAPES[name])
        assert got > 0 and abs(got - want) <= 1e-9 * want, (name, got, want)
        kinds.add(SHAPES[name].kind)
    assert kinds == {"train", "prefill", "decode"}


# ---- breakdown --------------------------------------------------------------

def _cells():
    cells = []
    for i, arch in enumerate(PORT_ARCHS + ["not-an-arch"]):
        cells.append({"arch": arch, "shape": "train_4k", "mesh": "1",
                      "roofline": {"compute_s": 0.1 * (i + 1), "memory_s": 0.3,
                                   "collective_s": 0.05 * i,
                                   "dominant": "compute" if i > 2 else "memory"}})
    cells.append({"arch": "gemma-2b", "shape": "prefill_32k"})      # no roofline
    cells.append({"arch": "gemma-2b", "shape": "decode_32k",
                  "roofline": {"compute_s": 0.0, "memory_s": 0.0, "collective_s": 0.0,
                               "dominant": "compute"}})
    return cells


def test_breakdown_rows_and_domain_table_match_the_reference():
    rows = breakdown_rows(_cells())
    assert rows == ref_breakdown_rows(_cells()) and len(rows) == len(PORT_ARCHS) + 1
    assert domain_table(rows) == ref_domain_table(rows)
    only_train = lambda r: r["shape"].startswith("train")   # noqa: E731
    assert domain_table(rows, only_train) == ref_domain_table(rows, only_train)
    assert {d["domain"] for d in domain_table(rows)} == {"NLP", "Multimodal", "Speech", "?"}


def test_a_profiled_port_record_gives_the_references_measured_row():
    r = BenchmarkRunner(device="cpu", runs=2, warmup=0, compile_warmup=0)
    rr = r.run(Scenario(arch="gemma-2b", task="infer_prefill", batch=1, seq=8),
               profile=True, record=False)
    plain = r.run(Scenario(arch="gemma-2b", task="infer_decode", batch=1, seq=8),
                  record=False)
    assert rr.status == plain.status == "ok", rr.error
    got = measured_breakdown_rows([rr, plain])
    assert got == ref_measured_rows([rr.to_dict(), plain.to_dict()])
    (row,) = got
    assert row["source"] == "measured" and row["cell"] == rr.name
    assert row["dominant"] in ("compute", "memory", "collective", "dispatch", "idle")


def test_analytic_cells_are_roofline_rows():
    r = BenchmarkRunner(device="cpu")
    benches = [get_benchmark("gemma-2b", "train"), get_benchmark("mamba2-2.7b", "infer_prefill")]
    cells = analytic_cells(benches, batch=1, seq=8, runner=r)
    rows = breakdown_rows(cells)
    assert rows == ref_breakdown_rows(cells)
    assert [(c["arch"], c["shape"]) for c in cells] == [("gemma-2b", "train"),
                                                       ("mamba2-2.7b", "infer_prefill")]
    for c, row in zip(cells, rows):
        rl = c["roofline"]
        assert row["source"] == "analytic" and rl["hw"] == "h100_sxm"
        assert abs(row["compute_frac"] + row["memory_frac"] + row["collective_frac"] - 1) < 1e-9
        assert rl["flops_global"] > 0 and rl["bytes_global"] > 0 and rl["model_flops"] > 0
        assert rl["compute_s"] == pytest.approx(rl["flops_global"] / DEFAULT_HW.peak_flops_bf16)


# ---- ci ---------------------------------------------------------------------

def test_nightly_detects_an_injected_slowdown(tmp_path):
    store = MetricStore(str(tmp_path / "metrics.json"))
    runner = BenchmarkRunner(device="cpu", runs=3, warmup=0, compile_warmup=1)
    kw = dict(archs=["gemma-2b"], tasks=("train",), runs=3, batches=(1,), seqs=(8,),
              runner=runner)
    rep0 = ci.run_nightly(store, update_baseline=True, **kw)
    assert rep0.ran == 1 and not rep0.issues
    assert set(store.baseline("gemma-2b/train")) == set(METRICS)
    # a clean night: at most the host's drift, bounded rather than pinned
    rep1 = ci.run_nightly(store, **kw)
    assert rep1.ran == 1 and all(i.metric != "status" for i in rep1.issues)
    noise = max((i.increase for i in rep1.issues if i.metric == "median_us"), default=0.0)
    assert runner.stats.executable_cache_hits >= 1
    hooks = {"gemma-2b/train": RegressionHook(slowdown_s=0.25, device="cpu")}
    rep2 = ci.run_nightly(store, hooks=hooks, **kw)
    hits = [i for i in rep2.issues
            if i.metric == "median_us" and i.benchmark == "gemma-2b/train"]
    assert hits and hits[0].increase > max(THRESHOLD, 2 * noise)
    assert hits[0].observed >= 0.25e6          # the slowdown is in every sample
    assert rep2.to_dict()["issues"][0]["benchmark"] == "gemma-2b/train"
    # every night's result is a history point; the baseline stayed night 0's
    assert len(list(store.history("gemma-2b/train/b1/s8/fp32/jit_donated"))) == 3


def test_a_refused_cell_is_a_status_issue(tmp_path):
    store = MetricStore(str(tmp_path / "metrics.json"))
    rep = ci.run_nightly(store, archs=["whisper-large-v3"], tasks=("train",), runs=1,
                         batches=(1,), seqs=(8,), update_baseline=True,
                         runner=BenchmarkRunner(device="cpu", runs=1, warmup=0,
                                                compile_warmup=0))
    (issue,) = rep.issues
    assert rep.ran == 1 and issue.metric == "status"
    assert issue.benchmark == "whisper-large-v3/train" and "item 15" in issue.culprit
    assert store.data == {}


class _Recorder:
    """A runner that records the matrix it is given and runs nothing."""

    def __init__(self):
        self.names = None

    def run_matrix(self, matrix, **kw):
        self.names = [sc.name for sc in matrix.expand()]
        return []

    def close(self):
        pass


@pytest.mark.parametrize("kw", [{}, {"tasks": ("infer_prefill",), "batches": (1, 4),
                                     "seqs": (8, 128)}])
def test_the_nightly_matrix_is_the_references(tmp_path, kw):
    names = []
    for mod, store_cls in ((ci, MetricStore), (ref_ci, RefMetricStore)):
        rec = _Recorder()
        rep = mod.run_nightly(store_cls(str(tmp_path / f"{mod.__name__}.json")),
                              archs=PORT_ARCHS, runner=rec, **kw)
        assert rep.ran == 0 and rep.issues == []
        names.append(rec.names)
    assert names[0] == names[1] and len(names[0]) == len(PORT_ARCHS) * (
        2 if not kw else 4)
