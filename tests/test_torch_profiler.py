"""The port's measured profiler on the CPU, against the reference's.

* ``Timeline``, ``attribute``, ``detect``, ``build_report`` and
  ``format_table`` give the reference's results exactly on the fixtures of
  ``tests/test_profiler.py``, run through both packages;
* ``op_class`` names every ``__global__`` of ``src/repro_torch/csrc/*.cu``
  attention, and library kernels their classes;
* each kernel's ``cost()`` against a hand count at two shapes;
* ``analyze_step``'s matmul + attention flops against the reference's
  ``analyze_hlo`` on the same reduced gemma-2b cells;
* the runner's profiled cells (train, infer_prefill, infer_decode, a
  bursty serve) carry the reference's ``prof_*`` keys, with fractions
  summing to 1.
"""
import copy
import json
import math
import pathlib
import re

import numpy as np
import pytest
import torch

from repro.core.hloanalysis import HloCost as RefHloCost
from repro.profiler import Thresholds as RefThresholds
from repro.profiler import Timeline as RefTimeline
from repro.profiler import attribute as ref_attribute
from repro.profiler import build_report as ref_build_report
from repro.profiler import detect as ref_detect
from repro.profiler import format_table as ref_format_table
from repro.profiler.timeline import PhaseSample as RefPhaseSample
from repro.runner import BenchmarkRunner as RefRunner
from repro.runner import Scenario as RefScenario
from repro_torch.core import harness
from repro_torch.core.hardware import DEFAULT_HW
from repro_torch.core.hloanalysis import OP_CLASSES, HloCost, analyze_step, op_class
from repro_torch.core.suite import build_arch, get_benchmark
from repro_torch.kernels import accounting
from repro_torch.kernels.flash_attention import kernel as fa
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.rglru import kernel as rk
from repro_torch.kernels.ssd import kernel as sk
from repro_torch.launch.serve import ServeEngine, summarize_metrics
from repro_torch.profiler import (Thresholds, Timeline, attribute, build_report,
                                  detect, format_table, profile_extra, trace_device_time)
from repro_torch.profiler.attribution import trace_phases
from repro_torch.profiler.timeline import PhaseSample
from repro_torch.runner import BenchmarkRunner, Scenario, ScenarioMatrix
from repro_torch.runner.traces import TraceSpec, cache_len_bound, generate

# tiny shapes: one intra-op thread each, as the suite runs in parallel workers
torch.set_num_threads(1)

PROF_FRACS = ("prof_frac_compute", "prof_frac_memory", "prof_frac_collective",
              "prof_frac_dispatch", "prof_frac_idle")
CSRC = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"


def _frac_sum(extra):
    return sum(extra[k] for k in PROF_FRACS)


# ---- the reference's fixtures, through both packages ------------------------

def _costs(tallies, collective_bytes=0.0):
    """The same cost in both packages: ``tallies`` {class: (flops, bytes)}."""
    out = []
    for cls_ in (RefHloCost, HloCost):
        c = cls_()
        for k, (f, b) in tallies.items():
            c.tally_flops(k, f)
            c.tally_bytes(k, b)
        c.collective_bytes = collective_bytes
        out.append(c)
    return out


def _timelines(dispatch=100.0, device=900.0, n=3, idle=0.0):
    return (RefTimeline(kind="step", samples=[RefPhaseSample(dispatch, device)] * n,
                        idle_us=idle),
            Timeline(kind="step", samples=[PhaseSample(dispatch, device)] * n,
                     idle_us=idle))


ATTRIBUTION_CASES = {
    # test_attribute_fractions_sum_and_split
    "split": (lambda: _timelines(),
              {"matmul": (1e12, 1e6), "elementwise": (1e3, 1e9)}, 0.0),
    # test_attribute_empty_cost_lands_in_idle
    "empty": (lambda: _timelines(), {}, 0.0),
    # test_attribute_serve_idle_share
    "serve_idle": (lambda: tuple(cls.from_phase_log([(1e-4, 9e-4)] * 10, kind="decode_step",
                                                    wall_s=0.02)
                                 for cls in (RefTimeline, Timeline)),
                   {"matmul": (1e9, 1e6)}, 0.0),
    # every class and the collective's wire bytes, with idle
    "all_classes": (lambda: _timelines(30.0, 470.0, 5, idle=250.0),
                    {"matmul": (4e9, 2e6), "attention": (1e8, 5e7),
                     "collective": (0.0, 3e6), "elementwise": (2e5, 8e7),
                     "other": (1e4, 1e6)}, 9e6),
}


@pytest.mark.parametrize("case", sorted(ATTRIBUTION_CASES))
def test_timeline_and_attribute_equal_the_reference(case):
    timelines, tallies, wire = ATTRIBUTION_CASES[case]
    ref_tl, tl = timelines()
    ref_cost, cost = _costs(tallies, wire)
    assert tl.to_extra() == ref_tl.to_extra()
    # the same numbers: the port's H100 peaks in both (the reference's
    # default is its TPU's)
    got, want = attribute(tl, cost), ref_attribute(ref_tl, ref_cost, DEFAULT_HW)
    assert got.to_extra() == want.to_extra()
    assert got.fractions() == want.fractions()
    assert abs(sum(got.fractions().values()) - 1.0) < 1e-9


def _rec(name, task="train", status="ok", compile_us=0.0, wall_s=1.0, **extra):
    return {"name": name, "task": task, "status": status,
            "compile_us": compile_us, "wall_s": wall_s, "extra": extra}


def _prof(mem=0.2, comp=0.6, disp=0.1, util=1e-3, **kw):
    return dict(prof_frac_memory=mem, prof_frac_compute=comp,
                prof_frac_collective=0.0, prof_frac_dispatch=disp,
                prof_frac_idle=max(0.0, 1.0 - mem - comp - disp),
                prof_util=util, **kw)


DETECTOR_CASES = {
    "data_movement": [_rec("a/train/x", **_prof(mem=0.8, comp=0.1)),
                      _rec("b/train/x", **_prof(mem=0.3, comp=0.6))],
    "dispatch_bound": [_rec("a/x", **_prof(mem=0.2, comp=0.2, disp=0.5)),
                       _rec("b/x", **_prof(disp=0.1))],
    "low_util": [_rec(f"c{i}/x", **_prof(util=1e-3)) for i in range(4)]
    + [_rec("slow/x", **_prof(util=1e-5))],
    "low_util_too_few": [_rec("slow/x", **_prof(util=1e-5)), _rec("c0/x", **_prof(util=1e-3))],
    "compile_outlier": [_rec(f"c{i}/x", compile_us=2e5) for i in range(3)]
    + [_rec("big/x", compile_us=5e6)],
    "compile_small": [_rec("s0/x", compile_us=10.0), _rec("s1/x", compile_us=10.0),
                      _rec("sbig/x", compile_us=400.0)],
    "queue_saturation": [_rec("s/serve/x", task="serve", slots=2, queue_depth_mean=5.0,
                              queue_depth_max=9, trace="bursty"),
                         _rec("ok/serve/x", task="serve", slots=4, queue_depth_mean=1.0,
                              queue_depth_max=3, trace="uniform")],
    "shard_imbalance": [_rec("a/x", wall_s=10.0, shard=0), _rec("b/x", wall_s=1.0, shard=1)],
    "shard_balanced": [_rec("a/x", wall_s=5.0, shard=0), _rec("b/x", wall_s=4.5, shard=1)],
    "ranked_report": [_rec("crit/x", **_prof(mem=0.9, comp=0.05)),
                      _rec("warn/x", **_prof(mem=0.6, comp=0.2)),
                      _rec("c0/x", compile_us=1e5), _rec("c1/x", compile_us=1e5),
                      _rec("big/x", compile_us=9e6)],
}


@pytest.mark.parametrize("case", sorted(DETECTOR_CASES))
def test_detect_and_report_equal_the_reference(case):
    recs = DETECTOR_CASES[case]
    got, want = detect(copy.deepcopy(recs)), ref_detect(copy.deepcopy(recs))
    assert [f.to_dict() for f in got] == [f.to_dict() for f in want]
    report = build_report(recs, got, meta={"case": case})
    assert report == ref_build_report(recs, want, meta={"case": case})
    assert json.loads(json.dumps(report)) == report
    assert format_table(report) == ref_format_table(report)
    assert format_table(report, max_rows=1) == ref_format_table(report, max_rows=1)
    # pinned thresholds give the same findings too
    assert [f.to_dict() for f in detect(recs, Thresholds(dispatch_frac=0.05))] == \
        [f.to_dict() for f in ref_detect(recs, RefThresholds(dispatch_frac=0.05))]


def test_measured_class_times_replace_the_roofline_weights():
    """With the trace's class times, device time splits by them; a class
    the costs cannot explain lands in idle, and the fractions still sum
    to 1."""
    _, tl = _timelines()
    _, cost = _costs({"matmul": (1e12, 1e6), "elementwise": (1e3, 1e9)})
    att = attribute(tl, cost, class_us={"matmul": 30.0, "elementwise": 50.0, "other": 20.0})
    assert att.class_frac == pytest.approx({"matmul": 0.3, "attention": 0.0, "collective": 0.0,
                                            "elementwise": 0.5, "other": 0.2}, abs=1e-12)
    assert abs(sum(att.fractions().values()) - 1.0) < 1e-9
    assert att.frac_idle == pytest.approx(0.9 * 0.2)       # "other" has no cost
    assert att.frac_dispatch == pytest.approx(0.1)
    # bound and util come from the costs alone
    assert att.bound_us == attribute(tl, cost).bound_us


# ---- op classes -----------------------------------------------------------------

def _global_names():
    names = set()
    for path in CSRC.glob("*.cu"):
        text = path.read_text()
        for m in re.finditer(r"__global__\s+(?:void\s+)?(?:__launch_bounds__\([^)]*\)\s+)?"
                             r"(?:void\s+)?(\w+)\s*\(", text):
            names.add(m.group(1))
    return sorted(names)


def test_every_kernel_of_the_port_is_attention():
    names = _global_names()
    assert len(names) >= 15 and {"fa_tc_kernel", "ssd_chunk_scan_kernel",
                                 "rglru_chunked_kernel", "fa_bwd_tc_dkv"} <= set(names)
    for name in names:
        # as torch.profiler names them: demangled, in namespaces, templated
        for shown in (name, f"void (anonymous namespace)::tc::{name}<256, 2>(FaParams)",
                      f"void simt::{name}<float>(float const*, int)"):
            assert op_class(shown) == "attention", shown


@pytest.mark.parametrize("name,cls", [
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64_warpgroupsize1x1x1", "matmul"),
    ("nvjet_tst_192x192_64x4_1x2_h_bz_coopA_TNT", "matmul"),
    ("void cutlass::Kernel2<cutlass_80_wmma_tensorop_bf16_s161616gemm_bf16_16x16_128x2_tn>",
     "matmul"),
    ("void gemv2T_kernel_val<int, int, float, float, float, float, 128, 16, 4, 4>", "matmul"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::BinaryFunctor<float>>",
     "elementwise"),
    ("void at::native::unrolled_elementwise_kernel<at::native::direct_copy_kernel_cuda>",
     "elementwise"),
    ("void at::native::(anonymous namespace)::multi_tensor_apply_kernel<TensorListMetadata<4>>",
     "elementwise"),
    ("Memcpy HtoD (Pageable -> Device)", "elementwise"),
    ("ncclDevKernel_AllReduce_Sum_bf16_RING_LL(ncclDevKernelArgsStorage<4096ul>)", "collective"),
    ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float>>", "other"),
    ("void at::native::(anonymous namespace)::cunn_SoftMaxForward<4, float>", "other"),
    ("aten::mm", "matmul"), ("aten.addmm.default", "matmul"), ("aten::bmm", "matmul"),
    ("aten::baddbmm", "matmul"), ("aten::add_", "elementwise"), ("aten.mul.Tensor", "elementwise"),
    ("aten::_to_copy", "elementwise"), ("aten::copy_", "elementwise"),
    ("aten::rsqrt", "elementwise"), ("aten::sum", "other"), ("aten::embedding", "other"),
])
def test_op_class_of_library_kernels_and_aten_ops(name, cls):
    assert op_class(name) == cls
    assert cls in OP_CLASSES


# ---- each kernel's work, by hand ------------------------------------------------

@pytest.mark.parametrize("shape", [
    # B, Sq, Sk, H, K, D, dtype, mask kwargs, visible pairs (by hand)
    (1, 4, 4, 2, 1, 8, torch.float32, dict(mask_type="causal"), 10),
    (2, 3, 6, 4, 2, 16, torch.bfloat16, dict(mask_type="local", window=2, q_offset=3,
                                             kv_len=torch.tensor([6, 5])), 6 + 5),
])
def test_flash_attention_cost_by_hand(shape):
    B, Sq, Sk, H, K, D, dtype, kw, pairs = shape
    flops, nbytes = fa.cost(B, Sq, Sk, H, K, D, dtype, **kw)
    assert flops == 4 * D * H * pairs
    vis = fa.visible(B, Sq, Sk, mask_type=kw["mask_type"], window=kw.get("window", 0),
                     prefix_len=0, q_offset=kw.get("q_offset", 0), kv_len=kw.get("kv_len"))
    assert int(vis.sum()) == pairs
    # keys some query sees: causal 4 (one row); local window 2 from
    # offset 3: keys 2..5 of row 0, 2..4 of row 1 (kv_len 5)
    kv_rows = 4 if B == 1 else 4 + 3
    elem = 4 if dtype == torch.float32 else 2
    assert nbytes == elem * (2 * B * Sq * H * D + 2 * kv_rows * K * D)
    bflops, bbytes = fa.cost_bwd(B, Sq, Sk, H, K, D, dtype, **kw)
    assert bflops == 10 * D * H * pairs
    assert bbytes == elem * 4 * D * (B * Sq * H + B * Sk * K)


@pytest.mark.parametrize("shape", [(1, 64, 2, 8, 16, torch.float32, False),
                                   (2, 300, 3, 16, 8, torch.bfloat16, True)])
def test_ssd_cost_by_hand(shape):
    B, S, H, P, N, dtype, init = shape
    flops, nbytes = sk.cost(B, S, H, P, N, dtype, init)
    chunks = [S] if S <= 256 else [256, S - 256]
    want = sum(B * (2 * n * n * N + H * (2 * n * n * P + 4 * n * N * P)) for n in chunks)
    assert flops == want
    elem = 4 if dtype == torch.float32 else 2
    state = 4 * B * H * P * N
    assert nbytes == (elem * (2 * B * S * H * P + 2 * B * S * N) + 4 * (B * S * H + H)
                      + state * (2 if init else 1))


@pytest.mark.parametrize("shape", [(1, 16, 8, False), (3, 5, 7, True)])
def test_rglru_cost_by_hand(shape):
    B, S, D, init = shape
    assert rk.cost(B, S, D, init) == (7 * B * S * D, 4 * (3 * B * S * D + init * B * D))


# ---- the eager step's costs against the reference's HLO -------------------------

CELLS = {
    "train": dict(task="train", batch=1, seq=8),
    "infer_prefill": dict(task="infer_prefill", batch=1, seq=8),
    "infer_decode": dict(task="infer_decode", batch=1, seq=8),
    "serve": dict(task="serve", batch=4, seq=8, slots=2, trace="bursty"),
}


@pytest.fixture(scope="module")
def reference():
    """The reference's profiled records of the four cells and its HLO
    costs (the runner caches one per scenario)."""
    r = RefRunner(runs=2, warmup=0)
    try:
        out = {}
        for name, kw in CELLS.items():
            sc = RefScenario(arch="gemma-2b", **kw)
            rr = r.run(sc, profile=True, record=False)
            assert rr.status == "ok", rr.error
            out[name] = (rr, r._prof_costs.get(sc))
        return out
    finally:
        r.close()


@pytest.fixture(scope="module")
def runner():
    return BenchmarkRunner(device="cpu", runs=2, warmup=0, compile_warmup=0)


@pytest.mark.parametrize("task", ["infer_prefill", "train"])
def test_analyze_step_flops_match_the_reference_hlo(reference, runner, task):
    """matmul + attention flops of the eager step against the dots of the
    compiled XLA step.  XLA's dots multiply every (query, key) pair of the
    attention; the kernel's count (``cost()``) takes the visible pairs
    only, so the two differ by 4 D H flops a masked pair and forward call
    (train: 8 of them, 4 layers recomputed once under remat="full").  The
    train cell's backward is one call a layer on the CPU too
    (``PlainFlashAttention``), counted by ``cost_bwd``: five products of
    2 D H flops a visible pair, where XLA's gradient makes four over every
    pair.  With those differences added back they agree to 1e-9; without,
    within 1% at this size."""
    sc = Scenario(arch="gemma-2b", **CELLS[task])
    rr = runner.run(sc, profile=True, record=False)
    assert rr.status == "ok", rr.error
    cost = runner._prof_costs[sc]
    _, ref_cost = reference[task]
    want = ref_cost.flops_by_class.get("matmul", 0.0) + ref_cost.flops_by_class.get("attention", 0.0)
    got = cost.flops_by_class.get("matmul", 0.0) + cost.flops_by_class.get("attention", 0.0)
    cfg = build_arch("gemma-2b", device="cpu").cfg
    D, H, L = cfg.head_dim, cfg.n_heads, cfg.n_layers
    if task == "train":      # fresh sequences from 0, Sk = Sq = 8: causal
        calls, visible, masked = 2 * L, 36, 8 * 8 - 36
        assert cost.notes == [f"kernel calls: flash_attention {calls}, "
                              f"flash_attention_bwd {L}"]
        bwd = L * 2 * D * H * (4 * (visible + masked) - 5 * visible)
    else:                    # the threaded cache's offset is past its 16 slots
        calls, masked, bwd = L, 0, 0
        assert cost.notes == [f"kernel calls: flash_attention {calls}"]
    assert abs(got + calls * 4 * D * H * masked + bwd - want) <= 1e-9 * want
    assert abs(got - want) <= 0.01 * want
    assert abs(sum(cost.flops_by_class.values()) - cost.flops) <= 1e-9 * cost.flops
    assert abs(sum(cost.bytes_by_class.values()) - cost.bytes_accessed) <= 1e-9 * cost.bytes_accessed


# ---- the runner's profiled cells ---------------------------------------------

@pytest.mark.parametrize("name", sorted(CELLS))
def test_profiled_cells_carry_the_reference_keys(reference, runner, name):
    sc = Scenario(arch="gemma-2b", **CELLS[name])
    rr = runner.run(sc, profile=True, record=False)
    assert rr.status == "ok", rr.error
    e = rr.extra
    ref_rr, _ = reference[name]
    assert {k for k in e if k.startswith("prof_")} == \
        {k for k in ref_rr.extra if k.startswith("prof_")}
    assert abs(_frac_sum(e) - 1.0) < 1e-9
    assert abs(sum(e["prof_class_frac"].values()) - 1.0) < 1e-9
    assert e["prof_class_us"]["attention"] > 0 and e["prof_flops"] > 0
    assert e["prof_util"] > 0 and "prof_error" not in e
    assert set(e["trace_clamp"]) == {"samples", "busy_over_wall_max"}
    assert json.loads(json.dumps(rr.to_dict()))["extra"]["prof_steps"] == e["prof_steps"]
    if name == "serve":
        assert e["prof_kind"] == "decode_step"
        assert e["prof_steps"] == e["decode_steps"]
        assert e["prof_idle_us"] > 0     # admission and prefill, outside decode steps
    else:
        assert e["prof_kind"] == "step" and e["prof_steps"] == 2
        assert len(e["prof_timeline"]) == 2
    for d, v in e["prof_timeline"]:
        assert d >= 0 and v > 0


def test_unprofiled_run_records_no_prof_keys(runner):
    rr = runner.run(Scenario(arch="gemma-2b", task="infer_prefill", batch=1, seq=8),
                    record=False)
    assert rr.status == "ok"
    assert not any(k.startswith("prof_") for k in rr.extra)


def test_profile_overhead_within_tolerance():
    """The timed loop is the same with and without the profile: its trace
    and cost pass run after it.  Checked on the step's calls, which the
    machine's load cannot move (two wall-clock medians can): a profiled
    run makes the unprofiled run's calls first, none of them under a trace
    or an analysis pass, and only then the traced and analysed ones."""
    r = BenchmarkRunner(device="cpu", runs=3, warmup=1, compile_warmup=0)
    sc = Scenario(arch="gemma-2b", task="train", batch=1, seq=8)
    assert r.run(sc, record=False, runs=1).status == "ok"     # builds the cell
    entry = r._execs[sc]
    step, calls = entry.jitted, []

    def counted(*args):
        calls.append((torch.autograd._profiler_enabled(), bool(accounting._passes)))
        return step(*args)

    entry.jitted = counted
    base = r.run(sc, record=False)
    base_calls = calls[:]
    del calls[:]
    prof = r.run(sc, record=False, profile=True)
    assert base.status == prof.status == "ok"
    n = 1 + 1 + 3            # measure's first call, the warmup, the timed runs
    assert base_calls == [(False, False)] * n
    assert calls[:n] == base_calls
    after = calls[n:]
    assert after.count((True, False)) == 3 and after.count((False, True)) == 1
    assert len(after) == 4
    assert not any(k.startswith("prof_") for k in base.extra)
    assert {"prof_dispatch_us_mean", "prof_device_us_mean", *PROF_FRACS} <= set(prof.extra)
    assert "prof_error" not in prof.extra


def test_profile_through_the_runner_setting_and_the_matrix():
    r = BenchmarkRunner(device="cpu", runs=1, warmup=0, compile_warmup=0, profile=True)
    m = ScenarioMatrix(archs=("gemma-2b",), tasks=("infer_prefill",), batches=(1,), seqs=(8,))
    (rr,) = r.run_matrix(m)
    assert rr.status == "ok" and abs(_frac_sum(rr.extra) - 1.0) < 1e-9
    (rr,) = r.run_matrix(m, profile=False)
    assert not any(k.startswith("prof_") for k in rr.extra)


def _state_values(x):
    if isinstance(x, torch.Tensor):
        return [x.detach().clone()]
    if isinstance(x, torch.nn.Module):
        return [t.detach().clone() for t in list(x.parameters()) + list(x.buffers())]
    if isinstance(x, dict):
        return [v for k in sorted(x) for v in _state_values(x[k])]
    if isinstance(x, (list, tuple)):
        return [v for t in x for v in _state_values(t)]
    return []


@pytest.mark.parametrize("task", ["train", "infer_decode"])
def test_analyze_step_leaves_donated_state_unchanged(task):
    built = build_arch("gemma-2b", {"n_layers": 2}, device="cpu")
    step, args, donate = get_benchmark("gemma-2b", task).make(batch=1, seq=8, built=built)
    fn = harness.prepare(step, donate, mutable=donate)
    before = _state_values(args[donate[0]])
    entries = dict(args[2]) if task == "infer_decode" else None
    cost = analyze_step(fn, args, donate)
    assert cost.flops > 0 and cost.flops_by_class["attention"] > 0
    after = _state_values(args[donate[0]])
    assert len(before) == len(after)
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    if entries is not None:
        assert all(args[2][k] is v for k, v in entries.items())
    # the step still runs on the restored state, in place
    out = fn(*args)
    if task == "train":
        assert torch.isfinite(out[1]["loss"]) and out[0][0] is args[0][0]
    else:
        assert out[1] is args[2]


def test_measure_splits_each_sample_into_host_and_busy_time():
    built = build_arch("gemma-2b", {"n_layers": 1}, device="cpu")
    step, args, donate = get_benchmark("gemma-2b", "infer_prefill").make(
        batch=1, seq=8, built=built)
    log, trace, events = [], {}, []
    m = harness.measure("p", step, args, donate, runs=4, warmup=1,
                        jitted=harness.prepare(step, donate, mutable=donate),
                        phase_log=log, device_trace=trace, events=events, device="cpu")
    assert len(log) == 4 and m.runs == 4
    assert [e[0] for e in events] == ["compile", "warm", "measure"]
    assert trace["steps"] == 3 and trace["busy_us"] > 0
    assert abs(sum(trace["class_us"].values()) - trace["busy_us"]) < 1e-6 * trace["busy_us"]
    assert trace["class_us"]["attention"] > 0 and trace["class_us"]["matmul"] > 0
    for dispatch_s, device_s in log:
        assert dispatch_s >= 0 and 0 < device_s <= trace["busy_us"] * 1e-6 + 1e-12
    walls = [d + v for d, v in log]
    assert trace["busy_over_wall_max"] == pytest.approx(trace["busy_us"] * 1e-6 / min(walls))
    assert trace["clamped_samples"] == sum(w < trace["busy_us"] * 1e-6 for w in walls)


def test_a_profile_traces_the_device_it_is_given():
    """No profile guesses its device: ``measure`` wants one, and the trace
    defaults to the card, which a machine without one refuses (and a card
    refuses to call a step on the CPU its device time)."""
    step, args, donate = get_benchmark("gemma-2b", "infer_prefill").make(
        batch=1, seq=8, built=build_arch("gemma-2b", {"n_layers": 1}, device="cpu"))
    with pytest.raises(ValueError, match="device="):
        harness.measure("p", step, args, donate, runs=1, warmup=0, phase_log=[])
    w = torch.randn(32, 32)
    with pytest.raises(RuntimeError):
        trace_device_time(lambda: w @ w, 1)
    trace = {}
    trace_phases(lambda: w @ w, 1, [1.0], [], trace, "cuda")
    assert trace["error"].startswith("RuntimeError")
    extra = profile_extra([], HloCost(), device_trace=trace, device="cpu")
    assert extra["prof_error"] == trace["error"]


def test_samples_shorter_than_the_trace_are_recorded_as_clamped():
    """A sample whose wall W is below the traced busy time per step B is
    clamped (device W, host 0), and the profile says so in ``trace_clamp``,
    outside the ``prof_`` keys; an unclamped one records 0 samples there."""
    w = torch.randn(256, 256)
    log, trace = [], {}
    trace_phases(lambda: w @ w, 2, [1e-9, 10.0], log, trace, "cpu")
    busy_s = trace["busy_us"] * 1e-6
    assert 1e-9 < busy_s < 10.0
    assert log == [(0.0, 1e-9), (10.0 - busy_s, busy_s)]
    assert trace["clamped_samples"] == 1
    assert trace["busy_over_wall_max"] == pytest.approx(busy_s / 1e-9)
    extra = profile_extra(log, HloCost(), device_trace=trace, device="cpu")
    assert extra["trace_clamp"] == {"samples": 1,
                                    "busy_over_wall_max": trace["busy_over_wall_max"]}
    log, trace = [], {}
    trace_phases(lambda: w @ w, 2, [10.0], log, trace, "cpu")
    assert trace["clamped_samples"] == 0
    extra = profile_extra(log, HloCost(), device_trace=trace, device="cpu")
    assert extra["trace_clamp"]["samples"] == 0
    assert extra["trace_clamp"]["busy_over_wall_max"] == trace["busy_over_wall_max"]


def test_serve_phase_log_leaves_the_replay_unchanged():
    built = build_arch("gemma-2b", {"n_layers": 2}, device="cpu")
    reqs = generate(TraceSpec(profile="bursty", requests=5, prompt_len=8, max_new=4),
                    vocab=built.cfg.vocab)
    eng = ServeEngine(built, slots=2, max_len=cache_len_bound(reqs))
    plain = summarize_metrics(eng.run(reqs))
    log, trace = [], {}
    out = eng.run(reqs, phase_log=log, device_trace=trace)
    assert summarize_metrics(out)["tokens_digest"] == plain["tokens_digest"]
    assert len(log) == out["decode_steps"] and trace["busy_us"] > 0
    again = summarize_metrics(eng.run(reqs))
    assert again["tokens_digest"] == plain["tokens_digest"]
    assert again["admit_shapes"] == plain["admit_shapes"]


def test_trace_classes_the_cpu_kernel_calls_as_attention():
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 16, 2, 8, generator=g) for _ in range(3))
    w = torch.randn(64, 64, generator=g)
    busy, by_class = trace_device_time(lambda: flash_attention(q, k, v), 2, device="cpu")
    assert by_class["attention"] > 0 and by_class["attention"] == pytest.approx(busy)
    busy, by_class = trace_device_time(lambda: w @ w, 2, device="cpu")
    assert by_class["matmul"] > 0 and by_class["attention"] == 0.0


@pytest.mark.parametrize("call", ["jobs", "tracer", "coverage", "cluster"])
def test_dispatch_tracing_and_coverage_still_raise(call, monkeypatch):
    """Tracing still raises; dispatch and coverage are ported, so a
    profiled matrix through the pool or the cluster runs, with the
    profile, and a profiled cell of a coverage runner carries both."""
    m = ScenarioMatrix(archs=("gemma-2b",), tasks=("infer_prefill",), batches=(1,), seqs=(8,))
    if call in ("jobs", "cluster"):
        monkeypatch.setenv("OMP_NUM_THREADS", "1")
        r = BenchmarkRunner(device="cpu", runs=2, warmup=0, compile_warmup=0)
        try:
            kw = dict(jobs=2) if call == "jobs" else dict(cluster="local:2")
            (rr,) = r.run_matrix(m, profile=True, **kw)
        finally:
            r.close()
        assert rr.status == "ok" and rr.extra["isolated"], rr.error
        assert abs(_frac_sum(rr.extra) - 1.0) < 1e-9
        return
    if call == "coverage":
        r = BenchmarkRunner(device="cpu", runs=2, warmup=0, compile_warmup=0,
                            profile=True, coverage=True)
        (rr,) = r.run_matrix(m)
        assert rr.status == "ok" and rr.extra["cov_primitives"] > 0, rr.error
        assert abs(_frac_sum(rr.extra) - 1.0) < 1e-9
        return
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        BenchmarkRunner(device="cpu", profile=True, tracer=object())


def test_h100_profile_is_the_default_hardware():
    assert (DEFAULT_HW.name, DEFAULT_HW.peak_flops_bf16, DEFAULT_HW.peak_flops_fp32,
            DEFAULT_HW.hbm_bw, DEFAULT_HW.hbm_bytes) == ("h100_sxm", 989e12, 67e12, 3.35e12, 80e9)
    assert math.isclose(DEFAULT_HW.peak("fp32"), 67e12)
    assert np.isfinite(DEFAULT_HW.link_bw)
