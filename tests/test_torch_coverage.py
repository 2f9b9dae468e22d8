"""The port's API-surface coverage (``core/coverage``) on the CPU.

* the suite of gemma-2b, mamba2-2.7b, recurrentgemma-9b and
  whisper-large-v3 steps covers more than the gemma-2b sub-suite, and the
  report has the reference's keys;
* each of the port's kernel calls is one op of both surfaces, named
  ``repro_torch.kernel::<name>``, and its plain version's ops are not
  counted (the flash backward too);
* the pass runs the step and leaves the state it updates in place bitwise
  as it was;
* a ``BenchmarkRunner(coverage=True)`` carries ``cov_primitives`` and
  ``cov_new_primitives``, and a pass that raises makes an error record.
"""
import pytest
import torch

from repro.core.coverage import coverage_report as ref_coverage_report
from repro_torch.core import coverage
from repro_torch.core.coverage import api_name, coverage_report, step_surfaces
from repro_torch.core.suite import build_arch, get_benchmark
from repro_torch.fleet.metrics import registry
from repro_torch.kernels.accounting import SCOPE_PREFIX
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.rglru.ops import rglru
from repro_torch.kernels.ssd.ops import ssd
from repro_torch.runner import BenchmarkRunner, Scenario

torch.set_num_threads(1)

# the suite's steps that run on the card as well (ROADMAP: mamba2 and
# recurrentgemma train on the CPU only, whisper does not train yet), and
# the two CPU-only train steps
SUITE = [("gemma-2b", "train"), ("gemma-2b", "infer_prefill"),
         ("mamba2-2.7b", "infer_prefill"), ("recurrentgemma-9b", "infer_prefill"),
         ("whisper-large-v3", "infer_prefill"),
         ("mamba2-2.7b", "train"), ("recurrentgemma-9b", "train")]


@pytest.fixture(scope="module")
def report():
    benches = [get_benchmark(a, t) for a, t in SUITE]
    return coverage_report(benches, batch=1, seq=16,
                           runner=BenchmarkRunner(device="cpu"))


def test_the_suite_covers_more_than_one_model(report):
    assert set(report) == set(ref_coverage_report([]))
    assert report["coverage_x_primitives"] > 1.1
    assert report["suite_stablehlo_ops"] >= report["baseline_stablehlo_ops"] > 0
    union = set(report["union_primitives"])
    assert {SCOPE_PREFIX + k for k in ("flash_attention", "flash_attention_bwd",
                                       "ssd", "rglru")} <= union
    assert report["suite_primitives"] == len(union)
    per = report["per_benchmark"]
    assert list(per) == [f"{a}/{t}" for a, t in SUITE]
    for name, d in per.items():
        assert d["n_primitives"] == len(d["primitives"]) > 0
        assert d["n_stablehlo_ops"] == len(d["stablehlo_ops"]) > 0
        assert all(op.startswith(("aten::", SCOPE_PREFIX)) for op in d["stablehlo_ops"])


def test_the_card_runnable_suite_alone_covers_more_than_one_model(report):
    """The five steps that run on the card too, as ``chip_smoke.py``
    compares them across devices."""
    per = report["per_benchmark"]
    prims = [set(per[f"{a}/{t}"]["primitives"]) for a, t in SUITE[:5]]
    suite, base = set().union(*prims), prims[0] | prims[1]
    assert len(suite) / len(base) > 1.1


def test_a_train_step_sees_the_backward(report):
    ops = set(report["per_benchmark"]["gemma-2b/train"]["stablehlo_ops"])
    assert {"aten::gelu_backward", SCOPE_PREFIX + "flash_attention_bwd"} <= ops
    assert "aten::_softmax_backward_data" not in ops   # inside the backward call
    api = set(report["per_benchmark"]["gemma-2b/train"]["primitives"])
    assert {"torch.Tensor.backward", "torch._foreach_addcmul_"} <= api


def _attention_inputs(grad=False):
    g = torch.Generator().manual_seed(0)
    return [torch.randn(1, 16, 4, 32, generator=g).requires_grad_(grad) for _ in range(3)]


def _ssd_inputs():
    g = torch.Generator().manual_seed(0)
    B, S, H, P, N = 1, 80, 2, 8, 16
    return (torch.randn(B, S, H, P, generator=g), torch.rand(B, S, H, generator=g),
            -torch.rand(H, generator=g), torch.randn(B, S, N, generator=g),
            torch.randn(B, S, N, generator=g))


def _rglru_inputs():
    g = torch.Generator().manual_seed(0)
    return torch.randn(2, 40, 16, generator=g), torch.rand(2, 40, 16, generator=g)


KERNEL_CALLS = {"flash_attention": (flash_attention, _attention_inputs),
                "ssd": (ssd, _ssd_inputs), "rglru": (rglru, _rglru_inputs)}


@pytest.mark.parametrize("case", sorted(KERNEL_CALLS))
def test_a_kernel_call_is_one_op(case):
    fn, inputs = KERNEL_CALLS[case]
    args = inputs()
    api, aten = step_surfaces(lambda: fn(*args))
    assert aten == {SCOPE_PREFIX + case}
    # besides the call, only reads of its arguments' shapes or devices
    assert SCOPE_PREFIX + case in api
    assert all(n.endswith("__get__") for n in api - {SCOPE_PREFIX + case}), api
    # the plain version alone is many ops
    _, plain = step_surfaces(lambda: attention_ref(*_attention_inputs()))
    assert {"aten::bmm", "aten::_softmax"} <= plain


def test_a_differentiated_kernel_call_is_two_ops():
    q, k, v = _attention_inputs(grad=True)
    api, aten = step_surfaces(lambda: flash_attention(q, k, v).sum().backward())
    kernels = {SCOPE_PREFIX + "flash_attention", SCOPE_PREFIX + "flash_attention_bwd"}
    assert kernels <= aten and kernels <= api
    assert not {"aten::bmm", "aten::_softmax", "aten::_softmax_backward_data"} & aten
    assert {"torch.Tensor.backward", "torch.Tensor.sum"} <= api
    assert q.grad is not None and torch.isfinite(q.grad).all()


def test_the_kernel_gradient_is_autograds_through_the_plain_version():
    q, k, v = _attention_inputs(grad=True)
    flash_attention(q, k, v, softcap=5.0).square().sum().backward()
    q2, k2, v2 = (t.detach().clone().requires_grad_() for t in (q, k, v))
    attention_ref(q2, k2, v2, softcap=5.0).square().sum().backward()
    for a, b in ((q, q2), (k, k2), (v, v2)):
        assert torch.equal(a.grad, b.grad)


def _tensors(x, out):
    if isinstance(x, torch.Tensor):
        out.append(x.detach().clone())
    elif isinstance(x, torch.nn.Module):
        out.extend(t.detach().clone() for t in list(x.parameters()) + list(x.buffers()))
    elif isinstance(x, dict):
        for k in sorted(x):
            _tensors(x[k], out)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _tensors(v, out)
    return out


@pytest.mark.parametrize("task", ["train", "infer_decode"])
def test_the_pass_leaves_the_state_bitwise_unchanged(task):
    built = build_arch("gemma-2b", device="cpu")
    step, args, donate = get_benchmark("gemma-2b", task).make(batch=1, seq=8, built=built)
    before = _tensors(args[donate[0]], [])
    api, aten = step_surfaces(step, args, donate)
    after = _tensors(args[donate[0]], [])
    assert len(before) == len(after) > 0
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    assert SCOPE_PREFIX + "flash_attention" in aten and api
    step(*args)                   # the same call outside the pass moves the state
    moved = _tensors(args[donate[0]], [])
    assert not all(torch.equal(a, b) for a, b in zip(before, moved))


def test_api_names_resolve_the_foreach_builtins():
    assert api_name(torch.Tensor.add) == "torch.Tensor.add"
    assert api_name(torch._foreach_add_).endswith("_foreach_add_")


def test_a_coverage_runner_carries_both_cov_keys():
    r = BenchmarkRunner(device="cpu", runs=1, warmup=0, compile_warmup=0, coverage=True)
    first = r.run(Scenario(arch="gemma-2b", task="infer_prefill", batch=1, seq=8),
                  record=False)
    second = r.run(Scenario(arch="mamba2-2.7b", task="infer_prefill", batch=1, seq=8),
                   record=False)
    again = r.run(Scenario(arch="gemma-2b", task="infer_prefill", batch=1, seq=8),
                  record=False)
    assert first.status == second.status == again.status == "ok"
    e1, e2, e3 = first.extra, second.extra, again.extra
    assert e1["cov_primitives"] == e1["cov_new_primitives"] > 0
    assert 0 < e2["cov_new_primitives"] < e2["cov_primitives"]
    assert e3["cov_primitives"] == e1["cov_primitives"] and e3["cov_new_primitives"] == 0
    union = e1["cov_primitives"] + e2["cov_new_primitives"]
    assert registry().snapshot()["gauges"]["fleet_cov_union_primitives"] == union
    plain = BenchmarkRunner(device="cpu", runs=1, warmup=0, compile_warmup=0).run(
        Scenario(arch="gemma-2b", task="infer_prefill", batch=1, seq=8), record=False)
    assert not any(k.startswith("cov_") for k in plain.extra)


def test_a_failed_pass_gives_an_error_record(monkeypatch):
    def broken(*a, **kw):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(coverage, "step_surfaces", broken)
    r = BenchmarkRunner(device="cpu", runs=1, warmup=0, compile_warmup=0, coverage=True)
    sc = Scenario(arch="gemma-2b", task="infer_prefill", batch=1, seq=8)
    rr = r.run(sc, record=False)
    assert rr.status == "error" and "illegal memory access" in rr.error
    assert r.stats.errors == 1 and sc not in r._execs
