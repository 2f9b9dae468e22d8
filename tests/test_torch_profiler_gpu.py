"""The measured profiler on the card: the runner's profiled cells split
each step by the device's busy time from a kernel trace, class the port's
kernels as attention, and count the same work as on the CPU.

These tests need a Hopper card (compute capability 9.0 or above) and
``nvcc``; elsewhere they skip.  Whether there is such a card is decided in
the ``hopper`` fixture, never at import, so every test worker collects
the same tests.  Run them on the card with ``PYTHONPATH=src python -m
pytest -q --noconftest -m gpu tests/test_torch_profiler_gpu.py`` (the
suite's conftest imports JAX; this file needs only torch).
"""
import pytest
import torch

from repro_torch.core.hloanalysis import analyze_step
from repro_torch.core.suite import build_arch, get_benchmark
from repro_torch.core import harness
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.profiler import trace_device_time
from repro_torch.runner import BenchmarkRunner, Scenario

pytestmark = pytest.mark.gpu

PROF_FRACS = ("prof_frac_compute", "prof_frac_memory", "prof_frac_collective",
              "prof_frac_dispatch", "prof_frac_idle")


@pytest.fixture
def hopper():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    if torch.cuda.get_device_capability(0) < (9, 0):
        pytest.skip("needs compute capability 9.0 or above (sm_90a)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.parametrize("kw", [
    dict(arch="gemma-2b", task="infer_prefill", batch=1, seq=64),
    dict(arch="gemma-2b", task="infer_decode", batch=2, seq=64),
    dict(arch="gemma-2b", task="train", batch=1, seq=64),
    dict(arch="gemma-2b", task="serve", batch=4, seq=16, slots=2, trace="bursty"),
    dict(arch="mamba2-2.7b", task="infer_prefill", batch=1, seq=64),
    dict(arch="recurrentgemma-9b", task="infer_prefill", batch=1, seq=96),
])
def test_profiled_cells_on_the_card(hopper, kw):
    r = BenchmarkRunner(device=hopper, runs=3, warmup=1, compile_warmup=1)
    rr = r.run(Scenario(**kw), profile=True, record=False)
    assert rr.status == "ok", rr.error
    e = rr.extra
    assert "prof_error" not in e, e.get("prof_error")
    assert abs(sum(e[k] for k in PROF_FRACS) - 1.0) < 1e-6
    assert 0.0 < e["prof_util"] <= 1.05
    assert e["prof_class_us"]["attention"] > 0
    assert e["prof_device_peak_bytes"] > 0
    for d, v in e["prof_timeline"]:
        assert d >= 0 and v > 0


def test_trace_classes_the_kernels_as_attention(hopper):
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 256, 8, 64, generator=g).to(hopper, torch.bfloat16)
               for _ in range(3))
    flash_attention(q, k, v)       # warm, as every traced step is
    busy, by_class = trace_device_time(lambda: flash_attention(q, k, v), 3, device=hopper)
    assert busy > 0 and by_class["attention"] == pytest.approx(busy)


def test_a_cpu_trace_of_work_on_the_card_raises(hopper):
    """The CPU's busy time never stands in for the card's: a trace asked
    for on the CPU of a step that launches kernels refuses."""
    w = torch.randn(512, 512, device=hopper)
    w @ w
    with pytest.raises(RuntimeError, match="work on a card"):
        trace_device_time(lambda: w @ w, 2, device="cpu")


def test_measure_profiles_a_train_step_whose_tensors_sit_in_a_module(hopper):
    """A train cell's card tensors lie in its model; ``measure`` waits for
    that card and traces the device it is given."""
    built = build_arch("gemma-2b", device=hopper)
    step, args, donate = get_benchmark("gemma-2b", "train").make(batch=1, seq=32, built=built)
    assert harness._cuda_devices(args[0][0], set()) == {hopper}
    log, trace = [], {}
    harness.measure("t", step, args, donate, runs=2, warmup=1,
                    jitted=harness.prepare(step, donate, mutable=donate),
                    phase_log=log, device_trace=trace, device=hopper)
    assert "error" not in trace and trace["busy_us"] > 0 and len(log) == 2
    assert trace["class_us"]["attention"] > 0


def test_the_card_counts_the_cpus_work(hopper):
    """One reduced prefill analysed on the card and on the CPU: the same
    matmul flops and the same kernel calls and attention work."""
    costs = {}
    for dev in ("cpu", hopper):
        built = build_arch("gemma-2b", device=dev)
        step, args, donate = get_benchmark("gemma-2b", "infer_prefill").make(
            batch=1, seq=32, built=built)
        costs[str(dev)] = analyze_step(harness.prepare(step, donate, mutable=donate),
                                       args, donate)
    cpu, card = costs["cpu"], costs[str(hopper)]
    assert card.notes == cpu.notes
    for cls in ("matmul", "attention"):
        assert card.flops_by_class[cls] == cpu.flops_by_class[cls]
    assert card.bytes_by_class["attention"] == cpu.bytes_by_class["attention"]
