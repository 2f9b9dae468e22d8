"""Compiled steps on the card (``harness.compile_step``: TorchInductor):
the reduced gemma-2b prefill and train cells, and gemma3-12b's prefill
past its window, launch the same hand-written kernels as the eager step,
as many times, and are held to its outputs: the prefill's logits; one
train step's loss, gradient norm, updated weights and updated moments,
from identical states.

Tolerances: the compiled step's against the eager step's 5e-2 in bf16 and
1e-4 in fp32 (Inductor fuses the elementwise ops around the kernels and
rounds in other places).

These tests need a Hopper card (compute capability 9.0 or above) and
``nvcc``; elsewhere they skip.  Whether there is such a card is decided in
the ``hopper`` fixture, never at import, so every test worker collects
the same tests.  Run them on the card with ``PYTHONPATH=src python -m
pytest -q --noconftest -m gpu tests/test_torch_compilers_gpu.py`` (the
suite's conftest imports JAX; this file needs only torch).
"""
import pytest
import torch

from repro_torch.core.harness import clone_tree, compile_step, dynamo_counts
from repro_torch.core.suite import build_arch, get_benchmark
from repro_torch.kernels.flash_attention import kernel as fa
from repro_torch.optim.adamw import leaves as _leaves

pytestmark = pytest.mark.gpu

TOL = {torch.bfloat16: 5e-2, torch.float32: 1e-4}


@pytest.fixture
def hopper():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    if torch.cuda.get_device_capability(0) < (9, 0):
        pytest.skip("needs compute capability 9.0 or above (sm_90a)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _launches(call):
    """(flash forward launches, backward launches) of ``call()``, and its
    result."""
    fa.flash_attention_cuda.launches = fa.flash_attention_bwd_cuda.launches = 0
    out = call()
    torch.cuda.synchronize()
    return (fa.flash_attention_cuda.launches, fa.flash_attention_bwd_cuda.launches), out


# gemma3-12b's prefill past its reduced window (64): a region for its
# local layers and one for its global layers
CELLS = [(arch, task, dtype) for arch, task in (("gemma-2b", "infer_prefill"),
                                                ("gemma-2b", "train"))
         for dtype in (torch.float32, torch.bfloat16)] + [
    ("gemma3-12b", "infer_prefill", torch.bfloat16)]


@pytest.mark.parametrize("arch,task,dtype", CELLS)
def test_compiled_cells_launch_the_kernels_of_eager_and_match(hopper, arch, task, dtype):
    built = build_arch(arch, {"compute_dtype": dtype}, device=hopper)
    seq = 80 if arch == "gemma3-12b" else 64
    step, args, _ = get_benchmark(arch, task).make(batch=2, seq=seq, built=built)
    compiled = compile_step(step, hopper)
    compiled(*clone_tree(args))                  # the compile
    c0 = dynamo_counts()
    want_n, want = _launches(lambda: step(*clone_tree(args)))
    got_n, got = _launches(lambda: compiled(*clone_tree(args)))
    c1 = dynamo_counts()
    assert c1["frames"] == c0["frames"] and c1["graph_calls"] > c0["graph_calls"]
    L = built.cfg.n_layers
    assert got_n == want_n == ((L, 0) if task == "infer_prefill" else (2 * L, L))
    tol = TOL[dtype]
    if task == "train":
        # one step from identical states: the loss, the gradient's norm, and
        # the updated weights and moments (Inductor's backward and update)
        pairs = [(got[1][k], want[1][k]) for k in ("loss", "grad_norm")]
        (gmodel, gopt), (wmodel, wopt) = got[0], want[0]
        pairs += list(zip(gmodel.parameters(), wmodel.parameters()))
        pairs += list(zip(_leaves((gopt.mu, gopt.nu)), _leaves((wopt.mu, wopt.nu))))
        assert int(gopt.step) == int(wopt.step) == 1
    else:
        pairs = [(got[0], want[0])]
    for g, w in pairs:
        assert torch.isfinite(g).all()
        torch.testing.assert_close(g.float(), w.float(), atol=tol, rtol=tol)
