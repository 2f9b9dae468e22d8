"""The hand-written CUDA SSD backward (``csrc/ssd_bwd.cu``) against
autograd through the plain version on the card: at mamba2-2.7b's train
width (H=80, P=64, N=128) in bf16, with a ragged last chunk, an initial
state and a nonzero ``dstate``, at a strong decay, and at the reduced
config in fp32; through the op's autograd formula, each call one launch;
and two runs bitwise equal.

These tests need a Hopper card (compute capability 9.0 or above) and
``nvcc``; elsewhere they skip.  Whether there is such a card is decided in
the ``hopper`` fixture, never at import, so every test worker collects
the same tests.  Run them on the card with ``PYTHONPATH=src python -m
pytest -q --noconftest -m gpu tests/test_torch_ssd_bwd_gpu.py``.

Tolerance: each gradient's max abs error relative to its largest |value|,
5e-2 in bf16 (inputs and dx, dB, dC rounded to bf16) and 1e-4 in fp32,
held to autograd through ``ssd_ref`` in float64 on the same inputs (fp32
autograd through it strays ~4e-3 in dA at a strong decay,
``tests/test_torch_ssd_bwd.py``).
"""
import pytest
import torch

from repro_torch.kernels.ssd import kernel as sk
from repro_torch.kernels.ssd.ops import ssd
from repro_torch.kernels.ssd.ref import ssd_ref

pytestmark = pytest.mark.gpu

TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}


@pytest.fixture
def hopper():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    if torch.cuda.get_device_capability(0) < (9, 0):
        pytest.skip("needs compute capability 9.0 or above (sm_90a)")
    torch.backends.cuda.matmul.allow_tf32 = False   # the plain version in full precision
    return torch.device("cuda", 0)


def _inputs(dev, dtype, B, S, H, P, N, decay=None):
    g = torch.Generator().manual_seed(0)
    x = torch.randn(B, S, H, P, generator=g)
    dt = torch.nn.functional.softplus(torch.randn(B, S, H, generator=g))
    A = -torch.exp(torch.randn(H, generator=g) * 0.3) if decay is None else torch.full((H,), decay)
    Bm, Cm = (torch.randn(B, S, N, generator=g) * 0.3 for _ in range(2))
    h0, ds = (torch.randn(B, H, P, N, generator=g) for _ in range(2))
    dy = torch.randn(B, S, H, P, generator=g)
    return ([x.to(dev, dtype), dt.to(dev), A.to(dev), Bm.to(dev, dtype), Cm.to(dev, dtype),
             h0.to(dev)], dy.to(dev, dtype), ds.to(dev))


def _check(dev, dtype, B, S, H, P, N, decay=None):
    ins, dy, ds = _inputs(dev, dtype, B, S, H, P, N, decay)
    leaves = [t.clone().requires_grad_() for t in ins]
    before = sk.ssd_bwd_cuda.launches
    torch.autograd.backward(ssd(*leaves), (dy, ds))
    torch.cuda.synchronize()
    assert sk.ssd_bwd_cuda.launches == before + 1
    got = [t.grad for t in leaves]
    exact = [t.double().requires_grad_() for t in ins]
    torch.autograd.backward(ssd_ref(*exact), (dy.double(), ds.double()))
    for name, g, t, w in zip(("dx", "ddt", "dA", "dBm", "dCm", "dinit"), got, ins, exact):
        assert g.dtype == t.dtype and g.shape == t.shape, name
        w = w.grad
        err = ((g.double() - w).abs().max() / w.abs().max()).item()
        assert torch.isfinite(g).all() and err <= TOL[dtype], (name, err)
    again = sk.ssd_bwd_cuda(ins[0], ins[1], ins[2], ins[3], ins[4], ins[5],
                            dy.contiguous(), ds)
    first = sk.ssd_bwd_cuda(ins[0], ins[1], ins[2], ins[3], ins[4], ins[5],
                            dy.contiguous(), ds)
    assert all(torch.equal(a, b) for a, b in zip(again, first))


def test_mamba2_train_shape_bf16(hopper):
    _check(hopper, torch.bfloat16, 1, 2048, 80, 64, 128)


def test_ragged_with_state_bf16(hopper):
    _check(hopper, torch.bfloat16, 2, 2000, 80, 64, 128)


def test_strong_decay_fp32(hopper):
    _check(hopper, torch.float32, 1, 300, 8, 64, 128, decay=-50.0)


@pytest.mark.parametrize("S", [1, 37, 64, 65, 200])
def test_reduced_fp32(hopper, S):
    _check(hopper, torch.float32, 2, S, 16, 16, 16)
