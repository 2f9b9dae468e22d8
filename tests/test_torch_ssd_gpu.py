"""The hand-written CUDA SSD kernel against its plain version on the card:
at the shapes of ``tests/test_kernels.py``, at mamba2-2.7b's full width
(H=80, P=64, N=128), with a ragged last chunk, a nonzero initial state
and strided inputs, in bf16 and fp32.  Every case checks y and the final
state.

These tests need a Hopper card (compute capability 9.0 or above) and
``nvcc``; elsewhere they skip.  Whether there is such a card is decided in
the ``hopper`` fixture, never at import, so every test worker collects
the same tests.  Run them on the card with ``PYTHONPATH=src python -m
pytest -q --noconftest -m gpu tests/test_torch_ssd_gpu.py``.

Tolerances as in ``tests/test_kernels.py``: 5e-5 in fp32 (same math,
another summation order), 5e-2 in bf16 (y rounded to bf16).
"""
import pytest
import torch

from repro_torch.kernels.ssd import kernel as ssd_kernel
from repro_torch.kernels.ssd.ops import ssd
from repro_torch.kernels.ssd.ref import ssd_ref

pytestmark = pytest.mark.gpu

TOL = {torch.float32: 5e-5, torch.bfloat16: 5e-2}


@pytest.fixture
def hopper():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    if torch.cuda.get_device_capability(0) < (9, 0):
        pytest.skip("needs compute capability 9.0 or above (sm_90a)")
    torch.backends.cuda.matmul.allow_tf32 = False   # the plain version in fp32
    return torch.device("cuda", 0)


def _inputs(dev, dtype, B, S, H, P, N, init=False):
    """The distributions of tests/test_kernels.py."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(B, S, H, P, generator=g)
    dt = torch.nn.functional.softplus(torch.randn(B, S, H, generator=g))
    A = -torch.exp(torch.randn(H, generator=g) * 0.3)
    Bm = torch.randn(B, S, N, generator=g) * 0.3
    Cm = torch.randn(B, S, N, generator=g) * 0.3
    h0 = torch.randn(B, H, P, N, generator=g) if init else None
    out = [x.to(dev, dtype), dt.to(dev), A.to(dev), Bm.to(dev, dtype), Cm.to(dev, dtype)]
    return out + [None if h0 is None else h0.to(dev)]


def _check(dev, dtype, B, S, H, P, N, init=False):
    x, dt, A, Bm, Cm, h0 = _inputs(dev, dtype, B, S, H, P, N, init)
    before = ssd_kernel.ssd_cuda.launches
    y, state = ssd(x, dt, A, Bm, Cm, init_state=h0)
    torch.cuda.synchronize()
    assert ssd_kernel.ssd_cuda.launches == before + 1
    want_y, want_state = ssd_ref(x, dt, A, Bm, Cm, h0)
    assert y.dtype == dtype and state.dtype == torch.float32
    tol = TOL[dtype]
    torch.testing.assert_close(y.float(), want_y.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(state, want_state, atol=tol, rtol=tol)


@pytest.mark.parametrize("B,S,H,P,N", [
    (1, 64, 2, 16, 32), (2, 96, 3, 16, 32), (1, 128, 1, 32, 16),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_test_kernels_shapes(hopper, B, S, H, P, N, dtype):
    _check(hopper, dtype, B, S, H, P, N)


@pytest.mark.parametrize("B,S", [(4, 128), (1, 2048)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_at_full_width(hopper, B, S, dtype):
    _check(hopper, dtype, B, S, 80, 64, 128)


@pytest.mark.parametrize("S", [1, 37, 200])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_ragged_with_initial_state(hopper, S, dtype):
    _check(hopper, dtype, 2, S, 80, 64, 128, init=True)


def test_kernel_reads_strided_slices_of_one_buffer(hopper):
    """x, B and C as the model hands them over: slices of the conv output
    (row stride d_inner + 2N), read in place."""
    B, S, H, P, N = 2, 100, 4, 64, 128
    g = torch.Generator().manual_seed(1)
    xbc = torch.randn(B, S, H * P + 2 * N, generator=g).to(hopper) * 0.3
    x = xbc[..., :H * P].reshape(B, S, H, P)
    Bm, Cm = xbc[..., H * P:H * P + N], xbc[..., H * P + N:]
    dt = torch.nn.functional.softplus(torch.randn(B, S, H, generator=g)).to(hopper)
    A = -torch.exp(torch.randn(H, generator=g) * 0.3).to(hopper)
    y, state = ssd(x, dt, A, Bm, Cm)
    want_y, want_state = ssd_ref(x, dt, A, Bm, Cm)
    torch.testing.assert_close(y, want_y, atol=5e-5, rtol=5e-5)
    torch.testing.assert_close(state, want_state, atol=5e-5, rtol=5e-5)


def test_kernel_wrapper_rejects_what_the_kernel_does_not_take(hopper):
    x, dt, A, Bm, Cm, _ = _inputs(hopper, torch.float16, 1, 8, 2, 16, 16)
    with pytest.raises(ValueError, match="dtype"):
        ssd(x, dt, A, Bm, Cm)
    for P, N in ((12, 16), (16, 136)):
        x, dt, A, Bm, Cm, _ = _inputs(hopper, torch.float32, 1, 8, 2, P, N)
        with pytest.raises(ValueError, match="multiple of 8"):
            ssd(x, dt, A, Bm, Cm)
