"""The hand-written CUDA SSD kernel against its plain version on the card:
at the shapes of ``tests/test_kernels.py``, at mamba2-2.7b's full width
(H=80, P=64, N=128), with a ragged last chunk, a nonzero initial state
and strided inputs, in bf16 and fp32.  Every case checks y and the final
state; the full-width bf16 cases also check that the three-pass
tensor-core variant (``tc``) ran, and fp32 the first design (``simt``).

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


def _full_width_variant(dtype):
    return "tc" if dtype == torch.bfloat16 else "simt"


def _check(dev, dtype, B, S, H, P, N, init=False, variant=None, A=None, tol=None):
    """One call against the plain version; ``variant``: the one that must
    have launched; ``A``: a decay to use for every head; ``tol``: in place
    of the dtype's tolerance."""
    x, dt, A0, Bm, Cm, h0 = _inputs(dev, dtype, B, S, H, P, N, init)
    A = A0 if A is None else torch.full_like(A0, A)
    before = ssd_kernel.ssd_cuda.launches
    by_variant = dict(ssd_kernel.ssd_cuda.launches_by_variant)
    y, state = ssd(x, dt, A, Bm, Cm, init_state=h0)
    torch.cuda.synchronize()
    assert ssd_kernel.ssd_cuda.launches == before + 1
    if variant is not None:
        assert ssd_kernel.plan(B, S, H, P, N, dtype)[0] == variant
        assert ssd_kernel.ssd_cuda.launches_by_variant[variant] == by_variant[variant] + 1
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(state).all())
    want_y, want_state = ssd_ref(x, dt, A, Bm, Cm, h0)
    assert y.dtype == dtype and state.dtype == torch.float32
    tol = TOL[dtype] if tol is None else tol
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
    _check(hopper, dtype, B, S, 80, 64, 128, variant=_full_width_variant(dtype))


@pytest.mark.parametrize("S", [1, 63, 65])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_at_chunk_edges_with_the_cache_state(hopper, S, dtype):
    """Four rows at full width, S below, just under and just over one
    64-step chunk, from an fp32 initial state as the model passes its SSM
    cache (``cache["ssm"]``)."""
    _check(hopper, dtype, 4, S, 80, 64, 128, init=True, variant=_full_width_variant(dtype))


# Under A = -50 the chunk's cum runs to about -3000, and any fp32
# evaluation of e^(cum_i - cum_j) carries about |cum| * 2^-24 ~ 2e-4 of
# relative rounding from the cumsum, which the kernel's warp scan and
# torch.cumsum round differently: in fp32 the two agree to ~3e-4 there,
# so this case holds fp32 to 1e-3; bf16 keeps its 5e-2.
STRONG_DECAY_TOL = {torch.float32: 1e-3, torch.bfloat16: 5e-2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_stays_finite_under_strong_decay(hopper, dtype):
    """A = -50 over 2048 steps: the decays within a chunk underflow, and
    e^(cum_i - cum_j) above the diagonal would overflow if it were formed
    before the mask.  y and the final state stay finite and agree with the
    plain version."""
    _check(hopper, dtype, 1, 2048, 80, 64, 128, init=True, variant=_full_width_variant(dtype),
           A=-50.0, tol=STRONG_DECAY_TOL[dtype])


def test_tc_with_a_partial_head_group(hopper):
    """H = 6 in groups of 4 heads (a full and a partial group): enough
    chunks that the plan keeps 4 heads per block."""
    B, S, H = 2, 66 * 64, 6
    assert ssd_kernel.plan(B, S, H, 64, 128, torch.bfloat16) == ("tc", 4)
    _check(hopper, torch.bfloat16, B, S, H, 64, 128, init=True, variant="tc")


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


def test_tc_reads_strided_bf16_slices_of_one_buffer(hopper):
    """The same in bf16 at full head sizes, as the model's bf16 path hands
    them to the tc variant: the slices are read in place."""
    B, S, H, P, N = 2, 100, 4, 64, 128
    g = torch.Generator().manual_seed(1)
    xbc = (torch.randn(B, S, H * P + 2 * N, generator=g) * 0.3).to(hopper, torch.bfloat16)
    x = xbc[..., :H * P].reshape(B, S, H, P)
    Bm, Cm = xbc[..., H * P:H * P + N], xbc[..., H * P + N:]
    dt = torch.nn.functional.softplus(torch.randn(B, S, H, generator=g)).to(hopper)
    A = -torch.exp(torch.randn(H, generator=g) * 0.3).to(hopper)
    before = ssd_kernel.ssd_cuda.launches_by_variant["tc"]
    y, state = ssd(x, dt, A, Bm, Cm)
    assert ssd_kernel.ssd_cuda.launches_by_variant["tc"] == before + 1
    want_y, want_state = ssd_ref(x, dt, A, Bm, Cm)
    torch.testing.assert_close(y.float(), want_y.float(), atol=5e-2, rtol=5e-2)
    torch.testing.assert_close(state, want_state, atol=5e-2, rtol=5e-2)


def test_kernel_wrapper_rejects_what_the_kernel_does_not_take(hopper):
    x, dt, A, Bm, Cm, _ = _inputs(hopper, torch.float16, 1, 8, 2, 16, 16)
    with pytest.raises(ValueError, match="dtype"):
        ssd(x, dt, A, Bm, Cm)
    for P, N in ((12, 16), (16, 136)):
        x, dt, A, Bm, Cm, _ = _inputs(hopper, torch.float32, 1, 8, 2, P, N)
        with pytest.raises(ValueError, match="multiple of 8"):
            ssd(x, dt, A, Bm, Cm)
