"""The hand-written CUDA RG-LRU scan kernels against their plain version on
the card: at the shapes of ``tests/test_kernels.py``, at recurrentgemma-9b's
full width (B=1 S=2048 and B=4 S=128, D=4096, and B=2 S=2048 with an
initial state), at the chunk edges (S = 2047, 2049), with an initial
state, with strided and ragged inputs, over identity steps and at the
extreme decays.  Every call asserts that the variant ``kernel.plan()``
picks (``seq`` or ``chunked``) is the one that launched.

The plain version (``ref.rglru_blocked``) is the TPU kernel's blocked
log-space algorithm; the kernels scan step by step (``chunked``: in
32-step chunks with a look-back over earlier chunks).  Tolerance 2e-5 as
in ``tests/test_kernels.py`` (fp32 both, another summation order).

These tests need a Hopper card (compute capability 9.0 or above) and
``nvcc``; elsewhere they skip.  Whether there is such a card is decided in
the ``hopper`` fixture, never at import, so every test worker collects
the same tests.  Run them on the card with ``PYTHONPATH=src python -m
pytest -q --noconftest -m gpu tests/test_torch_rglru_gpu.py``.
"""
import pytest
import torch

from repro_torch.kernels.rglru import kernel as rglru_kernel
from repro_torch.kernels.rglru.ops import rglru
from repro_torch.kernels.rglru.ref import gated_input, rglru_blocked, rglru_sequential

pytestmark = pytest.mark.gpu

TOL = dict(atol=2e-5, rtol=2e-5)


@pytest.fixture
def hopper():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    if torch.cuda.get_device_capability(0) < (9, 0):
        pytest.skip("needs compute capability 9.0 or above (sm_90a)")
    return torch.device("cuda", 0)


def _inputs(dev, B, S, D, init=False, seed=0):
    """The distributions of tests/test_kernels.py: x normal, a =
    sigmoid(2 * normal)."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(B, S, D, generator=g)
    a = torch.sigmoid(torch.randn(B, S, D, generator=g) * 2)
    h0 = torch.randn(B, D, generator=g) if init else None
    return x.to(dev), a.to(dev), None if h0 is None else h0.to(dev)


def _check(x, a, h0=None, variant=None):
    """One op call against the plain version; ``variant``, when given, is
    the one plan() must pick for this shape."""
    planned, _ = rglru_kernel.plan(*x.shape)
    assert variant in (None, planned)
    before = rglru_kernel.rglru_cuda.launches
    by_variant = dict(rglru_kernel.rglru_cuda.launches_by_variant)
    h, h_last = rglru(x, a, init_state=h0)
    torch.cuda.synchronize()
    assert rglru_kernel.rglru_cuda.launches == before + 1
    by_variant[planned] += 1
    assert rglru_kernel.rglru_cuda.launches_by_variant == by_variant
    assert h.dtype == torch.float32 and h.shape == x.shape
    want = rglru_blocked(x, a, h0)
    torch.testing.assert_close(h, want, **TOL)
    torch.testing.assert_close(h_last, want[:, -1], **TOL)
    return h


@pytest.mark.parametrize("B,S,D", [(1, 64, 64), (2, 48, 96), (1, 128, 128), (2, 50, 100)])
def test_kernel_matches_plain_test_kernels_shapes(hopper, B, S, D):
    x, a, _ = _inputs(hopper, B, S, D)
    h = _check(x, a)
    # and the sequential oracle on the same inputs
    torch.testing.assert_close(h, rglru_sequential(a, gated_input(x, a)), **TOL)


@pytest.mark.parametrize("B,S,variant", [(1, 2048, "chunked"), (4, 128, "seq")])
def test_kernel_matches_plain_at_full_width(hopper, B, S, variant):
    """The infer_prefill step and the serve run's admission."""
    x, a, _ = _inputs(hopper, B, S, 4096)
    _check(x, a, variant=variant)


def test_chunked_kernel_at_full_width_with_an_initial_state(hopper):
    x, a, h0 = _inputs(hopper, 2, 2048, 4096, init=True, seed=4)
    _check(x, a, h0, variant="chunked")


@pytest.mark.parametrize("S", [2047, 2049])
def test_chunked_kernel_at_the_chunk_edges(hopper, S):
    """A ragged last chunk (2047) and a last chunk of one step (2049)."""
    x, a, h0 = _inputs(hopper, 1, S, 4096, init=S == 2049, seed=5)
    _check(x, a, h0, variant="chunked")


@pytest.mark.parametrize("B,S,D,variant", [
    (1, 64, 4096, "seq"),        # two chunks: the walk is short
    (2, 16, 4096, "seq"),
    (16, 200, 4096, "seq"),      # the lanes fill the card
    (3, 128, 4096, "seq"),       # four chunks at the short fill
    (2, 128, 4096, "chunked"),
    (1, 65, 300, "chunked"),     # just past two chunks, ragged D
    (5, 1000, 96, "chunked"),
])
def test_plan_picks_each_variant_and_it_launches(hopper, B, S, D, variant):
    x, a, _ = _inputs(hopper, B, S, D, seed=6)
    _check(x, a, variant=variant)


@pytest.mark.parametrize("S", [1, 50, 130])
def test_kernel_matches_plain_with_initial_state(hopper, S):
    x, a, h0 = _inputs(hopper, 2, S, 4096, init=True, seed=1)
    _check(x, a, h0)


def test_kernel_reads_strided_ragged_inputs(hopper):
    """x and a as slices of wider rows (row strides above D), at an S and D
    that no block size divides."""
    g = torch.Generator().manual_seed(2)
    buf = torch.randn(3, 37, 2 * 300 + 7, generator=g).to(hopper)
    x = buf[..., :300]
    a = torch.sigmoid(buf * 2)[..., 300:600]
    assert x.stride(1) == a.stride(1) == 607
    _check(x, a)


def test_chunked_kernel_reads_strided_inputs(hopper):
    """x and a as slices of wider rows, through the chunked variant, with
    a ragged last chunk and an initial state."""
    g = torch.Generator().manual_seed(7)
    buf = torch.randn(2, 300, 2 * 600 + 7, generator=g).to(hopper)
    x = buf[..., :600]
    a = torch.sigmoid(buf * 2)[..., 600:1200]
    h0 = torch.randn(2, 600, generator=g).to(hopper)
    assert x.stride(1) == a.stride(1) == 1207
    _check(x, a, h0, variant="chunked")


@pytest.mark.parametrize("S", [64, 200])
def test_kernel_at_extreme_decays_matches_plain(hopper, S):
    """S = 64 through seq, 200 through chunked, where a = 1e-6 makes the
    chunk's product A underflow to 0."""
    B, D = 1, 256
    x = torch.randn(B, S, D, generator=torch.Generator().manual_seed(3)).to(hopper)
    a = torch.cat([torch.full((B, S, D // 2), 1e-6),
                   torch.full((B, S, D // 2), 1 - 1e-6)], -1).to(hopper)
    h = _check(x, a, variant="seq" if S == 64 else "chunked")
    assert bool(torch.isfinite(h).all())


def test_chunked_kernel_holds_the_state_over_identity_steps(hopper):
    """Rows shorter than S arrive with identity steps (a = 1, x = 0) past
    their length, as ``models/rglru.py`` pads them: the final state is the
    state at the last valid step."""
    B, S, D = 3, 150, 4096
    x, a, h0 = _inputs(hopper, B, S, D, init=True, seed=8)
    lengths = [S, 70, 0]
    for row, n in enumerate(lengths):
        a[row, n:] = 1.0
        x[row, n:] = 0.0
    h = _check(x, a, h0, variant="chunked")
    for row, n in enumerate(lengths):
        held = h[row, n - 1] if n else h0[row]
        torch.testing.assert_close(h[row, -1], held, **TOL)


def test_kernel_wrapper_rejects_what_the_kernel_does_not_take(hopper):
    x, a, _ = _inputs(hopper, 1, 8, 16)
    with pytest.raises(ValueError, match="float32"):
        rglru_kernel.rglru_cuda(x.to(torch.bfloat16), a)
    with pytest.raises(ValueError, match="float32"):
        rglru_kernel.rglru_cuda(x, a[:, :4])
    with pytest.raises(ValueError, match="unit stride"):
        rglru_kernel.rglru_cuda(x.transpose(1, 2).contiguous().transpose(1, 2), a)
    with pytest.raises(ValueError, match="init_state"):
        rglru_kernel.rglru_cuda(x, a, torch.zeros(1, 8, device=hopper))
