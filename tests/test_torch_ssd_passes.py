"""The three-pass SSD algorithm of the CUDA kernel's ``tc`` variant, and
the plan that picks a variant, on the CPU.

``ref.ssd_passes_ref`` computes the SSD scan as the ``tc`` kernel does:
chunk states per head group, state passing over chunks, chunk scan with
C·Bᵀ shared by a head group.  In fp32 it is held against the port's plain
version ``ssd_ref``, the port's ``ssd_sequential`` and the reference
package's ``ssd_chunked`` and Pallas kernel (interpret mode, as
``tests/test_kernels.py`` runs it) on the same numpy inputs, at 5e-5
(the same math, summed in another order).  With the tensor cores' bf16
operands rounded where the kernel rounds them, it is held against fp32
``ssd_sequential`` at mamba2-2.7b's head sizes within the card's bf16
check, 5e-2.  ``kernel.plan`` is held to the rules the CUDA side relies
on.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd.ops import ssd as jax_ssd_kernel
from repro.models import ssm as RS
from repro_torch.kernels.ssd import kernel as ssd_kernel
from repro_torch.kernels.ssd.ref import CHUNK, ssd_passes_ref, ssd_ref
from repro_torch.models.ssm import ssd_sequential

torch.set_num_threads(1)

TOL = 5e-5
BF16_TOL = 5e-2


def _inputs(B, S, H, P, N, seed=0, init=False):
    """The distributions of tests/test_kernels.py, drawn with numpy."""
    rng = np.random.default_rng(seed)
    r = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(np.float32)  # noqa: E731
    x = r(B, S, H, P)
    dt = np.log1p(np.exp(r(B, S, H))).astype(np.float32)
    A = (-np.exp(r(H) * 0.3)).astype(np.float32)
    Bm, Cm = r(B, S, N, scale=0.3), r(B, S, N, scale=0.3)
    h0 = r(B, H, P, N) if init else None
    return x, dt, A, Bm, Cm, h0


def _t(arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("S", [1, CHUNK - 1, CHUNK, CHUNK + 1, 200])
@pytest.mark.parametrize("heads_per_block", [4, 1])
def test_passes_match_every_reference(S, heads_per_block):
    """H = 6 over groups of 4 (a full and a partial group) or of 1."""
    x, dt, A, Bm, Cm, _ = arrays = _inputs(2, S, 6, 16, 32)
    y, state = ssd_passes_ref(*_t(arrays), heads_per_block=heads_per_block)
    want_y, want_state = ssd_ref(*_t(arrays))
    _close(y, want_y)
    _close(state, want_state)
    seq_y, seq_state = ssd_sequential(*_t(arrays))
    _close(y, seq_y)
    _close(state, seq_state)
    jx = [jnp.asarray(a) for a in (x, dt, A, Bm, Cm)]
    jy, jstate = RS.ssd_chunked(*jx, chunk=32)
    _close(y, jy)
    _close(state, jstate)
    _close(y, jax_ssd_kernel(*jx, chunk=min(CHUNK, S), interpret=True))


@pytest.mark.parametrize("S", [1, CHUNK + 1, 200])
def test_passes_carry_an_initial_state(S):
    x, dt, A, Bm, Cm, h0 = arrays = _inputs(2, S, 6, 16, 32, seed=1, init=True)
    y, state = ssd_passes_ref(*_t(arrays), heads_per_block=4)
    for want_y, want_state in (ssd_ref(*_t(arrays)), ssd_sequential(*_t(arrays)),
                               RS.ssd_chunked(*(jnp.asarray(a) for a in (x, dt, A, Bm, Cm)),
                                              chunk=64, init_state=jnp.asarray(h0))):
        _close(y, want_y)
        _close(state, want_state)


def test_pad_steps_leave_the_state_untouched():
    """Right-padded rows (``seq_lens``): dt = 0 past each row's length, so
    the final state is the state after the row's valid prefix and the
    valid outputs are unchanged."""
    lens = (150, 70, 1)
    x, dt, A, Bm, Cm, h0 = _inputs(3, 150, 5, 16, 32, seed=2, init=True)
    for row, n in enumerate(lens):
        dt[row, n:] = 0.0
    y, state = ssd_passes_ref(*_t((x, dt, A, Bm, Cm, h0)), heads_per_block=4)
    for row, n in enumerate(lens):
        one = [a[row:row + 1, :n] for a in (x, dt)] + [A] + [a[row:row + 1, :n] for a in (Bm, Cm)]
        want_y, want_state = ssd_sequential(*_t(one), init_state=torch.from_numpy(h0[row:row + 1]))
        _close(y[row:row + 1, :n], want_y)
        _close(state[row:row + 1], want_state)


@pytest.mark.parametrize("init", [False, True])
def test_bf16_operands_at_full_head_sizes_within_the_card_check(init):
    """mamba2-2.7b's P = 64, N = 128 at S = 512 (8 chunks), bf16 inputs;
    the initial state as the model passes its SSM cache.  y is held
    within 5e-2 of the fp32 recurrence (y in bf16, as the kernel returns
    it), the final state too."""
    x, dt, A, Bm, Cm, h0 = _inputs(1, 512, 8, 64, 128, seed=3, init=init)
    xb, Bb, Cb = (torch.from_numpy(a).to(torch.bfloat16) for a in (x, Bm, Cm))
    dt_t, A_t = torch.from_numpy(dt), torch.from_numpy(A)
    h0_t = None if h0 is None else torch.from_numpy(h0)
    y, state = ssd_passes_ref(xb, dt_t, A_t, Bb, Cb, h0_t, heads_per_block=4,
                              bf16_operands=True)
    assert y.dtype == torch.bfloat16 and state.dtype == torch.float32
    want_y, want_state = ssd_sequential(xb.float(), dt_t, A_t, Bb.float(), Cb.float(), h0_t)
    _close(y.float(), want_y, BF16_TOL)
    _close(state, want_state, BF16_TOL)
    # the roundings are the kernel's only departure: without them, 5e-5
    y32, state32 = ssd_passes_ref(xb.float(), dt_t, A_t, Bb.float(), Cb.float(), h0_t)
    _close(y32, want_y)
    _close(state32, want_state)


def test_plan_rules():
    bf16, fp32 = torch.bfloat16, torch.float32
    # the main path: bf16 at mamba2's P = 64, N = 128
    assert ssd_kernel.plan(1, 2048, 80, 64, 128, bf16) == ("tc", 4)   # 32 x 20 = 640 blocks
    assert ssd_kernel.plan(4, 128, 80, 64, 128, bf16) == ("tc", 2)    # 4 x 2 x 40 = 320 blocks
    assert ssd_kernel.plan(1, 1, 80, 64, 128, bf16) == ("tc", 1)      # 80 blocks at most
    # fp32 (5e-5, which TF32 would miss) and other head sizes: the first design
    assert ssd_kernel.plan(1, 2048, 80, 64, 128, fp32) == ("simt", 1)
    for P, N in ((16, 32), (64, 64), (32, 128), (128, 128)):
        assert ssd_kernel.plan(2, 256, 8, P, N, bf16) == ("simt", 1)
    for B in (1, 2, 4, 8, 64):
        for S in (1, 63, 64, 65, 128, 2048, 8192):
            for H in (1, 6, 80):
                variant, hpb = ssd_kernel.plan(B, S, H, 64, 128, bf16)
                blocks = B * -(-S // CHUNK) * -(-H // hpb)
                assert variant == "tc" and 1 <= hpb <= ssd_kernel.HEADS_PER_BLOCK
                # halved only while a pass has fewer than two blocks per SM
                assert hpb == ssd_kernel.HEADS_PER_BLOCK or (
                    B * -(-S // CHUNK) * -(-H // (2 * hpb)) < 2 * ssd_kernel.SMS)
                assert hpb == 1 or blocks >= 2 * ssd_kernel.SMS or hpb == ssd_kernel.HEADS_PER_BLOCK


def test_scratch_shapes():
    states, h_in, last = ssd_kernel.scratch_shapes(2, 130, 80, 64, 128)
    assert states == h_in == (2, 3, 80, 64, 128) and last == (2, 3, 80)
