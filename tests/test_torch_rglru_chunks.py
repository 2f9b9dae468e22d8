"""The chunked RG-LRU algorithm of the CUDA kernel's ``chunked`` variant,
and the plan that picks a variant, on the CPU.

``ref.rglru_chunked_ref`` computes the scan as the ``chunked`` kernel
does: each chunk scanned from a zero state into its aggregate (A = prod
a_t, H), the carry-in of each chunk from its predecessors' aggregates and
the initial state, each chunk scanned again from its carry-in.  It is held
against the reference package's op (``repro.kernels.rglru.ops.rglru``, as
``tests/test_torch_rglru.py`` runs it), its model scan
(``repro.models.rglru.rglru_scan``, for the initial state) and the port's
``rglru_sequential`` on the same numpy inputs, at 2e-5 as
``tests/test_kernels.py`` (fp32 both sides, another summation order).
``kernel.plan`` is held to the rules the CUDA side relies on.
"""
import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rglru.ops import rglru as jax_rglru
from repro.models import rglru as RR
from repro_torch.kernels.rglru import kernel as rglru_kernel
from repro_torch.kernels.rglru.kernel import (CHUNK, FILL_LANES, SHORT_FILL_LANES, VARIANTS,
                                              plan, scratch_words)
from repro_torch.kernels.rglru.ref import (chunk_aggregates, gated_input, rglru_chunked_ref,
                                           rglru_sequential)

torch.set_num_threads(1)

TOL = dict(atol=2e-5, rtol=2e-5)


def _xa(B, S, D, seed=0):
    """The distributions of tests/test_kernels.py, drawn with numpy: x
    normal, a = sigmoid(2 * normal)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    a = (1.0 / (1.0 + np.exp(-2.0 * rng.standard_normal((B, S, D))))).astype(np.float32)
    return x, a


@functools.lru_cache(maxsize=None)
def _jax_op(B, S, D, seed=0):
    x, a = _xa(B, S, D, seed)
    return np.asarray(jax_rglru(jnp.asarray(x), jnp.asarray(a)), np.float32)


def _seq(x, a, h0=None):
    return rglru_sequential(a, gated_input(x, a), h0)


SHAPES = [(1, 64, 64), (2, 50, 100), (1, 130, 256), (2, 512, 128)]


@pytest.mark.parametrize("B,S,D", SHAPES)
@pytest.mark.parametrize("chunk", ["1", "CHUNK", "CHUNK+1", "S", "S+5"])
def test_chunked_ref_matches_reference_op_and_sequential(B, S, D, chunk):
    """Chunk 1 (every step a chunk), the kernel's chunk, a chunk that
    leaves the last one ragged, one chunk exactly S and one longer than
    S."""
    c = {"1": 1, "CHUNK": CHUNK, "CHUNK+1": CHUNK + 1, "S": S, "S+5": S + 5}[chunk]
    x, a = (torch.from_numpy(t) for t in _xa(B, S, D))
    h = rglru_chunked_ref(x, a, chunk=c)
    assert h.dtype == torch.float32 and h.shape == (B, S, D)
    np.testing.assert_allclose(h.numpy(), _jax_op(B, S, D), **TOL)
    torch.testing.assert_close(h, _seq(x, a), **TOL)


@pytest.mark.parametrize("S", [1, CHUNK, CHUNK + 3, 130])
@pytest.mark.parametrize("chunk", [1, CHUNK])
def test_chunked_ref_carries_an_initial_state(S, chunk):
    B, D = 2, 96
    x, a = _xa(B, S, D, seed=1)
    h0 = np.random.default_rng(2).standard_normal((B, D)).astype(np.float32)
    want, want_last = RR.rglru_scan(jnp.asarray(x), jnp.asarray(a), init_state=jnp.asarray(h0))
    xt, at, h0t = (torch.from_numpy(t) for t in (x, a, h0))
    h = rglru_chunked_ref(xt, at, h0t, chunk=chunk)
    np.testing.assert_allclose(h.numpy(), np.asarray(want, np.float32), **TOL)
    np.testing.assert_allclose(h[:, -1].numpy(), np.asarray(want_last, np.float32), **TOL)
    torch.testing.assert_close(h, _seq(xt, at, h0t), **TOL)


def test_chunked_ref_holds_the_state_over_identity_steps():
    """Steps past a row's valid length arrive as a = 1, x = 0
    (``models/rglru.py``): the state after them is the state at the row's
    last valid step, exactly within that step's chunk and to 2e-5 past it
    (the next chunk's carry-in is A * carry + H, rounded apart from the
    stepped state); a row of length 0 keeps its initial state exactly."""
    B, S, D = 3, 3 * CHUNK + 5, 64
    x, a = _xa(B, S, D, seed=3)
    lengths = [S, CHUNK + 7, 0]
    for row, n in enumerate(lengths):
        a[row, n:] = 1.0
        x[row, n:] = 0.0
    h0 = np.random.default_rng(4).standard_normal((B, D)).astype(np.float32)
    xt, at, h0t = (torch.from_numpy(t) for t in (x, a, h0))
    h = rglru_chunked_ref(xt, at, h0t, chunk=CHUNK)
    torch.testing.assert_close(h, _seq(xt, at, h0t), **TOL)
    want, _ = RR.rglru_scan(jnp.asarray(x), jnp.asarray(a), init_state=jnp.asarray(h0))
    np.testing.assert_allclose(h.numpy(), np.asarray(want, np.float32), **TOL)
    for row, n in enumerate(lengths):
        held = (h[row, n - 1] if n else h0t[row]).expand(S - n, D)
        torch.testing.assert_close(h[row, n:], held, **TOL)
        edge = min(S, -(-n // CHUNK) * CHUNK) if n else S   # end of the last valid chunk
        assert torch.equal(h[row, n:edge], held[:edge - n])


@pytest.mark.parametrize("chunk", [1, CHUNK])
def test_chunked_ref_at_extreme_decays(chunk):
    """a = 1e-6: the chunk's product A underflows to exactly 0, which is
    right and must not turn into NaN; a = 1 - 1e-6: A stays near 1."""
    B, S, D = 1, 4 * CHUNK + 9, 128
    x = np.random.default_rng(5).standard_normal((B, S, D)).astype(np.float32)
    a = np.concatenate([np.full((B, S, D // 2), 1e-6, np.float32),
                        np.full((B, S, D // 2), 1 - 1e-6, np.float32)], -1)
    xt, at = torch.from_numpy(x), torch.from_numpy(a)
    A, H = chunk_aggregates(at, gated_input(xt, at), chunk)
    if chunk == CHUNK:
        assert bool((A[..., :D // 2] == 0).all())
    assert bool(torch.isfinite(A).all() and torch.isfinite(H).all())
    h = rglru_chunked_ref(xt, at, chunk=chunk)
    assert bool(torch.isfinite(h).all())
    torch.testing.assert_close(h, _seq(xt, at), **TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(jax_rglru(jnp.asarray(x), jnp.asarray(a)),
                                                     np.float32), **TOL)


def test_chunk_aggregates_compose_to_the_end_state():
    """Folding the aggregates in order over the initial state gives the
    scan's end state: the associative pair the kernel's look-back folds."""
    B, S, D = 2, 5 * CHUNK - 3, 32
    x, a = (torch.from_numpy(t) for t in _xa(B, S, D, seed=6))
    h0 = torch.randn(B, D, generator=torch.Generator().manual_seed(7))
    A, H = chunk_aggregates(a, gated_input(x, a), CHUNK)
    assert A.shape == H.shape == (B, math.ceil(S / CHUNK), D)
    state = h0
    for c in range(A.shape[1]):
        state = A[:, c] * state + H[:, c]
    torch.testing.assert_close(state, _seq(x, a, h0)[:, -1], **TOL)


# ---------------------------------------------------------------------------
# plan()
# ---------------------------------------------------------------------------


def test_plan_on_the_main_path():
    """recurrentgemma-9b (lru_width 4096): the infer_prefill step B=1
    S=2048 takes the chunked variant; the serve run's 4-row admission of
    128-token prompts keeps the step-by-step walk, its smaller waves the
    chunked one."""
    assert plan(1, 2048, 4096) == ("chunked", CHUNK)
    assert plan(2, 2048, 4096) == ("chunked", CHUNK)
    assert plan(4, 128, 4096) == ("seq", 128)
    assert plan(2, 128, 4096) == plan(1, 128, 4096) == ("chunked", CHUNK)


@pytest.mark.parametrize("B,D", [(1, 1), (1, 4096), (64, 4096), (2, 300)])
def test_plan_keeps_seq_for_at_most_two_chunks(B, D):
    for S in (1, CHUNK - 1, CHUNK, 2 * CHUNK):
        assert plan(B, S, D) == ("seq", S)


@pytest.mark.parametrize("S", [2 * CHUNK + 1, 4 * CHUNK, 4 * CHUNK + 1, 2048, 100_000])
def test_plan_keeps_seq_where_the_lanes_fill_the_card(S):
    assert plan(16, S, 4096) == ("seq", S)
    assert plan(1, S, FILL_LANES) == ("seq", S)
    assert plan(32, S, 2048) == ("seq", S)
    assert plan(1, S, FILL_LANES - 1)[0] == ("seq" if S <= 4 * CHUNK else "chunked")


def test_plan_for_short_walks_splits_at_the_short_fill():
    for S in (2 * CHUNK + 1, 3 * CHUNK, 4 * CHUNK):
        assert plan(1, S, SHORT_FILL_LANES) == ("seq", S)
        assert plan(1, S, SHORT_FILL_LANES - 1) == ("chunked", CHUNK)
    # past four chunks the short fill no longer keeps seq
    assert plan(1, 4 * CHUNK + 1, SHORT_FILL_LANES) == ("chunked", CHUNK)


def test_plan_is_pure_python_and_its_counts_cover_both_variants():
    """No tensor, no device: ints in, (str, int) out; the wrapper counts
    every variant plan() can return."""
    seen = set()
    for B in (1, 2, 3, 4, 8, 16, 64):
        for S in (1, 33, 64, 65, 128, 129, 512, 2048):
            for D in (64, 300, 2560, 4096):
                variant, chunk = plan(B, S, D)
                assert variant in VARIANTS and isinstance(chunk, int)
                assert chunk == (S if variant == "seq" else CHUNK)
                seen.add(variant)
    assert seen == set(VARIANTS)
    assert set(rglru_kernel.rglru_cuda.launches_by_variant) == set(VARIANTS)


@pytest.mark.parametrize("B,S,D", [(1, 2048, 4096), (3, 33, 300), (2, 1, 8)])
def test_scratch_words_hold_the_ticket_and_two_words_per_chunk_and_lane(B, S, D):
    assert scratch_words(B, S, D) == 1 + 2 * B * math.ceil(S / CHUNK) * D

