"""The RG-LRU backward's algorithm on the CPU: ``ref.rglru_bwd_ref`` (the
reverse recurrence ``csrc/rglru_bwd.cu`` runs over the forward's output)
against autograd through the plain version ``rglru_blocked`` and against
``jax.vjp`` of the reference's ``rglru_scan``; ``kernel.plan_bwd`` and
``cost_bwd``; ``opcheck`` of the ``rglru_bwd`` op; and the op's calls in
a reduced recurrentgemma train step.

Inputs are numpy draws from a seed, fp32, with lanes at a = 1 exactly
(where the gate's slope s'(a) is 0: the reference's maximum clamps
there).  Tolerance: each gradient's max abs error within 1e-4 of its
largest |value| (fp32 sums in other orders: the plain version scans in
16-step log-space blocks, the reference by an associative scan).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.rglru import rglru_scan
from repro_torch.configs import get_arch
from repro_torch.core.harness import compile_step
from repro_torch.core.suite import build_arch, get_benchmark
from repro_torch.kernels import accounting, library
from repro_torch.kernels.rglru import kernel as rk
from repro_torch.kernels.rglru.ref import rglru_blocked, rglru_bwd_ref

torch.set_num_threads(1)

TOL = 1e-4


def _inputs(B, S, D, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    a = (1 / (1 + np.exp(-2 * rng.standard_normal((B, S, D))))).astype(np.float32)
    a[..., : max(1, D // 8)] = 1.0
    f = lambda *s: rng.standard_normal(s).astype(np.float32)   # noqa: E731
    return x, a, f(B, D), f(B, S, D), f(B, D)


def _close(got, want, names=("dx", "da", "dinit")):
    for name, g, w in zip(names, got, want):
        if w is None:
            continue
        w = np.asarray(w, np.float64)
        err = np.abs(np.asarray(g, np.float64) - w).max() / np.abs(w).max()
        assert err <= TOL, f"{name}: {err:.3g} of its largest |value| (limit {TOL})"


@pytest.mark.parametrize("B,S,D,init,last", [(2, 37, 16, True, True), (1, 64, 8, False, False),
                                             (2, 300, 24, True, False),
                                             (1, 256, 16, False, True)])
def test_reverse_recurrence_matches_autograd_and_jax_vjp(B, S, D, init, last):
    x, a, h0, dh, dl = _inputs(B, S, D)
    leaves = [torch.from_numpy(t).requires_grad_() for t in (x, a, h0)]
    h = rglru_blocked(leaves[0], leaves[1], leaves[2] if init else None)
    outs, grads = ([h, h[:, -1]], [torch.from_numpy(dh), torch.from_numpy(dl)]) if last else \
        ([h], [torch.from_numpy(dh)])
    want = torch.autograd.grad(outs, leaves if init else leaves[:2], grads)
    got = rglru_bwd_ref(torch.from_numpy(x), torch.from_numpy(a), h.detach(),
                        torch.from_numpy(h0) if init else None, torch.from_numpy(dh),
                        torch.from_numpy(dl) if last else None)
    assert [tuple(g.shape) for g in got] == [x.shape, a.shape, h0.shape]
    _close(got, list(want) + ([] if init else [None]))

    @jax.jit
    def vjp(x_, a_, h0_, dh_, dl_):
        f = lambda x1, a1, h1: rglru_scan(x1, a1, h1 if init else None)   # noqa: E731
        return jax.vjp(f, x_, a_, h0_)[1]((dh_, dl_))
    jw = vjp(*(jnp.asarray(t) for t in (x, a, h0, dh)),
             jnp.asarray(dl) if last else jnp.zeros((B, D), jnp.float32))
    _close(got, [jw[0], jw[1], jw[2] if init else None])


def test_the_clamped_lanes_have_no_slope_term():
    """At a = 1 the gate is clamped: da there is g h_{t-1} alone, and dx
    is g times s(1) = 1e-6."""
    x, a, h0, dh, _ = _inputs(1, 20, 8, seed=3)
    h = rglru_blocked(*(torch.from_numpy(t) for t in (x, a, h0)))
    dx, da, _ = rglru_bwd_ref(torch.from_numpy(x), torch.from_numpy(a), h,
                              torch.from_numpy(h0), torch.from_numpy(dh), None)
    lane = 0   # a = 1 at every step: g_t = sum_{s >= t} dh_s
    g = np.cumsum(dh[0, ::-1, lane])[::-1]
    h_prev = np.concatenate([h0[:, lane], h[0, :-1, lane].numpy()])
    np.testing.assert_allclose(da[0, :, lane].numpy(), g * h_prev, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(dx[0, :, lane].numpy(), g * 1e-6, rtol=1e-5)


def test_plan_and_cost_bwd():
    assert rk.plan_bwd(1, 2048, 4096) == "seq" and rk.BWD_VARIANTS == ("seq",)
    flops, nbytes = rk.cost_bwd(1, 2048, 4096, False, False)
    assert flops == 12 * 2048 * 4096
    # x, a, h, dh read and dx, da written in fp32; dinit written: 201 MB
    assert nbytes == 4 * (6 * 2048 * 4096 + 4096) and round(nbytes / 1e6) == 201
    assert rk.cost_bwd(2, 8, 16, True, True)[1] - rk.cost_bwd(2, 8, 16, False, False)[1] \
        == 2 * 4 * 2 * 16


def test_opcheck_of_the_backward_op():
    x, a, h0, dh, dl = (torch.from_numpy(t) for t in _inputs(2, 21, 8))
    h = rglru_blocked(x, a, h0)
    for args in ((x, a, h, h0, dh, dl), (x, a, h, None, dh, None)):
        result = torch.library.opcheck(library.rglru_bwd, args)
        assert set(result.values()) == {"SUCCESS"}, result


class _Calls:
    """An analysis pass that records the kernel calls (``accounting``)."""

    def __init__(self):
        self.depth = 0
        self.names = []

    def add_kernel(self, name, flops, nbytes):
        self.names.append(name)


@pytest.mark.parametrize("compiled", [False, True])
def test_a_train_step_calls_the_backward_op_once_per_recurrent_layer(compiled):
    """A reduced recurrentgemma train step on the CPU (three layers, two
    recurrent), uncompiled and compiled (``aot_eager``, which keeps each op
    one call, as Inductor does on the card): one ``rglru_bwd`` call per
    recurrent layer, two ``rglru`` calls (the forward again under
    ``remat="full"``), no CUDA launch."""
    cfg = get_arch("recurrentgemma-9b").reduced(n_layers=3)
    built = build_arch("recurrentgemma-9b", {"n_layers": 3}, device="cpu")
    step, args, _ = get_benchmark("recurrentgemma-9b", "train").make(batch=1, seq=20,
                                                                      built=built)
    if compiled:
        step = compile_step(step, "cpu")
    launches = rk.rglru_bwd_cuda.launches
    calls = _Calls()
    with accounting.accounting(calls):
        step(*args)
    assert calls.names.count("rglru_bwd") == cfg.pattern_rec == 2
    assert calls.names.count("rglru") == 2 * cfg.pattern_rec
    assert rk.rglru_bwd_cuda.launches == launches
