"""The SSD backward's algorithm on the CPU: ``ref.ssd_bwd_ref`` (the
reverse passes ``csrc/ssd_bwd.cu`` runs) against autograd through the
plain version ``ssd_ref`` and against ``jax.vjp`` of the reference's
``ssd_chunked``; ``kernel.plan_bwd``, ``cost_bwd`` and the scratch sizes;
and the op's calls in a reduced mamba2 train step.

Inputs are numpy draws from a seed, fp32.  Tolerance: each gradient's
max abs error within 1e-4 of its largest |value| (fp32 sums in other
orders).  At a strong decay (A = -50) fp32 autograd through ``ssd_ref``
itself strays ~4e-3 in dA (the decays' gradient cancels there), so that
case is held to autograd through ``ssd_ref`` in float64.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.ssm import ssd_chunked
from repro_torch.configs import get_arch
from repro_torch.core.harness import compile_step
from repro_torch.core.suite import build_arch, get_benchmark
from repro_torch.kernels import accounting
from repro_torch.kernels.ssd import kernel as sk
from repro_torch.kernels.ssd.ref import CHUNK, ssd_bwd_ref, ssd_ref

torch.set_num_threads(1)

TOL = 1e-4
NAMES = ("dx", "ddt", "dA", "dBm", "dCm", "dinit")


def _inputs(B, S, H, P, N, seed=0, decay=None):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)   # noqa: E731
    A = -np.exp(f(H) * 0.3) if decay is None else np.full(H, decay, np.float32)
    ins = (f(B, S, H, P), np.log1p(np.exp(f(B, S, H))).astype(np.float32),
           A.astype(np.float32), f(B, S, N) * 0.3, f(B, S, N) * 0.3, f(B, H, P, N))
    return ins, (f(B, S, H, P), f(B, H, P, N))


def _autograd(ins, outs_grad, init, dstate, dtype=torch.float32):
    leaves = [torch.from_numpy(a).to(dtype).requires_grad_() for a in ins]
    if not init:
        leaves[5] = None
    y, state = ssd_ref(*leaves)
    dy, ds = (torch.from_numpy(g).to(dtype) for g in outs_grad)
    outs, grads = ((y, state), (dy, ds)) if dstate else ((y,), (dy,))
    got = torch.autograd.grad(outs, [t for t in leaves if t is not None], grads)
    return list(got) + ([] if init else [None])


def _close(got, want, names=NAMES, tol=TOL):
    for name, g, w in zip(names, got, want):
        if w is None:
            continue
        w = np.asarray(w, np.float64)
        err = np.abs(np.asarray(g, np.float64) - w).max() / np.abs(w).max()
        assert err <= tol, f"{name}: {err:.3g} of its largest |value| (limit {tol})"


CASES = [  # (B, S, H, P, N, init, dstate)
    (2, 70, 3, 8, 16, True, True),       # a ragged second chunk, both carries
    (1, 40, 2, 16, 16, False, False),    # under one chunk, no state in or out
    (1, 2 * CHUNK, 2, 16, 32, True, False),
    (2, 3 * CHUNK + 5, 2, 8, 8, False, True),
]


@pytest.mark.parametrize("B,S,H,P,N,init,dstate", CASES)
def test_reverse_passes_match_autograd_and_jax_vjp(B, S, H, P, N, init, dstate):
    ins, outs_grad = _inputs(B, S, H, P, N)
    t = [torch.from_numpy(a) for a in ins]
    got = ssd_bwd_ref(*t[:5], t[5] if init else None, torch.from_numpy(outs_grad[0]),
                      torch.from_numpy(outs_grad[1]) if dstate else None)
    for g, a in zip(got, ins):
        assert g.shape == a.shape and g.dtype == torch.float32
    _close(got, _autograd(ins, outs_grad, init, dstate))

    def f(x, dt, A, Bm, Cm, h0):
        return ssd_chunked(x, dt, A, Bm, Cm, 32, h0 if init else None)
    _, vjp = jax.vjp(f, *(jnp.asarray(a) for a in ins))
    cot = (jnp.asarray(outs_grad[0]),
           jnp.asarray(outs_grad[1]) if dstate else jnp.zeros(ins[5].shape, jnp.float32))
    want = vjp(cot)
    _close(got, [w if i < 5 or init else None for i, w in enumerate(want)])


def test_strong_decay_against_float64_autograd():
    ins, outs_grad = _inputs(2, 37 + CHUNK, 2, 16, 16, seed=1, decay=-50.0)
    t = [torch.from_numpy(a) for a in ins]
    got = ssd_bwd_ref(*t, *(torch.from_numpy(g) for g in outs_grad))
    _close(got, _autograd(ins, outs_grad, True, True, torch.float64))


def test_dinit_is_the_gradient_carried_through_every_chunk():
    """With no steps' outputs wanted (dy = 0), dinit is dstate decayed by
    every step, prod_t e^(dt_t A) per head, and C gets no gradient."""
    ins, (dy, ds) = _inputs(1, 150, 2, 8, 8, seed=2)
    t = [torch.from_numpy(a) for a in ins]
    got = ssd_bwd_ref(*t, torch.zeros_like(torch.from_numpy(dy)), torch.from_numpy(ds))
    decay = np.exp((ins[1].astype(np.float64) * ins[2]).sum(1))[0]   # (H,)
    np.testing.assert_allclose(got[5][0].numpy(), ds[0] * decay[:, None, None], rtol=1e-4,
                               atol=1e-6 * np.abs(ds).max())
    assert not got[4].abs().any() and got[0].abs().any()


def test_plan_bwd_rules_and_shared_memory():
    assert sk.plan_bwd(1, 2048, 80, 64, 128, torch.bfloat16) == "simt"
    assert sk.plan_bwd(2, 37, 16, 16, 16, torch.float32) == "simt"
    state, chunk = sk.bwd_shared_memory_bytes(64, 128)
    assert chunk <= sk.MAX_BLOCK_SMEM and state < chunk
    for bad in [dict(P=12, N=16), dict(P=16, N=136), dict(P=128, N=128)]:
        with pytest.raises(ValueError, match="ssd backward"):
            sk.plan_bwd(1, 64, 2, bad["P"], bad["N"], torch.float32)
    with pytest.raises(ValueError, match="dtype"):
        sk.plan_bwd(1, 64, 2, 16, 16, torch.float16)


def test_scratch_and_cost_bwd():
    # mamba2-2.7b's train shape: 32 chunks of 64 steps
    B, S, H, P, N = 1, 2048, 80, 64, 128
    nc = S // CHUNK
    floats = sk.bwd_scratch_floats(B, S, H, P, N)
    assert floats == 2 * nc * H * P * N + 2 * nc * H + 2 * S * H * N
    assert 4 * nc * H * P * N == 83_886_080     # one (P, N) scratch: 84 MB
    flops, nbytes = sk.cost_bwd(B, S, H, P, N, torch.bfloat16, False, True)
    # x, dy, dx; B, C, dB, dC in bf16; dt, ddt, A, dA in fp32; dstate, dinit
    assert nbytes == 2 * (3 * S * H * P + 4 * S * N) + 4 * (2 * S * H + 2 * H) + 8 * H * P * N
    # the products at the kernel's chunk: ~21.5 GFLOP there
    n = CHUNK
    per_chunk = 2 * n * n * N + H * (4 * n * n * P + 4 * n * n * N + 10 * n * P * N)
    assert flops == math.ceil(S / n) * per_chunk
    assert 21.4e9 < flops < 21.6e9
    # a ragged tail costs its own length's products; init adds its bytes
    f2, b2 = sk.cost_bwd(2, 300, 3, 16, 16, torch.float32, True, True)
    tail = 2 * 44 * 44 * 16 + 3 * (4 * 44 * 44 * 16 * 2 + 10 * 44 * 256)
    assert f2 == 2 * (4 * (2 * n * n * 16 + 3 * (8 * n * n * 16 + 10 * n * 256)) + tail)
    assert b2 - sk.cost_bwd(2, 300, 3, 16, 16, torch.float32, False, True)[1] == 4 * 2 * 3 * 256


class _Calls:
    """An analysis pass that records the kernel calls (``accounting``)."""

    def __init__(self):
        self.depth = 0
        self.names = []

    def add_kernel(self, name, flops, nbytes):
        self.names.append(name)


@pytest.mark.parametrize("compiled", [False, True])
def test_a_train_step_calls_the_backward_op_once_per_layer(compiled):
    """A reduced mamba2 train step on the CPU, uncompiled and compiled
    (``aot_eager``, which keeps each op one call, as Inductor does on the
    card): one ``ssd_bwd`` call per layer (its CPU implementation), two
    ``ssd`` calls (the forward again under ``remat="full"``), and no CUDA
    launch."""
    built = build_arch("mamba2-2.7b", {"n_layers": 2}, device="cpu")
    step, args, _ = get_benchmark("mamba2-2.7b", "train").make(batch=1, seq=70, built=built)
    if compiled:
        step = compile_step(step, "cpu")
    launches = sk.ssd_bwd_cuda.launches
    calls = _Calls()
    with accounting.accounting(calls):
        step(*args)
    layers = get_arch("mamba2-2.7b").reduced(n_layers=2).n_layers
    assert (calls.names.count("ssd_bwd"), calls.names.count("ssd")) == (layers, 2 * layers)
    assert sk.ssd_bwd_cuda.launches == launches


def test_opcheck_of_the_backward_op():
    from repro_torch.kernels import library
    ins, (dy, ds) = _inputs(1, 70, 2, 8, 16, seed=4)
    t = [torch.from_numpy(a) for a in ins]
    for args in ((*t, torch.from_numpy(dy), torch.from_numpy(ds)),
                 (*t[:5], None, torch.from_numpy(dy), None)):
        result = torch.library.opcheck(library.ssd_bwd, args)
        assert set(result.values()) == {"SUCCESS"}, result
