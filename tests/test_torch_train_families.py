"""Training the vlm and encdec families in the port against the reference,
on the CPU, at the reduced paligemma-3b and whisper-large-v3 configs in
fp32: the loss (the vlm prefix sliced off before the head; the encdec
frames encoded under the loss), plain and with the chunked
cross-entropy, and one and three train steps from bridged weights.  Also
the CPU gradients of the SSD and RG-LRU ops, which are bitwise those of
autograd through their plain versions (the ``ssd_bwd`` and ``rglru_bwd``
ops' CPU implementations).

Inputs are drawn with numpy and handed to both packages (patch
embeddings x 0.02, frames x 0.1, as the suite draws them).  Tolerances
as ``tests/test_torch_train.py`` (fp32, the frameworks summing in other
orders): the loss within 1e-5 relative; steps by its ``_assert_step``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.launch.steps import TrainHyper as RefHyper
from repro.launch.steps import make_train_step as ref_make_train_step
from repro.models import build_model as ref_build_model
from repro.optim.adamw import adamw_init as ref_adamw_init
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_arch
from repro_torch.kernels.library import rglru, rglru_bwd, ssd, ssd_bwd
from repro_torch.kernels.rglru.ref import rglru_blocked
from repro_torch.kernels.ssd.ref import ssd_ref
from repro_torch.launch.steps import TrainHyper, make_train_step
from test_torch_train import HYPER, RTOL, _assert_step, _np, _port_state

torch.set_num_threads(1)

ARCHS = ("paligemma-3b", "whisper-large-v3")


def _batch(arch, B=2, S=12, seed=0):
    """The same numpy tokens (and patch embeddings or frames) for both
    packages, at the reduced config's widths (d_model 128; 8 patch
    positions; 32 frames)."""
    rng = np.random.default_rng(seed)
    arrays = {"tokens": rng.integers(0, 512, (B, S)).astype(np.int32)}
    if arch == "paligemma-3b":
        arrays["patch_embeds"] = (rng.standard_normal((B, 8, 128)) * 0.02).astype(np.float32)
    else:
        arrays["frames"] = (rng.standard_normal((B, 32, 128)) * 0.1).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in arrays.items()},
            {k: torch.from_numpy(v) for k, v in arrays.items()})


def _ref_cfg(arch, **kw):
    return ref_get_arch(arch).reduced(compute_dtype=jnp.float32, **kw)


@pytest.fixture(scope="module")
def trajectories():
    """Per arch: the reference's initial params and its first three steps."""
    cache = {}

    def get(arch):
        if arch not in cache:
            step, model = ref_make_train_step(_ref_cfg(arch), RefHyper(**HYPER))
            params = model.init(jax.random.key(0))
            state = (params, ref_adamw_init(params))
            batch = _batch(arch)[0]
            step = jax.jit(step)
            out = []
            for _ in range(3):
                state, m = step(state, batch)
                out.append((_np(state[0]), _np(state[1]), {k: float(v) for k, v in m.items()}))
            cache[arch] = (_np(params), out)
        return cache[arch]
    return get


@pytest.mark.parametrize("chunk", [0, 5])   # 11 targets: chunked and padded
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_matches_reference(arch, chunk):
    rmodel = ref_build_model(_ref_cfg(arch, opt_ce_chunk=chunk))
    params = rmodel.init(jax.random.key(0))
    rbatch, tbatch = _batch(arch, seed=3)
    want, wm = rmodel.loss(params, rbatch)
    _, (model, _) = _port_state(_np(params), arch, opt_ce_chunk=chunk)
    got, gm = model.loss(tbatch)
    assert float(got.detach()) == pytest.approx(float(want), rel=RTOL)
    assert float(gm["ppl"]) == pytest.approx(float(wm["ppl"]), rel=RTOL)
    # the text tokens only (vlm), the frames under the loss (encdec): the
    # loss is not the one over every position, nor one without the frames
    if arch == "paligemma-3b":
        assert got.dim() == 0 and model.forward(tbatch).shape[1] == 8 + 12


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_match_reference(trajectories, arch, steps):
    p0, ref = trajectories(arch)
    tcfg, state = _port_state(p0, arch)
    step = make_train_step(tcfg, TrainHyper(**HYPER))
    batch = _batch(arch)[1]
    for _ in range(steps):
        state, metrics = step(state, batch)
    _assert_step(state, metrics, ref[steps - 1])
    assert all(p.grad is None for p in state[0].parameters())


def test_the_encoder_is_trained_through_the_loss():
    """The encoder's weights get a gradient through the cross attention,
    and the frames change the loss."""
    cfg = get_arch("whisper-large-v3").reduced(compute_dtype=torch.float32)
    params = ref_build_model(_ref_cfg("whisper-large-v3")).init(jax.random.key(0))
    model = params_from_numpy(jax.tree.map(np.asarray, params), cfg, "cpu").requires_grad_(True)
    batch = _batch("whisper-large-v3")[1]
    loss, _ = model.loss(batch)
    loss.backward()
    enc = [p for n, p in model.named_parameters() if n.startswith(("enc_blocks", "enc_"))]
    assert enc and all(p.grad is not None and bool(p.grad.abs().sum() > 0) for p in enc)
    other = dict(batch, frames=batch["frames"] * 2)
    with torch.no_grad():
        assert float(model.loss(other)[0]) != pytest.approx(float(loss), rel=1e-6)


def _ssd_arrays(B=2, S=70, H=2, P=8, N=16, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)   # noqa: E731
    return (f(B, S, H, P), np.log1p(np.exp(f(B, S, H))).astype(np.float32),
            -np.exp(f(H) * 0.3).astype(np.float32), f(B, S, N) * 0.3, f(B, S, N) * 0.3,
            f(B, H, P, N)), (f(B, S, H, P), f(B, H, P, N))


def _leaves_of(arrays):
    return [torch.from_numpy(a.copy()).requires_grad_() for a in arrays]


@pytest.mark.parametrize("op", ["ssd", "rglru"])
def test_cpu_scan_gradients_are_autograd_through_the_plain_versions(op):
    """Through the op's autograd formula (its backward op) and through the
    plain version, from an initial state and with both outputs' gradients
    given: bitwise equal."""
    if op == "ssd":
        ins, (dy, ds) = _ssd_arrays()
        got, want = _leaves_of(ins), _leaves_of(ins)
        outs = ssd(*got)
        ref_outs = ssd_ref(*want)
    else:
        rng = np.random.default_rng(1)
        x = rng.standard_normal((2, 37, 16)).astype(np.float32)
        a = (1 / (1 + np.exp(-2 * rng.standard_normal((2, 37, 16))))).astype(np.float32)
        a[..., 0] = 1.0   # the gate's clamp: s'(1) = 0
        ins = (x, a, rng.standard_normal((2, 16)).astype(np.float32))
        dy = rng.standard_normal((2, 37, 16)).astype(np.float32)
        ds = rng.standard_normal((2, 16)).astype(np.float32)
        got, want = _leaves_of(ins), _leaves_of(ins)
        outs = rglru(*got)
        h = rglru_blocked(*want)
        ref_outs = (h, h[:, -1])
    grads = (torch.from_numpy(dy), torch.from_numpy(ds))
    torch.autograd.backward(outs, grads)
    torch.autograd.backward(ref_outs, grads)
    for g, w in zip(got, want):
        assert torch.equal(g.grad, w.grad)
    # the backward op called alone gives the same gradients
    if op == "ssd":
        direct = ssd_bwd(*(t.detach() for t in got), *grads)
    else:
        direct = rglru_bwd(got[0].detach(), got[1].detach(), outs[0].detach(),
                           got[2].detach(), *grads)
    for d, w in zip(direct, want):
        assert torch.equal(d, w.grad)
