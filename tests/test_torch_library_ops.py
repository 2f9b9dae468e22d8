"""The port's four kernels as ``torch.library`` custom ops
(``repro_torch/kernels/library.py``), on the CPU: ``opcheck`` of each op,
each op against the reference's Pallas kernel (interpret mode) on the
same numpy inputs, the ops compiled (``aot_eager``) against eager, the
gradients against autograd through the plain versions, and each call one
unit of account for the analysis and coverage passes.

Tolerances: the ops against the reference's kernels 2e-5 (fp32, sums in
other orders), as ``tests/test_torch_kernels.py``; compiled against eager
and the gradients against autograd through the plain version bitwise
(the same ops on the same values).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as ref_flash
from repro.kernels.rglru.ops import rglru as ref_rglru
from repro.kernels.ssd.ops import ssd as ref_ssd
from repro_torch.core.coverage import step_surfaces
from repro_torch.core.harness import compile_step, dynamo_counts
from repro_torch.core.hloanalysis import analyze_step
from repro_torch.kernels import accounting, flash_attention, library, rglru, ssd
from repro_torch.kernels.accounting import SCOPE_PREFIX
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.rglru.ref import rglru_blocked
from repro_torch.kernels.ssd.ref import ssd_ref

torch.set_num_threads(1)

TOL = 2e-5


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _qkv(B=2, Sq=16, Sk=16, H=4, K=2, D=32, seed=0):
    rng = np.random.default_rng(seed)
    return _rand(rng, B, Sq, H, D), _rand(rng, B, Sk, K, D), _rand(rng, B, Sk, K, D)


def _ssd_np(B=1, S=80, H=2, P=8, N=16, seed=0):
    rng = np.random.default_rng(seed)
    return (_rand(rng, B, S, H, P), rng.uniform(0.01, 0.2, (B, S, H)).astype(np.float32),
            -rng.uniform(0.5, 2.0, (H,)).astype(np.float32), _rand(rng, B, S, N),
            _rand(rng, B, S, N))


def _xa_np(B=2, S=40, D=16, seed=0):
    rng = np.random.default_rng(seed)
    return _rand(rng, B, S, D), rng.uniform(0.5, 0.99, (B, S, D)).astype(np.float32)


def _t(*arrays, grad=False):
    return [torch.from_numpy(a.copy()).requires_grad_(grad) for a in arrays]


def _rows(*values):
    return torch.tensor(values, dtype=torch.int32)


# ---- opcheck ------------------------------------------------------------------

def _opcheck_cases():
    q, k, v = _t(*_qkv(), grad=True)
    o = attention_ref(q, k, v).detach()
    plain = ("causal", 0, 0, 0, None, None, None, None, 0.0)
    rowed = ("local", 6, 0, 0, _rows(3, 5), None, _rows(12, 16), 0.2, 5.0)
    x, dt, A, Bm, Cm = _t(*_ssd_np())
    x.requires_grad_()
    xr, a = _t(*_xa_np())
    xr.requires_grad_()
    return {
        "flash_attention": (library.flash_attention, (q, k, v) + plain),
        "flash_attention_rows": (library.flash_attention, (q, k, v) + rowed),
        "flash_attention_bwd": (library.flash_attention_bwd,
                                (q.detach(), k.detach(), v.detach(), o,
                                 torch.randn_like(o)) + plain),
        "ssd": (library.ssd, (x, dt, A, Bm, Cm, None)),
        "ssd_init": (library.ssd, (x, dt, A, Bm, Cm, torch.randn(1, 2, 8, 16))),
        "rglru": (library.rglru, (xr, a, None)),
        "rglru_init": (library.rglru, (xr, a, torch.randn(2, 16))),
    }


@pytest.mark.parametrize("case", sorted(_opcheck_cases()))
def test_opcheck(case):
    op, args = _opcheck_cases()[case]
    result = torch.library.opcheck(op, args)
    assert set(result.values()) == {"SUCCESS"}, result


def test_the_ops_are_registered_in_one_namespace():
    for name in ("flash_attention", "flash_attention_bwd", "ssd", "rglru"):
        packet = getattr(torch.ops.repro_torch, name)
        assert packet.default.namespace == "repro_torch"


def test_a_device_without_an_implementation_raises():
    q, k, v = (t.to("meta") for t in _t(*_qkv()))
    with pytest.raises(ValueError, match="no path"):
        flash_attention(q, k, v)


# ---- the ops against the reference's kernels -------------------------------------

def test_flash_attention_op_matches_the_reference_kernel():
    q, k, v = _qkv(B=1, Sq=64, Sk=64, H=4, K=2, D=32)
    got = flash_attention(*_t(q, k, v), q_offset=0, softcap=20.0)
    want = ref_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), softcap=20.0,
                     block_q=32, block_k=32, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


def test_ssd_op_matches_the_reference_kernel():
    arrays = _ssd_np(B=1, S=64, H=2, P=16, N=16)
    y, _ = ssd(*_t(*arrays))
    want = ref_ssd(*(jnp.asarray(a) for a in arrays), chunk=32, interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(want), atol=5e-5, rtol=5e-5)


def test_rglru_op_matches_the_reference_kernel():
    x, a = _xa_np(B=1, S=64, D=128)
    h, last = rglru(*_t(x, a))
    want = np.asarray(ref_rglru(jnp.asarray(x), jnp.asarray(a), block_t=16,
                                interpret=True))
    np.testing.assert_allclose(h.numpy(), want, atol=TOL, rtol=TOL)
    assert torch.equal(last, h[:, -1]) and last.data_ptr() != h[:, -1].data_ptr()


# ---- compiled against eager --------------------------------------------------------

def _attention_layer(q, k, v, qo, kl):
    return flash_attention(q * 2, k, v, mask_type="local", window=6, q_offset=qo,
                           kv_len=kl).sum(-1)


def _ssm_layer(x, dt, A, Bm, Cm, a):
    y, state = ssd(x.tanh(), dt, A, Bm, Cm)
    h, last = rglru(y.flatten(2), a)
    return h + 1, state.sum() + last.sum()


def test_compiled_calls_trace_the_ops_whole_and_match_eager():
    """One graph, no break, and the op's values bitwise, for scalar and
    per-row offsets (the decode path's)."""
    q, k, v = _t(*_qkv())
    x, dt, A, Bm, Cm = _t(*_ssd_np(B=2, S=40, H=2, P=8, N=16))
    _, a = _t(*_xa_np(B=2, S=40, D=16))
    for fn, args in ((_attention_layer, (q, k, v, 0, None)),
                     (_attention_layer, (q, k, v, _rows(3, 5), _rows(12, 16))),
                     (_ssm_layer, (x, dt, A, Bm, Cm, a))):
        c0 = dynamo_counts()
        got = compile_step(fn, "cpu")(*args)
        c1 = dynamo_counts()
        assert c1["graph_breaks"] == c0["graph_breaks"]
        assert c1["graphs"] - c0["graphs"] == 1
        for g, w in zip(torch.utils._pytree.tree_leaves(got),
                        torch.utils._pytree.tree_leaves(fn(*args))):
            assert torch.equal(g, w)


def test_a_compiled_call_is_counted_once_by_the_analysis_pass():
    """The scope lies inside the op's implementation, which runs when the
    op runs: an eager call and the compiled one each count one call of
    ``cost()`` work (the pass itself runs the compiled callable's step
    uncompiled, under its dispatch mode)."""
    q, k, v = _t(*_qkv())
    fn = lambda q, k, v: _attention_layer(q, k, v, 0, None)   # noqa: E731
    compiled = compile_step(fn, "cpu")
    compiled(q, k, v)
    want = fa_kernel.cost(2, 16, 16, 4, 2, 32, torch.float32, mask_type="local",
                          window=6)
    for call in (fn, compiled):
        cost = analyze_step(call, (q, k, v))
        assert cost.notes == ["kernel calls: flash_attention 1"]
        assert cost.flops_by_class["attention"] == want[0]
        assert cost.bytes_by_class["attention"] == want[1]


def test_the_passes_see_no_op_of_the_namespace():
    q, k, v = _t(*_qkv(), grad=True)
    api, aten = step_surfaces(lambda: flash_attention(q, k, v).sum().backward())
    assert not any(n.startswith(("repro_torch::", "repro_torch.flash")) for n in aten | api)
    assert {SCOPE_PREFIX + "flash_attention", SCOPE_PREFIX + "flash_attention_bwd"} <= aten


# ---- gradients ------------------------------------------------------------------------

def test_flash_gradient_is_autograd_through_the_plain_version_bitwise():
    q, k, v = _t(*_qkv(), grad=True)
    flash_attention(q, k, v, softcap=5.0, mask_type="local", window=5).square().sum().backward()
    q2, k2, v2 = _t(*_qkv(), grad=True)
    attention_ref(q2, k2, v2, softcap=5.0, mask_type="local",
                  window=5).square().sum().backward()
    for a, b in ((q, q2), (k, k2), (v, v2)):
        assert torch.equal(a.grad, b.grad)


def test_ssd_and_rglru_gradients_are_autograd_through_the_plain_versions():
    arrays = _ssd_np(B=1, S=70, H=2, P=8, N=16)
    got, want = _t(*arrays, grad=True), _t(*arrays, grad=True)
    y, s = ssd(*got)
    (y.square().sum() + s.sum()).backward()
    y, s = ssd_ref(*want)
    (y.square().sum() + s.sum()).backward()
    for g, w in zip(got, want):
        assert torch.equal(g.grad, w.grad)
    xa = _xa_np()
    got, want = _t(*xa, grad=True), _t(*xa, grad=True)
    h, last = rglru(*got)
    (h.square().sum() + last.sum()).backward()
    h = rglru_blocked(*want)
    (h.square().sum() + h[:, -1].sum()).backward()
    for g, w in zip(got, want):
        assert torch.equal(g.grad, w.grad)


def test_only_the_flash_op_has_a_gradient_on_the_card(monkeypatch):
    """Every forward op has a gradient on the card: the SSD's and RG-LRU's
    backward go through their backward ops, ``repro_torch::ssd_bwd`` and
    ``repro_torch::rglru_bwd`` (the kernels on the card), as the flash
    op's goes through ``flash_attention_bwd``.  CPU tensors that claim to
    lie on the card stand in for the card here (the old refusal read
    ``is_cuda``); the ops run their CPU implementations.  The name is the
    one the test had while only the flash op had a gradient there."""
    arrays = _ssd_np(B=1, S=8, H=2, P=8, N=16)
    xa = _xa_np(B=1, S=8, D=16)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    seen = []

    class Calls:
        depth = 0

        def add_kernel(self, name, flops, nbytes):
            seen.append(name)

    with accounting.accounting(Calls()):
        y, state = ssd(*_t(*arrays, grad=True))
        (y.sum() + state.sum()).backward()
        h, last = rglru(*_t(*xa, grad=True))
        (h.sum() + last.sum()).backward()
    assert seen == ["ssd", "ssd_bwd", "rglru", "rglru_bwd"]
    y, state = ssd(*_t(*arrays))
    assert y.shape == arrays[0].shape and state.shape == (1, 2, 8, 16)
