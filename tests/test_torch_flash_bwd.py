"""The plain flash-attention backward (``ref.attention_bwd_ref``, the
FlashAttention-2 formulas the backward kernel is held against on the
card) against autograd of the plain forward ``ref.attention_ref``, on the
CPU, and the op's gradient path there.

Tolerance 1e-5 (absolute and relative) in fp32: the same math through
other sums (P from lse, delta from the output), at small shapes.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_bwd_ref, attention_ref

torch.set_num_threads(1)

TOL = 1e-5


def _inputs(B, Sq, Sk, H, K, D, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for s in ((B, Sq, H, D), (B, Sk, K, D), (B, Sk, K, D), (B, Sq, H, D))]


def _autograd(q, k, v, do, **kw):
    q, k, v = (t.clone().requires_grad_(True) for t in (q, k, v))
    o = attention_ref(q, k, v, **kw)
    o.backward(do)
    return o.detach(), (q.grad, k.grad, v.grad)


@pytest.mark.parametrize("K", [1, 2])
@pytest.mark.parametrize("softcap", [0.0, 5.0])
@pytest.mark.parametrize("mask,window,prefix", [("causal", 0, 0), ("local", 7, 0),
                                                ("full", 0, 0), ("prefix", 0, 9)])
def test_bwd_ref_matches_autograd_of_forward(mask, window, prefix, softcap, K):
    q, k, v, do = _inputs(2, 24, 24, 4, K, 16)
    kw = dict(mask_type=mask, window=window, prefix_len=prefix, softcap=softcap)
    o, want = _autograd(q, k, v, do, **kw)
    got = attention_bwd_ref(q, k, v, o, do, **kw)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        torch.testing.assert_close(g, w, atol=TOL, rtol=TOL, msg=name)


def test_bwd_ref_with_offset_kv_len_and_scale():
    """A query block at an offset into a longer key range, keys past
    kv_len masked, an explicit scale: the serve path's arguments."""
    q, k, v, do = _inputs(2, 8, 20, 4, 2, 12, seed=3)
    kw = dict(mask_type="causal", q_offset=10, kv_len=17, softmax_scale=0.3)
    o, want = _autograd(q, k, v, do, **kw)
    got = attention_bwd_ref(q, k, v, o, do, **kw)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=TOL, rtol=TOL)
    assert float(got[1][:, 17:].abs().max()) == 0.0   # keys past kv_len get none


def test_op_differentiates_the_plain_path_on_cpu():
    """On the CPU the op is ``attention_ref`` and autograd runs through
    it: its gradients are the formulas', and no kernel is launched."""
    q, k, v, do = _inputs(1, 16, 16, 4, 1, 8, seed=1)
    before = (fa_kernel.flash_attention_cuda.launches,
              fa_kernel.flash_attention_bwd_cuda.launches)
    qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
    o = flash_attention(qg, kg, vg, mask_type="causal", softcap=3.0)
    o.backward(do)
    want = attention_bwd_ref(q, k, v, o.detach(), do, softcap=3.0)
    for g, w in zip((qg.grad, kg.grad, vg.grad), want):
        torch.testing.assert_close(g, w, atol=TOL, rtol=TOL)
    assert (fa_kernel.flash_attention_cuda.launches,
            fa_kernel.flash_attention_bwd_cuda.launches) == before


def test_bwd_kernel_wrapper_refuses_cpu_tensors():
    q, k, v, do = _inputs(1, 8, 8, 2, 1, 8)
    with pytest.raises(ValueError, match="CUDA"):
        fa_kernel.flash_attention_bwd_cuda(q, k, v, q, do, q_offset=0, kv_len=8,
                                           mask_type="causal", window=0,
                                           prefix_len=0, scale=0.3, softcap=0.0)
