"""The hand-written CUDA flash-attention backward against its plain
version (``ref.attention_bwd_ref``) on the card, over the cases of
``chip_smoke.py``'s ``fa_backward_kernels``: gemma-2b at full width
(B=1, S=2048, 8 query heads over 1 kv head of 256) in bf16 and fp32, the
reduced config (D=32), the local and prefix masks, softcap, and K=2.
Both variants on every case: the planned one (``tc`` in bf16, ``simt``
in fp32) through the counted wrapper, and ``simt`` in bf16 through the
uncounted ``launch_bwd``; a bitwise-equal rerun on every case; the
refusals; both variants at a query offset with keys past kv_len; and
the op's autograd path through the kernels.

These tests need a Hopper card (compute capability 9.0 or above) and
``nvcc``; elsewhere they skip.  Whether there is such a card is decided in
the ``hopper`` fixture, never at import.  Run them on the card with
``PYTHONPATH=src python -m pytest -q --noconftest -m gpu
tests/test_torch_flash_bwd_gpu.py``.

Tolerance, relative to each gradient's largest |value|: 1e-4 in fp32 (the
same fp32 math, other sums), 3e-2 in bf16 (inputs and gradients rounded
to bf16; the plain version computes in fp32 from the same bf16 inputs).
"""
import pytest
import torch

from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_bwd_ref, attention_ref

pytestmark = pytest.mark.gpu

TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}

CASES = {   # B, S, H, K, D, attention keywords
    "gemma2b": (1, 2048, 8, 1, 256, {}),
    "reduced": (2, 64, 4, 1, 32, {}),
    "local": (1, 300, 4, 1, 64, dict(mask_type="local", window=100)),
    "prefix": (1, 300, 4, 1, 64, dict(mask_type="prefix", prefix_len=70)),
    "softcap": (1, 256, 8, 1, 128, dict(softcap=30.0)),
    "k2": (2, 200, 8, 2, 64, {}),
}


@pytest.fixture
def hopper():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    if torch.cuda.get_device_capability(0) < (9, 0):
        pytest.skip("needs compute capability 9.0 or above (sm_90a)")
    torch.backends.cuda.matmul.allow_tf32 = False   # the plain version in fp32
    return torch.device("cuda", 0)


def _inputs(dev, dtype, B, S, H, K, D):
    g = torch.Generator().manual_seed(0)
    return [torch.randn(s, generator=g).to(dev, dtype)
            for s in ((B, S, H, D), (B, S, K, D), (B, S, K, D), (B, S, H, D))]


def _bwd(q, k, v, o, do, kw):
    return fa_kernel.flash_attention_bwd_cuda(
        q, k, v, o, do, q_offset=0, kv_len=k.shape[1], scale=q.shape[-1] ** -0.5,
        mask_type=kw.get("mask_type", "causal"), window=kw.get("window", 0),
        prefix_len=kw.get("prefix_len", 0), softcap=kw.get("softcap", 0.0))


def _check(got, want, dtype):
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == dtype and g.shape == w.shape
        err = (g.float() - w.float()).abs().max() / w.float().abs().max()
        assert err <= TOL[dtype], f"{name}: {err}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(CASES))
def test_bwd_kernel_matches_plain(hopper, case, dtype):
    """The planned variant (bf16: ``tc``, fp32: ``simt``), counted once."""
    B, S, H, K, D, kw = CASES[case]
    q, k, v, do = _inputs(hopper, dtype, B, S, H, K, D)
    o = flash_attention(q, k, v, **kw)
    bwd = fa_kernel.flash_attention_bwd_cuda
    variant = fa_kernel.plan_bwd(B, S, S, H, K, D, dtype)
    assert variant == ("tc" if dtype == torch.bfloat16 else "simt")
    before = (bwd.launches, bwd.launches_by_variant[variant])
    got = _bwd(q, k, v, o, do, kw)
    torch.cuda.synchronize()
    assert (bwd.launches, bwd.launches_by_variant[variant]) == (before[0] + 1, before[1] + 1)
    _check(got, attention_bwd_ref(q, k, v, o, do, **kw), dtype)


@pytest.mark.parametrize("case", sorted(CASES))
def test_bwd_simt_in_bf16_matches_plain(hopper, case):
    """The CUDA-core variant on the bf16 inputs the plan gives ``tc``,
    through the uncounted ``launch_bwd``."""
    B, S, H, K, D, kw = CASES[case]
    q, k, v, do = _inputs(hopper, torch.bfloat16, B, S, H, K, D)
    o = flash_attention(q, k, v, **kw)
    before = fa_kernel.flash_attention_bwd_cuda.launches
    got = fa_kernel.launch_bwd(
        q, k, v, o, do, "simt", q_offset=0, kv_len=S, scale=D ** -0.5,
        mask_type=kw.get("mask_type", "causal"), window=kw.get("window", 0),
        prefix_len=kw.get("prefix_len", 0), softcap=kw.get("softcap", 0.0))
    torch.cuda.synchronize()
    assert fa_kernel.flash_attention_bwd_cuda.launches == before
    _check(got, attention_bwd_ref(q, k, v, o, do, **kw), torch.bfloat16)


@pytest.mark.parametrize("variant,dtype", [("tc", torch.bfloat16), ("simt", torch.bfloat16),
                                           ("simt", torch.float32)])
@pytest.mark.parametrize("kw", [dict(mask_type="causal"),
                                dict(mask_type="local", window=50)])
def test_bwd_kernel_at_an_offset_with_keys_past_kv_len(hopper, variant, dtype, kw):
    """Queries 120-219 over 230 keys of which 210 count: keys past kv_len
    (no gradient), a last key block of 38 keys, a key block no query sees
    (local), and query chunks of different counts a key block."""
    q, k, v, do = _inputs(hopper, dtype, 2, 100, 8, 1, 64)
    k, v = (torch.cat([x, x, x[:, :30]], 1).contiguous() for x in (k, v))   # Sk = 230
    kw = dict(dict(window=0, prefix_len=0, q_offset=120, kv_len=210), **kw)
    o = attention_ref(q, k, v, softmax_scale=0.125, **kw).contiguous()
    got = fa_kernel.launch_bwd(q, k, v, o, do, variant, scale=0.125, softcap=0.0, **kw)
    torch.cuda.synchronize()
    want = attention_bwd_ref(q, k, v, o, do, softmax_scale=0.125, **kw)
    _check(got, want, dtype)
    assert float(got[1][:, 210:].float().abs().max()) == 0.0


@pytest.mark.parametrize("dtype,H", [(torch.float32, 4), (torch.bfloat16, 3)])
def test_bwd_tc_refuses_what_it_cannot_take(hopper, dtype, H):
    """No variant stands in for another: ``tc`` on fp32 inputs, or on a
    group size that does not divide 64, raises."""
    q, k, v, do = _inputs(hopper, dtype, 1, 128, H, 1, 64)
    o = flash_attention(q, k, v)
    with pytest.raises(RuntimeError, match=r"\(tc\) launch failed"):
        fa_kernel.launch_bwd(q, k, v, o, do, "tc", q_offset=0, kv_len=128, scale=0.125,
                             mask_type="causal", window=0, prefix_len=0, softcap=0.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(CASES))
def test_bwd_kernel_is_deterministic(hopper, case, dtype):
    """A rerun of the planned variant (bf16: ``tc``) is bitwise equal."""
    B, S, H, K, D, kw = CASES[case]
    q, k, v, do = _inputs(hopper, dtype, B, S, H, K, D)
    o = flash_attention(q, k, v, **kw)
    first = _bwd(q, k, v, o, do, kw)
    second = _bwd(q, k, v, o, do, kw)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_bwd_kernel_refuses_per_row_offsets(hopper):
    q, k, v, do = _inputs(hopper, torch.bfloat16, 2, 64, 4, 1, 32)
    o = flash_attention(q, k, v)
    rows = torch.tensor([0, 3], dtype=torch.int32, device=hopper)
    with pytest.raises(ValueError, match="q_offset must be an int"):
        fa_kernel.flash_attention_bwd_cuda(q, k, v, o, do, q_offset=rows, kv_len=64,
                                           mask_type="causal", window=0, prefix_len=0,
                                           scale=0.2, softcap=0.0)
    with pytest.raises(ValueError, match="kv_len must be an int"):
        fa_kernel.flash_attention_bwd_cuda(q, k, v, o, do, q_offset=0, kv_len=rows,
                                           mask_type="causal", window=0, prefix_len=0,
                                           scale=0.2, softcap=0.0)


def test_op_gradient_runs_both_kernels(hopper):
    """Under autograd the op launches the forward kernel, saves q, k, v
    and o, and its backward is the backward kernel."""
    q, k, v, do = _inputs(hopper, torch.bfloat16, 1, 256, 8, 1, 256)
    fwd, bwd = fa_kernel.flash_attention_cuda, fa_kernel.flash_attention_bwd_cuda
    before = (fwd.launches, bwd.launches, bwd.launches_by_variant["tc"])
    qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
    o = flash_attention(qg, kg, vg)
    o.backward(do)
    torch.cuda.synchronize()
    assert (fwd.launches, bwd.launches, bwd.launches_by_variant["tc"]) == (
        before[0] + 1, before[1] + 1, before[2] + 1)
    want = attention_bwd_ref(q, k, v, o.detach(), do)
    for g, w in zip((qg.grad, kg.grad, vg.grad), want):
        assert ((g.float() - w.float()).abs().max() / w.float().abs().max()) <= TOL[torch.bfloat16]
