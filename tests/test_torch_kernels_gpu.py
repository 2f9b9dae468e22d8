"""The hand-written CUDA flash-attention kernels against their plain
version on the card, at the shapes of ``tests/test_kernels.py`` plus the
per-row offsets, GQA and prefix mask the model path needs, and each of
the three variants ``kernel.plan`` chooses between: ``tc`` (bf16
tensor-core prefill, D in {32, 64, 128, 256}, one or two
warpgroups), ``split`` (split-KV decode, bf16 and fp32) and ``simt``.

These tests need a Hopper card (compute capability 9.0 or above) and
``nvcc``; elsewhere they skip.  Whether there is such a card is decided in
the ``hopper`` fixture, never at import, so every test worker collects
the same tests.  Run them on the card with ``PYTHONPATH=src python -m
pytest -q --noconftest -m gpu tests/test_torch_kernels_gpu.py`` (the
suite's conftest imports JAX; this file needs only torch).

Tolerances as in ``tests/test_kernels.py``: 2e-5 in fp32 (same math,
another summation order), 2e-2 in bf16 (outputs rounded to bf16).  The
``tc`` variant also rounds the probabilities P to bf16 before P·V (the
tensor cores take bf16 operands): a relative error of at most 2^-9 per
term of a convex combination, well inside 2e-2.
"""
import pytest
import torch

from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref

pytestmark = pytest.mark.gpu

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def hopper():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    if torch.cuda.get_device_capability(0) < (9, 0):
        pytest.skip("needs compute capability 9.0 or above (sm_90a)")
    torch.backends.cuda.matmul.allow_tf32 = False   # the plain version in fp32
    return torch.device("cuda", 0)


def _qkv(dev, dtype, B, Sq, Sk, H, K, D):
    g = torch.Generator().manual_seed(0)
    return [torch.randn(s, generator=g).to(dev, dtype)
            for s in ((B, Sq, H, D), (B, Sk, K, D), (B, Sk, K, D))]


def _check(dev, dtype, shape, variant=None, **kw):
    q, k, v = _qkv(dev, dtype, *shape)
    cuda = fa_kernel.flash_attention_cuda
    before, by_variant = cuda.launches, dict(cuda.launches_by_variant)
    out = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert cuda.launches == before + 1
    if variant is not None:
        assert cuda.launches_by_variant[variant] == by_variant[variant] + 1
    want = attention_ref(q, k, v, **kw)
    torch.testing.assert_close(out.float(), want.float(), atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("B,S,H,K,D", [
    (1, 128, 2, 2, 32), (2, 256, 4, 2, 64), (1, 192, 8, 1, 128), (2, 64, 4, 4, 64),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_shapes_dtypes(hopper, B, S, H, K, D, dtype):
    _check(hopper, dtype, (B, S, S, H, K, D))


@pytest.mark.parametrize("mask,window", [("causal", 0), ("local", 32), ("local", 100),
                                         ("full", 0), ("prefix", 0)])
def test_kernel_matches_plain_masks(hopper, mask, window):
    _check(hopper, torch.float32, (1, 160, 160, 2, 2, 64), mask_type=mask,
           window=window, prefix_len=40)


def test_kernel_matches_plain_softcap_and_offset(hopper):
    _check(hopper, torch.float32, (1, 32, 128, 2, 2, 32), q_offset=96, softcap=30.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_per_row_decode_at_head_dim_256(hopper, dtype):
    rows = dict(q_offset=torch.tensor([2047, 1000, 17, 2055], dtype=torch.int32),
                kv_len=torch.tensor([2048, 1001, 18, 2056], dtype=torch.int32))
    _check(hopper, dtype, (4, 1, 2056, 8, 1, 256), **rows)


def test_kernel_wrapper_rejects_what_the_kernel_does_not_take(hopper):
    q, k, v = _qkv(hopper, torch.float16, 1, 8, 8, 2, 1, 32)
    with pytest.raises(ValueError, match="dtype"):
        flash_attention(q, k, v)
    q, k, v = _qkv(hopper, torch.float32, 1, 8, 8, 2, 1, 288)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(q, k, v)


@pytest.mark.parametrize("variant,dtype,shape", [
    ("tc", torch.bfloat16, (1, 192, 192, 8, 1, 128)),
    ("split", torch.bfloat16, (4, 1, 2056, 8, 1, 256)),
    ("split", torch.float32, (2, 4, 300, 8, 1, 64)),
    ("simt", torch.float32, (1, 192, 192, 8, 1, 128)),
    ("simt", torch.bfloat16, (1, 100, 100, 4, 1, 96)),
])
def test_each_variant_launches_as_planned(hopper, variant, dtype, shape):
    B, Sq, Sk, H, K, D = shape
    assert fa_kernel.plan(B, Sq, Sk, H, K, D, dtype)[0] == variant
    _check(hopper, dtype, shape, variant=variant)


@pytest.mark.parametrize("D", [32, 64, 128, 256])
@pytest.mark.parametrize("B,Sq,H,K", [(2, 100, 16, 1), (1, 1100, 16, 1), (1, 90, 16, 2)])
def test_tc_head_dims_ragged_rows_and_warpgroups(hopper, D, B, Sq, H, K):
    """Sq·G not a multiple of 128; (1, 1100, 16, 1) fills 138 blocks of 128
    rows (two warpgroups), the others one."""
    _check(hopper, torch.bfloat16, (B, Sq, Sq, H, K, D), variant="tc")


@pytest.mark.parametrize("mask,window,softcap", [
    ("causal", 0, 0.0), ("local", 48, 0.0), ("local", 200, 30.0), ("full", 0, 0.0),
    ("prefix", 0, 0.0), ("causal", 0, 30.0)])
def test_tc_masks_softcap_and_rows(hopper, mask, window, softcap):
    rows = dict(q_offset=torch.tensor([40, 0], dtype=torch.int32),
                kv_len=torch.tensor([200, 130], dtype=torch.int32))
    _check(hopper, torch.bfloat16, (2, 130, 210, 8, 1, 64), variant="tc", mask_type=mask,
           window=window, prefix_len=70, softcap=softcap, **rows)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_at_edge_kv_lens(hopper, dtype):
    """kv_len 1, 63, 64, 65 and 2056 in one batch: most splits of the short
    rows are empty and must contribute nothing."""
    kv = torch.tensor([1, 63, 64, 65, 2056], dtype=torch.int32)
    _check(hopper, dtype, (5, 1, 2056, 8, 1, 256), variant="split", q_offset=kv - 1,
           kv_len=kv)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_ring_decode_and_masked_splits(hopper, dtype):
    """recurrentgemma's decode (G = 16 over a 2048-slot ring, ``full``
    mask, scalar kv_len), a local window over a part of the cache, and a
    causal row whose last split [96, 99) is fully masked for query 95."""
    _check(hopper, dtype, (4, 1, 2048, 16, 1, 256), variant="split", mask_type="full",
           q_offset=5000, kv_len=2048)
    _check(hopper, dtype, (2, 4, 900, 16, 1, 128), variant="split", mask_type="local",
           window=100, q_offset=torch.tensor([800, 500], dtype=torch.int32),
           kv_len=torch.tensor([804, 504], dtype=torch.int32))
    _check(hopper, dtype, (2, 4, 900, 16, 1, 128), variant="split",
           q_offset=torch.tensor([95, 500], dtype=torch.int32),
           kv_len=torch.tensor([99, 504], dtype=torch.int32))


@pytest.mark.parametrize("shape", [(3, 2, 500, 8, 1, 64), (3, 1, 500, 4, 1, 128),
                                   (2, 1, 700, 16, 1, 256), (2, 1, 700, 8, 2, 256)])
def test_split_tensor_core_form_head_dims(hopper, shape):
    """bf16 with at most 16 packed rows takes the split variant's mma.sync
    form: each head dim it instantiates, GQA over two kv heads, ragged
    per-row lengths."""
    B = shape[0]
    kv = torch.tensor([500, 37, 300][:B], dtype=torch.int32)
    _check(hopper, torch.bfloat16, shape, variant="split", q_offset=kv - shape[1], kv_len=kv)


_ROWS = lambda *x: torch.tensor(x, dtype=torch.int32)   # noqa: E731


@pytest.mark.parametrize("variant,shape,kw", [
    # gemma3-12b: 16 query heads over 8 kv heads of 256, a 1024-key window
    ("tc", (1, 2048, 2048, 16, 8, 256), dict(mask_type="local", window=1024)),
    # its decode over the 1024-slot ring: mask "full", kv_len min(pos + 1, 1024)
    ("split", (4, 1, 1024, 16, 8, 256),
     dict(mask_type="full", q_offset=_ROWS(2048, 3000, 100, 1023),
          kv_len=_ROWS(1024, 1024, 101, 1024))),
    # paligemma-3b: 256 patch positions + 128 tokens, MQA over 8 heads
    ("tc", (2, 384, 384, 8, 1, 256), dict(mask_type="prefix", prefix_len=256)),
    # whisper-large-v3: the 1500-frame encoder (not a multiple of the
    # 64-key tile), cross attention over its keys at prefill and decode
    ("tc", (1, 1500, 1500, 20, 20, 64), dict(mask_type="full")),
    ("tc", (4, 128, 1500, 20, 20, 64), dict(mask_type="full")),
    ("split", (4, 1, 1500, 20, 20, 64),
     dict(mask_type="full", q_offset=_ROWS(128, 131, 140, 143))),
], ids=["gemma3_local_prefill", "gemma3_ring_decode", "paligemma_prefix_prefill",
        "whisper_encoder", "whisper_cross_prefill", "whisper_cross_decode"])
def test_served_models_regimes(hopper, variant, shape, kw):
    """The regimes the dense variants, vlm and encdec bring, in bf16 at
    full width, through the variant the plan picks."""
    assert fa_kernel.plan(*shape, torch.bfloat16)[0] == variant
    _check(hopper, torch.bfloat16, shape, variant=variant, **kw)
