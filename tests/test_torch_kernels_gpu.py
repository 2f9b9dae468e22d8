"""The hand-written CUDA flash-attention kernel against its plain version
on the card, at the shapes of ``tests/test_kernels.py`` plus the per-row
offsets, GQA and prefix mask the model path needs.

These tests need a Hopper card (compute capability 9.0 or above) and
``nvcc``; elsewhere they skip.  Whether there is such a card is decided in
the ``hopper`` fixture, never at import, so every test worker collects
the same tests.  Run them on the card with ``PYTHONPATH=src python -m
pytest -q --noconftest -m gpu tests/test_torch_kernels_gpu.py`` (the
suite's conftest imports JAX; this file needs only torch).

Tolerances as in ``tests/test_kernels.py``: 2e-5 in fp32 (same math,
another summation order), 2e-2 in bf16 (outputs rounded to bf16).
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


def _check(dev, dtype, shape, **kw):
    q, k, v = _qkv(dev, dtype, *shape)
    before = fa_kernel.flash_attention_cuda.launches
    out = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa_kernel.flash_attention_cuda.launches == before + 1
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
