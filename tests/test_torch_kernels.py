"""The port's flash-attention op on the CPU (its plain version) against the
reference Pallas kernel (interpret mode) and the reference oracle, at the
shapes, masks and softcap/offset cases of ``tests/test_kernels.py``.

Inputs are drawn once with numpy and handed to both packages; bf16 inputs
are rounded from the same fp32 draws on both sides.  Tolerances: 2e-5 in
fp32 (two fp32 softmaxes that differ only in summation order) and 2e-2 in
bf16 (the outputs are rounded to bf16, whose spacing near 1 is 2^-7).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import validate as ref_validate
from repro.kernels.flash_attention.ops import flash_attention as ref_flash
from repro.kernels.flash_attention.ref import attention_ref as ref_oracle
from repro_torch.kernels import validate
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref

# tiny shapes: one intra-op thread each, as the suite runs in parallel workers
torch.set_num_threads(1)

DTYPES = {"fp32": (jnp.float32, torch.float32, 2e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _fa_ref(q, k, v, **kw):
    """The oracle of tests/test_kernels.py: GQA by materialised repeat."""
    B, Sq, H, D = q.shape
    G = H // k.shape[2]
    qf = q.transpose(0, 2, 1, 3).reshape(B * H, Sq, D)
    kf = jnp.repeat(k.transpose(0, 2, 1, 3), G, axis=1).reshape(B * H, k.shape[1], D)
    vf = jnp.repeat(v.transpose(0, 2, 1, 3), G, axis=1).reshape(B * H, k.shape[1], D)
    return ref_oracle(qf, kf, vf, **kw).reshape(B, H, Sq, D).transpose(0, 2, 1, 3)


def _qkv(B, Sq, Sk, H, K, D, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, D), np.float32),
            rng.standard_normal((B, Sk, K, D), np.float32),
            rng.standard_normal((B, Sk, K, D), np.float32))


def _both(arrays, dtype):
    jdt, tdt, _ = DTYPES[dtype]
    return ([jnp.asarray(a).astype(jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


def _check(out, *refs, tol):
    got = out.float().numpy()
    for r in refs:
        np.testing.assert_allclose(got, np.asarray(r, np.float32), atol=tol, rtol=tol)


@pytest.mark.parametrize("B,S,H,K,D", [
    (1, 128, 2, 2, 32), (2, 256, 4, 2, 64), (1, 192, 8, 1, 128), (2, 64, 4, 4, 64),
])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_plain_matches_reference_kernel_shapes_dtypes(B, S, H, K, D, dtype):
    (jq, jk, jv), (q, k, v) = _both(_qkv(B, S, S, H, K, D), dtype)
    ref_out = ref_flash(jq, jk, jv, block_q=64, block_k=64, interpret=True)
    _check(flash_attention(q, k, v), ref_out, _fa_ref(jq, jk, jv),
           tol=DTYPES[dtype][2])


@pytest.mark.parametrize("mask,window", [("causal", 0), ("local", 32), ("local", 100), ("full", 0)])
def test_plain_matches_reference_kernel_masks(mask, window):
    (jq, jk, jv), (q, k, v) = _both(_qkv(1, 160, 160, 2, 2, 64), "fp32")
    ref_out = ref_flash(jq, jk, jv, mask_type=mask, window=window,
                        block_q=64, block_k=64, interpret=True)
    _check(flash_attention(q, k, v, mask_type=mask, window=window), ref_out,
           _fa_ref(jq, jk, jv, mask_type=mask, window=window), tol=2e-5)


def test_plain_matches_reference_kernel_softcap_and_offset():
    (jq, jk, jv), (q, k, v) = _both(_qkv(1, 32, 128, 2, 2, 32), "fp32")
    ref_out = ref_flash(jq, jk, jv, q_offset=96, softcap=30.0, block_q=32,
                        block_k=64, interpret=True)
    _check(flash_attention(q, k, v, q_offset=96, softcap=30.0), ref_out,
           _fa_ref(jq, jk, jv, q_offset=96, softcap=30.0), tol=2e-5)


def test_per_row_offsets_and_prefix_mask_match_row_by_row():
    """Per-row (B,) q_offset / kv_len and the prefix mask: each query
    equals the reference oracle's full attention over exactly the keys the
    prefix mask and its row's kv_len let it see."""
    B, Sq, Sk, H, K, D = 3, 4, 40, 4, 2, 16
    arrays = _qkv(B, Sq, Sk, H, K, D, seed=3)
    (jq, jk, jv), (q, k, v) = _both(arrays, "fp32")
    q_off, kv_len = [10, 0, 30], [14, 4, 34]
    out = flash_attention(q, k, v, mask_type="prefix", prefix_len=6,
                          q_offset=torch.tensor(q_off), kv_len=torch.tensor(kv_len))
    for b in range(B):
        for i in range(Sq):
            qp = q_off[b] + i
            vis = [j for j in range(kv_len[b]) if j <= qp or j < 6]
            row = _fa_ref(jq[b:b + 1, i:i + 1], jk[b:b + 1, vis], jv[b:b + 1, vis],
                          mask_type="full")
            np.testing.assert_allclose(out[b, i].numpy(), np.asarray(row[0, 0]),
                                       atol=2e-5, rtol=2e-5)


def test_cpu_tensors_take_the_plain_version_and_cuda_kernel_refuses_them():
    _, (q, k, v) = _both(_qkv(1, 8, 8, 2, 1, 16), "fp32")
    before = fa_kernel.flash_attention_cuda.launches
    torch.testing.assert_close(flash_attention(q, k, v), attention_ref(q, k, v),
                               rtol=0, atol=0)
    assert fa_kernel.flash_attention_cuda.launches == before
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa_kernel.flash_attention_cuda(
            q, k, v, q_offset=torch.zeros(1, dtype=torch.int32),
            kv_len=torch.full((1,), 8, dtype=torch.int32), mask_type="causal",
            window=0, prefix_len=0, scale=0.25, softcap=0.0)
    with pytest.raises(ValueError, match="no path"):
        flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))
    with pytest.raises(NotImplementedError, match="MLA"):
        flash_attention(q, k, v[..., :8])


@pytest.mark.parametrize("dim,block,divides", [
    (128, 64, False), (128, 200, False), (96, 50, True), (100, 0, False), (7, 3, True),
    (64, True, False),
])
def test_validate_matches_reference(dim, block, divides):
    def outcome(mod):
        try:
            return ("ok", mod.validate_block("k", "S", dim, "block", block, divides=divides))
        except ValueError as e:
            return ("err", str(e))
    assert outcome(validate) == outcome(ref_validate)
    if not isinstance(block, bool):
        assert (validate.nearest_valid_block(dim, block, divides=divides)
                == ref_validate.nearest_valid_block(dim, block, divides=divides))
