"""The tensor-core flash-attention backward's algorithm
(``ref.attention_bwd_tiles_ref``: 64-key blocks in the transposed
orientation, query chunks with their fixed-order combine, dq over 64-row
tiles) and the plan that picks the backward's variant, on the CPU.

The tiled algorithm is held in fp32 against the port's plain backward
``attention_bwd_ref`` and against ``jax.vjp`` of the reference package's
``repro.models.layers.attention`` on the same numpy inputs: tolerance
1e-5 (absolute and relative; the same math summed in another order).
With the kernel's bf16 roundings (P and dS rounded before their
products) on bf16 inputs it is held within 3e-2 of each gradient's
largest |value| of ``attention_bwd_ref`` on the same inputs, the
tolerance the card's test holds the kernel to.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.layers import attention as jax_attention
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention.kernel import (BWD_TILE, bwd_dkv_blocks,
                                                        bwd_rows_seeing)
from repro_torch.kernels.flash_attention.ref import (allowed_mask, attention_bwd_ref,
                                                     attention_bwd_tiles_ref, attention_ref)

torch.set_num_threads(1)

TOL = 1e-5
BF16_TOL = 3e-2

# the cases of chip_smoke.py's fa_backward_kernels at small sizes:
# B, S, H, K, D, attention keywords, query chunk (row tiles)
CASES = {
    "gemma2b_like": (1, 160, 8, 1, 32, {}, 2),
    "reduced": (2, 64, 4, 1, 32, {}, 16),
    "local": (1, 200, 8, 1, 32, dict(mask_type="local", window=50), 2),
    "prefix": (1, 150, 4, 1, 64, dict(mask_type="prefix", prefix_len=70), 2),
    "softcap": (1, 130, 8, 1, 64, dict(softcap=5.0), 3),
    "k2": (2, 100, 8, 2, 64, {}, 2),
    "full": (1, 96, 6, 2, 32, dict(mask_type="full"), 1),
}


def _inputs(B, S, H, K, D, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, S, H, D), (B, S, K, D), (B, S, K, D), (B, S, H, D))]


def _jax_vjp(arrays, kw):
    q, k, v, do = (jnp.asarray(a) for a in arrays)
    fn = lambda q, k, v: jax_attention(   # noqa: E731
        q, k, v, mask_type=kw.get("mask_type", "causal"), window=kw.get("window", 0),
        prefix_len=kw.get("prefix_len", 0), logit_softcap=kw.get("softcap", 0.0))
    grads = jax.jit(lambda q, k, v, do: jax.vjp(fn, q, k, v)[1](do))(q, k, v, do)
    return [torch.from_numpy(np.array(g)) for g in grads]


@pytest.mark.parametrize("case", sorted(CASES))
def test_tiles_match_plain_backward_and_jax_vjp(case):
    B, S, H, K, D, kw, qchunk = CASES[case]
    arrays = _inputs(B, S, H, K, D)
    q, k, v, do = (torch.from_numpy(a) for a in arrays)
    o = attention_ref(q, k, v, **kw)
    got = attention_bwd_tiles_ref(q, k, v, o, do, qchunk=qchunk, **kw)
    plain = attention_bwd_ref(q, k, v, o, do, **kw)
    ref = _jax_vjp(arrays, kw)
    for name, g, p, r in zip(("dq", "dk", "dv"), got, plain, ref):
        torch.testing.assert_close(g, p, atol=TOL, rtol=TOL, msg=name)
        torch.testing.assert_close(g, r, atol=TOL, rtol=TOL, msg=name)


def test_tiles_offset_kv_len_and_many_chunks():
    """A query block at an offset, keys past kv_len masked (they get no
    gradient), one-tile chunks: many partials per key block."""
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(2, 40, 4, 2, 32, seed=5))
    k, v = (torch.cat([x, x[:, :30]], 1) for x in (k, v))   # Sk = 70
    kw = dict(mask_type="causal", q_offset=10, kv_len=55, softmax_scale=0.3)
    o = attention_ref(q, k, v, **kw)
    got = attention_bwd_tiles_ref(q, k, v, o, do, qchunk=1, **kw)
    want = attention_bwd_ref(q, k, v, o, do, **kw)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=TOL, rtol=TOL)
    assert float(got[1][:, 55:].abs().max()) == 0.0


@pytest.mark.parametrize("case", ["gemma2b_like", "softcap", "k2"])
def test_tiles_with_bf16_products_stay_within_kernel_tolerance(case):
    B, S, H, K, D, kw, qchunk = CASES[case]
    q, k, v, do = (torch.from_numpy(a).bfloat16() for a in _inputs(B, S, H, K, D, seed=1))
    o = attention_ref(q, k, v, **kw)
    got = attention_bwd_tiles_ref(q, k, v, o, do, qchunk=qchunk, bf16_products=True, **kw)
    exact = attention_bwd_tiles_ref(q, k, v, o, do, qchunk=qchunk, **kw)
    want = attention_bwd_ref(q, k, v, o, do, **kw)
    for name, g, e, w in zip(("dq", "dk", "dv"), got, exact, want):
        assert g.dtype == torch.bfloat16
        err = float((g.float() - w.float()).abs().max() / w.float().abs().max())
        assert err <= BF16_TOL, f"{name}: {err}"
    assert not all(torch.equal(g, e) for g, e in zip(got, exact))   # the roundings bite


@pytest.mark.parametrize("D", [32, 64, 128, 256])
@pytest.mark.parametrize("shape", [(1, 2048, 2048, 8, 1), (2, 64, 64, 4, 1), (2, 200, 200, 8, 2),
                                   (4, 1, 300, 16, 1)])
def test_plan_bwd_picks_tc_for_bf16_at_its_head_dims(shape, D):
    assert fa_kernel.plan_bwd(*shape, D, torch.bfloat16) == "tc"
    assert fa_kernel.plan_bwd(*shape, D, torch.float32) == "simt"


@pytest.mark.parametrize("D", [4, 16, 48, 96, 160, 252])
def test_plan_bwd_keeps_other_head_dims_on_simt(D):
    assert fa_kernel.plan_bwd(1, 128, 128, 8, 1, D, torch.bfloat16) == "simt"
    assert fa_kernel.plan_bwd(1, 128, 128, 8, 1, D, torch.float32) == "simt"


@pytest.mark.parametrize("H,K", [(3, 1), (12, 2), (128, 1), (96, 1)])
def test_plan_bwd_keeps_groups_not_dividing_64_on_simt(H, K):
    """The tc passes load 64 packed rows as 64 / G queries of G heads."""
    assert fa_kernel.plan_bwd(1, 128, 128, H, K, 128, torch.bfloat16) == "simt"


def test_plan_bwd_covers_the_train_steps_backward_calls():
    """gemma-2b's train step (B=1, S=2048, 8 heads over 1 of 256, bf16
    compute) and the runner's reduced train cell run ``tc``."""
    from repro_torch.configs import get_arch
    for cfg, (B, S) in ((get_arch("gemma-2b"), (1, 2048)),
                        (get_arch("gemma-2b").reduced(), (2, 64))):
        assert cfg.compute_dtype == torch.bfloat16
        assert fa_kernel.plan_bwd(B, S, S, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                                  cfg.compute_dtype) == "tc"


@pytest.mark.parametrize("geom", [(160, 160, 8, 0, 160, "causal", 0, 0),
                                  (200, 200, 8, 0, 200, "local", 50, 0),
                                  (150, 150, 4, 0, 150, "prefix", 0, 70),
                                  (96, 96, 3, 0, 96, "full", 0, 0),
                                  (40, 70, 2, 10, 55, "causal", 0, 0),
                                  (64, 300, 4, 236, 290, "local", 20, 0)])
def test_bwd_dkv_blocks_counts_the_chunks_of_the_rows_that_see_each_key_block(geom):
    """The plan's rows per 64-key block (``bwd_rows_seeing``) are the
    packed rows with any visible key there, by the mask itself, and
    ``bwd_dkv_blocks`` (the dk/dv grid and partials) counts their chunks,
    at least one a key block."""
    Sq, Sk, G, q_offset, klim, mask, window, prefix = geom
    qpos = q_offset + torch.arange(Sq * G) // G
    kpos = torch.arange(Sk)
    vis = allowed_mask(qpos, kpos, mask, window, prefix) & (kpos < klim)
    for chunk in (1, 2, 5):
        want = 0
        for k0 in range(0, Sk, BWD_TILE):
            rows = vis[:, k0:k0 + BWD_TILE].any(-1).nonzero().flatten().tolist()
            span = (rows[0], rows[-1] + 1) if rows else None
            assert len(rows) == (span[1] - span[0] if rows else 0)   # one run of rows
            lo, hi = bwd_rows_seeing(k0, min(BWD_TILE, Sk - k0), Sq, G, q_offset, klim, mask,
                                     window, prefix)
            assert (lo, hi) == span if rows else lo == hi
            want += max(1, -(-len(rows) // (chunk * BWD_TILE)))
        assert bwd_dkv_blocks(Sq, Sk, G, q_offset, klim, mask, window, prefix, chunk) == want


def _dkv_blocks(B, S, H, K, mask, window, prefix, chunk):
    return B * K * bwd_dkv_blocks(S, S, H // K, 0, S, mask, window, prefix, chunk)


@pytest.mark.parametrize("shape", [(1, 2048, 8, 1, "causal", 0, 0), (2, 64, 4, 1, "causal", 0, 0),
                                   (1, 512, 8, 1, "local", 128, 0),
                                   (1, 512, 8, 1, "prefix", 0, 100), (2, 256, 8, 2, "full", 0, 0),
                                   (4, 4096, 8, 1, "causal", 0, 0)])
def test_bwd_chunk_tiles_is_the_fewest_within_two_waves(shape):
    """The dk/dv grid fits two waves of 132 blocks with the planned chunk,
    and not with one tile less (unless one chunk a key block is all the
    grid can shrink to)."""
    B, S, H, K, mask, window, prefix = shape
    c = fa_kernel.bwd_chunk_tiles(B, S, S, H, K, mask, window, prefix, 0, S)
    blocks = _dkv_blocks(B, S, H, K, mask, window, prefix, c)
    assert c >= 1 and (blocks <= 2 * fa_kernel.SMS or c == -(-S * (H // K) // BWD_TILE))
    if c > 1:
        assert _dkv_blocks(B, S, H, K, mask, window, prefix, c - 1) > 2 * fa_kernel.SMS
    if shape[:2] == (1, 2048):   # gemma-2b's training call: 17 tiles, 264 blocks
        assert (c, blocks) == (17, 264)
