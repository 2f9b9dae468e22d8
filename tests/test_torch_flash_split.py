"""The split-KV algorithm of the flash-attention kernel's ``split`` variant
and the plan that picks a variant, on the CPU.

``ref.attention_split_ref`` computes attention as the split kernel does
(per-split fp32 partials m, l, acc, then the combine); it is held against
the port's plain version ``attention_ref`` and against the reference
package's oracle on the same numpy inputs.  Tolerance: 1e-5 in fp32 (the
same softmax, summed in another order).  ``kernel.plan`` is held to the
rules the CUDA side relies on, at the full-width shapes of the served
models.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ref import attention_ref as jax_oracle
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention.ref import (MASKS, SPLIT_TILE, attention_ref,
                                                     attention_split_ref, split_ranges)

torch.set_num_threads(1)

TOL = 1e-5


def _qkv(B, Sq, Sk, H, K, D, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, D), np.float32),
            rng.standard_normal((B, Sk, K, D), np.float32),
            rng.standard_normal((B, Sk, K, D), np.float32))


def _both_refs(arrays, n_split, **kw):
    q, k, v = (torch.from_numpy(a) for a in arrays)
    return (attention_split_ref(q, k, v, n_split=n_split, **kw),
            attention_ref(q, k, v, **kw))


@pytest.mark.parametrize("mask", MASKS)
@pytest.mark.parametrize("G", [1, 8, 16])
def test_split_matches_plain_every_mask_and_group(mask, G):
    """Per-row kv_len at 1, a split edge minus one, on it and plus one (the
    shares are 32-key tiles), and the whole cache; decode and a short
    multi-query row."""
    kv = torch.tensor([1, 31, 32, 33, 96])
    for Sq in (1, 3):
        arrays = _qkv(5, Sq, 96, 2 * G, 2, 16, seed=G)
        got, want = _both_refs(arrays, 3, mask_type=mask, window=20, prefix_len=10,
                               q_offset=kv - Sq, kv_len=kv)
        # a row whose first query sees no key (kv_len 1, Sq 3, causal)
        # keeps no defined output: compare the rows that see a key
        ok = (kv - Sq >= 0) | (mask in ("full", "prefix"))
        torch.testing.assert_close(got[ok], want[ok], atol=TOL, rtol=TOL)


@pytest.mark.parametrize("softcap", [0.0, 5.0])
@pytest.mark.parametrize("n_split", [1, 2, 7, 40])
def test_split_matches_plain_with_empty_and_masked_splits(softcap, n_split):
    """More splits than tiles leaves trailing splits empty; a causal query
    whose range ends past it (query 95 of rows seeing up to 98) sees none
    of the last split's keys; a local window leaves early splits masked for
    the later queries."""
    arrays = _qkv(2, 4, 300, 16, 2, 32, seed=1)
    rows = dict(q_offset=torch.tensor([95, 200]), kv_len=torch.tensor([99, 204]))
    for mask, window in (("causal", 0), ("local", 40)):
        got, want = _both_refs(arrays, n_split, mask_type=mask, window=window,
                               softcap=softcap, **rows)
        torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)


def test_empty_split_contributes_nothing():
    """A share with no keys gives m = -1e30, l = 0: the combine weights it
    e^(-1e30 - M) = 0, so the answer equals one split's."""
    arrays = _qkv(1, 1, 40, 8, 1, 16, seed=2)
    lo_hi = split_ranges(39, 40, 1, 40, "causal", 0, 0, 8)
    assert lo_hi[0] == (0, 32) and lo_hi[1] == (32, 40)
    assert all(lo >= hi for lo, hi in lo_hi[2:])
    one, _ = _both_refs(arrays, 1, q_offset=39)
    many, _ = _both_refs(arrays, 8, q_offset=39)
    torch.testing.assert_close(many, one, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("mask,window", [("causal", 0), ("local", 24), ("full", 0)])
def test_split_matches_jax_reference(mask, window):
    """The split algorithm against the reference package's oracle, GQA by
    materialised repeat there, on the same numpy inputs."""
    B, Sq, Sk, H, K, D = 2, 2, 70, 4, 2, 16
    q, k, v = _qkv(B, Sq, Sk, H, K, D, seed=4)
    got = attention_split_ref(*(torch.from_numpy(a) for a in (q, k, v)), n_split=3,
                              mask_type=mask, window=window, q_offset=Sk - Sq)
    G = H // K
    qf = jnp.asarray(q).transpose(0, 2, 1, 3).reshape(B * H, Sq, D)
    kf = jnp.repeat(jnp.asarray(k).transpose(0, 2, 1, 3), G, axis=1).reshape(B * H, Sk, D)
    vf = jnp.repeat(jnp.asarray(v).transpose(0, 2, 1, 3), G, axis=1).reshape(B * H, Sk, D)
    want = jax_oracle(qf, kf, vf, mask_type=mask, window=window, q_offset=Sk - Sq)
    want = np.asarray(want).reshape(B, H, Sq, D).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("beg_end,n_split", [((0, 2056), 32), ((5, 6), 4), ((100, 100), 3),
                                             ((1953, 2049), 5)])
def test_split_ranges_tile_the_visible_range(beg_end, n_split):
    beg, end = beg_end
    q_off = end - 1
    window = end - beg
    got = split_ranges(q_off, end, 1, end, "local", window, 0, n_split)
    assert len(got) == n_split
    keys = [kp for lo, hi in got for kp in range(lo, hi)]
    assert keys == list(range(beg, end))
    for lo, hi in got:
        assert (lo - beg) % SPLIT_TILE == 0


# -- plan -------------------------------------------------------------------

@pytest.mark.parametrize("name,shape", [
    ("gemma-2b prefill", (2, 2048, 2056, 8, 1, 256)),
    ("gemma-2b infer_prefill", (1, 2048, 2056, 8, 1, 256)),
    ("gemma-2b serve admission", (4, 128, 144, 8, 1, 256)),
    ("recurrentgemma-9b prefill", (1, 2048, 2048, 16, 1, 256)),
    ("recurrentgemma-9b serve admission", (4, 128, 144, 16, 1, 256)),
])
def test_plan_sends_full_width_prefill_to_tensor_cores(name, shape):
    assert fa_kernel.plan(*shape, torch.bfloat16) == ("tc", 1), name


@pytest.mark.parametrize("name,shape", [
    ("gemma-2b decode", (4, 1, 2056, 8, 1, 256)),
    ("recurrentgemma-9b decode", (4, 1, 2048, 16, 1, 256)),
    ("serve decode", (4, 1, 144, 8, 1, 256)),
    ("batch-1 decode", (1, 1, 4096, 8, 1, 256)),
    ("wide decode", (64, 1, 2056, 8, 1, 256)),
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_plan_splits_decode_over_the_card(name, shape, dtype):
    """At least 2 x 132 blocks, unless a split would then hold fewer than 64
    keys: then as many 64-key splits as the cache holds."""
    B, Sq, Sk, H, K, D = shape
    variant, n_split = fa_kernel.plan(*shape, dtype)
    assert variant == "split", name
    assert Sk // n_split >= 64 or n_split == 1
    assert B * K * n_split >= 2 * 132 or Sk // (n_split + 1) < 64
    assert fa_kernel.scratch_shape(B, Sq, H, K, D, n_split) == (n_split, B, K, Sq * H // K,
                                                                D + 2)


@pytest.mark.parametrize("shape,dtype", [
    ((2, 2048, 2056, 8, 1, 256), torch.float32),    # fp32 prefill stays off TF32
    ((1, 256, 256, 8, 1, 96), torch.bfloat16),      # no tc instance at D = 96
    ((1, 65, 65, 1, 1, 64), torch.float32),
])
def test_plan_leaves_fp32_prefill_and_other_head_dims_to_simt(shape, dtype):
    assert fa_kernel.plan(*shape, dtype) == ("simt", 1)


@pytest.mark.parametrize("Sq,G,variant", [(64, 1, "split"), (65, 1, "tc"), (8, 8, "split"),
                                          (9, 8, "tc"), (4, 16, "split"), (5, 16, "tc")])
def test_plan_edge_at_64_packed_rows(Sq, G, variant):
    assert fa_kernel.plan(1, Sq, 512, G, 1, 128, torch.bfloat16)[0] == variant


@pytest.mark.parametrize("shape,warpgroups", [
    ((2, 2048, 8, 1), 2), ((1, 2048, 16, 1), 2), ((1, 2048, 8, 1), 1), ((4, 128, 8, 1), 1)])
def test_tc_blocks_take_two_warpgroups_when_they_fill_the_card(shape, warpgroups):
    assert fa_kernel.tc_warpgroups(*shape) == warpgroups


def test_rows_arguments_go_as_ints_or_int32_rows():
    dev = torch.device("cpu")
    assert fa_kernel._rows_arg("kv_len", 7, 3, dev) == (7, None)
    assert fa_kernel._rows_arg("kv_len", np.int64(9), 3, dev) == (9, None)
    s, rows = fa_kernel._rows_arg("q_offset", torch.tensor(5), 3, dev)
    assert s == 0 and rows.dtype == torch.int32 and rows.tolist() == [5, 5, 5]
    s, rows = fa_kernel._rows_arg("q_offset", torch.tensor([1, 2, 3]), 3, dev)
    assert rows.dtype == torch.int32 and rows.is_contiguous() and rows.tolist() == [1, 2, 3]
    with pytest.raises(ValueError, match="kv_len"):
        fa_kernel._rows_arg("kv_len", torch.tensor([1, 2]), 3, dev)

