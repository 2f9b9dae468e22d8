"""The port's layers against ``repro.models.layers`` on the same inputs and
the same (bridged) weights, in fp32.

Tolerance 1e-5 throughout: both sides compute in fp32 and differ only in
summation order; the reference's attention takes its chunked ``lax.scan``
path here (Sk above ``attn_chunk``), the port its plain version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.models import layers as RL
from repro_torch.configs import get_arch
from repro_torch.models import layers as L

# tiny shapes: one intra-op thread each, as the suite runs in parallel workers
torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-5)


def _cfgs(**kw):
    return (ref_get_arch("gemma-2b").reduced(compute_dtype=jnp.float32, **kw),
            get_arch("gemma-2b").reduced(compute_dtype=torch.float32, **kw))


def _np(x):
    return np.asarray(x, np.float32)


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("K", [2, 1])
@pytest.mark.parametrize("mask,window,prefix,softcap", [
    ("causal", 0, 0, 0.0), ("local", 16, 0, 0.0), ("full", 0, 0, 30.0),
    ("prefix", 0, 10, 0.0),
])
def test_attention_matches_reference(K, mask, window, prefix, softcap):
    rng = np.random.default_rng(0)
    B, Sq, Sk, H, D = 2, 8, 96, 4, 32      # Sk > chunk: the reference scans
    q, k, v = _rand(rng, B, Sq, H, D), _rand(rng, B, Sk, K, D), _rand(rng, B, Sk, K, D)
    q_off, kv_len = np.array([40, 80], np.int32), np.array([48, 88], np.int32)
    kw = dict(mask_type=mask, window=window, prefix_len=prefix, logit_softcap=softcap)
    want = RL.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        q_offset=jnp.asarray(q_off), kv_len=jnp.asarray(kv_len),
                        chunk=64, **kw)
    got = L.attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                      q_offset=torch.from_numpy(q_off), kv_len=torch.from_numpy(kv_len),
                      **kw)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


def test_rms_norm_rope_and_activation_match_reference():
    rng = np.random.default_rng(1)
    x, g = _rand(rng, 2, 5, 64), _rand(rng, 64, scale=0.1)
    np.testing.assert_allclose(L.rms_norm(torch.from_numpy(x), torch.from_numpy(g)).numpy(),
                               _np(RL.rms_norm(jnp.asarray(x), jnp.asarray(g))), **TOL)
    xs = _rand(rng, 2, 5, 3, 32)
    pos = np.array([[0, 1, 2, 3, 4], [7, 8, 9, 10, 11]], np.int32)   # per-row
    jc, js = RL.rope_freqs(jnp.asarray(pos), 32, 10000.0)
    tc, ts = L.rope_freqs(torch.from_numpy(pos), 32, 10000.0)
    np.testing.assert_allclose(tc.numpy(), _np(jc), **TOL)
    np.testing.assert_allclose(L.apply_rope(torch.from_numpy(xs), tc, ts).numpy(),
                               _np(RL.apply_rope(jnp.asarray(xs), jc, js)), **TOL)
    for name in ("gelu", "gelu_tanh", "silu", "relu", "sq_relu"):
        np.testing.assert_allclose(L.ACTIVATIONS[name](torch.from_numpy(x)).numpy(),
                                   _np(RL.ACTIVATIONS[name](jnp.asarray(x))), **TOL)


def _bridged(ref_defs, seed):
    """Reference params drawn by jax.random, and the same as torch tensors."""
    p = RL.init_tree(ref_defs, jax.random.key(seed))
    return p, jax.tree.map(lambda a: torch.from_numpy(np.array(a)), p)


def test_ffn_matches_reference():
    rcfg, tcfg = _cfgs()
    rp, tp = _bridged(RL.ffn_defs(rcfg), 2)
    x = _rand(np.random.default_rng(2), 2, 6, rcfg.d_model)
    np.testing.assert_allclose(L.ffn(tp, torch.from_numpy(x), tcfg).numpy(),
                               _np(RL.ffn(rp, jnp.asarray(x), rcfg)), **TOL)


def test_gqa_attention_with_cache_matches_reference():
    """Padded batched prefill into a cache, then one per-row decode step:
    outputs, k/v caches and the len vectors agree."""
    rcfg, tcfg = _cfgs()
    rp, tp = _bridged(RL.gqa_defs(rcfg), 3)
    rng = np.random.default_rng(3)
    B, S, M = 2, 8, 24
    shape = (B, M, rcfg.n_kv_heads, rcfg.head_dim)
    jcache = {"k": jnp.zeros(shape), "v": jnp.zeros(shape), "len": jnp.zeros(B, jnp.int32)}
    tcache = {"k": torch.zeros(shape), "v": torch.zeros(shape),
              "len": torch.zeros(B, dtype=torch.int32)}
    seq_lens = np.array([8, 5], np.int32)
    x = _rand(rng, B, S, rcfg.d_model)
    jy, jcache = RL.gqa_attention(rp, jnp.asarray(x), rcfg, mask_type="causal",
                                  cache=jcache, seq_lens=jnp.asarray(seq_lens))
    ty, tcache = L.gqa_attention(tp, torch.from_numpy(x), tcfg, mask_type="causal",
                                 cache=tcache, seq_lens=torch.from_numpy(seq_lens))
    np.testing.assert_allclose(ty.numpy(), _np(jy), **TOL)
    x1 = _rand(rng, B, 1, rcfg.d_model)
    pos = seq_lens[:, None]
    jy, jcache = RL.gqa_attention(rp, jnp.asarray(x1), rcfg, mask_type="causal",
                                  positions=jnp.asarray(pos), cache=jcache)
    ty, tcache = L.gqa_attention(tp, torch.from_numpy(x1), tcfg, mask_type="causal",
                                 positions=torch.from_numpy(pos), cache=tcache)
    np.testing.assert_allclose(ty.numpy(), _np(jy), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(tcache[name].numpy(), _np(jcache[name]), **TOL)
    np.testing.assert_array_equal(tcache["len"].numpy(), np.asarray(jcache["len"]))


def test_row_update_clamps_out_of_range_start_like_dynamic_update_slice():
    rng = np.random.default_rng(4)
    cache, fresh = _rand(rng, 3, 10, 2), _rand(rng, 3, 4, 2)
    idx = np.array([2, 8, 50], np.int32)          # rows 1 and 2 run past the end
    want = RL._row_update(jnp.asarray(cache), jnp.asarray(fresh), jnp.asarray(idx))
    t = torch.from_numpy(cache.copy())
    got = L._row_update(t, torch.from_numpy(fresh), torch.from_numpy(idx))
    assert got is t                                 # written in place
    np.testing.assert_array_equal(got.numpy(), _np(want))
    np.testing.assert_array_equal(got[2, 6:].numpy(), fresh[2])


def test_init_tree_is_seeded_and_follows_reference_fan_in():
    _, tcfg = _cfgs()
    defs = L.gqa_defs(tcfg, (4,))
    a = L.init_tree(defs, torch.Generator().manual_seed(0))
    b = L.init_tree(defs, torch.Generator().manual_seed(0))
    c = L.init_tree(defs, torch.Generator().manual_seed(1))
    torch.testing.assert_close(a["wq"], b["wq"], rtol=0, atol=0)
    assert not torch.equal(a["wq"], c["wq"])
    # fan-in over every axis but the last, the stacked layer axis included
    fan_in = 4 * tcfg.d_model * tcfg.n_heads
    assert abs(a["wq"].std().item() * fan_in ** 0.5 - 1.0) < 0.05
    assert {k: tuple(v.shape) for k, v in a.items()} == \
        {k: d.shape for k, d in RL.gqa_defs(_cfgs()[0], (4,)).items()}


def test_unported_layer_features_raise_naming_the_roadmap():
    q = torch.zeros(1, 2, 2, 8)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        L.attention(q, q, q, bf16_probs=True)


@pytest.mark.parametrize("S,seq_lens", [(24, None), (12, None), (24, (24, 13))])
def test_ring_cache_matches_reference_through_the_wrap(S, seq_lens):
    """A local layer whose cache holds exactly ``window`` (16) slots keeps a
    ring: prefill past the window (the roll), inside it (zero padding) and
    ragged (the per-row gather), then 6 decode steps at slot ``len % 16``
    that wrap round the ring; outputs, k/v and len agree."""
    rcfg, tcfg = _cfgs()
    rp = RL.init_tree(RL.gqa_defs(rcfg), jax.random.key(5))
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), rp)
    rng = np.random.default_rng(5)
    B, W = 2, 16
    shape = (B, W, tcfg.n_kv_heads, tcfg.head_dim)
    jcache = {"k": jnp.zeros(shape), "v": jnp.zeros(shape),
              "len": jnp.zeros(B, jnp.int32)}
    tcache = {"k": torch.zeros(shape), "v": torch.zeros(shape),
              "len": torch.zeros(B, dtype=torch.int32)}
    lens = None if seq_lens is None else np.asarray(seq_lens, np.int32)
    x = _rand(rng, B, S, rcfg.d_model)
    kw = dict(mask_type="local", window=W)
    jy, jcache = RL.gqa_attention(rp, jnp.asarray(x), rcfg, cache=jcache,
                                  seq_lens=None if lens is None else jnp.asarray(lens), **kw)
    ty, tcache = L.gqa_attention(tp, torch.from_numpy(x), tcfg, cache=tcache,
                                 seq_lens=None if lens is None else torch.from_numpy(lens), **kw)
    np.testing.assert_allclose(ty.numpy(), _np(jy), **TOL)
    pos = np.full(B, S, np.int32) if lens is None else lens.copy()
    for _ in range(6):
        x1 = _rand(rng, B, 1, rcfg.d_model)
        jy, jcache = RL.gqa_attention(rp, jnp.asarray(x1), rcfg, cache=jcache,
                                      positions=jnp.asarray(pos[:, None]), **kw)
        ty, tcache = L.gqa_attention(tp, torch.from_numpy(x1), tcfg, cache=tcache,
                                     positions=torch.from_numpy(pos[:, None]), **kw)
        np.testing.assert_allclose(ty.numpy(), _np(jy), **TOL)
        for name in ("k", "v"):
            np.testing.assert_allclose(tcache[name].numpy(), _np(jcache[name]), **TOL)
        np.testing.assert_array_equal(tcache["len"].numpy(), np.asarray(jcache["len"]))
        pos += 1
    np.testing.assert_array_equal(tcache["len"].numpy(), pos)
    assert tuple(tcache["k"].shape) == shape     # still W slots, written in place
