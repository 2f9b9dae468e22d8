"""The port's config and model against the reference on bridged weights:
``forward``, ``prefill`` (with and without ``lengths=``) and
``decode_step`` logits and caches at the reduced gemma-2b config.

Tolerances: 1e-4 at fp32 compute (fp32 throughout, summation order only,
over four layers and a 512-word head); 5e-2 at bf16 compute (the two
frameworks round bf16 at different places, e.g. the GELU and the softmax
inputs, and the rounding compounds over the layers).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.models import build_model as ref_build_model
from repro_torch.bridge import cache_from_numpy, cache_to_numpy, params_from_numpy
from repro_torch.configs import get_arch
from repro_torch.models import build_model

# tiny shapes: one intra-op thread each, as the suite runs in parallel workers
torch.set_num_threads(1)

COMPUTE = {"fp32": (jnp.float32, torch.float32, 1e-4),
           "bf16": (jnp.bfloat16, torch.bfloat16, 5e-2)}


def _np(x):
    return np.asarray(x, np.float32)


@pytest.fixture(scope="module", params=["fp32", "bf16"])
def pair(request):
    jdt, tdt, tol = COMPUTE[request.param]
    rcfg = ref_get_arch("gemma-2b").reduced(compute_dtype=jdt)
    tcfg = get_arch("gemma-2b").reduced(compute_dtype=tdt)
    rmodel = ref_build_model(rcfg)
    params = rmodel.init(jax.random.key(0))
    tmodel = params_from_numpy(jax.tree.map(np.asarray, params), tcfg, "cpu")
    return rmodel, params, tmodel, tol


def _tokens(B, S, seed=0):
    return np.random.default_rng(seed).integers(0, 512, (B, S)).astype(np.int32)


def _assert_caches_close(tcache, rcache, tol):
    got, want = cache_to_numpy(tcache)["blocks"], jax.tree.map(_np, rcache)["blocks"]
    for name in ("k", "v"):
        np.testing.assert_allclose(got[name], want[name], atol=tol, rtol=tol)
    np.testing.assert_array_equal(got["len"], want["len"])


@pytest.mark.parametrize("lengths", [None, (12, 7)])
def test_prefill_then_decode_match_reference(pair, lengths):
    rmodel, params, tmodel, tol = pair
    B, S, M = 2, 12, 20
    toks = _tokens(B, S)
    lens_j = None if lengths is None else jnp.asarray(lengths, jnp.int32)
    lens_t = None if lengths is None else torch.tensor(lengths, dtype=torch.int32)
    rl, rc = jax.jit(rmodel.prefill)(params, {"tokens": toks}, rmodel.init_cache(B, M),
                                     lengths=lens_j)
    tl, tc = tmodel.prefill({"tokens": torch.from_numpy(toks)},
                            tmodel.init_cache(B, M), lengths=lens_t)
    np.testing.assert_allclose(tl.float().numpy(), _np(rl), atol=tol, rtol=tol)
    _assert_caches_close(tc, rc, tol)
    for step in range(2):
        nxt = _tokens(B, 1, seed=10 + step)
        rl, rc = jax.jit(rmodel.decode_step)(params, nxt, rc)
        tl, tc = tmodel.decode_step(torch.from_numpy(nxt), tc)
        np.testing.assert_allclose(tl.float().numpy(), _np(rl), atol=tol, rtol=tol)
        _assert_caches_close(tc, rc, tol)


def test_forward_matches_reference(pair):
    rmodel, params, tmodel, tol = pair
    toks = _tokens(2, 10, seed=5)
    want = jax.jit(rmodel.forward)(params, {"tokens": toks})
    got = tmodel.forward({"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(got.float().numpy(), _np(want), atol=tol, rtol=tol)


def test_decode_from_bridged_cache_matches_reference(pair):
    """A reference cache carried across (cache_from_numpy) decodes to the
    same logits: the cache layouts agree leaf for leaf."""
    rmodel, params, tmodel, tol = pair
    toks = _tokens(2, 6, seed=7)
    _, rc = jax.jit(rmodel.prefill)(params, {"tokens": toks}, rmodel.init_cache(2, 10))
    tc = cache_from_numpy(jax.tree.map(np.asarray, rc), tmodel, 2, 10)
    nxt = _tokens(2, 1, seed=8)
    rl, _ = jax.jit(rmodel.decode_step)(params, nxt, rc)
    tl, _ = tmodel.decode_step(torch.from_numpy(nxt), tc)
    np.testing.assert_allclose(tl.float().numpy(), _np(rl), atol=tol, rtol=tol)


@pytest.mark.parametrize("reduced", [False, True])
def test_config_matches_reference_field_for_field(reduced):
    ref, port = ref_get_arch("gemma-2b"), get_arch("gemma-2b")
    if reduced:
        ref, port = ref.reduced(), port.reduced()
    dtypes = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}
    rd, pd = dataclasses.asdict(ref), dataclasses.asdict(port)
    assert rd.keys() == pd.keys()
    for name, value in rd.items():
        assert pd[name] == dtypes.get(value, value), name


def test_build_model_is_seeded_and_params_match_reference_tree():
    cfg = get_arch("gemma-2b").reduced(n_layers=2)
    a = build_model(cfg, device="cpu", seed=0)
    b = build_model(cfg, device="cpu", seed=0)
    for (na, pa), (nb, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert na == nb and torch.equal(pa, pb)
    # per-layer parameters are views of the stacked tree, not copies
    assert a.blocks[1].attn["wq"].untyped_storage().data_ptr() == \
        a.blocks[0].attn["wq"].untyped_storage().data_ptr()
    ref_tree = ref_build_model(ref_get_arch("gemma-2b").reduced(n_layers=2)).param_defs()
    with pytest.raises(ValueError, match="shape"):
        bad = jax.tree.map(lambda d: np.zeros(d.shape, np.float32), ref_tree,
                           is_leaf=lambda d: hasattr(d, "axes"))
        bad["embed"] = np.zeros((3, 3), np.float32)
        params_from_numpy(bad, cfg, "cpu")


@pytest.mark.parametrize("change", [dict(use_mla=True),
                                    dict(family="moe", n_experts=4, top_k=2, d_ff_expert=64),
                                    dict(family="moe", n_experts=4, top_k=2, d_ff_expert=64,
                                         local_window=64)])
def test_unported_configs_raise_naming_the_roadmap(change):
    cfg = dataclasses.replace(get_arch("gemma-2b").reduced(), **change)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_model(cfg, device="cpu")


@pytest.mark.parametrize("arch", ["paligemma-3b", "whisper-large-v3"])
def test_unported_losses_raise_naming_the_roadmap(arch):
    """The vlm and encdec families train (their losses were refused until
    ROADMAP items 15-16 were done): the loss of the suite's train inputs
    is finite and the suite's train entry builds a state and steps.  The
    values are held to the reference in ``tests/test_torch_train_families.py``.
    The name is the one the test had while it checked the refusal: it now
    checks that both families train."""
    from repro_torch.core.suite import build_arch, get_benchmark
    built = build_arch(arch, {}, device="cpu")
    step, (state, inputs), _ = get_benchmark(arch, "train").make(batch=1, seq=8, built=built)
    with torch.no_grad():
        loss, metrics = built.model.loss(inputs)
    assert loss.dim() == 0 and np.isfinite(float(loss)) and set(metrics) == {"loss", "ppl"}
    state, metrics = step(state, inputs)
    assert int(state[1].step) == 1 and np.isfinite(float(metrics["loss"]))
