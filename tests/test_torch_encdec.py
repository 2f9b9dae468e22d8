"""The port's encdec family on the CPU against the reference:
whisper-large-v3 at its reduced config (a 2-layer encoder over 32
precomputed frames, 4 decoder layers with causal self-attention and
cross-attention, learned positions, no RoPE, tied head).

Inputs are drawn with numpy and handed to both packages (frames x 0.1,
as the suite draws them); weights are the reference's, bridged.
Tolerances:
  * the cross-attention layer alone 1e-5 (fp32 both sides; summation
    order only);
  * the encoder's output and the model 1e-4 at fp32 compute (logits and
    caches, the cross keys and values included) and 5e-2 at bf16
    compute, as ``tests/test_torch_model.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.core.suite import Built as RefBuilt
from repro.launch.serve import ServeEngine as RefEngine
from repro.launch.serve import summarize_metrics as ref_summarize
from repro.models import build_model as ref_build_model
from repro.models import layers as RL
from repro.runner.traces import TraceSpec as RefSpec
from repro.runner.traces import generate as ref_generate
from repro_torch.bridge import (cache_from_numpy, cache_to_numpy, params_from_numpy,
                                params_to_numpy)
from repro_torch.configs import get_arch
from repro_torch.core.suite import Built, get_benchmark
from repro_torch.launch import serve
from repro_torch.models import layers as L
from repro_torch.runner.runner import BenchmarkRunner
from repro_torch.runner.scenario import Scenario
from repro_torch.runner.traces import TraceSpec, cache_len_bound, generate

# tiny shapes: one intra-op thread each, as the suite runs in parallel workers
torch.set_num_threads(1)

ARCH = "whisper-large-v3"
COMPUTE = {"fp32": (jnp.float32, torch.float32, 1e-4),
           "bf16": (jnp.bfloat16, torch.bfloat16, 5e-2)}
LAYER_TOL = dict(atol=1e-5, rtol=1e-5)
F = 32   # the reduced config's frames


def _np(x):
    return np.asarray(x, np.float32)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


def _batches(B, S, seed=0):
    """The same numpy tokens and frames for both packages."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 512, (B, S)).astype(np.int32)
    frames = (rng.standard_normal((B, F, 128)) * 0.1).astype(np.float32)
    return ({"tokens": toks, "frames": jnp.asarray(frames)},
            {"tokens": torch.from_numpy(toks), "frames": torch.from_numpy(frames)})


@pytest.fixture(scope="module", params=["fp32", "bf16"])
def pair(request):
    jdt, tdt, tol = COMPUTE[request.param]
    rcfg = ref_get_arch(ARCH).reduced(compute_dtype=jdt)
    tcfg = get_arch(ARCH).reduced(compute_dtype=tdt)
    rmodel = ref_build_model(rcfg)
    params = rmodel.init(jax.random.key(0))
    tmodel = params_from_numpy(jax.tree.map(np.asarray, params), tcfg, "cpu")
    return rmodel, params, tmodel, tol


def _assert_caches_close(tcache, rcache, tol):
    got = dict(_leaves(cache_to_numpy(tcache)))
    want = dict(_leaves(jax.tree.map(_np, rcache)))
    assert set(got) == set(want)
    assert {("blocks", "cross_k"), ("blocks", "self", "len")} <= set(got)
    for path, w in want.items():
        if path[-1] == "len":
            np.testing.assert_array_equal(got[path], w, err_msg=str(path))
        else:
            np.testing.assert_allclose(got[path], w, atol=tol, rtol=tol, err_msg=str(path))


@pytest.mark.parametrize("reduced", [False, True])
def test_config_matches_reference_field_for_field(reduced):
    ref, port = ref_get_arch(ARCH), get_arch(ARCH)
    if reduced:
        ref, port = ref.reduced(), port.reduced()
    dtypes = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}
    rd, pd = dataclasses.asdict(ref), dataclasses.asdict(port)
    assert rd.keys() == pd.keys()
    for name, value in rd.items():
        assert pd[name] == dtypes.get(value, value), name
    assert (port.rope_theta, port.pos_embed, port.enc_seq) == \
        (0.0, "learned", F if reduced else 1500)


def test_param_and_cache_trees_follow_the_reference(pair):
    """enc_pos_embed, enc_blocks, enc_norm, pos_embed, the decoder's
    ln_cross/cross; caches {"self", "cross_k", "cross_v"}; the weights
    round-trip through the bridge."""
    rmodel, params, tmodel, _ = pair
    shapes = lambda t: {p: tuple(d.shape) for p, d in _leaves(t)}   # noqa: E731
    assert shapes(tmodel.param_defs()) == shapes(rmodel.param_defs())
    assert {("enc_blocks", "attn", "wq"), ("blocks", "cross", "wk"),
            ("pos_embed",)} <= set(shapes(tmodel.param_defs()))
    assert {p.dtype for p in tmodel.parameters()} == {torch.float32}
    assert len(tmodel.enc_blocks) == 2 and len(tmodel.blocks) == 4
    assert {b.mask_type for b in tmodel.enc_blocks} == {"full"}
    assert shapes(tmodel.init_cache(2, 20)) == shapes(rmodel.cache_defs(2, 20))
    back = dict(_leaves(params_to_numpy(tmodel)))
    for path, w in _leaves(jax.tree.map(_np, params)):
        np.testing.assert_array_equal(back[path], w, err_msg=str(path))


def test_cross_attention_layer_matches_reference():
    """A decoder layer's cross-attention alone: given keys and values, no
    RoPE, no cache, mask "full", at per-row decode positions."""
    rcfg = ref_get_arch(ARCH).reduced(compute_dtype=jnp.float32)
    tcfg = get_arch(ARCH).reduced(compute_dtype=torch.float32)
    rp = RL.init_tree(RL.gqa_defs(rcfg), jax.random.key(6))
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), rp)
    rng = np.random.default_rng(6)
    ck, cv = (rng.standard_normal((2, F, tcfg.n_kv_heads, tcfg.head_dim)).astype(np.float32)
              for _ in range(2))
    layer = jax.jit(lambda p, x, pos, k, v: RL.gqa_attention(
        p, x, rcfg, mask_type="full", positions=pos, cross_kv=(k, v)))
    for S, pos in ((7, np.arange(7)), (1, np.array([[9], [4]]))):
        x = rng.standard_normal((2, S, tcfg.d_model)).astype(np.float32)
        jy, _ = layer(rp, jnp.asarray(x), jnp.asarray(pos), jnp.asarray(ck), jnp.asarray(cv))
        ty, none = L.gqa_attention(tp, torch.from_numpy(x), tcfg, mask_type="full",
                                   positions=torch.from_numpy(pos),
                                   cross_kv=(torch.from_numpy(ck), torch.from_numpy(cv)))
        assert none is None
        np.testing.assert_allclose(ty.numpy(), _np(jy), **LAYER_TOL)


def test_encoder_matches_reference(pair):
    rmodel, params, tmodel, tol = pair
    rb, tb = _batches(2, 4, seed=3)
    want = jax.jit(rmodel.encode)(params, rb["frames"])
    got = tmodel.encode(tb["frames"])
    assert got.shape == (2, F, 128) and got.dtype == tmodel.cfg.compute_dtype
    np.testing.assert_allclose(got.float().numpy(), _np(want), atol=tol, rtol=tol)


def test_forward_matches_reference(pair):
    rmodel, params, tmodel, tol = pair
    rb, tb = _batches(2, 12, seed=5)
    want = jax.jit(rmodel.forward)(params, rb)
    got = tmodel.forward(tb)
    np.testing.assert_allclose(got.float().numpy(), _np(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("lengths", [None, (12, 7)])
def test_prefill_then_decode_match_reference(pair, lengths):
    """Prefill encodes the frames and caches every layer's cross keys and
    values; then 3 decode steps at per-row learned positions."""
    rmodel, params, tmodel, tol = pair
    B, S, M = 2, 12, 20
    rb, tb = _batches(B, S)
    lens_j = None if lengths is None else jnp.asarray(lengths, jnp.int32)
    lens_t = None if lengths is None else torch.tensor(lengths, dtype=torch.int32)
    rl, rc = jax.jit(rmodel.prefill)(params, rb, rmodel.init_cache(B, M), lengths=lens_j)
    tl, tc = tmodel.prefill(tb, tmodel.init_cache(B, M), lengths=lens_t)
    np.testing.assert_allclose(tl.float().numpy(), _np(rl), atol=tol, rtol=tol)
    _assert_caches_close(tc, rc, tol)
    for step in range(3):
        nxt = np.random.default_rng(10 + step).integers(0, 512, (B, 1)).astype(np.int32)
        rl, rc = jax.jit(rmodel.decode_step)(params, nxt, rc)
        tl, tc = tmodel.decode_step(torch.from_numpy(nxt), tc)
        np.testing.assert_allclose(tl.float().numpy(), _np(rl), atol=tol, rtol=tol)
    _assert_caches_close(tc, rc, tol)


def test_decode_from_bridged_cache_matches_reference(pair):
    """The reference's cache, cross keys and values included, carried
    across, decodes to the same logits and cache."""
    rmodel, params, tmodel, tol = pair
    rb, _ = _batches(2, 6, seed=7)
    _, rc = jax.jit(rmodel.prefill)(params, rb, rmodel.init_cache(2, 10))
    tc = cache_from_numpy(jax.tree.map(np.asarray, rc), tmodel, 2, 10)
    nxt = np.random.default_rng(8).integers(0, 512, (2, 1)).astype(np.int32)
    rl, rc = jax.jit(rmodel.decode_step)(params, nxt, rc)
    tl, tc = tmodel.decode_step(torch.from_numpy(nxt), tc)
    np.testing.assert_allclose(tl.float().numpy(), _np(rl), atol=tol, rtol=tol)
    _assert_caches_close(tc, rc, tol)


@pytest.mark.parametrize("trace", ["uniform", "bursty+bimodal"])
def test_serve_tokens_equal_reference_engine(trace):
    """Admission zeroes the frames and scatters each row's cross keys and
    values into its slot along their ``cache_batch`` axis."""
    rcfg = ref_get_arch(ARCH).reduced(compute_dtype=jnp.float32)
    tcfg = get_arch(ARCH).reduced(compute_dtype=torch.float32)
    rmodel = ref_build_model(rcfg)
    params = rmodel.init(jax.random.key(0))
    built = Built(cfg=tcfg, model=params_from_numpy(jax.tree.map(np.asarray, params), tcfg,
                                                    "cpu"))
    profile, _, prompts = trace.partition("+")
    spec = dict(profile=profile, prompt_len=12, prompt_profile=prompts or "fixed",
                requests=6, max_new=5, seed=0)
    ref_reqs = ref_generate(RefSpec(**spec), vocab=512)
    reqs = generate(TraceSpec(**spec), vocab=512)
    max_len = cache_len_bound(reqs)
    want = ref_summarize(RefEngine(RefBuilt(cfg=rcfg, model=rmodel, params=params),
                                   slots=3, max_len=max_len).run(ref_reqs))
    engine = serve.ServeEngine(built, slots=3, max_len=max_len)
    assert engine._cache_axes["blocks"]["cross_k"] == 1
    got = serve.summarize_metrics(engine.run(reqs))
    assert got["tokens_digest"] == want["tokens_digest"]
    assert got["decode_steps"] == want["decode_steps"]
    assert got["admit_calls"] == want["admit_calls"]


def test_suite_draws_frames():
    """``frames`` (B, enc_seq, d_model) x 0.1 from numpy seed 2."""
    _, (_, batch, cache), _ = get_benchmark(ARCH, "infer_prefill").make(batch=2, seq=16,
                                                                        device="cpu")
    want = np.random.default_rng(2).standard_normal((2, F, 128)) * 0.1
    np.testing.assert_allclose(batch["frames"].numpy(), want.astype(np.float32))
    assert tuple(cache["blocks"]["cross_k"].shape) == (4, 2, F, 2, 32)


@pytest.mark.parametrize("task", ["infer_prefill", "infer_decode", "serve"])
def test_runner_cells_run_reduced_whisper(task):
    runner = BenchmarkRunner(device="cpu", runs=2, warmup=0, compile_warmup=0)
    rr = runner.run(Scenario(arch=ARCH, task=task, batch=1, seq=16))
    assert rr.status == "ok", rr.error
    assert rr.median_us > 0 and rr.extra["prov_device"] == "cpu"
