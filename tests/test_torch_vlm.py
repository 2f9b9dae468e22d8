"""The port's vlm family on the CPU against the reference: paligemma-3b at
its reduced config (8 patch positions ahead of the tokens under the
prefix mask, MQA, tied head).

Inputs are drawn with numpy and handed to both packages (the patch
embeddings x 0.02, as the suite draws them); weights are the
reference's, bridged.  Tolerances: 1e-4 at fp32 compute (logits and
caches) and 5e-2 at bf16 compute, as ``tests/test_torch_model.py``.
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
from repro.runner.traces import TraceSpec as RefSpec
from repro.runner.traces import cache_len_bound as ref_cache_len_bound
from repro.runner.traces import generate as ref_generate
from repro_torch.bridge import cache_from_numpy, cache_to_numpy, params_from_numpy
from repro_torch.configs import get_arch
from repro_torch.core.suite import Built, get_benchmark
from repro_torch.launch import serve
from repro_torch.runner.runner import BenchmarkRunner
from repro_torch.runner.scenario import Scenario
from repro_torch.runner.traces import TraceSpec, cache_len_bound, generate

# tiny shapes: one intra-op thread each, as the suite runs in parallel workers
torch.set_num_threads(1)

ARCH = "paligemma-3b"
COMPUTE = {"fp32": (jnp.float32, torch.float32, 1e-4),
           "bf16": (jnp.bfloat16, torch.bfloat16, 5e-2)}
P = 8   # the reduced config's patch positions


def _np(x):
    return np.asarray(x, np.float32)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


def _batches(B, S, seed=0):
    """The same numpy tokens and patch embeddings for both packages."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 512, (B, S)).astype(np.int32)
    pe = (rng.standard_normal((B, P, 128)) * 0.02).astype(np.float32)
    return ({"tokens": toks, "patch_embeds": jnp.asarray(pe)},
            {"tokens": torch.from_numpy(toks), "patch_embeds": torch.from_numpy(pe)})


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
    assert set(got) == set(want) == {("blocks", "k"), ("blocks", "v"), ("blocks", "len")}
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
    assert port.n_prefix == (P if reduced else 256) and port.family == "vlm"


def test_param_tree_and_layers_follow_the_reference(pair):
    rmodel, _, tmodel, _ = pair
    shapes = lambda t: {p: tuple(d.shape) for p, d in _leaves(t)}   # noqa: E731
    assert shapes(tmodel.param_defs()) == shapes(rmodel.param_defs())
    assert {p.dtype for p in tmodel.parameters()} == {torch.float32}
    assert [(b.mask_type, b.prefix_len) for b in tmodel.blocks] == [("prefix", P)] * 4
    assert shapes(tmodel.init_cache(2, 20 + P)) == shapes(rmodel.cache_defs(2, 20 + P))


def test_forward_matches_reference(pair):
    """Logits at every position, the patch positions' included."""
    rmodel, params, tmodel, tol = pair
    rb, tb = _batches(2, 12, seed=5)
    want = jax.jit(rmodel.forward)(params, rb)
    got = tmodel.forward(tb)
    assert got.shape == (2, P + 12, 512)
    np.testing.assert_allclose(got.float().numpy(), _np(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("lengths", [None, (12, 7)])
def test_prefill_then_decode_match_reference(pair, lengths):
    """The cache holds the prefix and the prompt; ragged rows end at
    ``n_prefix + lengths``; then 3 decode steps past them."""
    rmodel, params, tmodel, tol = pair
    B, S, M = 2, 12, 20 + P
    rb, tb = _batches(B, S)
    lens_j = None if lengths is None else jnp.asarray(lengths, jnp.int32)
    lens_t = None if lengths is None else torch.tensor(lengths, dtype=torch.int32)
    rl, rc = jax.jit(rmodel.prefill)(params, rb, rmodel.init_cache(B, M), lengths=lens_j)
    tl, tc = tmodel.prefill(tb, tmodel.init_cache(B, M), lengths=lens_t)
    np.testing.assert_allclose(tl.float().numpy(), _np(rl), atol=tol, rtol=tol)
    _assert_caches_close(tc, rc, tol)
    want_len = [P + S] * B if lengths is None else [P + n for n in lengths]
    np.testing.assert_array_equal(tc["blocks"]["len"][0].numpy(), want_len)
    for step in range(3):
        nxt = np.random.default_rng(10 + step).integers(0, 512, (B, 1)).astype(np.int32)
        rl, rc = jax.jit(rmodel.decode_step)(params, nxt, rc)
        tl, tc = tmodel.decode_step(torch.from_numpy(nxt), tc)
        np.testing.assert_allclose(tl.float().numpy(), _np(rl), atol=tol, rtol=tol)
    _assert_caches_close(tc, rc, tol)


def test_decode_from_bridged_cache_matches_reference(pair):
    rmodel, params, tmodel, tol = pair
    rb, _ = _batches(2, 6, seed=7)
    _, rc = jax.jit(rmodel.prefill)(params, rb, rmodel.init_cache(2, 10 + P))
    tc = cache_from_numpy(jax.tree.map(np.asarray, rc), tmodel, 2, 10 + P)
    nxt = np.random.default_rng(8).integers(0, 512, (2, 1)).astype(np.int32)
    rl, rc = jax.jit(rmodel.decode_step)(params, nxt, rc)
    tl, tc = tmodel.decode_step(torch.from_numpy(nxt), tc)
    np.testing.assert_allclose(tl.float().numpy(), _np(rl), atol=tol, rtol=tol)
    _assert_caches_close(tc, rc, tol)


@pytest.mark.parametrize("trace", ["uniform", "bursty+bimodal"])
def test_serve_tokens_equal_reference_engine(trace):
    """Admission zeroes the patch embeddings, slot positions start past
    the prefix, and the cache bound counts it."""
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
    max_len = cache_len_bound(reqs, prefix=P)
    assert max_len == ref_cache_len_bound(ref_reqs, prefix=P) == P + cache_len_bound(reqs)
    want = ref_summarize(RefEngine(RefBuilt(cfg=rcfg, model=rmodel, params=params),
                                   slots=3, max_len=max_len).run(ref_reqs))
    engine = serve.ServeEngine(built, slots=3, max_len=max_len)
    got = serve.summarize_metrics(engine.run(reqs))
    assert got["tokens_digest"] == want["tokens_digest"]
    assert got["decode_steps"] == want["decode_steps"]
    assert got["admit_calls"] == want["admit_calls"]
    assert engine._bucket(40) == max_len - P   # buckets stop short of the prefix


def test_suite_draws_patch_embeddings_and_sizes_the_cache():
    """``patch_embeds`` (B, n_prefix, d_model) x 0.02 from numpy seed 2;
    the decode cell's cache holds seq + 8 + n_prefix positions."""
    bench = get_benchmark(ARCH, "infer_decode")
    _, (model, tokens, cache), _ = bench.make(batch=2, seq=16, device="cpu")
    assert tuple(cache["blocks"]["k"].shape[2:3]) == (16 + 8 + P,)
    np.testing.assert_array_equal(cache["blocks"]["len"][0].numpy(), [16 + P] * 2)
    _, (_, batch, _), _ = get_benchmark(ARCH, "infer_prefill").make(batch=2, seq=16,
                                                                    device="cpu")
    want = np.random.default_rng(2).standard_normal((2, P, 128)) * 0.02
    np.testing.assert_allclose(batch["patch_embeds"].numpy(), want.astype(np.float32))


@pytest.mark.parametrize("task", ["infer_prefill", "infer_decode", "serve"])
def test_runner_cells_run_reduced_paligemma(task):
    runner = BenchmarkRunner(device="cpu", runs=2, warmup=0, compile_warmup=0)
    rr = runner.run(Scenario(arch=ARCH, task=task, batch=1, seq=16))
    assert rr.status == "ok", rr.error
    assert rr.median_us > 0 and rr.extra["prov_device"] == "cpu"
