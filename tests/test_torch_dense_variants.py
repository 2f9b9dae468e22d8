"""The port's dense variants on the CPU against the reference: gemma3-12b
(qk_norm, the grouped 5:1 local:global stack with ring caches),
nemotron-4-15b (squared-ReLU without a gate, untied head) and
internlm2-20b (SwiGLU, GQA, untied head), at their reduced configs.

Inputs are drawn with numpy and handed to both packages; weights are the
reference's, bridged.  Tolerances:
  * the qk_norm attention layer alone 1e-5 (fp32 both sides; summation
    order only);
  * the model 1e-4 at fp32 compute (logits and caches) and 5e-2 at bf16
    compute, as ``tests/test_torch_model.py``;
  * one gemma3 train step: loss and grad norm 1e-5 relative, the moments
    1e-5 of each leaf's largest |value|, params 1e-5 relative plus 1e-6
    except at most one element in 10^4, which must lie within 1e-3, as
    ``tests/test_torch_train.py`` (where a gradient element is near zero,
    AdamW's m / (sqrt(v) + eps) turns its last-bit rounding into a
    visible share of the step).
gemma3's reduced window is 64 slots: prompts of 80 tokens into caches of
96 slots make its local layers' caches rings that wrap.
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
from repro.launch.steps import TrainHyper as RefHyper
from repro.launch.steps import make_train_step as ref_make_train_step
from repro.models import build_model as ref_build_model
from repro.models import layers as RL
from repro.optim.adamw import adamw_init as ref_adamw_init
from repro.runner.traces import TraceSpec as RefSpec
from repro.runner.traces import generate as ref_generate
from repro_torch.bridge import (cache_from_numpy, cache_to_numpy, opt_state_to_numpy,
                                params_from_numpy, params_to_numpy)
from repro_torch.configs import get_arch
from repro_torch.core.suite import Built
from repro_torch.launch import serve
from repro_torch.launch.steps import TrainHyper, make_train_step
from repro_torch.models import layers as L
from repro_torch.optim import adamw_init
from repro_torch.runner.runner import BenchmarkRunner
from repro_torch.runner.scenario import Scenario
from repro_torch.runner.traces import TraceSpec, cache_len_bound, generate

# tiny shapes: one intra-op thread each, as the suite runs in parallel workers
torch.set_num_threads(1)

ARCHS = ("gemma3-12b", "nemotron-4-15b", "internlm2-20b")
COMPUTE = {"fp32": (jnp.float32, torch.float32, 1e-4),
           "bf16": (jnp.bfloat16, torch.bfloat16, 5e-2)}
LAYER_TOL = dict(atol=1e-5, rtol=1e-5)


def _np(x):
    return np.asarray(x, np.float32)


def _tokens(B, S, seed=0):
    return np.random.default_rng(seed).integers(0, 512, (B, S)).astype(np.int32)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


def _cfgs(arch, compute="fp32", **kw):
    jdt, tdt, _ = COMPUTE[compute]
    return (ref_get_arch(arch).reduced(compute_dtype=jdt, **kw),
            get_arch(arch).reduced(compute_dtype=tdt, **kw))


@pytest.fixture(scope="module")
def pairs():
    """(reference model, its params, the port's model on them, tolerance)
    by (arch, compute), each built once for the module."""
    built = {}

    def get(arch, compute):
        if (arch, compute) not in built:
            rcfg, tcfg = _cfgs(arch, compute)
            rmodel = ref_build_model(rcfg)
            params = rmodel.init(jax.random.key(0))
            tmodel = params_from_numpy(jax.tree.map(np.asarray, params), tcfg, "cpu")
            built[arch, compute] = (rmodel, params, tmodel, COMPUTE[compute][2])
        return built[arch, compute]
    return get


def _assert_caches_close(tcache, rcache, tol):
    got = dict(_leaves(cache_to_numpy(tcache)))
    want = dict(_leaves(jax.tree.map(_np, rcache)))
    assert set(got) == set(want)
    for path, w in want.items():
        if path[-1] == "len":
            np.testing.assert_array_equal(got[path], w, err_msg=str(path))
        else:
            np.testing.assert_allclose(got[path], w, atol=tol, rtol=tol, err_msg=str(path))


# ---------------------------------------------------------------------------
# Configs and trees
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference_field_for_field(arch, reduced):
    ref, port = ref_get_arch(arch), get_arch(arch)
    if reduced:
        ref, port = ref.reduced(), port.reduced()
    dtypes = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}
    rd, pd = dataclasses.asdict(ref), dataclasses.asdict(port)
    assert rd.keys() == pd.keys()
    for name, value in rd.items():
        assert pd[name] == dtypes.get(value, value), name


def _shapes(tree):
    return {"/".join(p): tuple(d.shape) for p, d in _leaves(tree)}


@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_cache_trees_follow_the_reference(pairs, arch):
    """The port declares the reference's param and cache trees (leaf for
    leaf, shape for shape); every weight stays fp32 at bf16 compute; the
    layers run in the reference's order."""
    rcfg, tcfg = _cfgs(arch, "bf16")
    rmodel = ref_build_model(rcfg)
    model = pairs(arch, "bf16")[2]
    assert _shapes(model.param_defs()) == _shapes(rmodel.param_defs())
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    cache = model.init_cache(2, 96)
    assert {k: tuple(v.shape) for k, v in _leaves(cache)} == \
        {k: tuple(d.shape) for k, d in _leaves(rmodel.cache_defs(2, 96))}
    if arch == "gemma3-12b":
        # 2 groups of (1 local, 1 global); q_norm/k_norm over the head dim
        assert [b.mask_type for b in model.blocks] == ["local", "causal"] * 2
        assert model.blocks[0].window == 64 and "lm_head" not in dict(model.named_parameters())
        assert tuple(model.blocks[1].attn["q_norm"].shape) == (tcfg.head_dim,)
        assert tuple(cache["groups"]["local"]["k"].shape) == (2, 1, 2, 64, 2, 32)   # rings
        assert tuple(cache["groups"]["global"]["k"].shape) == (2, 2, 96, 2, 32)
        # a cache no longer than the window is a plain local cache
        assert tuple(model.init_cache(2, 40)["groups"]["local"]["k"].shape) == (2, 1, 2, 40, 2, 32)
    else:
        assert [b.mask_type for b in model.blocks] == ["causal"] * 4
        assert tuple(model.lm_head.shape) == (tcfg.d_model, tcfg.vocab)
        assert ("w_gate" in model.blocks[0].mlp) == tcfg.glu
        assert "q_norm" not in model.blocks[0].attn


def test_qk_norm_attention_layer_matches_reference():
    """gemma3's attention layer alone: q and k normed over the head dim
    before RoPE, a cache at per-row offsets, then a decode step."""
    rcfg, tcfg = _cfgs("gemma3-12b")
    rp = RL.init_tree(RL.gqa_defs(rcfg), jax.random.key(4))
    rp = {**rp, "q_norm": rp["q_norm"] + 0.3, "k_norm": rp["k_norm"] - 0.2}
    assert set(rp) == {"wq", "wk", "wv", "wo", "q_norm", "k_norm"}
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), rp)
    rng = np.random.default_rng(4)
    B, S, M = 2, 10, 16
    shape = (B, M, tcfg.n_kv_heads, tcfg.head_dim)
    jcache = {"k": jnp.zeros(shape), "v": jnp.zeros(shape), "len": jnp.asarray([0, 3], jnp.int32)}
    tcache = {"k": torch.zeros(shape), "v": torch.zeros(shape),
              "len": torch.tensor([0, 3], dtype=torch.int32)}
    x = rng.standard_normal((B, S, tcfg.d_model)).astype(np.float32)
    layer = jax.jit(lambda p, x, pos, c, mask, window: RL.gqa_attention(
        p, x, rcfg, mask_type=mask, window=window, positions=pos, cache=c),
        static_argnums=(4, 5))
    jy, jcache = layer(rp, jnp.asarray(x), jnp.arange(S), jcache, "causal", 0)
    ty, tcache = L.gqa_attention(tp, torch.from_numpy(x), tcfg, mask_type="causal",
                                 positions=torch.arange(S), cache=tcache)
    np.testing.assert_allclose(ty.numpy(), _np(jy), **LAYER_TOL)
    x1 = rng.standard_normal((B, 1, tcfg.d_model)).astype(np.float32)
    pos = np.array([[10], [13]])
    jy, jcache = layer(rp, jnp.asarray(x1), jnp.asarray(pos), jcache, "local", 8)
    ty, tcache = L.gqa_attention(tp, torch.from_numpy(x1), tcfg, mask_type="local", window=8,
                                 positions=torch.from_numpy(pos), cache=tcache)
    np.testing.assert_allclose(ty.numpy(), _np(jy), **LAYER_TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(tcache[name].numpy(), _np(jcache[name]), **LAYER_TOL)
    np.testing.assert_array_equal(tcache["len"].numpy(), [11, 14])


# ---------------------------------------------------------------------------
# The reduced models
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("compute", ["fp32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(pairs, arch, compute):
    """80 tokens: past gemma3's reduced window of 64."""
    rmodel, params, tmodel, tol = pairs(arch, compute)
    toks = _tokens(2, 80, seed=5)
    want = jax.jit(rmodel.forward)(params, {"tokens": toks})
    got = tmodel.forward({"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(got.float().numpy(), _np(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("arch,compute,lengths", [
    (arch, compute, lengths) for arch in ARCHS
    for compute, lengths in (("fp32", None), ("fp32", (80, 50)), ("bf16", None))
    if compute == "fp32" or arch == "gemma3-12b"])
def test_prefill_then_decode_match_reference(pairs, arch, compute, lengths):
    """Prefill of 80 tokens into 96 slots (gemma3's local layers keep rings
    of 64), then 4 decode steps; logits and every cache leaf agree.  bf16
    compute through the grouped stack (nemotron's and internlm2's plain
    stacks run gemma-2b's bf16 path: ``tests/test_torch_model.py``)."""
    rmodel, params, tmodel, tol = pairs(arch, compute)
    B, S, M = 2, 80, 96
    toks = _tokens(B, S)
    lens_j = None if lengths is None else jnp.asarray(lengths, jnp.int32)
    lens_t = None if lengths is None else torch.tensor(lengths, dtype=torch.int32)
    rl, rc = jax.jit(rmodel.prefill)(params, {"tokens": toks}, rmodel.init_cache(B, M),
                                     lengths=lens_j)
    tcache = tmodel.init_cache(B, M)
    tl, tc = tmodel.prefill({"tokens": torch.from_numpy(toks)}, tcache, lengths=lens_t)
    assert tc is tcache                       # updated in place
    np.testing.assert_allclose(tl.float().numpy(), _np(rl), atol=tol, rtol=tol)
    _assert_caches_close(tc, rc, tol)
    for step in range(4):
        nxt = _tokens(B, 1, seed=10 + step)
        rl, rc = jax.jit(rmodel.decode_step)(params, nxt, rc)
        tl, tc = tmodel.decode_step(torch.from_numpy(nxt), tc)
        np.testing.assert_allclose(tl.float().numpy(), _np(rl), atol=tol, rtol=tol)
    _assert_caches_close(tc, rc, tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_from_bridged_cache_matches_reference(pairs, arch):
    """A reference cache carried across (cache_from_numpy) decodes to the
    same logits and the same cache: the layouts agree leaf for leaf."""
    rmodel, params, tmodel, tol = pairs(arch, "fp32")
    toks = _tokens(2, 70, seed=7)
    _, rc = jax.jit(rmodel.prefill)(params, {"tokens": toks}, rmodel.init_cache(2, 80))
    tc = cache_from_numpy(jax.tree.map(np.asarray, rc), tmodel, 2, 80)
    nxt = _tokens(2, 1, seed=8)
    rl, rc = jax.jit(rmodel.decode_step)(params, nxt, rc)
    tl, tc = tmodel.decode_step(torch.from_numpy(nxt), tc)
    np.testing.assert_allclose(tl.float().numpy(), _np(rl), atol=tol, rtol=tol)
    _assert_caches_close(tc, rc, tol)


# ---------------------------------------------------------------------------
# Serving and the runner
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_tokens_equal_reference_engine(pairs, arch):
    """Bimodal prompts of 20 and 80 tokens: gemma3's admissions prefill
    past its window into rings of 64 (max_len 85)."""
    rmodel, params, tmodel, _ = pairs(arch, "fp32")
    spec = dict(profile="bursty", prompt_len=40, prompt_profile="bimodal", requests=6,
                max_new=5, seed=0)
    ref_reqs = ref_generate(RefSpec(**spec), vocab=512)
    reqs = generate(TraceSpec(**spec), vocab=512)
    max_len = cache_len_bound(reqs)
    assert max(len(r.prompt) for r in reqs) > 64 < max_len
    want = ref_summarize(RefEngine(RefBuilt(cfg=rmodel.cfg, model=rmodel, params=params),
                                   slots=3, max_len=max_len).run(ref_reqs))
    got = serve.summarize_metrics(
        serve.ServeEngine(Built(cfg=tmodel.cfg, model=tmodel), slots=3,
                          max_len=max_len).run(reqs))
    assert got["tokens_digest"] == want["tokens_digest"]
    assert got["decode_steps"] == want["decode_steps"]
    assert got["admit_calls"] == want["admit_calls"]


@pytest.mark.parametrize("task", ["infer_prefill", "infer_decode", "serve"])
@pytest.mark.parametrize("arch", ARCHS)
def test_runner_cells_run_reduced_dense_variants(arch, task):
    runner = BenchmarkRunner(device="cpu", runs=2, warmup=0, compile_warmup=0)
    rr = runner.run(Scenario(arch=arch, task=task, batch=1, seq=16))
    assert rr.status == "ok", rr.error
    assert rr.median_us > 0 and rr.extra["prov_device"] == "cpu"


# ---------------------------------------------------------------------------
# Training: one reduced gemma3 step
# ---------------------------------------------------------------------------


def test_gemma3_train_step_matches_reference():
    """One step of the reduced gemma3 from the reference's weights, 80
    tokens past its window (qk_norm and the local mask through autograd):
    loss, grad norm, params and moments agree."""
    tokens = _tokens(2, 80, seed=3)
    hyper = dict(warmup_steps=2, total_steps=20)
    rcfg, tcfg = _cfgs("gemma3-12b")
    rstep, rmodel = ref_make_train_step(rcfg, RefHyper(**hyper))
    params = rmodel.init(jax.random.key(0))
    p0 = jax.tree.map(np.asarray, params)
    (rparams, ropt), rm = jax.jit(rstep)((params, ref_adamw_init(params)),
                                        {"tokens": jnp.asarray(tokens)})
    model = params_from_numpy(p0, tcfg, "cpu").requires_grad_(True)
    state = (model, adamw_init(model.stacked_params()))
    state, m = make_train_step(tcfg, TrainHyper(**hyper))(
        state, {"tokens": torch.from_numpy(tokens)})
    for k in ("loss", "grad_norm", "lr"):
        assert float(m[k]) == pytest.approx(float(rm[k]), rel=1e-5), k
    got = dict(_leaves(params_to_numpy(state[0])))
    want = dict(_leaves(jax.tree.map(_np, rparams)))
    assert set(got) == set(want) and ("groups", "local", "attn", "q_norm") in got
    g = np.concatenate([np.ravel(got[p]) for p in sorted(want)])
    w = np.concatenate([np.ravel(want[p]) for p in sorted(want)])
    diff = np.abs(g - w)
    outliers = diff > 1e-6 + 1e-5 * np.abs(w)
    assert outliers.mean() <= 1e-4, f"{outliers.sum()} of {g.size} params differ"
    assert diff.max() <= 1e-3, f"params differ by {diff.max()}"
    opt = opt_state_to_numpy(state[1])
    for name, rtree in (("mu", ropt.mu), ("nu", ropt.nu)):
        for path, w in _leaves(jax.tree.map(_np, rtree)):
            g = dict(_leaves(opt[name]))[path]
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * float(np.abs(w).max()),
                                       err_msg=f"{name}{path}")
