"""The port's recurrentgemma slice on the CPU against the reference: the
RG-LRU op (the plain version of the CUDA kernel) with an initial state and
its final state, the Griffin recurrent block, the reduced recurrentgemma
model's logits and caches (the local attention layers' ring buffers
included), and the serving engine's token digests.

Inputs are drawn with numpy and handed to both packages; weights are the
reference's, bridged.  Tolerances:
  * the RG-LRU op 2e-5, as ``tests/test_kernels.py`` (fp32 both sides; the
    port sums in 16-step log-space blocks, the reference in one
    associative scan or in 512-step blocks);
  * the block 1e-5 (fp32 both sides; summation order only);
  * the model 1e-4 at fp32 compute and 5e-2 at bf16 compute, as
    ``tests/test_torch_model.py`` (bf16 rounds at other places in the two
    frameworks).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.core.suite import Built as RefBuilt
from repro.kernels.rglru.ops import rglru as ref_rglru
from repro.launch.serve import ServeEngine as RefEngine
from repro.launch.serve import summarize_metrics as ref_summarize
from repro.models import build_model as ref_build_model
from repro.models import layers as RL
from repro.models import rglru as RR
from repro.runner.traces import TraceSpec as RefSpec
from repro.runner.traces import generate as ref_generate
from repro_torch.bridge import cache_from_numpy, cache_to_numpy, params_from_numpy
from repro_torch.configs import get_arch
from repro_torch.core.suite import Built
from repro_torch.kernels.rglru import kernel as rglru_kernel
from repro_torch.kernels.rglru.ops import rglru
from repro_torch.kernels.rglru.ref import gated_input, rglru_blocked, rglru_sequential
from repro_torch.launch import serve
from repro_torch.models import build_model
from repro_torch.models import rglru as R
from repro_torch.runner.runner import BenchmarkRunner
from repro_torch.runner.scenario import Scenario
from repro_torch.runner.traces import TraceSpec, cache_len_bound, generate

# tiny shapes: one intra-op thread each, as the suite runs in parallel workers
torch.set_num_threads(1)

ARCH = "recurrentgemma-9b"
COMPUTE = {"fp32": (jnp.float32, torch.float32, 1e-4),
           "bf16": (jnp.bfloat16, torch.bfloat16, 5e-2)}
OP_TOL = dict(atol=2e-5, rtol=2e-5)
BLOCK_TOL = dict(atol=1e-5, rtol=1e-5)


def _np(x):
    return np.asarray(x, np.float32)


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _xa(B, S, D, seed=0):
    """The distributions of tests/test_kernels.py: x normal, a =
    sigmoid(2 * normal)."""
    rng = np.random.default_rng(seed)
    x = _rand(rng, B, S, D)
    a = (1.0 / (1.0 + np.exp(-2.0 * _rand(rng, B, S, D)))).astype(np.float32)
    return x, a


# ---------------------------------------------------------------------------
# The RG-LRU op (plain version of the CUDA kernel)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,S,D", [(1, 64, 64), (2, 48, 96), (1, 128, 128),
                                   (2, 50, 100), (1, 1024, 128)])
def test_rglru_op_matches_reference_kernel_and_scan(B, S, D):
    """S=1024 takes the reference scan's 512-step blocked branch."""
    x, a = _xa(B, S, D)
    want_kernel = ref_rglru(jnp.asarray(x), jnp.asarray(a))
    want_scan, want_last = RR.rglru_scan(jnp.asarray(x), jnp.asarray(a))
    before = rglru_kernel.rglru_cuda.launches
    h, h_last = rglru(torch.from_numpy(x), torch.from_numpy(a))
    assert rglru_kernel.rglru_cuda.launches == before   # CPU: the plain version
    assert h.dtype == torch.float32 and h.shape == (B, S, D)
    np.testing.assert_allclose(h.numpy(), _np(want_kernel), **OP_TOL)
    np.testing.assert_allclose(h.numpy(), _np(want_scan), **OP_TOL)
    np.testing.assert_allclose(h_last.numpy(), _np(want_last), **OP_TOL)


@pytest.mark.parametrize("S", [1, 50, 130])
def test_rglru_op_with_initial_state_matches_reference_scan(S):
    B, D = 2, 96
    x, a = _xa(B, S, D, seed=1)
    h0 = _rand(np.random.default_rng(2), B, D)
    want, want_last = RR.rglru_scan(jnp.asarray(x), jnp.asarray(a),
                                    init_state=jnp.asarray(h0))
    h, h_last = rglru(torch.from_numpy(x), torch.from_numpy(a),
                      init_state=torch.from_numpy(h0))
    np.testing.assert_allclose(h.numpy(), _np(want), **OP_TOL)
    np.testing.assert_allclose(h_last.numpy(), _np(want_last), **OP_TOL)
    # the sequential oracle agrees on the same inputs
    seq = rglru_sequential(torch.from_numpy(a),
                           gated_input(torch.from_numpy(x), torch.from_numpy(a)),
                           torch.from_numpy(h0))
    np.testing.assert_allclose(seq.numpy(), _np(want), **OP_TOL)


@pytest.mark.parametrize("decay", [1e-6, 1 - 1e-6])
def test_rglru_op_stays_finite_at_extreme_decays(decay):
    B, S, D = 1, 32, 128
    x = _rand(np.random.default_rng(0), B, S, D)
    a = np.full((B, S, D), decay, np.float32)
    h, _ = rglru(torch.from_numpy(x), torch.from_numpy(a))
    assert bool(torch.isfinite(h).all())
    want = ref_rglru(jnp.asarray(x), jnp.asarray(a), block_t=16)
    np.testing.assert_allclose(h.numpy(), _np(want), **OP_TOL)


def test_rglru_kernel_wrapper_refuses_cpu_tensors_and_what_it_does_not_take():
    x, a = (torch.from_numpy(t) for t in _xa(1, 8, 16))
    with pytest.raises(ValueError, match="CUDA tensors"):
        rglru_kernel.rglru_cuda(x, a)
    with pytest.raises(ValueError, match="float32"):
        rglru_kernel.rglru_cuda(x.to(torch.bfloat16), a)
    with pytest.raises(ValueError, match="float32"):
        rglru_kernel.rglru_cuda(x, a[:, :4])
    with pytest.raises(ValueError, match=r"\(B, S, D\)"):
        rglru_kernel.rglru_cuda(x[0], a[0])
    with pytest.raises(ValueError, match="unit stride"):
        rglru_kernel.rglru_cuda(x.transpose(1, 2).contiguous().transpose(1, 2), a)
    with pytest.raises(ValueError, match="init_state"):
        rglru_kernel.rglru_cuda(x, a, torch.zeros(1, 8))
    with pytest.raises(ValueError, match="no path"):
        rglru(x.to("meta"), a.to("meta"))
    # on the CPU the op is exactly the plain version
    h, h_last = rglru(x, a)
    torch.testing.assert_close(h, rglru_blocked(x, a), rtol=0, atol=0)
    torch.testing.assert_close(h_last, h[:, -1], rtol=0, atol=0)


# ---------------------------------------------------------------------------
# The recurrent block
# ---------------------------------------------------------------------------


def _cfgs(compute="fp32", **kw):
    jdt, tdt, _ = COMPUTE[compute]
    return (ref_get_arch(ARCH).reduced(compute_dtype=jdt, **kw),
            get_arch(ARCH).reduced(compute_dtype=tdt, **kw))


@pytest.mark.parametrize("gate_blocks", [16, 0])
def test_rglru_block_matches_reference(gate_blocks):
    """Without a cache; then a padded prefill into a nonzero cache and two
    decode steps (S == 1 takes ``rglru_step``): outputs, conv and h states
    and the len vectors agree."""
    rcfg, tcfg = _cfgs(gate_blocks=gate_blocks)
    rp = RL.init_tree(RR.rglru_defs(rcfg), jax.random.key(3))
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), rp)
    rng = np.random.default_rng(3)
    B, Sq = 2, 12
    block = jax.jit(lambda p, u, c, lens: RR.rglru_block(p, u, rcfg, cache=c,
                                                         seq_lens=lens))
    u = _rand(rng, B, Sq, rcfg.d_model)
    jy, _ = RR.rglru_block(rp, jnp.asarray(u), rcfg)
    ty, none = R.rglru_block(tp, torch.from_numpy(u), tcfg)
    assert none is None
    np.testing.assert_allclose(ty.numpy(), _np(jy), **BLOCK_TOL)

    cdefs = RR.rglru_cache_defs(rcfg, B)
    c0 = {k: _rand(rng, *d.shape, scale=0.5) for k, d in cdefs.items() if k != "len"}
    c0["len"] = np.array([3, 5], np.int32)
    jcache = {k: jnp.asarray(v) for k, v in c0.items()}
    tcache = {k: torch.from_numpy(v.copy()) for k, v in c0.items()}
    seq_lens = np.array([12, 7], np.int32)
    jy, jcache = block(rp, jnp.asarray(u), jcache, jnp.asarray(seq_lens))
    ty, tcache = R.rglru_block(tp, torch.from_numpy(u), tcfg, cache=tcache,
                               seq_lens=torch.from_numpy(seq_lens))
    np.testing.assert_allclose(ty.numpy(), _np(jy), **BLOCK_TOL)
    for step in range(2):
        u1 = _rand(rng, B, 1, rcfg.d_model)
        jy, jcache = block(rp, jnp.asarray(u1), jcache, None)
        ty, tcache = R.rglru_block(tp, torch.from_numpy(u1), tcfg, cache=tcache)
        np.testing.assert_allclose(ty.numpy(), _np(jy), **BLOCK_TOL)
    for name in ("conv", "h"):
        np.testing.assert_allclose(tcache[name].numpy(), _np(jcache[name]), **BLOCK_TOL)
    np.testing.assert_array_equal(tcache["len"].numpy(), np.asarray(jcache["len"]))
    np.testing.assert_array_equal(tcache["len"].numpy(), [17, 14])


# ---------------------------------------------------------------------------
# The reduced model: 6 layers, (rec, rec, local attn) x 2, window 64
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=["fp32", "bf16"])
def pair(request):
    rcfg, tcfg = _cfgs(request.param)
    rmodel = ref_build_model(rcfg)
    params = rmodel.init(jax.random.key(0))
    tmodel = params_from_numpy(jax.tree.map(np.asarray, params), tcfg, "cpu")
    return rmodel, params, tmodel, COMPUTE[request.param][2]


def _tokens(B, Sq, seed=0):
    return np.random.default_rng(seed).integers(0, 512, (B, Sq)).astype(np.int32)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


def _assert_caches_close(tcache, rcache, tol):
    got = dict(_leaves(cache_to_numpy(tcache)))
    want = dict(_leaves(jax.tree.map(_np, rcache)))
    assert set(got) == set(want) and ("groups", "attn", "k") in got
    for path, w in want.items():
        if path[-1] == "len":
            np.testing.assert_array_equal(got[path], w, err_msg=str(path))
        else:
            np.testing.assert_allclose(got[path], w, atol=tol, rtol=tol, err_msg=str(path))


@pytest.mark.parametrize("Sq,lengths", [(88, None), (88, (88, 62)), (40, (40, 17))])
def test_prefill_then_decode_match_reference(pair, Sq, lengths):
    """Prompts past and inside the 64-token window into a 100-slot cache
    (the attention layers keep rings of 64): prefill, then 4 decode steps
    (row 1 of the ragged case wraps from slot 63 to slot 0)."""
    rmodel, params, tmodel, tol = pair
    B, max_len = 2, 100
    toks = _tokens(B, Sq)
    lens_j = None if lengths is None else jnp.asarray(lengths, jnp.int32)
    lens_t = None if lengths is None else torch.tensor(lengths, dtype=torch.int32)
    rl, rc = jax.jit(rmodel.prefill)(params, {"tokens": toks},
                                     rmodel.init_cache(B, max_len), lengths=lens_j)
    tcache = tmodel.init_cache(B, max_len)
    assert tcache["groups"]["attn"]["k"].shape[2] == tmodel.cfg.local_window
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


def test_forward_matches_reference(pair):
    """88 tokens: the local mask cuts the attention layers' window."""
    rmodel, params, tmodel, tol = pair
    toks = _tokens(2, 88, seed=5)
    want = jax.jit(rmodel.forward)(params, {"tokens": toks})
    got = tmodel.forward({"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(got.float().numpy(), _np(want), atol=tol, rtol=tol)


def test_decode_from_bridged_cache_matches_reference(pair):
    rmodel, params, tmodel, tol = pair
    toks = _tokens(2, 70, seed=7)
    _, rc = jax.jit(rmodel.prefill)(params, {"tokens": toks}, rmodel.init_cache(2, 80))
    tc = cache_from_numpy(jax.tree.map(np.asarray, rc), tmodel, 2, 80)
    assert tc["groups"]["rec"]["h"].dtype == torch.float32
    nxt = _tokens(2, 1, seed=8)
    rl, _ = jax.jit(rmodel.decode_step)(params, nxt, rc)
    tl, _ = tmodel.decode_step(torch.from_numpy(nxt), tc)
    np.testing.assert_allclose(tl.float().numpy(), _np(rl), atol=tol, rtol=tol)


def test_cache_len_is_the_first_len_leaf_and_every_counter_agrees():
    """``_cache_len`` reads ``groups.attn.len`` (the reference's flatten
    order); under ragged prefill and decode every layer's counter advances
    alike, so any of them would do."""
    cfg = _cfgs(n_layers=8)[1]      # G = 2 groups and a tail of 2
    model = build_model(cfg, device="cpu", seed=0)
    cache = model.init_cache(2, 100)
    cache["groups"]["attn"]["len"][0] = torch.tensor([7, 9], dtype=torch.int32)
    np.testing.assert_array_equal(model._cache_len(cache).numpy(), [7, 9])
    cache = model.init_cache(2, 100)
    model.prefill({"tokens": torch.from_numpy(_tokens(2, 70))}, cache,
                  lengths=torch.tensor([70, 33], dtype=torch.int32))
    model.decode_step(torch.from_numpy(_tokens(2, 1)), cache)
    lens = [t.reshape(-1, 2) for p, t in _leaves(cache) if p[-1] == "len"]
    assert len(lens) == 3
    for t in lens:
        np.testing.assert_array_equal(t.numpy(), np.tile([71, 34], (t.shape[0], 1)))


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
    if reduced:
        assert (port.n_layers, port.d_model, port.lru_width, port.local_window) == \
            (6, 128, 128, 64)
    else:   # the published width the card runs
        assert (port.n_layers, port.d_model, port.n_heads, port.n_kv_heads,
                port.head_dim, port.d_ff, port.vocab, port.local_window,
                port.lru_width, port.pattern_rec, port.gate_blocks,
                port.conv_width, port.activation) == \
            (38, 4096, 16, 1, 256, 12288, 256000, 2048, 4096, 2, 16, 4, "gelu_tanh")


def test_param_tree_and_dtypes_follow_the_declarations():
    """The bridged tree is the reference's (groups/tail, stacked axes); the
    fp32 leaves stay fp32 at bf16 compute; the layers run rec, rec, attn."""
    rcfg, tcfg = _cfgs("bf16", n_layers=8)      # G = 2 groups and a tail of 2
    params = ref_build_model(rcfg).init(jax.random.key(1))
    model = params_from_numpy(jax.tree.map(np.asarray, params), tcfg, "cpu")
    assert [type(b).__name__ for b in model.blocks] == \
        ["RecBlock", "RecBlock", "Block"] * 2 + ["RecBlock"] * 2
    assert model.blocks[2].mask_type == "local" and model.blocks[2].window == 64
    rec = model.blocks[0].rec
    for name in ("lambda_p", "w_x", "w_input_gate", "conv_w"):
        assert rec[name].dtype == torch.float32, name
    assert tuple(rec["w_input_gate"].shape) == (16, 8, 8)
    cache = model.init_cache(2, 100)
    assert set(cache) == {"groups", "tail"}
    assert tuple(cache["tail"]["h"].shape) == (2, 2, 128)
    assert cache["groups"]["rec"]["conv"].dtype == torch.bfloat16
    assert cache["groups"]["rec"]["h"].dtype == torch.float32
    assert cache["groups"]["rec"]["len"].dtype == torch.int32
    assert tuple(cache["groups"]["attn"]["k"].shape) == (2, 2, 64, 1, 32)
    # a cache no longer than the window is a plain (non-ring) local cache
    assert tuple(model.init_cache(2, 40)["groups"]["attn"]["k"].shape) == (2, 2, 40, 1, 32)


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


SERVE_TRACES = {
    "uniform": dict(profile="uniform", prompt_len=12, prompt_profile="fixed"),
    "bursty+bimodal": dict(profile="bursty", prompt_len=12, prompt_profile="bimodal"),
    # prompts of 20 and 80 tokens into rings of 64 (max_len 85): admission
    # runs the ring gather under seq_lens, for rows inside and past the window
    "past_window": dict(profile="uniform", prompt_len=40, prompt_profile="bimodal"),
}


@pytest.mark.parametrize("trace", sorted(SERVE_TRACES))
def test_serve_tokens_equal_reference_engine(trace):
    rcfg, tcfg = _cfgs("fp32")
    rmodel = ref_build_model(rcfg)
    params = rmodel.init(jax.random.key(0))
    built = Built(cfg=tcfg, model=params_from_numpy(
        jax.tree.map(np.asarray, params), tcfg, "cpu"))
    spec = dict(requests=6, max_new=5, seed=0, **SERVE_TRACES[trace])
    ref_reqs = ref_generate(RefSpec(**spec), vocab=512)
    reqs = generate(TraceSpec(**spec), vocab=512)
    max_len = cache_len_bound(reqs)
    if trace == "past_window":
        assert max(len(r.prompt) for r in reqs) > tcfg.local_window < max_len
    want = ref_summarize(RefEngine(RefBuilt(cfg=rcfg, model=rmodel, params=params),
                                   slots=3, max_len=max_len).run(ref_reqs))
    got = serve.summarize_metrics(
        serve.ServeEngine(built, slots=3, max_len=max_len).run(reqs))
    assert got["tokens_digest"] == want["tokens_digest"]
    assert got["decode_steps"] == want["decode_steps"]
    assert got["admit_calls"] == want["admit_calls"]


def test_admission_policies_and_cache_copies_agree():
    """Batched admission's row scatter carries every hybrid cache leaf
    (rings, conv, h, len): batched and single admission, in-place and
    copied caches, give equal tokens."""
    cfg = _cfgs("fp32")[1]
    built = Built(cfg=cfg, model=build_model(cfg, device="cpu", seed=0))
    reqs = generate(TraceSpec(profile="mixed", requests=6, prompt_len=40, max_new=5,
                              seed=0, prompt_profile="bimodal"), vocab=512)
    max_len = cache_len_bound(reqs)
    assert max_len > cfg.local_window
    digests = set()
    for admission in serve.ADMISSIONS:
        for donate in (True, False):
            engine = serve.ServeEngine(built, slots=2, max_len=max_len,
                                       admission=admission, donate=donate)
            digests.add(serve.summarize_metrics(engine.run(reqs))["tokens_digest"])
    assert len(digests) == 1


@pytest.mark.parametrize("task", ["infer_prefill", "infer_decode", "serve"])
def test_runner_cells_run_reduced_recurrentgemma(task):
    runner = BenchmarkRunner(device="cpu", runs=2, warmup=0, compile_warmup=0)
    rr = runner.run(Scenario(arch=ARCH, task=task, batch=1, seq=16))
    assert rr.status == "ok", rr.error
    assert rr.median_us > 0 and rr.extra["prov_device"] == "cpu"
