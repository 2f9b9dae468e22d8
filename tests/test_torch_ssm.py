"""The port's mamba2 slice on the CPU against the reference: the causal
conv, the SSD op (the plain version of the CUDA kernel) with its final
state, the Mamba-2 block, the reduced mamba2 model's logits and caches,
and the serving engine's token digests.

Inputs are drawn with numpy and handed to both packages; weights are the
reference's, bridged.  Tolerances:
  * conv 1e-5 and block 1e-5 (fp32 both sides; summation order only);
  * the SSD op 5e-5 in fp32 and 5e-2 in bf16, as ``tests/test_kernels.py``
    (the port chunks by the kernel's 64 steps, the reference by its own
    chunk: the sums differ in order);
  * the model 1e-4 at fp32 compute and 5e-2 at bf16 compute, as
    ``tests/test_torch_model.py`` (bf16 rounds at other places in the
    two frameworks, e.g. inside SiLU and softplus).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.core.suite import Built as RefBuilt
from repro.kernels.ssd.ops import ssd as ref_ssd
from repro.launch.serve import ServeEngine as RefEngine
from repro.launch.serve import summarize_metrics as ref_summarize
from repro.models import build_model as ref_build_model
from repro.models import layers as RL
from repro.models import ssm as RS
from repro.runner.traces import TraceSpec as RefSpec
from repro.runner.traces import generate as ref_generate
from repro_torch.bridge import cache_from_numpy, cache_to_numpy, params_from_numpy
from repro_torch.configs import get_arch
from repro_torch.core.suite import Built
from repro_torch.kernels.ssd import kernel as ssd_kernel
from repro_torch.kernels.ssd.ops import ssd
from repro_torch.kernels.ssd.ref import ssd_ref
from repro_torch.launch import serve
from repro_torch.models import build_model
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.runner.runner import BenchmarkRunner
from repro_torch.runner.scenario import Scenario
from repro_torch.runner.traces import TraceSpec, cache_len_bound, generate

# tiny shapes: one intra-op thread each, as the suite runs in parallel workers
torch.set_num_threads(1)

ARCH = "mamba2-2.7b"
COMPUTE = {"fp32": (jnp.float32, torch.float32, 1e-4),
           "bf16": (jnp.bfloat16, torch.bfloat16, 5e-2)}
SSD_DTYPES = {"fp32": (jnp.float32, torch.float32, 5e-5),
              "bf16": (jnp.bfloat16, torch.bfloat16, 5e-2)}


def _np(x):
    return np.asarray(x, np.float32)


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# causal_conv1d
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("lengths", [None, (9, 4, 1)])
def test_causal_conv1d_matches_reference(with_state, lengths):
    rng = np.random.default_rng(0)
    B, Sq, C, W = 3, 9, 24, 4
    x, w = _rand(rng, B, Sq, C), _rand(rng, W, C, scale=0.5)
    state = _rand(rng, B, W - 1, C) if with_state else None
    lens = None if lengths is None else np.asarray(lengths, np.int32)
    jy, js = RL.causal_conv1d(jnp.asarray(x), jnp.asarray(w),
                              None if state is None else jnp.asarray(state),
                              lengths=None if lens is None else jnp.asarray(lens))
    ty, ts = L.causal_conv1d(torch.from_numpy(x), torch.from_numpy(w),
                             None if state is None else torch.from_numpy(state),
                             lengths=None if lens is None else torch.from_numpy(lens))
    np.testing.assert_allclose(ty.numpy(), _np(jy), atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(ts.numpy(), _np(js))


# ---------------------------------------------------------------------------
# The SSD op (plain version of the CUDA kernel)
# ---------------------------------------------------------------------------


def _ssd_inputs(B, Sq, H, P, N, seed=0):
    """The distributions of tests/test_kernels.py, drawn with numpy."""
    rng = np.random.default_rng(seed)
    x = _rand(rng, B, Sq, H, P)
    dt = np.log1p(np.exp(_rand(rng, B, Sq, H))).astype(np.float32)
    A = (-np.exp(_rand(rng, H) * 0.3)).astype(np.float32)
    Bm, Cm = _rand(rng, B, Sq, N, scale=0.3), _rand(rng, B, Sq, N, scale=0.3)
    return x, dt, A, Bm, Cm


@pytest.mark.parametrize("B,Sq,H,P,N,chunk", [
    (1, 64, 2, 16, 32, 16), (2, 96, 3, 16, 32, 32), (1, 128, 1, 32, 16, 64),
])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_ssd_op_matches_reference_kernel_and_sequential(B, Sq, H, P, N, chunk, dtype):
    jdt, tdt, tol = SSD_DTYPES[dtype]
    x, dt, A, Bm, Cm = _ssd_inputs(B, Sq, H, P, N)
    jx, jb, jc = (jnp.asarray(a).astype(jdt) for a in (x, Bm, Cm))
    want_kernel = ref_ssd(jx, jnp.asarray(dt), jnp.asarray(A), jb, jc, chunk=chunk,
                          interpret=True)
    # the oracle sees the same (bf16-rounded) inputs, in fp32
    want, want_state = RS.ssd_sequential(jx.astype(jnp.float32), jnp.asarray(dt),
                                         jnp.asarray(A), jb.astype(jnp.float32),
                                         jc.astype(jnp.float32))
    before = ssd_kernel.ssd_cuda.launches
    y, state = ssd(torch.from_numpy(x).to(tdt), torch.from_numpy(dt),
                   torch.from_numpy(A), torch.from_numpy(Bm).to(tdt),
                   torch.from_numpy(Cm).to(tdt))
    assert ssd_kernel.ssd_cuda.launches == before   # CPU: the plain version
    assert y.dtype == tdt and state.dtype == torch.float32
    for ref in (want_kernel, want):
        np.testing.assert_allclose(y.float().numpy(), _np(ref), atol=tol, rtol=tol)
    np.testing.assert_allclose(state.numpy(), _np(want_state), atol=tol, rtol=tol)


@pytest.mark.parametrize("Sq", [1, 50, 64, 130])
def test_ssd_op_with_initial_state_matches_sequential(Sq):
    """A nonzero initial state, and S below, at and off the 64-step chunk."""
    B, H, P, N = 2, 3, 16, 32
    x, dt, A, Bm, Cm = _ssd_inputs(B, Sq, H, P, N, seed=1)
    h0 = _rand(np.random.default_rng(2), B, H, P, N)
    want, want_state = RS.ssd_sequential(*(jnp.asarray(a) for a in (x, dt, A, Bm, Cm)),
                                         init_state=jnp.asarray(h0))
    y, state = ssd(*(torch.from_numpy(a) for a in (x, dt, A, Bm, Cm)),
                   init_state=torch.from_numpy(h0))
    np.testing.assert_allclose(y.numpy(), _np(want), atol=5e-5, rtol=5e-5)
    np.testing.assert_allclose(state.numpy(), _np(want_state), atol=5e-5, rtol=5e-5)
    # the port's own sequential form agrees too
    ys, ss = S.ssd_sequential(*(torch.from_numpy(a) for a in (x, dt, A, Bm, Cm)),
                              init_state=torch.from_numpy(h0))
    np.testing.assert_allclose(ys.numpy(), _np(want), atol=5e-5, rtol=5e-5)
    np.testing.assert_allclose(ss.numpy(), _np(want_state), atol=5e-5, rtol=5e-5)


def test_ssd_kernel_wrapper_refuses_cpu_tensors_and_what_it_does_not_take():
    x, dt, A, Bm, Cm = (torch.from_numpy(a) for a in _ssd_inputs(1, 8, 2, 16, 16))
    with pytest.raises(ValueError, match="CUDA tensors"):
        ssd_kernel.ssd_cuda(x, dt, A, Bm, Cm)
    meta = [t.to("meta") for t in (x, dt, A, Bm, Cm)]
    with pytest.raises(ValueError, match="no path"):
        ssd(*meta)
    # on the CPU the op is exactly the plain version
    y, st = ssd(x, dt, A, Bm, Cm)
    y2, st2 = ssd_ref(x, dt, A, Bm, Cm)
    torch.testing.assert_close(y, y2, rtol=0, atol=0)
    torch.testing.assert_close(st, st2, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# The Mamba-2 block and the model
# ---------------------------------------------------------------------------


def _cfgs(compute="fp32", **kw):
    jdt, tdt, _ = COMPUTE[compute]
    return (ref_get_arch(ARCH).reduced(compute_dtype=jdt, n_layers=2, **kw),
            get_arch(ARCH).reduced(compute_dtype=tdt, n_layers=2, **kw))


def test_mamba2_block_with_cache_matches_reference():
    """Padded prefill into a nonzero cache, then one decode step: outputs,
    conv and SSM states and the len vectors agree."""
    rcfg, tcfg = _cfgs()
    rp = RL.init_tree(RS.mamba2_defs(rcfg), jax.random.key(3))
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), rp)
    rng = np.random.default_rng(3)
    B, Sq = 2, 12
    cdefs = RS.mamba2_cache_defs(rcfg, B)
    c0 = {k: _rand(rng, *d.shape, scale=0.5) for k, d in cdefs.items() if k != "len"}
    c0["len"] = np.array([3, 5], np.int32)
    jcache = {k: jnp.asarray(v) for k, v in c0.items()}
    tcache = {k: torch.from_numpy(v.copy()) for k, v in c0.items()}
    seq_lens = np.array([12, 7], np.int32)
    u = _rand(rng, B, Sq, rcfg.d_model)
    block = jax.jit(lambda p, u, c, lens: RS.mamba2_block(p, u, rcfg, cache=c,
                                                          seq_lens=lens))
    jy, jcache = block(rp, jnp.asarray(u), jcache, jnp.asarray(seq_lens))
    ty, tcache = S.mamba2_block(tp, torch.from_numpy(u), tcfg, cache=tcache,
                                seq_lens=torch.from_numpy(seq_lens))
    np.testing.assert_allclose(ty.numpy(), _np(jy), atol=1e-5, rtol=1e-5)
    u1 = _rand(rng, B, 1, rcfg.d_model)
    jy, jcache = block(rp, jnp.asarray(u1), jcache, None)
    ty, tcache = S.mamba2_block(tp, torch.from_numpy(u1), tcfg, cache=tcache)
    np.testing.assert_allclose(ty.numpy(), _np(jy), atol=1e-5, rtol=1e-5)
    for name in ("conv", "ssm"):
        np.testing.assert_allclose(tcache[name].numpy(), _np(jcache[name]),
                                   atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(tcache["len"].numpy(), np.asarray(jcache["len"]))


@pytest.fixture(scope="module", params=["fp32", "bf16"])
def pair(request):
    rcfg, tcfg = _cfgs(request.param)
    rmodel = ref_build_model(rcfg)
    params = rmodel.init(jax.random.key(0))
    tmodel = params_from_numpy(jax.tree.map(np.asarray, params), tcfg, "cpu")
    return rmodel, params, tmodel, COMPUTE[request.param][2]


def _tokens(B, Sq, seed=0):
    return np.random.default_rng(seed).integers(0, 512, (B, Sq)).astype(np.int32)


def _assert_caches_close(tcache, rcache, tol):
    got, want = cache_to_numpy(tcache)["blocks"], jax.tree.map(_np, rcache)["blocks"]
    assert set(got) == set(want) == {"conv", "ssm", "len"}
    for name in ("conv", "ssm"):
        np.testing.assert_allclose(got[name], want[name], atol=tol, rtol=tol)
    np.testing.assert_array_equal(got["len"], want["len"])


@pytest.mark.parametrize("lengths", [None, (40, 23)])
def test_prefill_then_decode_match_reference(pair, lengths):
    rmodel, params, tmodel, tol = pair
    B, Sq = 2, 40
    toks = _tokens(B, Sq)
    lens_j = None if lengths is None else jnp.asarray(lengths, jnp.int32)
    lens_t = None if lengths is None else torch.tensor(lengths, dtype=torch.int32)
    rl, rc = jax.jit(rmodel.prefill)(params, {"tokens": toks}, rmodel.init_cache(B, Sq),
                                     lengths=lens_j)
    tl, tc = tmodel.prefill({"tokens": torch.from_numpy(toks)},
                            tmodel.init_cache(B, Sq), lengths=lens_t)
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
    toks = _tokens(2, 24, seed=5)
    want = jax.jit(rmodel.forward)(params, {"tokens": toks})
    got = tmodel.forward({"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(got.float().numpy(), _np(want), atol=tol, rtol=tol)


def test_decode_from_bridged_cache_matches_reference(pair):
    rmodel, params, tmodel, tol = pair
    toks = _tokens(2, 6, seed=7)
    _, rc = jax.jit(rmodel.prefill)(params, {"tokens": toks}, rmodel.init_cache(2, 8))
    tc = cache_from_numpy(jax.tree.map(np.asarray, rc), tmodel, 2, 8)
    assert tc["blocks"]["ssm"].dtype == torch.float32
    nxt = _tokens(2, 1, seed=8)
    rl, _ = jax.jit(rmodel.decode_step)(params, nxt, rc)
    tl, _ = tmodel.decode_step(torch.from_numpy(nxt), tc)
    np.testing.assert_allclose(tl.float().numpy(), _np(rl), atol=tol, rtol=tol)


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
    if not reduced:   # the published width the card runs
        assert (port.n_layers, port.d_model, port.d_inner, port.n_ssm_heads,
                port.ssm_headdim, port.d_state, port.vocab) == \
            (64, 2560, 5120, 80, 64, 128, 50280)


def test_bridged_param_dtypes_follow_the_declarations():
    rcfg, tcfg = _cfgs("bf16")
    params = ref_build_model(rcfg).init(jax.random.key(1))
    model = params_from_numpy(jax.tree.map(np.asarray, params), tcfg, "cpu")
    mix = model.blocks[0].mix
    for name in ("A_log", "D", "dt_bias", "in_proj", "conv_w"):
        assert mix[name].dtype == torch.float32, name
    cache = model.init_cache(2, 8)["blocks"]
    assert cache["conv"].dtype == torch.bfloat16
    assert cache["ssm"].dtype == torch.float32 and cache["len"].dtype == torch.int32


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("trace", ["uniform", "bursty+bimodal"])
def test_serve_tokens_equal_reference_engine(trace):
    rcfg, tcfg = _cfgs("fp32")
    rmodel = ref_build_model(rcfg)
    params = rmodel.init(jax.random.key(0))
    built = Built(cfg=tcfg, model=params_from_numpy(
        jax.tree.map(np.asarray, params), tcfg, "cpu"))
    arrival, _, plen = trace.partition("+")
    spec = dict(profile=arrival, requests=6, prompt_len=12, max_new=5, seed=0,
                prompt_profile=plen or "fixed")
    ref_reqs = ref_generate(RefSpec(**spec), vocab=512)
    reqs = generate(TraceSpec(**spec), vocab=512)
    max_len = cache_len_bound(reqs)
    want = ref_summarize(RefEngine(RefBuilt(cfg=rcfg, model=rmodel, params=params),
                                   slots=3, max_len=max_len).run(ref_reqs))
    got = serve.summarize_metrics(
        serve.ServeEngine(built, slots=3, max_len=max_len).run(reqs))
    assert got["tokens_digest"] == want["tokens_digest"]
    assert got["decode_steps"] == want["decode_steps"]
    assert got["admit_calls"] == want["admit_calls"]


def test_admission_policies_and_cache_copies_agree():
    """Batched admission's row scatter carries every ssm cache leaf (conv,
    ssm, len): batched and single admission, in-place and copied caches,
    give equal tokens."""
    cfg = _cfgs("fp32")[1]
    built = Built(cfg=cfg, model=build_model(cfg, device="cpu", seed=0))
    reqs = generate(TraceSpec(profile="mixed", requests=6, prompt_len=12, max_new=5,
                              seed=0, prompt_profile="uniform"), vocab=512)
    max_len = cache_len_bound(reqs)
    digests = set()
    for admission in serve.ADMISSIONS:
        for donate in (True, False):
            engine = serve.ServeEngine(built, slots=2, max_len=max_len,
                                       admission=admission, donate=donate)
            digests.add(serve.summarize_metrics(engine.run(reqs))["tokens_digest"])
    assert len(digests) == 1


@pytest.mark.parametrize("task", ["infer_prefill", "infer_decode", "serve"])
def test_runner_cells_run_reduced_mamba2(task):
    runner = BenchmarkRunner(device="cpu", runs=2, warmup=0, compile_warmup=0)
    rr = runner.run(Scenario(arch=ARCH, task=task, batch=1, seq=16))
    assert rr.status == "ok", rr.error
    assert rr.median_us > 0 and rr.extra["prov_device"] == "cpu"
