"""Training in the port against the reference, on the CPU, at the reduced
gemma-2b config in fp32: the optimizer and schedule on the same numpy
trees, one and three train steps from bridged weights under every remat
policy, gradient accumulation, the chunked cross-entropy, the runner's
train cell, and serving after training.

Tolerances (fp32 throughout, the two frameworks summing in other
orders): loss, ppl, grad_norm and lr within 1e-5 relative; each leaf of
``mu`` and ``nu`` within 1e-5 of its largest |value|; params within 1e-5
relative plus an absolute 1e-6 (1/300 of one step at lr 3e-4), except
at most one element in 10^4, which must lie within 1e-3 (a few whole
steps): where a gradient element is near zero, AdamW's m / (sqrt(v) +
eps) turns its last-bit rounding into a visible share of the step, up
to the step's sign.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.models import build_model as ref_build_model
from repro.launch.steps import TrainHyper as RefHyper
from repro.launch.steps import make_state_defs as ref_make_state_defs
from repro.launch.steps import make_train_step as ref_make_train_step
from repro.optim.adamw import AdamWConfig as RefAdamWConfig
from repro.optim.adamw import OptState as RefOptState
from repro.optim.adamw import adamw_init as ref_adamw_init
from repro.optim.adamw import adamw_update as ref_adamw_update
from repro.optim.schedule import cosine_schedule as ref_cosine
from repro.optim.schedule import linear_warmup as ref_warmup
from repro.runner.results import RunResult as RefRunResult
from repro_torch.bridge import (opt_state_to_numpy, params_from_numpy,
                                params_to_numpy)
from repro_torch.configs import get_arch
from repro_torch.core.suite import build_arch, get_benchmark
from repro_torch.launch.serve import ServeEngine, summarize_metrics
from repro_torch.launch.steps import TrainHyper, make_state_defs, make_train_step
from repro_torch.models import build_model
from repro_torch.optim import (AdamWConfig, OptState, adamw_init, adamw_update,
                               cosine_schedule, linear_warmup)
from repro_torch.runner.results import RunResult
from repro_torch.runner.runner import BenchmarkRunner
from repro_torch.runner.scenario import Scenario
from repro_torch.runner.traces import TraceSpec, cache_len_bound, generate

torch.set_num_threads(1)

RTOL = 1e-5
ATOL_PARAMS = 1e-6
HYPER = dict(warmup_steps=2, total_steps=20)


def _np(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), tree)


def _assert_trees(got, want, what, rtol=RTOL):
    """Each leaf within ``rtol`` of its largest |value|."""
    flat_w, _ = jax.tree_util.tree_flatten_with_path(_np(want))
    flat_g = jax.tree.leaves(got)
    assert len(flat_g) == len(flat_w), what
    for (path, w), g in zip(flat_w, flat_g):
        np.testing.assert_allclose(g, w, rtol=0, atol=rtol * float(np.abs(w).max()),
                                   err_msg=f"{what}{jax.tree_util.keystr(path)}")


def _assert_params(got, want):
    g = np.concatenate([np.ravel(x) for x in jax.tree.leaves(got)])
    w = np.concatenate([np.ravel(x) for x in jax.tree.leaves(_np(want))])
    assert g.shape == w.shape
    diff = np.abs(g - w)
    outliers = diff > ATOL_PARAMS + RTOL * np.abs(w)
    assert outliers.mean() <= 1e-4, f"{outliers.sum()} of {g.size} params differ"
    assert diff.max() <= 1e-3, f"params differ by {diff.max()}"


def _tokens(B, S, seed=0):
    return np.random.default_rng(seed).integers(0, 512, (B, S)).astype(np.int32)


def _reference(steps, tokens, remat="full", micro=1, **cfg_kw):
    """The reference's params, OptState and metrics after each step."""
    rcfg = ref_get_arch("gemma-2b").reduced(compute_dtype=jnp.float32,
                                            remat=remat, **cfg_kw)
    step, model = ref_make_train_step(rcfg, RefHyper(microbatches=micro, **HYPER))
    params = model.init(jax.random.key(0))
    state = (params, ref_adamw_init(params))
    p0 = _np(params)
    step = jax.jit(step)
    out = []
    for _ in range(steps):
        state, m = step(state, {"tokens": jnp.asarray(tokens)})
        out.append((_np(state[0]), _np(state[1]), {k: float(v) for k, v in m.items()}))
    return p0, out


def _port_state(p0, arch="gemma-2b", **cfg_kw):
    """The port's train state over the reference's initial params ``p0``."""
    tcfg = get_arch(arch).reduced(compute_dtype=torch.float32, **cfg_kw)
    model = params_from_numpy(p0, tcfg, "cpu").requires_grad_(True)
    return tcfg, (model, adamw_init(model.stacked_params()))


def _assert_step(state, metrics, ref, moments_rtol=RTOL):
    rparams, ropt, rmetrics = ref
    for k, v in rmetrics.items():
        assert float(metrics[k]) == pytest.approx(v, rel=RTOL), k
    _assert_params(params_to_numpy(state[0]), rparams)
    opt = opt_state_to_numpy(state[1])
    assert int(opt["step"]) == int(ropt.step)
    _assert_trees(opt["mu"], ropt.mu, "mu", moments_rtol)
    _assert_trees(opt["nu"], ropt.nu, "nu", moments_rtol)


# ---------------------------------------------------------------------------
# (b) optimizer and schedule on the same numpy trees
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("step", [0, 1, 5, 50])
def test_schedules_match_reference(step):
    for args in ((step, 10, 100, 3e-4), (step, 0, 1, 1.0, 0.3), (step, 10, 10, 2.0)):
        assert float(cosine_schedule(*args)) == pytest.approx(float(ref_cosine(*args)), rel=1e-6)
    assert float(linear_warmup(step, 10, 3e-4)) == pytest.approx(float(ref_warmup(step, 10, 3e-4)),
                                                                 rel=1e-6)
    assert cosine_schedule(torch.tensor(step, dtype=torch.int32), 10, 100, 3e-4).dtype == torch.float32


def _defs(tree, path=""):
    """(path, shape, axes) of every ParamDef of a nest of dicts."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _defs(tree[k], f"{path}/{k}")]
    return [(path, tuple(tree.shape), tuple(tree.axes))]


def test_state_defs_match_reference():
    """(params, OptState) declared as the reference declares them: the
    same leaves, shapes and axes, fp32 moments, an int32 step."""
    rp, ro = ref_make_state_defs(ref_build_model(ref_get_arch("gemma-2b").reduced()))
    tp, to = make_state_defs(build_model(get_arch("gemma-2b").reduced(), device="cpu"))
    assert _defs(tp) == _defs(rp)
    assert _defs(to.mu) == _defs(ro.mu) == _defs(to.nu)
    assert {d.dtype for d in jax.tree.leaves(
        to.mu, is_leaf=lambda x: hasattr(x, "axes"))} == {torch.float32}
    assert to.step.shape == () and to.step.dtype == torch.int32


@pytest.mark.parametrize("clip", [1.0, 1e-3])
@pytest.mark.parametrize("param_dtype", ["fp32", "bf16"])
def test_adamw_update_matches_reference(clip, param_dtype):
    """Two updates from a state with moments, clipping on (1e-3) and off;
    bf16 params are updated in fp32 and cast back, as in the reference."""
    rng = np.random.default_rng(0)
    shapes = {"a": (3, 5), "b": {"c": (7,), "d": (2, 2, 4)}}
    mk = lambda: jax.tree.map(lambda s: rng.standard_normal(s).astype(np.float32),   # noqa: E731
                              shapes, is_leaf=lambda x: isinstance(x, tuple))
    p, m, v = mk(), mk(), jax.tree.map(np.abs, mk())
    grads = [mk(), mk()]
    jdt, tdt = {"fp32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[param_dtype]
    cfg = dict(grad_clip=clip)
    rstate = RefOptState(jnp.asarray(3, jnp.int32), jax.tree.map(jnp.asarray, m),
                         jax.tree.map(jnp.asarray, v))
    rp = jax.tree.map(lambda x: jnp.asarray(x, jdt), p)
    to_t = lambda t, dt=torch.float32: jax.tree.map(   # noqa: E731
        lambda x: torch.from_numpy(np.array(x)).to(dt), t)
    tstate = OptState(torch.tensor(3, dtype=torch.int32), to_t(m), to_t(v))
    tp = to_t(p, tdt)
    for g in grads:
        lr = jnp.float32(2e-3)
        rp, rstate, rm = ref_adamw_update(rp, jax.tree.map(jnp.asarray, g), rstate,
                                          RefAdamWConfig(**cfg), lr=lr)
        tp, tstate, tm = adamw_update(tp, to_t(g), tstate, AdamWConfig(**cfg),
                                      lr=torch.tensor(2e-3))
        assert float(tm["grad_norm"]) == pytest.approx(float(rm["grad_norm"]), rel=1e-6)
    assert int(tstate.step) == int(rstate.step) == 5
    tol = 1e-6 if param_dtype == "fp32" else 1e-2   # one bf16 rounding of p
    np.testing.assert_allclose(np.concatenate([x.float().numpy().ravel() for x in jax.tree.leaves(tp)]),
                               np.concatenate([np.asarray(x, np.float32).ravel()
                                               for x in jax.tree.leaves(rp)]), rtol=tol, atol=tol)
    for got, want in ((tstate.mu, rstate.mu), (tstate.nu, rstate.nu)):
        _assert_trees(jax.tree.map(lambda x: x.numpy(), got), want, "moments")


# ---------------------------------------------------------------------------
# (c) train steps against the reference, every remat policy
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def trajectories():
    """The reference's first three steps per remat policy (B=2, S=16)."""
    cache = {}

    def get(remat):
        if remat not in cache:
            cache[remat] = _reference(3, _tokens(2, 16), remat=remat)
        return cache[remat]
    return get


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("remat", ["full", "none", "dots"])
def test_train_steps_match_reference(trajectories, remat, steps):
    p0, ref = trajectories(remat)
    tcfg, state = _port_state(p0, remat=remat)
    step = make_train_step(tcfg, TrainHyper(**HYPER))
    batch = {"tokens": torch.from_numpy(_tokens(2, 16))}
    for i in range(steps):
        state, metrics = step(state, batch)
    _assert_step(state, metrics, ref[steps - 1])
    assert all(p.grad is None for p in state[0].parameters())
    assert set(metrics) == {"loss", "ppl", "grad_norm", "lr"}


# ---------------------------------------------------------------------------
# (d) gradient accumulation and the chunked cross-entropy
# ---------------------------------------------------------------------------


def test_microbatches_match_reference_and_one_batch():
    tokens = _tokens(4, 12, seed=2)
    p0, ref = _reference(2, tokens, micro=2)
    tcfg, state = _port_state(p0)
    _, single = _port_state(p0)
    step = make_train_step(tcfg, TrainHyper(microbatches=2, **HYPER))
    step1 = make_train_step(tcfg, TrainHyper(**HYPER))
    batch = {"tokens": torch.from_numpy(tokens)}
    for i in range(2):
        state, metrics = step(state, batch)
        single, m1 = step1(single, batch)
    _assert_step(state, metrics, ref[-1])
    # equal-size halves: the mean of the halves' means is the batch mean
    assert float(metrics["loss"]) == pytest.approx(float(m1["loss"]), rel=RTOL)
    _assert_params(params_to_numpy(state[0]), params_to_numpy(single[0]))


@pytest.mark.parametrize("chunk", [5, 6])   # 15 targets: even chunks, and padded
def test_chunked_cross_entropy_matches_reference(chunk):
    tokens = _tokens(2, 16, seed=4)
    p0, ref = _reference(1, tokens, opt_ce_chunk=chunk)
    tcfg, state = _port_state(p0, opt_ce_chunk=chunk)
    step = make_train_step(tcfg, TrainHyper(**HYPER))
    state, metrics = step(state, {"tokens": torch.from_numpy(tokens)})
    _assert_step(state, metrics, ref[0])
    # the unchunked loss at the initial weights: the chunked one's value
    plain = _port_state(p0)[1][0]
    with torch.no_grad():
        assert float(plain.loss({"tokens": torch.from_numpy(tokens)})[0]) == \
            pytest.approx(ref[0][2]["loss"], rel=RTOL)


# ---------------------------------------------------------------------------
# (e) the suite's and the runner's train cells; (f) serving afterwards
# ---------------------------------------------------------------------------


def test_suite_train_make_runs_and_keeps_the_build_frozen():
    built = build_arch("gemma-2b", {"n_layers": 2}, device="cpu")
    before = [p.detach().clone() for p in built.model.parameters()]
    step, args, donate = get_benchmark("gemma-2b", "train").make(batch=2, seq=8, built=built)
    assert donate == (0,)
    (model, opt), batch = args
    assert model is not built.model and int(opt.step) == 0
    state, metrics = step(args[0], batch)
    state, metrics = step(state, batch)
    assert int(state[1].step) == 2 and np.isfinite(float(metrics["loss"]))
    assert not all(torch.equal(a, b) for a, b in zip(before, state[0].parameters()))
    assert all(torch.equal(a, b) for a, b in zip(before, built.model.parameters()))
    assert not any(p.requires_grad for p in built.model.parameters())


def test_train_make_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="is_available"):
        get_benchmark("gemma-2b", "train").make(batch=1, seq=8)


@pytest.mark.parametrize("arch,device", [
    ("mamba2-2.7b", "cuda"), ("recurrentgemma-9b", "cuda"), ("whisper-large-v3", "cuda"),
    ("paligemma-3b", "cpu"), ("mamba2-2.7b", "cpu"), ("gemma-2b", "cuda")])
def test_train_make_refuses_what_the_step_would(arch, device, monkeypatch):
    """No family's training is refused: every train entry builds a state
    and takes a step, and ``Model.loss`` runs.  (The ssm and hybrid
    families were refused on the card, the vlm and encdec families on
    both devices.)  The card's cases run here with every tensor claiming
    to lie on the card, as the old refusal read ``is_cuda``; their
    gradients go through the backward ops (``tests/test_torch_library_ops.py``).
    The name is the one the test had while it checked the refusals: it now
    checks that every train entry builds and steps."""
    if device == "cuda":
        monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    built = build_arch(arch, {"n_layers": 2}, device="cpu")
    step, args, donate = get_benchmark(arch, "train").make(batch=1, seq=8, built=built)
    assert donate == (0,)
    before = [p.detach().clone() for p in args[0][0].parameters()]
    state, metrics = step(*args)
    assert int(state[1].step) == 1 and np.isfinite(float(metrics["loss"]))
    assert not all(torch.equal(a, b) for a, b in zip(before, state[0].parameters()))
    loss, _ = built.model.loss(args[1])
    assert np.isfinite(float(loss))


@pytest.mark.parametrize("mode", ["jit", "jit_donated"])
def test_runner_train_cell_then_serve_is_unchanged(mode):
    runner = BenchmarkRunner(device="cpu", runs=2, warmup=0, compile_warmup=0)
    reqs = generate(TraceSpec(profile="bursty", requests=4, prompt_len=8, max_new=4,
                              prompt_profile="bimodal"), vocab=512)
    built = runner.built_for("gemma-2b")
    serve = lambda: summarize_metrics(ServeEngine(   # noqa: E731
        built, slots=2, max_len=cache_len_bound(reqs)).run(reqs))["tokens_digest"]
    digest = serve()
    sc = Scenario(arch="gemma-2b", task="train", batch=1, seq=8, mode=mode)
    rr = runner.run(sc)
    assert rr.status == "ok", rr.error
    assert rr.name == sc.name and rr.task == "train" and rr.median_us > 0 and rr.runs == 2
    assert rr.extra["prov_framework"] == "torch" and rr.extra["prov_device"] == "cpu"
    assert set(rr.to_dict()) == {f.name for f in dataclasses.fields(RefRunResult)}
    assert [f.name for f in dataclasses.fields(RunResult)] == \
        [f.name for f in dataclasses.fields(RefRunResult)]
    # the threaded state trained (donated) or stayed as built (copied)
    entry = runner._execs[sc]
    assert int(entry.args[0][1].step) == (3 if mode == "jit_donated" else 0)   # first call + 2 runs
    assert runner.built_for("gemma-2b") is built
    assert not any(p.requires_grad for p in built.model.parameters())
    assert serve() == digest


def test_unported_train_modes_are_error_records():
    """Once refused as error records, ``eager``, ``jit_unrolled`` and
    ``jit_noremat`` train cells now run, and meet the reference's records
    of the same names: the compiled modes field for field against the
    reference runner's, the eager one against the reference's eager
    protocol (``measure_eager``: runs ``max(2, runs // 2)``, no compile,
    min and max as p10 and p90, no device delta; a JAX eager train step
    takes ~12 s a call here, so it is not run), with the state it was
    given left as it was (none of the three donates)."""
    from repro.runner.runner import BenchmarkRunner as RefRunner
    from repro.runner.scenario import Scenario as RefScenario
    runner = BenchmarkRunner(device="cpu", runs=2, warmup=0, compile_warmup=0)
    ref_runner = RefRunner(runs=2, warmup=0, compile_warmup=0)
    same = ("name", "bench", "arch", "task", "batch", "seq", "dtype", "mode", "status",
            "runs", "schema", "cache")
    for mode in ("eager", "jit_unrolled", "jit_noremat"):
        sc = Scenario(arch="gemma-2b", task="train", batch=1, seq=8, mode=mode)
        rr = runner.run(sc)
        assert rr.status == "ok", rr.error
        assert set(rr.to_dict()) == {f.name for f in dataclasses.fields(RefRunResult)}
        assert rr.p10_us <= rr.median_us <= rr.p90_us
        state = runner._execs[sc].args[0]
        if mode == "eager":
            assert rr.runs == 2 and rr.compile_us == 0.0 and rr.device_bytes_delta == 0
            assert int(state[1].step) == 0          # copied at every call
            assert not rr.cache["executable_reused"]
            continue
        want = ref_runner.run(RefScenario(arch="gemma-2b", task="train", batch=1,
                                          seq=8, mode=mode))
        assert want.status == "ok", want.error
        for field in same:
            assert getattr(rr, field) == getattr(want, field), field
        assert rr.compile_us > 0 and want.compile_us > 0
        assert int(state[1].step) == 0          # no donation: copied at every call


def test_loss_path_hands_attention_int_offsets(monkeypatch):
    """The backward kernel takes scalar offsets as ints only (a tensor is
    the serve path's per-row form): the loss path must pass q_offset=0
    and no kv_len to every attention call."""
    from repro_torch.models import layers
    seen = []
    real = layers.flash_attention

    def spy(q, k, v, **kw):
        seen.append((kw["q_offset"], kw["kv_len"]))
        return real(q, k, v, **kw)

    monkeypatch.setattr(layers, "flash_attention", spy)
    built = build_arch("gemma-2b", {"n_layers": 2}, device="cpu")
    step, args, _ = get_benchmark("gemma-2b", "train").make(batch=1, seq=8, built=built)
    step(*args)
    # two layers, each run once more by remat="full" in the backward
    assert seen == [(0, None)] * 4 and all(type(o) is int for o, _ in seen)


@pytest.mark.parametrize("arch,moments_rtol", [("mamba2-2.7b", 5e-5),
                                               ("recurrentgemma-9b", 5e-4)])
def test_other_families_train_step_matches_reference_on_cpu(arch, moments_rtol):
    """The ssm and hybrid families train on the CPU through their plain
    SSD and RG-LRU versions (on the card their kernels have no backward
    yet): one step against the reference's.  Their scans sum in other
    orders than the reference's (64-step SSD chunks against 32; 16-step
    log-space RG-LRU blocks against an associative scan), and the
    gradients through the decays carry it: up to 1.6e-5 (mamba2) and
    1.3e-4 (recurrentgemma's gate and decay params) of a moment leaf's
    largest |value| at S=16, held to 5e-5 and 5e-4."""
    tokens = _tokens(2, 16, seed=5)
    rcfg = ref_get_arch(arch).reduced(compute_dtype=jnp.float32)
    rstep, rmodel = ref_make_train_step(rcfg, RefHyper(**HYPER))
    params = rmodel.init(jax.random.key(0))
    (rparams, ropt), rm = jax.jit(rstep)((params, ref_adamw_init(params)),
                                         {"tokens": jnp.asarray(tokens)})
    tcfg, state = _port_state(_np(params), arch)
    state, metrics = make_train_step(tcfg, TrainHyper(**HYPER))(
        state, {"tokens": torch.from_numpy(tokens)})
    _assert_step(state, metrics, (_np(rparams), _np(ropt), {k: float(v) for k, v in rm.items()}),
                 moments_rtol)


def test_eight_steps_on_one_batch_match_reference():
    """``chip_smoke.py``'s repeated-batch run, reduced: eight fp32 steps on
    one batch with ``warmup_steps=1`` (the full learning rate from step 2)
    give the reference's loss at every step, so the curve's shape, rising
    or falling, is AdamW's on these weights and not a fault of the port."""
    hyper = dict(warmup_steps=1, total_steps=10000)
    tokens = _tokens(2, 16, seed=3)
    rcfg = ref_get_arch("gemma-2b").reduced(compute_dtype=jnp.float32)
    ref_step, ref_model = ref_make_train_step(rcfg, RefHyper(**hyper))
    params = ref_model.init(jax.random.key(0))
    ref_state, ref_losses = (params, ref_adamw_init(params)), []
    ref_step = jax.jit(ref_step)
    for _ in range(8):
        ref_state, m = ref_step(ref_state, {"tokens": jnp.asarray(tokens)})
        ref_losses.append(float(m["loss"]))
    tcfg, state = _port_state(_np(params))
    step = make_train_step(tcfg, TrainHyper(**hyper))
    batch = {"tokens": torch.from_numpy(tokens)}
    losses = []
    for _ in range(8):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    assert losses == pytest.approx(ref_losses, rel=RTOL)
