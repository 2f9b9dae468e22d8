"""A compiled train step (``harness.compile_step``: ``aot_eager`` on the
CPU) against the uncompiled step and the reference's jitted step, on the
same bridged weights and numpy tokens, under ``remat="full"`` and
``"none"``: three graphs (the moments' per-parameter views, the loss,
the update, which updates the views in place), with one graph break, at
``loss.backward()``; and ``search_batch_size`` through the runner's
compiled cells on reduced gemma-2b.

Tolerances: compiled against uncompiled bitwise (``aot_eager`` runs the
same aten ops and the kernels' custom ops on the same values); against
the reference ``tests/test_torch_train.py``'s: loss, ppl, grad norm and
lr within 1e-5 relative, the parameters within 1e-5 relative plus 1e-6
except at most one element in 10^4, within 1e-3 (AdamW's m / (sqrt(v) +
eps) turns a near-zero gradient's last-bit rounding into a visible share
of the step).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.core.batchsearch import search_batch_size as ref_search
from repro.launch.steps import TrainHyper as RefHyper
from repro.launch.steps import make_train_step as ref_make_train_step
from repro.optim.adamw import adamw_init as ref_adamw_init
from repro_torch.bridge import params_from_numpy, params_to_numpy
from repro_torch.configs import get_arch
from repro_torch.core.batchsearch import search_batch_size
from repro_torch.core.harness import compile_step, dynamo_counts
from repro_torch.core.suite import get_benchmark
from repro_torch.launch.steps import TrainHyper, make_train_step
from repro_torch.optim import adamw_init
from repro_torch.runner.results import RunResult
from repro_torch.runner.runner import BenchmarkRunner

torch.set_num_threads(1)

RTOL = 1e-5
ATOL_PARAMS = 1e-6
HYPER = dict(warmup_steps=2, total_steps=20)


def _np(x):
    return np.asarray(x, np.float32)


def _assert_params(got, want):
    g = np.concatenate([np.ravel(x) for x in jax.tree.leaves(got)])
    w = np.concatenate([np.ravel(_np(x)) for x in jax.tree.leaves(want)])
    assert g.shape == w.shape
    diff = np.abs(g - w)
    outliers = diff > ATOL_PARAMS + RTOL * np.abs(w)
    assert outliers.mean() <= 1e-4, f"{outliers.sum()} of {g.size} params differ"
    assert diff.max() <= 1e-3, f"params differ by {diff.max()}"


@pytest.mark.parametrize("remat", ["full", "none"])
def test_train_step_compiles_and_matches(remat):
    B, S = 2, 16
    toks = np.random.default_rng(0).integers(0, 512, (B, S)).astype(np.int32)
    rcfg = ref_get_arch("gemma-2b").reduced(compute_dtype=jnp.float32, remat=remat)
    rstep, rmodel = ref_make_train_step(rcfg, RefHyper(**HYPER))
    params = rmodel.init(jax.random.key(0))
    (rparams, _), rmetrics = jax.jit(rstep)((params, ref_adamw_init(params)),
                                            {"tokens": jnp.asarray(toks)})
    tcfg = get_arch("gemma-2b").reduced(compute_dtype=torch.float32, remat=remat)
    states = []
    for _ in range(2):
        model = params_from_numpy(jax.tree.map(np.asarray, params), tcfg,
                                  "cpu").requires_grad_(True)
        states.append((model, adamw_init(model.stacked_params())))
    step = make_train_step(tcfg, TrainHyper(**HYPER))
    batch = {"tokens": torch.from_numpy(toks)}
    # from an empty Dynamo cache: what earlier tests of this process
    # compiled of the same step neither serves nor adds graphs here
    torch._dynamo.reset()
    c0 = dynamo_counts()
    state, metrics = compile_step(step, "cpu")(states[0], batch)
    c1 = dynamo_counts()
    eager_state, eager_metrics = step(states[1], batch)
    assert c1["graphs"] - c0["graphs"] == 3
    assert c1["graph_calls"] - c0["graph_calls"] == 3
    assert all("backward" in k for k in c1["graph_breaks"]), c1["graph_breaks"]
    for k, v in rmetrics.items():
        assert torch.equal(metrics[k], eager_metrics[k]), k
        assert float(metrics[k]) == pytest.approx(float(v), rel=RTOL), k
    for g, w in zip(state[0].parameters(), eager_state[0].parameters()):
        assert torch.equal(g, w)
    for g, w in zip(jax.tree.leaves(state[1]), jax.tree.leaves(eager_state[1])):
        assert torch.equal(g, w)          # the step and the moments, in place
    _assert_params(params_to_numpy(state[0]), rparams)


def test_search_batch_size_on_reduced_gemma_matches_the_reference_protocol():
    """Doubling from 1 to 4 through the runner's compiled decode cells:
    every probe ok, each its own compile, the history the reference's
    keys, the best batch one of those probed."""
    runner = BenchmarkRunner(device="cpu", runs=1, warmup=0, compile_warmup=0)
    bench = get_benchmark("gemma-2b", "infer_decode")
    best, history = search_batch_size(bench, seq=8, max_batch=4, runs=1, runner=runner)
    assert [h["batch"] for h in history][:2] == [1, 2]
    assert all(set(h) == {"batch", "median_us", "items_per_s"} for h in history)
    assert best in [h["batch"] for h in history]
    assert runner.stats.executable_builds == len(history) == runner.stats.model_builds + \
        len(history) - 1

    class Failing:
        def run(self, sc, runs=None):
            return RunResult.from_error(sc, "out of memory")
    for search in (search_batch_size, ref_search):
        best, history = search(bench, seq=8, runner=Failing())
        assert (best, history) == (1, [{"batch": 1, "error": "out of memory"}])
