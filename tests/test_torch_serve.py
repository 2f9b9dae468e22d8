"""The port's serving engine against the reference ``ServeEngine`` on the
same trace and bridged weights at fp32 compute: equal token digests.
Inside the port, batched and single admission and in-place and copied
caches give equal digests too.
"""
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
from repro.runner.traces import generate as ref_generate
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_arch
from repro_torch.core.suite import Built
from repro_torch.launch import serve
from repro_torch.runner.traces import TraceSpec, cache_len_bound, generate

# tiny shapes: one intra-op thread each, as the suite runs in parallel workers
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def builds():
    rcfg = ref_get_arch("gemma-2b").reduced(compute_dtype=jnp.float32)
    tcfg = get_arch("gemma-2b").reduced(compute_dtype=torch.float32)
    rmodel = ref_build_model(rcfg)
    params = rmodel.init(jax.random.key(0))
    tmodel = params_from_numpy(jax.tree.map(np.asarray, params), tcfg, "cpu")
    return RefBuilt(cfg=rcfg, model=rmodel, params=params), Built(cfg=tcfg, model=tmodel)


def _spec(trace):
    arrival, _, plen = trace.partition("+")
    return dict(profile=arrival, requests=6, prompt_len=8, max_new=5, seed=0,
                prompt_profile=plen or "fixed")


@pytest.mark.parametrize("trace", ["uniform", "bursty+bimodal"])
def test_tokens_equal_reference_engine(builds, trace):
    ref_built, built = builds
    ref_reqs = ref_generate(RefSpec(**_spec(trace)), vocab=512)
    reqs = generate(TraceSpec(**_spec(trace)), vocab=512)
    assert [r.prompt.tolist() for r in reqs] == [r.prompt.tolist() for r in ref_reqs]
    max_len = cache_len_bound(reqs)
    want = ref_summarize(RefEngine(ref_built, slots=3, max_len=max_len).run(ref_reqs))
    got = serve.summarize_metrics(
        serve.ServeEngine(built, slots=3, max_len=max_len).run(reqs))
    assert got["tokens_digest"] == want["tokens_digest"]
    assert got["decode_steps"] == want["decode_steps"]
    assert got["admit_calls"] == want["admit_calls"]


def test_admission_policies_and_cache_copies_agree(builds):
    _, built = builds
    reqs = generate(TraceSpec(**_spec("mixed+uniform")), vocab=512)
    max_len = cache_len_bound(reqs)
    digests = set()
    for admission in serve.ADMISSIONS:
        for donate in (True, False):
            engine = serve.ServeEngine(built, slots=2, max_len=max_len,
                                       admission=admission, donate=donate)
            digests.add(serve.summarize_metrics(engine.run(reqs))["tokens_digest"])
    assert len(digests) == 1


def test_exhausted_cache_raises(builds):
    _, built = builds
    reqs = generate(TraceSpec(**_spec("uniform")), vocab=512)
    engine = serve.ServeEngine(built, slots=2, max_len=cache_len_bound(reqs) - 2)
    with pytest.raises(RuntimeError, match="KV cache exhausted"):
        engine.run(reqs)


def test_cli_serves_every_request_on_cpu(capsys):
    assert serve.main(["--device", "cpu", "--requests", "3", "--slots", "2",
                       "--prompt-len", "8", "--max-new", "3"]) == 0
    out = capsys.readouterr().out
    assert "served 3 requests" in out and "9 tokens" in out and "on cpu" in out
