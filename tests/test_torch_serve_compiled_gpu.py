"""The serving engine compiled on the card (``ServeEngine(compiled=True)``:
its decode step and admission through TorchInductor) against the
uncompiled engine, on reduced fp32 gemma-2b and mamba2-2.7b builds: equal
token digests, the first decode step's logits within 1e-4, and the same
kernel launches, by variant, in a replay.  mamba2-2.7b's admissions run
the SSD op inside a compiled graph.

These tests need a Hopper card (compute capability 9.0 or above) and
``nvcc``; elsewhere they skip.  Whether there is such a card is decided in
the ``hopper`` fixture, never at import, so every test worker collects
the same tests.  Run them on the card with ``PYTHONPATH=src python -m
pytest -q --noconftest -m gpu tests/test_torch_serve_compiled_gpu.py``
(the suite's conftest imports JAX; this file needs only torch).
"""
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.core.harness import dynamo_counts
from repro_torch.core.suite import Built
from repro_torch.kernels.flash_attention import kernel as fa
from repro_torch.kernels.ssd import kernel as sk
from repro_torch.launch.serve import ServeEngine, summarize_metrics
from repro_torch.models import build_model
from repro_torch.runner.traces import TraceSpec, cache_len_bound, generate

pytestmark = pytest.mark.gpu

#: the compiled engine's logits against the uncompiled engine's (fp32)
TOL = 1e-4


@pytest.fixture
def hopper():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    if torch.cuda.get_device_capability(0) < (9, 0):
        pytest.skip("needs compute capability 9.0 or above (sm_90a)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _launches():
    return {"flash_attention": dict(fa.flash_attention_cuda.launches_by_variant),
            "ssd": dict(sk.ssd_cuda.launches_by_variant)}


def _zero():
    for counter in (fa.flash_attention_cuda, sk.ssd_cuda):
        counter.launches = 0
        for k in counter.launches_by_variant:
            counter.launches_by_variant[k] = 0


@pytest.mark.parametrize("arch", ["gemma-2b", "mamba2-2.7b"])
def test_compiled_engine_matches_the_uncompiled_engine(hopper, arch):
    cfg = get_arch(arch).reduced(compute_dtype=torch.float32)
    built = Built(cfg, build_model(cfg, device=hopper, seed=0))
    reqs = generate(TraceSpec(profile="bursty", requests=8, prompt_len=16, max_new=8,
                              prompt_profile="bimodal"), vocab=cfg.vocab)
    got = {}
    for compiled in (True, False):
        engine = ServeEngine(built, slots=4, max_len=cache_len_bound(reqs),
                             compiled=compiled)
        c0 = dynamo_counts()
        engine.run(reqs)                         # the compiles
        breaks = dynamo_counts()["graph_breaks"]
        _zero()
        out = engine.run(reqs)
        torch.cuda.synchronize()
        launches = _launches()
        with engine.decode_probe(reqs) as (step, _):
            logits = step().float()
        got[compiled] = (summarize_metrics(out)["tokens_digest"], launches, logits,
                         out["admit_new_shapes"])
        if compiled:
            assert breaks == c0["graph_breaks"]
    (dc, lc, xc, new_c), (du, lu, xu, _) = got[True], got[False]
    assert dc == du
    assert lc == lu and sum(lc["flash_attention"].values()) + sum(lc["ssd"].values()) > 0
    if arch == "mamba2-2.7b":
        assert sum(lc["ssd"].values()) > 0
    assert (xc - xu).abs().max().item() <= TOL
    assert new_c == 0                            # the replay compiled nothing
