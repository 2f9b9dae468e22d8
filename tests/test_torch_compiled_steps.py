"""Compiled serving steps (``harness.compile_step``: ``aot_eager`` on
the CPU) against the uncompiled steps and the reference's jitted steps,
on the same bridged weights and numpy inputs: gemma-2b ``infer_prefill``
then ``infer_decode`` (through the nested region, and with
``scan_layers=False``, the ``jit_unrolled`` build), gemma3-12b's past its
local window (a region for its local and one for its global layers), the
regions' bodies and calls in Dynamo's graph under each, and the mamba2-2.7b
and recurrentgemma-9b prefills (their SSD and RG-LRU ops inside the
graph); one graph and no graph break a step, and no recompile on a
second call.  The train step: ``tests/test_torch_compiled_train.py``.

Tolerances: compiled against uncompiled bitwise (``aot_eager`` runs the
same aten ops and the kernels' custom ops on the same values); against
the reference 1e-4 for logits and caches (fp32, sums in other orders over
the layers, as ``tests/test_torch_model.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.models import build_model as ref_build_model
from repro_torch.bridge import cache_to_numpy, params_from_numpy
from repro_torch.configs import get_arch
from repro_torch.core.harness import clone_tree, compile_step, dynamo_counts

torch.set_num_threads(1)

TOL = 1e-4


def _np(x):
    return np.asarray(x, np.float32)


def _tokens(B, S, seed=0, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(np.int32)


def _bridged(arch, **kw):
    rcfg = ref_get_arch(arch).reduced(compute_dtype=jnp.float32, **kw)
    tcfg = get_arch(arch).reduced(compute_dtype=torch.float32, **kw)
    rmodel = ref_build_model(rcfg)
    params = rmodel.init(jax.random.key(0))
    return rmodel, params, params_from_numpy(jax.tree.map(np.asarray, params), tcfg, "cpu")


def _compiled(step, *args):
    """``compile_step(step)`` called on ``args``, and its Dynamo tallies:
    (output, compiled graphs the call ran, graph breaks by reason)."""
    c0 = dynamo_counts()
    out = compile_step(step, "cpu")(*args)
    c1 = dynamo_counts()
    breaks = {k: v - c0["graph_breaks"].get(k, 0) for k, v in c1["graph_breaks"].items()
              if v != c0["graph_breaks"].get(k, 0)}
    return out, c1["graph_calls"] - c0["graph_calls"], breaks


def _prefill(m, b, c):
    return m.prefill(b, c)


def _decode(m, t, c):
    return m.decode_step(t, c)


def _assert_serve_steps(arch, B=2, S=12, M=20, **kw):
    """Prefill, then one decode step: compiled against uncompiled (bitwise,
    logits and caches) and against the reference's jitted steps."""
    rmodel, params, tmodel = _bridged(arch, **kw)
    toks, nxt = _tokens(B, S), _tokens(B, 1, seed=10)
    rl, rc = jax.jit(rmodel.prefill)(params, {"tokens": toks}, rmodel.init_cache(B, M))
    rl2, rc2 = jax.jit(rmodel.decode_step)(params, nxt, rc)
    cache = tmodel.init_cache(B, M)
    eager_cache = clone_tree(cache)
    batch = {"tokens": torch.from_numpy(toks)}
    (got, cache), graphs, breaks = _compiled(_prefill, tmodel, batch, cache)
    want, eager_cache = _prefill(tmodel, batch, eager_cache)
    assert graphs == 1 and not breaks, breaks
    (got2, cache), graphs2, breaks2 = _compiled(_decode, tmodel, torch.from_numpy(nxt), cache)
    want2, eager_cache = _decode(tmodel, torch.from_numpy(nxt), eager_cache)
    assert graphs2 == 1 and not breaks2, breaks2
    for g, w, r in ((got, want, rl), (got2, want2, rl2)):
        assert torch.equal(g, w)
        np.testing.assert_allclose(g.float().numpy(), _np(r), atol=TOL, rtol=TOL)
    for g, w in zip(jax.tree.leaves(cache_to_numpy(cache)),
                    jax.tree.leaves(cache_to_numpy(eager_cache))):
        np.testing.assert_array_equal(g, w)
    for g, r in zip(jax.tree.leaves(cache_to_numpy(cache)), jax.tree.leaves(rc2)):
        np.testing.assert_allclose(g, _np(r), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("scan_layers", [True, False])
def test_gemma_prefill_and_decode_compile_whole_and_match(scan_layers):
    _assert_serve_steps("gemma-2b", scan_layers=scan_layers)


def test_gemma3_prefill_past_the_window_compiles_and_matches():
    """gemma3's local and global layers (a region each) on a prompt past
    the reduced window (64), so the local layers' ring caches wrap."""
    _assert_serve_steps("gemma3-12b", S=72, M=80)


def _regions(arch, scan_layers):
    """The nested regions Dynamo's graph of a compiled prefill calls: (the
    number of ``invoke_subgraph`` calls, the number of distinct bodies),
    and the layer kinds of the model."""
    _, _, tmodel = _bridged(arch, scan_layers=scan_layers)
    graphs = []

    def recording(gm, example_inputs):
        graphs.append(gm)
        return gm.forward

    batch = {"tokens": torch.from_numpy(_tokens(1, 8))}
    torch.compile(_prefill, backend=recording, dynamic=False)(
        tmodel, batch, tmodel.init_cache(1, 16))
    (gm,) = graphs
    calls = [n for n in gm.graph.nodes
             if n.target is torch.ops.higher_order.invoke_subgraph]
    return len(calls), len({n.args[0].target for n in calls}), tmodel._layout


@pytest.mark.parametrize("arch", ["gemma-2b", "gemma3-12b"])
def test_jit_traces_one_body_per_layer_kind_and_unrolled_none(arch):
    """``scan_layers=True`` (``jit``): every layer a call of its kind's one
    body; ``scan_layers=False`` (``jit_unrolled``): no region, every layer
    inline -- the two modes trace different programs."""
    calls, bodies, layout = _regions(arch, True)
    kinds = {kind for _, _, kind in layout}
    assert calls == len(layout) and bodies == len(kinds)
    assert len(kinds) == (2 if arch == "gemma3-12b" else 1)
    assert _regions(arch, False)[:2] == (0, 0)


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "recurrentgemma-9b"])
def test_ssm_and_hybrid_prefills_compile_with_their_kernels(arch):
    _assert_serve_steps(arch, S=40, M=48, n_layers=2 if arch == "mamba2-2.7b" else 3)


def test_a_second_call_does_not_recompile():
    _, _, tmodel = _bridged("gemma-2b")
    cache = tmodel.init_cache(1, 16)
    step = compile_step(_decode, "cpu")
    toks = torch.from_numpy(_tokens(1, 1))
    step(tmodel, toks, cache)
    c0 = dynamo_counts()
    step(tmodel, toks, cache)
    c1 = dynamo_counts()
    assert c1["frames"] == c0["frames"] and c1["graph_calls"] == c0["graph_calls"] + 1
