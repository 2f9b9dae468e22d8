#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA card.

Run from the root of a checkout, with one CUDA card visible:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from the checkout's sources (one
``nvcc`` per source, all started together), holds each against its plain
PyTorch version on the card, runs the runner's reduced cells of every
ported arch, checks the card against the CPU on small inputs, then serves
and steps gemma-2b at its full published width and depth through the
user entry points, and mamba2-2.7b, recurrentgemma-9b, paligemma-3b,
gemma3-12b, nemotron-4-15b, internlm2-20b and whisper-large-v3 at full
width and a cut depth through ``serve.built_for_cfg`` and
``ServeEngine``, one model on the card at a time.  Each model's main
path runs with every kernel's launch count set to 0 just before it and
read just after: every attention call goes
through the flash-attention kernel (full-width prefill through its
tensor-core variant, decode through its split-KV variant: counted by
variant), every prefill of every Mamba-2 layer through the SSD kernel
(at full width through its three-pass tensor-core variant: counted by
variant), every prefill of every RG-LRU layer through the RG-LRU kernel
(counted by variant: the infer_prefill step through its chunked variant).
Timed kernel cases report the variant, achieved TFLOP/s and GB/s, the
share of the bound and, for short calls, the device time from
``torch.profiler`` (for the SSD, its passes summed); the RG-LRU's timed
cases time both its variants, and a sweep over shapes holds its plan
against the faster one.  Training: the flash-attention backward kernel
against its plain version (``attention_bwd_ref``) over gemma-2b's full
width, the reduced config, every mask, softcap and K=2, with a bitwise
repeat (bf16 through its tensor-core variant, fp32 through its CUDA-core
one: counted by variant; at gemma-2b's shape both variants are timed);
at whisper-large-v3's cross attention (2048 queries over 1500 frames)
and encoder; the SSD's and RG-LRU's backward kernels against autograd
through their plain versions (``ssd_bwd_kernels``: mamba2-2.7b's train
shape, ragged, from a state, a strong decay, fp32; ``rglru_bwd_kernels``:
recurrentgemma-9b's, ragged, with ``dh_last``, lanes at a = 1, strided),
bitwise reruns; two reduced train steps on the card against the CPU for
every family (``train_reference_check``: gemma-2b, gemma3-12b,
nemotron-4-15b, mamba2-2.7b, recurrentgemma-9b, paligemma-3b,
whisper-large-v3, each backward op launched once per layer per step);
then gemma-2b trained at full width (B=1, S=2048) through the suite's
train step, whose every attention layer runs the forward kernel twice
(once more under ``remat="full"``) and the backward kernel once, all
through their tensor-core variants, and the other families trained at
full width, eager (``train_full``: mamba2-2.7b at its full 64 layers,
recurrentgemma-9b at 8 of 38, paligemma-3b at 6, whisper-large-v3 at 2 +
2), each step's launches counted, its device time by class and its peak
memory under ``TRAIN_MEMORY_LIMIT``.
The profiler (``repro_torch.profiler``) then profiles six of those cells
on the same builds (``profile_cell_full``: gemma-2b ``infer_prefill``,
``infer_decode``, ``train`` and ``serve``, mamba2-2.7b and
recurrentgemma-9b ``infer_prefill``): each step split into host time the
device did not hide and the device's busy time from a kernel trace, that
time by op class, the step's roofline bound over it (fractions summing to
1 within 1e-6, 0 < ``prof_util`` <= 1.05, attention time > 0, no
``prof_error``), and ranks the findings (``profile_report``).
Dispatch (``dispatch``, a part of its own): a matrix
of the runner's gemma-2b, mamba2-2.7b and recurrentgemma-9b cells (a
compiled mamba2-2.7b prefill and three serve cells) runs serially, across
two shard workers (``jobs=2``), across two ``local:2`` cluster workers
and, one cell, in its own subprocess, every worker on the card; names,
statuses and serve tokens must agree, a profiled serve cell must carry
the same ``prof_*`` keys serially and from a worker, with attention time
on the card, and no worker may outlive ``close()``.
Perf-CI (``core.ci``, ``core.regression``, ``core.coverage``): the paper's
nightly run (``nightly``: gemma-2b's reduced ``infer_decode`` cell and
the ``train`` cells of mamba2-2.7b, recurrentgemma-9b, paligemma-3b and
whisper-large-v3, the decode cell compiled in its worker and the train
cells uncompiled, across two shard workers without the measurement
fence; every cell comes back ok and records its baseline, no ``status``
issue, and an injected slowdown is filed) and the
API-surface coverage of reduced steps (``coverage``: the same torch API
and ATen op sets on the card as on the CPU, kernels and backward kernels
one op each); on the
full-width builds, each of the six profiled cells
is measured ``NOISE_RUNS`` times, the two ``ci_full`` cells
``NOISE_RUNS_CI`` times (``noise``: the spread of its median,
host and device time, and how many clean re-runs the 7% gate would
flag), and gemma-2b's and mamba2-2.7b's ``infer_prefill`` cells go through
the perf-CI flow (``ci_full``: an injected slowdown of 3x the cell's
spread and a 64 MiB leak a step on the card are filed, and on gemma-2b
12 commits of real measures are bisected to ``c08``); ``perf_ci`` gives
the four phases' walls.
The compiler modes (``compilers``, slice 8): the Inductor cache under
``build/inductor`` is emptied first, so each graph's first compile is
cold, and every later process loads a graph an earlier one compiled
(``harness.compile_env``; one ``compile_budget`` line per process that
compiles: its seconds inside compiles and its cache hits and misses).
Seven processes of their own (``PARTS``, ``chip_smoke.py --part``) run
beside the main one, ``dispatch`` and ``runner`` from the end of the
builds, the others from the end of the kernel phases, while the main one
runs coverage, ``loadgen``, the reference checks and mamba2's and
recurrentgemma's reduced train steps compiled under ``aot_eager``
(``_aot_eager_train``: Dynamo and AOT autograd through the backward ops'
fakes; launches equal to eager's, each backward op once a layer): the
paper's Figs. 3-4 matrix (reduced, ``train`` B=2 S=48 through the
runner: gemma-2b in all five modes, and internlm2-20b's five in a part
of their own) with its ``ratio_table``, and mamba2-2.7b's and
recurrentgemma-9b's reduced prefills under ``eager`` and ``jit``;
``nightly``: the nightly run, then the matrix's mamba2-2.7b,
recurrentgemma-9b and whisper-large-v3 cells eager, then
``serve_compiled_reduced``; ``runner_cell``; ``dispatch``; gemma-2b's
full-width ``infer_prefill`` and ``infer_decode`` compiled against eager,
then the serve CLI's engine compiled at full width (``serve_warm_full``:
the cold compile of the graphs the timed serve phases load); and
gemma-2b's full-width ``train`` compiled against eager (54 GB at its
peak, beside the inference part's 11 GB): equal kernel launches, outputs
within 5e-2 (bf16), no timed recompile.
Serving (slice 9): every serve cell of the runner compiles its engine's
decode step and admission; ``loadgen`` sweeps the reference's fast load
curve (gemma-2b reduced, four loads, both admission policies) with its
knees, ``slots="auto"`` and a split across two workers;
``serve_compiled_reduced`` holds the reduced fp32 gemma-2b and
mamba2-2.7b engines compiled against uncompiled (digests equal, logits
within 1e-4); gemma-2b's serve CLI runs compiled at full width, and
``serve_compiled_full`` holds a compiled engine against an uncompiled
one on its trace (launches by variant, the first decode step's logits
within 5e-2 from the same state, tok/s, TTFT, per-token latency) before
the compiled engine's profile (``profile_cell_full``).
The compiled gemma-2b train step is also held to the eager backward's
gradient norm, to a falling loss over its calls and, both ways, to
``TRAIN_MEMORY_LIMIT``.  The timed full-width phases run after every
part has ended.
The runner's phases (``runner_cell``, ``dispatch``, ``nightly``) compile
their step cells too, at the matrix's shapes; for the time limit they
run fewer cells than before and the full-width phases of every model but
gemma-2b, and ``train_full``, run at a cut depth (``runner_phase_walls``
prints the runner phases' walls beside the uncompiled ones).  The
reduced gemma-2b, gemma3-12b and nemotron-4-15b train steps run on the
card against the CPU (``train_reference_check``).  The harness phases
(``step_full``, ``train_full``, ``profile_cell_full``, ``noise``,
``ci_full``) measure the uncompiled step and say ``"compiled": false``;
the serve phases of the cut-depth models serve through an uncompiled
engine.
One JSON line per phase (``t_s``: seconds since the start); the last line is the
``{"ok": true, "device": ...}`` summary.  Any failed phase raises and the
script exits non-zero, printing no summary; so it does without a card, and
outside a checkout of the repository.

TF32 is switched off for matrix products and cuDNN, so fp32 plain versions
are full fp32 on the card.
"""
import contextlib
import copy
import dataclasses
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

TOL = {"fp32": 2e-5, "bf16": 2e-2}             # as tests/test_kernels.py
SSD_TOL = {"fp32": 5e-5, "bf16": 5e-2}         # as tests/test_kernels.py
# A = -50: the chunk's cum runs to ~-3000, so fp32 e^(cum_i - cum_j) carries
# ~2e-4 relative rounding whatever sums the cumsum (tests/test_torch_ssd_gpu.py)
SSD_STRONG_DECAY_TOL = {"fp32": 1e-3, "bf16": 5e-2}
FA_SOURCE = "src/repro_torch/csrc/flash_attention.cu"
FA_REPLACES = "src/repro/kernels/flash_attention/kernel.py:123"
SSD_SOURCE = "src/repro_torch/csrc/ssd.cu"
SSD_REPLACES = "src/repro/kernels/ssd/kernel.py:83"
RGLRU_TOL = 2e-5                               # as tests/test_kernels.py (fp32)
RGLRU_SOURCE = "src/repro_torch/csrc/rglru.cu"
RGLRU_REPLACES = "src/repro/kernels/rglru/kernel.py:70"
MEMORY_LIMIT = 50e9                            # bytes: one full model at a time
# the models of the dense-variant, vlm and encdec slice: each one's limit is
# its fp32 parameter bytes (reckoned from its ParamDefs, in the phase) plus
# this headroom: gemma3-12b 47.06 GB, nemotron-4-15b 62.51 GB, internlm2-20b
# at 24 layers 42.0 GB, paligemma-3b 10.03 GB, whisper-large-v3 6.31 GB
MEMORY_HEADROOM = 8e9
FA_BWD_SOURCE = "src/repro_torch/csrc/flash_attention_bwd.cu"
FA_BWD_REPLACES = ("none: no TPU kernel; the reference differentiates its XLA attention "
                   "(src/repro/models/layers.py:154) by autodiff")
# relative to each gradient's largest |value|: fp32 the same math in other
# sums; bf16 inputs and gradients rounded to bf16
BWD_TOL = {"fp32": 1e-4, "bf16": 3e-2}
TRAIN_MEMORY_LIMIT = 72e9                      # bytes: one model training, B=1 S=2048
SSD_BWD_SOURCE = "src/repro_torch/csrc/ssd_bwd.cu"
SSD_BWD_REPLACES = ("none: no TPU kernel; the reference differentiates its XLA chunked scan "
                    "(src/repro/models/ssm.py:56) by autodiff")
RGLRU_BWD_SOURCE = "src/repro_torch/csrc/rglru_bwd.cu"
RGLRU_BWD_REPLACES = ("none: no TPU kernel; the reference differentiates its XLA scan "
                      "(src/repro/models/rglru.py:56) by autodiff")
# the scans' backward kernels, each gradient's max abs error relative to its
# largest |value|: fp32 the same math in other sums, bf16 x, B, C, dy and
# dx, dB, dC rounded to bf16 (as SSD_TOL); a strong decay as the forward's
SCAN_BWD_TOL = {"fp32": 1e-4, "bf16": 5e-2}
SCAN_BWD_STRONG_DECAY_TOL = {"fp32": 1e-3, "bf16": 5e-2}


# a part run in a process of its own (``--part``, ``_start_part``) counts
# from its parent's start, whose wall-clock time it is given
_T0 = time.perf_counter() - (time.time() - float(os.environ["CHIP_SMOKE_EPOCH"])
                             if "CHIP_SMOKE_EPOCH" in os.environ else 0.0)
# where the parts write their lines and results (``build/`` is not committed)
PART_DIR = os.path.join(ROOT, "build", "chip_smoke_parts")


def emit(phase, **kw):
    """One phase's JSON line, with ``t_s``: seconds since the script began."""
    print(json.dumps({"phase": phase, **kw, "t_s": round(time.perf_counter() - _T0, 1)}),
          flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def time_ms(fn, iters=10, warmup=3):
    """Mean device time of ``fn`` over ``iters`` calls, by CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_device():
    import torch
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit("device", nvidia_smi=smi, torch_name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), capability=list(torch.cuda.get_device_capability(0)),
         torch=torch.__version__, cuda=torch.version.cuda,
         tf32_matmul=False, tf32_cudnn=False)
    return smi


def phase_build():
    """Build every kernel of the port at once: one nvcc per source, each in
    its own thread (nvcc runs as a subprocess, so the builds overlap)."""
    from concurrent.futures import ThreadPoolExecutor
    from types import SimpleNamespace
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.rglru import kernel as rk
    from repro_torch.kernels.ssd import kernel as sk
    fa_bwd = SimpleNamespace(library=fa.bwd_library, build_info=fa.bwd_build_info)
    ssd_bwd = SimpleNamespace(library=sk.bwd_library, build_info=sk.bwd_build_info)
    rglru_bwd = SimpleNamespace(library=rk.bwd_library, build_info=rk.bwd_build_info)
    t0 = time.perf_counter()
    mods = (fa, fa_bwd, sk, rk, ssd_bwd, rglru_bwd)
    with ThreadPoolExecutor(len(mods)) as ex:
        for f in [ex.submit(m.library) for m in mods]:
            f.result()
    wall = round(time.perf_counter() - t0, 3)
    for name, mod, source, smem in (
            ("flash_attention", fa, FA_SOURCE, dict(
                dynamic_smem_bytes_d256=fa.shared_memory_bytes(256),
                dynamic_smem_bytes_tc_d256_two_warpgroups=fa.shared_memory_bytes(
                    256, "tc", warpgroups=2),
                dynamic_smem_bytes_split_d256_16_rows_bf16=fa.shared_memory_bytes(
                    256, "split", rows=16))),
            ("ssd", sk, SSD_SOURCE, dict(
                dynamic_smem_bytes_p64_n128=sk.shared_memory_bytes(64, 128),
                dynamic_smem_bytes_p16_n16=sk.shared_memory_bytes(16, 16),
                dynamic_smem_bytes_tc_chunk_state=sk.shared_memory_bytes(64, 128, "chunk_state"),
                dynamic_smem_bytes_tc_chunk_scan=sk.shared_memory_bytes(64, 128, "chunk_scan"))),
            ("flash_attention_bwd", fa_bwd, FA_BWD_SOURCE, {
                **{f"dynamic_smem_bytes_{name}_d256": fa.bwd_shared_memory_bytes(i, 256, "tc")
                   for i, name in ((1, "fa_bwd_tc_lse"), (2, "fa_bwd_tc_dkv"),
                                   (3, "fa_bwd_tc_dq"))},
                **{f"dynamic_smem_bytes_simt_pass{i}_d256": fa.bwd_shared_memory_bytes(i, 256)
                   for i in (1, 2, 3)}}),
            ("rglru", rk, RGLRU_SOURCE, dict(dynamic_smem_bytes=0)),
            ("ssd_bwd", ssd_bwd, SSD_BWD_SOURCE, dict(zip(
                ("dynamic_smem_bytes_chunk_state_p64_n128", "dynamic_smem_bytes_chunk_p64_n128"),
                sk.bwd_shared_memory_bytes(64, 128)))),
            ("rglru_bwd", rglru_bwd, RGLRU_BWD_SOURCE, dict(dynamic_smem_bytes=0))):
        ptxas = mod.build_info.get("ptxas", "")
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", ptxas)]
        spills = re.findall(r"(\d+) bytes spill stores", ptxas)
        static_smem = [int(x) for x in re.findall(r"(\d+) bytes smem", ptxas)]
        emit("build", kernel=name, source=source, seconds_all_builds=wall,
             nvcc_seconds=mod.build_info.get("seconds"), registers=regs,
             spill_store_bytes=[int(x) for x in spills], static_smem_bytes=static_smem,
             **smem, ptxas=ptxas.splitlines())
        if name == "flash_attention":   # the redesigned variants must not spill
            spilled = {f: n for f, n in _spills_by_function(ptxas).items()
                       if n and any(v in f for v in ("fa_tc_kernel", "fa_split_kernel",
                                                     "fa_decode_combine"))}
            check(not spilled, f"flash attention variants spill registers: {spilled}")
        if name in ("ssd", "rglru", "flash_attention_bwd", "ssd_bwd",
                    "rglru_bwd"):   # none of these may spill
            spilled = {f: n for f, n in _spills_by_function(ptxas).items() if n}
            check(not spilled, f"{name} kernels spill registers: {spilled}")


def _spills_by_function(ptxas):
    """Spill-store bytes of each kernel in an ``nvcc -Xptxas -v`` report."""
    out, fn = {}, None
    for line in ptxas.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn = m.group(1)
            out.setdefault(fn, 0)
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and fn:
            out[fn] += int(m.group(1))
    return out


def _peak(dtype):
    """The card's peak FLOP/s for ``dtype`` ("bf16" on the tensor cores,
    "fp32" outside them): ``core.hardware.DEFAULT_HW``, the H100 SXM's
    published dense peaks at the 700 W limit, which the profiler's bounds
    use too."""
    from repro_torch.core.hardware import DEFAULT_HW
    return DEFAULT_HW.peak(dtype)


def _roofline(flops, nbytes, peak):
    """Least time for work of ``flops`` at ``peak`` FLOP/s and ``nbytes``
    at the memory rate (``DEFAULT_HW.hbm_bw``): (ms, "operations" or
    "bytes")."""
    from repro_torch.core.hardware import DEFAULT_HW
    t_ops, t_bytes = flops / peak, nbytes / DEFAULT_HW.hbm_bw
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def _bound(dtype, B, Sq, Sk, H, K, D, **mask):
    """Least time for one flash-attention call's work (``kernel.cost``,
    the count the profiler uses too): the visible (query, key) pairs'
    FLOPs at the type's peak, or the bytes of q, the output and the keys
    and values some query sees, at the memory rate.  Returns (ms, by,
    flops, bytes)."""
    import torch
    from repro_torch.kernels.flash_attention.kernel import cost
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    flops, nbytes = cost(B, Sq, Sk, H, K, D, tdt, **mask)
    return (*_roofline(flops, nbytes, _peak(dtype)), flops, nbytes)


def device_ms(fn, name="", iters=20):
    """Device time per call of the kernels whose names contain ``name``
    (every kernel by default), from ``torch.profiler`` over ``iters``
    calls: without the host's dispatch gaps that back-to-back timing by
    events includes."""
    return _device_ms_by(fn, (name,), iters)[name]


def kernel_case(name, dtype, B, Sq, Sk, H, K, D, timed=False, mask_type="causal",
                window=0, prefix_len=0, q_offset=0, kv_len=None, softcap=0.0, expect=None):
    """The flash-attention kernel against ``attention_ref`` on one case
    (``expect``: the variant ``plan()`` must pick); timed cases add the
    bound, the plain version's time and SDPA's as a yardstick."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda, plan, visible
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref
    dev = torch.device("cuda")
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    g = torch.Generator().manual_seed(0)
    q, k, v = [torch.randn(s, generator=g).to(dev, tdt)
               for s in ((B, Sq, H, D), (B, Sk, K, D), (B, Sk, K, D))]
    # per-row offsets live on the card, as the model's cache lengths do
    q_offset, kv_len = [x.to(dev) if isinstance(x, torch.Tensor) else x
                        for x in (q_offset, kv_len)]
    kw = dict(mask_type=mask_type, window=window, prefix_len=prefix_len,
              q_offset=q_offset, kv_len=kv_len, softcap=softcap)
    variant, n_split = plan(B, Sq, Sk, H, K, D, tdt)
    check(expect in (None, variant), f"{name}: plan() picks {variant}, expected {expect}")
    before = flash_attention_cuda.launches_by_variant[variant]
    out = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    check(flash_attention_cuda.launches_by_variant[variant] == before + 1,
          f"{name}: the {variant} variant did not launch")
    want = attention_ref(q, k, v, **kw)
    err = (out.float() - want.float()).abs().max().item()
    res = dict(case=name, dtype=dtype, shape=dict(B=B, Sq=Sq, Sk=Sk, H=H, K=K, D=D),
               mask=mask_type, variant=variant, n_split=n_split, max_abs_err=err,
               tol=TOL[dtype], finite=bool(torch.isfinite(out).all().item()))
    check(res["finite"] and err <= TOL[dtype],
          f"kernel disagrees with its plain version: {res}")
    if timed:
        mask = dict(mask_type=mask_type, window=window, prefix_len=prefix_len,
                    q_offset=q_offset, kv_len=kv_len)
        res["bound_ms"], res["bound_by"], flops, nbytes = _bound(dtype, B, Sq, Sk, H, K, D,
                                                                 **mask)
        vis = visible(B, Sq, Sk, **mask).to(dev)
        res["ms"] = time_ms(lambda: flash_attention(q, k, v, **kw), iters=50, warmup=5)
        res["tflops"] = flops / (res["ms"] * 1e-3) / 1e12
        res["gbytes_per_s"] = nbytes / (res["ms"] * 1e-3) / 1e9
        res["bound_share"] = res["bound_ms"] / res["ms"]
        if res["ms"] < 1.0:   # small: host dispatch may hide in back-to-back event timing
            res["device_ms"] = device_ms(lambda: flash_attention(q, k, v, **kw), "fa_")
            if isinstance(res["device_ms"], float):
                res["bound_share_device"] = res["bound_ms"] / res["device_ms"]
        res["plain_ms"] = time_ms(lambda: attention_ref(q, k, v, **kw), iters=3, warmup=1)
        # yardstick only, never called by the port: one library call on the
        # same inputs (kv heads repeated, explicit mask)
        qt = q.transpose(1, 2)
        kt = k.transpose(1, 2).repeat_interleave(H // K, dim=1)
        vt = v.transpose(1, 2).repeat_interleave(H // K, dim=1)
        am = vis[:, None]
        sdpa = lambda: F.scaled_dot_product_attention(   # noqa: E731
            qt, kt, vt, attn_mask=am, scale=D ** -0.5)
        res["library_ms"] = time_ms(sdpa, iters=20, warmup=3)
        if "device_ms" in res:
            res["library_device_ms"] = device_ms(sdpa)
        res["library"] = "torch.nn.functional.scaled_dot_product_attention"
    emit("kernel_vs_plain", **res)
    return res


def phase_kernels():
    import torch
    rows = lambda *x: torch.tensor(x, dtype=torch.int32)   # noqa: E731
    cases = []
    for dtype in ("bf16", "fp32"):
        for B, S, H, K, D in [(1, 128, 2, 2, 32), (2, 256, 4, 2, 64),
                              (1, 192, 8, 1, 128), (2, 64, 4, 4, 64)]:
            cases.append(kernel_case("test_kernels", dtype, B, S, S, H, K, D))
        for mask, window in [("causal", 0), ("local", 32), ("local", 100),
                             ("full", 0), ("prefix", 0)]:
            cases.append(kernel_case("test_kernels_masks", dtype, 1, 160, 160, 2, 2, 64,
                                     mask_type=mask, window=window, prefix_len=40))
        cases.append(kernel_case("softcap_offset", dtype, 1, 32, 128, 2, 2, 32,
                                 q_offset=96, softcap=30.0))
        # gemma-2b full width: H=8 over K=1 (MQA), D=256
        cases.append(kernel_case("gemma2b_prefill", dtype, 2, 2048, 2056, 8, 1, 256,
                                 timed=True, kv_len=rows(2048, 1500)))
        cases.append(kernel_case("gemma2b_decode", dtype, 4, 1, 2056, 8, 1, 256,
                                 timed=True, q_offset=rows(2047, 1000, 17, 2055),
                                 kv_len=rows(2048, 1001, 18, 2056)))
        # the shapes the full-width serve run below gives the kernel:
        # 4-row admission of 128-token prompts, decode over a 144 cache
        cases.append(kernel_case("serve_admit", dtype, 4, 128, 144, 8, 1, 256,
                                 timed=True, kv_len=128))
        cases.append(kernel_case("serve_decode", dtype, 4, 1, 144, 8, 1, 256,
                                 timed=True, q_offset=rows(128, 131, 140, 143),
                                 kv_len=rows(129, 132, 141, 144)))
        # recurrentgemma-9b full width: 16 query heads over 1 kv head of 256;
        # prefill with the 2048 local window, decode over the 2048-slot ring
        # (``full`` mask: ring membership is the window)
        cases.append(kernel_case("recurrentgemma_prefill", dtype, 1, 2048, 2048, 16, 1, 256,
                                 timed=True, mask_type="local", window=2048))
        cases.append(kernel_case("recurrentgemma_decode", dtype, 4, 1, 2048, 16, 1, 256,
                                 timed=True, mask_type="full",
                                 q_offset=rows(2048, 3000, 100, 2047),
                                 kv_len=rows(2048, 2048, 101, 2048)))
        # the split variant where its shares are empty or one tile long
        kv = rows(1, 63, 64, 65, 2056)
        cases.append(kernel_case("split_edges", dtype, 5, 1, 2056, 8, 1, 256, timed=True,
                                 q_offset=kv - 1, kv_len=kv))
    # the tensor-core variant at the smaller head dims it instantiates
    for D in (64, 128):
        cases.append(kernel_case(f"tc_d{D}", "bf16", 2, 2048, 2048, 16, 2, D, timed=True))
    # the regimes of gemma3-12b (16 query heads over 8 kv heads of 256, a
    # 1024-key local window; decode over the 1024-slot ring, ``full`` mask,
    # kv_len = min(position + 1, 1024)), paligemma-3b (256 patch positions
    # + 128 tokens under the prefix mask, MQA over 8 heads) and
    # whisper-large-v3 (20 heads of 64: the 1500-frame encoder, not a
    # multiple of the 64-key tile; cross attention over its 1500 keys)
    bf16 = dict(dtype="bf16", timed=True)
    cases.append(kernel_case("gemma3_local_prefill", B=1, Sq=2048, Sk=2048, H=16, K=8, D=256,
                             mask_type="local", window=1024, expect="tc", **bf16))
    cases.append(kernel_case("gemma3_ring_decode", B=4, Sq=1, Sk=1024, H=16, K=8, D=256,
                             mask_type="full", q_offset=rows(2048, 3000, 100, 1023),
                             kv_len=rows(1024, 1024, 101, 1024), expect="split", **bf16))
    cases.append(kernel_case("paligemma_prefix_prefill", B=2, Sq=384, Sk=384, H=8, K=1, D=256,
                             mask_type="prefix", prefix_len=256, expect="tc", **bf16))
    cases.append(kernel_case("whisper_encoder", B=1, Sq=1500, Sk=1500, H=20, K=20, D=64,
                             mask_type="full", expect="tc", **bf16))
    cases.append(kernel_case("whisper_cross_prefill", B=4, Sq=128, Sk=1500, H=20, K=20, D=64,
                             mask_type="full", expect="tc", **bf16))
    cases.append(kernel_case("whisper_cross_decode", B=4, Sq=1, Sk=1500, H=20, K=20, D=64,
                             mask_type="full", q_offset=rows(128, 131, 140, 143),
                             expect="split", **bf16))
    return cases


def _device_ms_by(fn, names, iters=5):
    """Device time per call of ``fn`` from ``torch.profiler`` over
    ``iters`` calls, summed over the kernels whose names contain each of
    ``names`` ("" = every kernel): one profile for several names."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    out = {}
    for name in names:
        us = sum(e.self_device_time_total for e in kernels if name in e.key)
        out[name] = us / 1e3 / iters if us else "not measured"
    return out


# the profiler keys of each backward variant's kernels
FA_BWD_KERNELS = {"tc": ("fa_bwd_tc_lse", "fa_bwd_tc_dkv", "fa_bwd_dkv_combine", "fa_bwd_tc_dq"),
                  "simt": ("fa_bwd_lse", "fa_bwd_dkv_kernel", "fa_bwd_dkv_combine", "fa_bwd_dq")}
# the matrix products each of them runs, of 2 D FLOPs a visible pair and head: the
# passes recompute S (lse, dk/dv, dq) and dP (dk/dv, dq), so 8 where the bound counts 5
FA_BWD_PASS_PRODUCTS = (1, 4, 0, 3)


def fa_bwd_case(name, dtype, B, S, H, K, D, timed=False, mask_type="causal", window=0,
                prefix_len=0, softcap=0.0, Sk=None):
    """The backward kernel against ``attention_bwd_ref`` on the card, on
    the forward kernel's own output, through the variant ``plan_bwd``
    picks: the worst error relative to each gradient's largest |value|,
    and a second run that must be bitwise equal.  Timed cases add device
    time (events; ``torch.profiler`` by kernel), TFLOP/s, the bound, the
    plain version, and the backward of ``scaled_dot_product_attention``
    alone as a yardstick (causal only); in bf16 also both variants in this
    run (``launch_bwd``, uncounted), each output held against the plain
    version and each timed, and the bytes of the ``tc`` dk/dv partials as
    the plan sizes them (computed, not measured).  ``Sk``: keys of their own
    length (cross attention), S by default."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.kernel import (BWD_TILE, BWD_VARIANTS,
                                                            bwd_chunk_tiles, bwd_dkv_blocks,
                                                            cost_bwd,
                                                            flash_attention_bwd_cuda,
                                                            launch_bwd, plan_bwd)
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref
    dev = torch.device("cuda")
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    g = torch.Generator().manual_seed(0)
    Sk = S if Sk is None else Sk
    q, k, v, do = [torch.randn(sh, generator=g).to(dev, tdt)
                   for sh in ((B, S, H, D), (B, Sk, K, D), (B, Sk, K, D), (B, S, H, D))]
    kw = dict(mask_type=mask_type, window=window, prefix_len=prefix_len, softcap=softcap)
    o = flash_attention(q, k, v, **kw)
    call = lambda: flash_attention_bwd_cuda(   # noqa: E731
        q, k, v, o, do, q_offset=0, kv_len=Sk, scale=D ** -0.5, **kw)
    variant = plan_bwd(B, S, Sk, H, K, D, tdt)
    by_variant = flash_attention_bwd_cuda.launches_by_variant
    before = (flash_attention_bwd_cuda.launches, by_variant[variant])
    got = call()
    torch.cuda.synchronize()
    check((flash_attention_bwd_cuda.launches, by_variant[variant]) == (before[0] + 1, before[1] + 1),
          f"{name}: the backward's {variant} variant did not launch")
    again = call()
    torch.cuda.synchronize()
    want = attention_bwd_ref(q, k, v, o, do, **kw)
    rel_err = lambda out: {n: ((a.float() - w.float()).abs().max()   # noqa: E731
                               / w.float().abs().max()).item()
                           for n, a, w in zip(("dq", "dk", "dv"), out, want)}
    rel = rel_err(got)
    res = dict(case=name, dtype=dtype, shape=dict(B=B, S=S, Sk=Sk, H=H, K=K, D=D), mask=mask_type,
               window=window, prefix_len=prefix_len, softcap=softcap, variant=variant, rel_err=rel,
               max_rel_err=max(rel.values()),
               max_abs_err=max((a.float() - w.float()).abs().max().item()
                               for a, w in zip(got, want)),
               tol=BWD_TOL[dtype],
               bitwise_equal_rerun=all(torch.equal(a, b) for a, b in zip(got, again)),
               finite=all(bool(torch.isfinite(a).all().item()) for a in got))
    check(res["finite"] and res["max_rel_err"] <= BWD_TOL[dtype] and res["bitwise_equal_rerun"],
          f"backward kernel disagrees with its plain version or is not deterministic: {res}")
    if timed:
        # 5 products of 2 D a visible pair and head; q, o, do, dq and k, v,
        # dk, dv once (``kernel.cost_bwd``, the profiler's count too)
        flops, nbytes = cost_bwd(B, S, Sk, H, K, D, tdt, mask_type=mask_type, window=window,
                                 prefix_len=prefix_len)
        res["bound_ms"], res["bound_by"] = _roofline(flops, nbytes, _peak(dtype))
        res["ms"] = time_ms(call, iters=10, warmup=2)
        dev_ms = _device_ms_by(call, ("fa_bwd_",) + FA_BWD_KERNELS[variant])
        res["device_ms"] = dev_ms["fa_bwd_"]
        res["passes_device_ms"] = {n: dev_ms[n] for n in FA_BWD_KERNELS[variant]}
        # each pass's own products at the peak (computed, not measured)
        res["passes_products_at_peak_ms"] = {
            n: p * flops / 5 / _peak(dtype) * 1e3
            for n, p in zip(FA_BWD_KERNELS[variant], FA_BWD_PASS_PRODUCTS) if p}
        if dtype == "bf16":   # both variants on the same inputs, in turns
            args = dict(q_offset=0, kv_len=Sk, scale=D ** -0.5, **kw)
            runs = {n: (lambda n=n: launch_bwd(q, k, v, o, do, n, **args)) for n in BWD_VARIANTS}
            res["variants_max_rel_err"] = {n: max(rel_err(runs[n]()).values())
                                           for n in BWD_VARIANTS}
            check(all(e <= BWD_TOL[dtype] for e in res["variants_max_rel_err"].values()),
                  f"{name}: a backward variant disagrees with its plain version: "
                  f"{res['variants_max_rel_err']} (limit {BWD_TOL[dtype]})")
            res["variants_ms"] = {n: [] for n in BWD_VARIANTS}
            for _ in range(2):
                for n in BWD_VARIANTS:
                    res["variants_ms"][n].append(time_ms(runs[n], iters=10, warmup=2))
            res["variants_device_ms"] = {n: device_ms(runs[n], "fa_bwd_", iters=5)
                                         for n in BWD_VARIANTS}
            chunk = bwd_chunk_tiles(B, S, Sk, H, K, mask_type, window, prefix_len, 0, Sk)
            blocks = B * K * bwd_dkv_blocks(S, Sk, H // K, 0, Sk, mask_type, window,
                                            prefix_len, chunk)
            # dk and dv fp32 tiles of 64 keys a dk/dv block, written once and read once
            res["partials_from_plan"] = dict(chunk_tiles=chunk, dkv_blocks=blocks,
                                             bytes=2 * 4 * blocks * BWD_TILE * D)
        res["tflops"] = flops / (res["ms"] * 1e-3) / 1e12
        res["bound_share"] = res["bound_ms"] / res["ms"]
        res["plain_ms"] = time_ms(lambda: attention_bwd_ref(q, k, v, o, do, **kw), iters=3, warmup=1)
        res["library_ms"] = None
        if mask_type == "causal" and softcap == 0.0:
            # yardstick only, never called by the port: SDPA's backward alone
            qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v))
            out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, scale=D ** -0.5,
                                                 enable_gqa=True)
            dot = do.transpose(1, 2)
            lib = lambda: torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True)   # noqa: E731
            res["library_ms"] = time_ms(lib, iters=10, warmup=2)
            res["library_device_ms"] = device_ms(lib, iters=5)
            res["library"] = ("backward of torch.nn.functional.scaled_dot_product_attention"
                              "(is_causal=True, enable_gqa=True)")
    emit("fa_backward_kernels", **res)
    return res


def phase_fa_backward_kernels():
    cases = []
    for dtype in ("bf16", "fp32"):
        # gemma-2b full width: 8 query heads over 1 kv head of 256, causal
        cases.append(fa_bwd_case("gemma2b_train", dtype, 1, 2048, 8, 1, 256, timed=True))
        cases.append(fa_bwd_case("reduced", dtype, 2, 64, 4, 1, 32))
        cases.append(fa_bwd_case("local", dtype, 1, 512, 8, 1, 128, mask_type="local",
                                 window=128))
        cases.append(fa_bwd_case("prefix", dtype, 1, 512, 8, 1, 128, mask_type="prefix",
                                 prefix_len=100))
        cases.append(fa_bwd_case("softcap", dtype, 1, 512, 8, 1, 256, softcap=30.0))
        cases.append(fa_bwd_case("k2", dtype, 2, 256, 8, 2, 64))
    # whisper-large-v3's train shapes (H = K = 20, D = 64, full mask): the
    # decoder's cross attention over the 1,500 frames, a ragged key length,
    # and the encoder's self attention
    cases.append(fa_bwd_case("whisper_cross", "bf16", 1, 2048, 20, 20, 64, mask_type="full",
                             Sk=1500))
    cases.append(fa_bwd_case("whisper_encoder", "bf16", 1, 1500, 20, 20, 64, mask_type="full"))
    emit("fa_backward_summary", cases=len(cases),
         worst_rel_err={d: max(c["max_rel_err"] for c in cases if c["dtype"] == d)
                        for d in ("bf16", "fp32")}, tol=BWD_TOL)
    return cases


def _ssd_work(dtype, B, S, H, P, N, init):
    """The work of one SSD call (``ssd/kernel.py:cost``, the profiler's
    count too): (flops, bytes)."""
    import torch
    from repro_torch.kernels.ssd.kernel import cost
    return cost(B, S, H, P, N, torch.bfloat16 if dtype == "bf16" else torch.float32, init)


def _ssd_bound(dtype, B, S, H, P, N, init):
    """Least time for one SSD call: its FLOPs (``_ssd_work``) at the bf16
    peak, or its bytes at the memory rate."""
    return _roofline(*_ssd_work(dtype, B, S, H, P, N, init), _peak("bf16"))


def ssd_case(name, dtype, B, S, H, P, N, init=False, timed=False, decay=None):
    """The SSD kernel against its plain version (``ssd_ref``, which chunks
    as the kernel does) on the same inputs, y and final state; ``decay``:
    one A for every head in place of the drawn ones."""
    import torch
    from repro_torch.kernels.ssd.kernel import plan, ssd_cuda
    from repro_torch.kernels.ssd.ops import ssd
    from repro_torch.kernels.ssd.ref import ssd_ref
    dev = torch.device("cuda")
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    g = torch.Generator().manual_seed(0)
    x = torch.randn(B, S, H, P, generator=g).to(dev, tdt)
    dt = torch.nn.functional.softplus(torch.randn(B, S, H, generator=g)).to(dev)
    A = -torch.exp(torch.randn(H, generator=g) * 0.3).to(dev)
    if decay is not None:
        A = torch.full_like(A, decay)
    Bm = (torch.randn(B, S, N, generator=g) * 0.3).to(dev, tdt)
    Cm = (torch.randn(B, S, N, generator=g) * 0.3).to(dev, tdt)
    h0 = torch.randn(B, H, P, N, generator=g).to(dev) if init else None
    variant, heads_per_block = plan(B, S, H, P, N, tdt)
    before = ssd_cuda.launches_by_variant[variant]
    y, state = ssd(x, dt, A, Bm, Cm, init_state=h0)
    torch.cuda.synchronize()
    check(ssd_cuda.launches_by_variant[variant] == before + 1,
          f"{name}: the SSD {variant} variant did not launch")
    want_y, want_state = ssd_ref(x, dt, A, Bm, Cm, h0)
    err_y = (y.float() - want_y.float()).abs().max().item()
    err_s = (state - want_state).abs().max().item()
    tol = SSD_TOL[dtype] if decay is None else SSD_STRONG_DECAY_TOL[dtype]
    # the tolerance is relative as well as absolute, as in assert_allclose
    ok_y = bool(((y.float() - want_y.float()).abs() <= tol + tol * want_y.float().abs()).all())
    ok_s = bool(((state - want_state).abs() <= tol + tol * want_state.abs()).all())
    res = dict(case=name, dtype=dtype, shape=dict(B=B, S=S, H=H, P=P, N=N),
               init_state=init, decay=decay, variant=variant, heads_per_block=heads_per_block,
               max_abs_err=max(err_y, err_s), max_abs_err_y=err_y,
               max_abs_err_state=err_s, tol=tol,
               finite=bool(torch.isfinite(y).all().item() and torch.isfinite(state).all().item()))
    check(res["finite"] and ok_y and ok_s, f"SSD kernel disagrees with its plain version: {res}")
    if timed:
        res["bound_ms"], res["bound_by"] = _ssd_bound(dtype, B, S, H, P, N, init)
        flops, nbytes = _ssd_work(dtype, B, S, H, P, N, init)
        call = lambda: ssd(x, dt, A, Bm, Cm, init_state=h0)   # noqa: E731
        res["ms"] = time_ms(call, iters=20)
        res["tflops"] = flops / (res["ms"] * 1e-3) / 1e12
        res["gbytes_per_s"] = nbytes / (res["ms"] * 1e-3) / 1e9
        res["bound_share"] = res["bound_ms"] / res["ms"]
        # device time of every SSD kernel of the call (the tc passes summed)
        res["device_ms"] = device_ms(call, "ssd_")
        if isinstance(res["device_ms"], float):
            res["bound_share_device"] = res["bound_ms"] / res["device_ms"]
            res["tflops_device"] = flops / (res["device_ms"] * 1e-3) / 1e12
            res["gbytes_per_s_device"] = nbytes / (res["device_ms"] * 1e-3) / 1e9
        res["plain_ms"] = time_ms(lambda: ssd_ref(x, dt, A, Bm, Cm, h0),
                                  iters=3, warmup=1)
        res["library_ms"] = None   # no single PyTorch call computes the SSD scan
    emit("ssd_vs_plain", **res)
    return res


def phase_ssd_kernels():
    cases = []
    for dtype in ("bf16", "fp32"):
        for B, S, H, P, N in [(1, 64, 2, 16, 32), (2, 96, 3, 16, 32), (1, 128, 1, 32, 16)]:
            cases.append(ssd_case("test_kernels", dtype, B, S, H, P, N))
        # mamba2-2.7b full width: H=80, P=64, N=128.  B=4 S=128 is the serve
        # run's admission; B=1 S=2048 the infer_prefill step
        cases.append(ssd_case("mamba2_serve_admit", dtype, 4, 128, 80, 64, 128,
                              timed=dtype == "bf16"))
        cases.append(ssd_case("mamba2_prefill", dtype, 1, 2048, 80, 64, 128,
                              timed=dtype == "bf16"))
        cases.append(ssd_case("ragged_init", dtype, 2, 200, 80, 64, 128, init=True))
        cases.append(ssd_case("reduced_ragged_init", dtype, 2, 37, 16, 16, 16, init=True))
        # the chunk's edges at full width, from a cache state; a strong decay
        for S in (1, 63, 65):
            cases.append(ssd_case(f"chunk_edge_s{S}_init", dtype, 4, S, 80, 64, 128, init=True))
        cases.append(ssd_case("strong_decay", dtype, 1, 2048, 80, 64, 128, init=True,
                              decay=-50.0))
    return cases


def _rglru_bound(B, S, D, init):
    """Least time for one RG-LRU scan (``rglru/kernel.py:cost``, the
    profiler's count too): a and x read and h written once in fp32 (and
    the initial state read) at the memory rate, or its ~7 fp32 operations
    per element at the fp32 peak."""
    from repro_torch.kernels.rglru.kernel import cost
    return _roofline(*cost(B, S, D, init), _peak("fp32"))


def rglru_case(name, B, S, D, init=False, strided=False, decay=None, timed=False):
    """The RG-LRU kernel against its plain version (``rglru_blocked``, the
    TPU kernel's blocked log-space algorithm) on the same fp32 inputs, as
    the model gives them: h and the final state, through the variant
    ``plan()`` picks.  Timed cases also time both variants by device time
    (``variants_device_ms``: the kernel, and the kernel with the chunked
    variant's scratch memset)."""
    import torch
    from repro_torch.kernels.rglru.kernel import launch, plan, rglru_cuda
    from repro_torch.kernels.rglru.ops import rglru
    from repro_torch.kernels.rglru.ref import rglru_blocked
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    if strided:   # x and a as slices of wider rows
        buf = torch.randn(B, S, 2 * D + 7, generator=g).to(dev)
        x, a = buf[..., :D], torch.sigmoid(buf * 2)[..., D:2 * D]
    else:
        x = torch.randn(B, S, D, generator=g).to(dev)
        a = torch.sigmoid(torch.randn(B, S, D, generator=g) * 2).to(dev)
    if decay is not None:
        a = torch.cat([torch.full((B, S, D // 2), decay[0]),
                       torch.full((B, S, D - D // 2), decay[1])], -1).to(dev)
    h0 = torch.randn(B, D, generator=g).to(dev) if init else None
    variant, chunk = plan(B, S, D)
    before = rglru_cuda.launches_by_variant[variant]
    h, h_last = rglru(x, a, init_state=h0)
    torch.cuda.synchronize()
    check(rglru_cuda.launches_by_variant[variant] == before + 1,
          f"{name}: the RG-LRU {variant} variant did not launch")
    want = rglru_blocked(x, a, h0)
    diff = (h - want).abs()
    ok = bool((diff <= RGLRU_TOL + RGLRU_TOL * want.abs()).all())
    res = dict(case=name, dtype="fp32", shape=dict(B=B, S=S, D=D), init_state=init,
               strided=strided, variant=variant, chunk=chunk, max_abs_err=diff.max().item(),
               max_abs_err_last=(h_last - want[:, -1]).abs().max().item(), tol=RGLRU_TOL,
               finite=bool(torch.isfinite(h).all().item()))
    check(res["finite"] and ok, f"RG-LRU kernel disagrees with its plain version: {res}")
    if timed:
        res["bound_ms"], res["bound_by"] = _rglru_bound(B, S, D, init)
        call = lambda: rglru(x, a, init_state=h0)   # noqa: E731
        res["ms"] = time_ms(call, iters=20)
        res["bound_share"] = res["bound_ms"] / res["ms"]
        res["device_ms"] = device_ms(call, "rglru_")
        if isinstance(res["device_ms"], float):
            res["bound_share_device"] = res["bound_ms"] / res["device_ms"]
        res["variants_device_ms"] = {
            v: [device_ms(lambda v=v: launch(x, a, h0, v), "rglru_"),
                device_ms(lambda v=v: launch(x, a, h0, v))] for v in ("seq", "chunked")}
        # not the same function: one elementwise call that moves the same
        # bytes (a and x read, one (B, S, D) fp32 tensor written), the rate
        # a streaming kernel reaches on this card
        out = torch.empty_like(want)
        res["stream_floor_device_ms"] = device_ms(lambda: torch.mul(a, x, out=out))
        res["plain_ms"] = time_ms(lambda: rglru_blocked(x, a, h0), iters=3, warmup=1)
        res["library_ms"] = None   # no single PyTorch call computes the recurrence
    emit("rglru_vs_plain", **res)
    return res


def phase_rglru_kernels():
    cases = [rglru_case("test_kernels", B, S, D)
             for B, S, D in [(1, 64, 64), (2, 48, 96), (1, 128, 128), (2, 50, 100)]]
    # recurrentgemma-9b full width, D = lru_width 4096: B=1 S=2048 is the
    # infer_prefill step, B=4 S=128 the serve run's admission
    cases.append(rglru_case("recurrentgemma_prefill", 1, 2048, 4096, timed=True))
    cases.append(rglru_case("recurrentgemma_serve_admit", 4, 128, 4096, timed=True))
    for S in (1, 50, 130, 2048):
        cases.append(rglru_case("initial_state", 2, S, 4096, init=True))
    # the chunk edges: a ragged last chunk, a last chunk of one step
    cases.append(rglru_case("chunk_edge_s2047", 1, 2047, 4096))
    cases.append(rglru_case("chunk_edge_s2049_init", 1, 2049, 4096, init=True))
    cases.append(rglru_case("strided_ragged", 3, 37, 300, strided=True))
    cases.append(rglru_case("strided_ragged_chunked", 2, 300, 600, init=True, strided=True))
    for S in (64, 200):   # seq, then chunked, where A underflows to 0
        cases.append(rglru_case("extreme_decays", 1, S, 256, decay=(1e-6, 1 - 1e-6)))
    return cases


def phase_rglru_plan_sweep():
    """Device time of both RG-LRU variants over shapes around the plan's
    thresholds (D = 4096): one line each, with the variant plan() picks
    and the faster one (kernel and the chunked variant's memset both
    counted).  Reported, not checked: the plan's constants come from it."""
    import torch
    from repro_torch.kernels.rglru.kernel import launch, plan
    dev = torch.device("cuda")
    D = 4096
    picked_faster = 0
    shapes = [(B, S) for S in (64, 128, 256, 2048) for B in (1, 2, 3, 4, 8, 16)]
    for B, S in shapes:
        g = torch.Generator(device=dev).manual_seed(0)
        x = torch.randn(B, S, D, device=dev, generator=g)
        a = torch.sigmoid(torch.randn(B, S, D, device=dev, generator=g) * 2)
        ms = {v: device_ms(lambda v=v: launch(x, a, None, v)) for v in ("seq", "chunked")}
        variant, _ = plan(B, S, D)
        faster = min(ms, key=lambda v: ms[v] if isinstance(ms[v], float) else float("inf"))
        picked_faster += variant == faster
        emit("rglru_plan_sweep", shape=dict(B=B, S=S, D=D), plan=variant, faster=faster,
             device_ms=ms, bound_ms=_rglru_bound(B, S, D, False)[0])
        del x, a
    emit("rglru_plan_sweep_summary", shapes=len(shapes), plan_picked_faster=picked_faster)


def _grad_errs(got, want, names):
    """Each gradient's max abs error, absolute and relative to its largest
    |value| in ``want``."""
    out = {}
    for n, g, w in zip(names, got, want):
        d = (g.double() - w.double()).abs().max().item()
        out[n] = (d, d / max(w.double().abs().max().item(), 1e-300))
    return out


def _scan_bwd_timing(res, call, plain, names, work, dtype, passes=()):
    """The timed part of a scan backward case: ms by events, device ms by
    ``torch.profiler`` (each of ``passes`` too), the bound from
    ``work = (flops, bytes)`` at the inputs' type's peak, the plain
    version's ms (autograd's backward through it, the forward's graph
    kept), and no library call."""
    flops, nbytes = work
    res["bound_ms"], res["bound_by"] = _roofline(flops, nbytes, _peak(dtype))
    res["ms"] = time_ms(call, iters=10, warmup=2)
    dev_ms = _device_ms_by(call, names + tuple(passes))
    res["device_ms"] = dev_ms[names[0]]
    if passes:
        res["passes_device_ms"] = {n: dev_ms[n] for n in passes}
    res["bound_share"] = res["bound_ms"] / res["ms"]
    if isinstance(res["device_ms"], float):
        res["bound_share_device"] = res["bound_ms"] / res["device_ms"]
    res["tflops"] = flops / (res["ms"] * 1e-3) / 1e12
    res["gbytes_per_s"] = nbytes / (res["ms"] * 1e-3) / 1e9
    res["plain_ms"] = time_ms(plain, iters=3, warmup=1)
    res["library_ms"] = None   # no single PyTorch call computes the scan's gradient


# the SSD backward's kernels (csrc/ssd_bwd.cu), as the profiler names them
SSD_BWD_PASSES = ("ssd_bwd_chunk_state", "ssd_bwd_state_pass", "ssd_bwd_chunk_kernel",
                  "ssd_bwd_reduce", "ssd_bwd_da")


def ssd_bwd_case(name, dtype, B, S, H, P, N, init=False, timed=False, decay=None):
    """The SSD backward kernel, through the op's autograd formula (one
    launch), against autograd through the plain version (``ssd_ref``) on
    the same inputs, with a nonzero ``dstate`` always.  The plain version
    is differentiated in float64 on the card: its fp32 autograd strays by
    itself ~4e-3 in dA at a strong decay (``tests/test_torch_ssd_bwd.py``),
    and its own fp32 error is reported beside (``plain_fp32_rel_err``).
    Then a second launch that must be bitwise equal.  ``decay``: one A for
    every head."""
    import torch
    from repro_torch.kernels.ssd.kernel import cost_bwd, plan_bwd, ssd_bwd_cuda
    from repro_torch.kernels.ssd.ops import ssd
    from repro_torch.kernels.ssd.ref import ssd_ref
    dev = torch.device("cuda")
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    g = torch.Generator().manual_seed(0)
    x = torch.randn(B, S, H, P, generator=g).to(dev, tdt)
    dt = torch.nn.functional.softplus(torch.randn(B, S, H, generator=g)).to(dev)
    A = -torch.exp(torch.randn(H, generator=g) * 0.3).to(dev)
    if decay is not None:
        A = torch.full_like(A, decay)
    Bm = (torch.randn(B, S, N, generator=g) * 0.3).to(dev, tdt)
    Cm = (torch.randn(B, S, N, generator=g) * 0.3).to(dev, tdt)
    h0 = torch.randn(B, H, P, N, generator=g).to(dev) if init else None
    dy = torch.randn(B, S, H, P, generator=g).to(dev, tdt)
    ds = torch.randn(B, H, P, N, generator=g).to(dev)
    ins = [x, dt, A, Bm, Cm, h0]
    names = ("dx", "ddt", "dA", "dBm", "dCm", "dinit")[:6 if init else 5]
    variant = plan_bwd(B, S, H, P, N, tdt)
    leaves = [None if t is None else t.clone().requires_grad_() for t in ins]
    before = dict(ssd_bwd_cuda.launches_by_variant)
    y, state = ssd(*leaves)
    torch.autograd.backward((y, state), (dy, ds))
    torch.cuda.synchronize()
    check(ssd_bwd_cuda.launches_by_variant[variant] == before[variant] + 1,
          f"{name}: the SSD backward's {variant} variant did not launch once")
    got = [t.grad for t in leaves if t is not None]

    def plain_grads(dtype_):
        lv = [None if t is None else t.to(dtype_).requires_grad_() for t in ins]
        outs = ssd_ref(*lv)
        return torch.autograd.grad(outs, [t for t in lv if t is not None],
                                   (dy.to(dtype_), ds.to(dtype_)))
    exact = plain_grads(torch.float64)
    errs = _grad_errs(got, exact, names)
    plain32 = _grad_errs(plain_grads(torch.float32), exact, names)
    again = ssd_bwd_cuda(x, dt, A, Bm, Cm, h0, dy, ds)
    first = ssd_bwd_cuda(x, dt, A, Bm, Cm, h0, dy, ds)
    torch.cuda.synchronize()
    tol = (SCAN_BWD_TOL if decay is None else SCAN_BWD_STRONG_DECAY_TOL)[dtype]
    res = dict(case=name, dtype=dtype, shape=dict(B=B, S=S, H=H, P=P, N=N), init_state=init,
               dstate=True, decay=decay, variant=variant,
               rel_err={n: e[1] for n, e in errs.items()},
               max_rel_err=max(e[1] for e in errs.values()),
               max_abs_err=max(e[0] for e in errs.values()), tol=tol,
               plain_fp32_rel_err={n: e[1] for n, e in plain32.items()},
               dtypes_ok=all(gg.dtype == t.dtype and gg.shape == t.shape
                             for gg, t in zip(got, [t for t in ins if t is not None])),
               bitwise_equal_rerun=all(torch.equal(a, b) for a, b in zip(again, first)),
               finite=all(bool(torch.isfinite(t).all().item()) for t in got))
    check(res["finite"] and res["dtypes_ok"] and res["bitwise_equal_rerun"]
          and res["max_rel_err"] <= tol,
          f"SSD backward disagrees with its plain version or is not deterministic: {res}")
    if timed:
        xp = [None if t is None else t.detach().requires_grad_() for t in ins]
        outs = ssd_ref(*xp)
        wrt = [t for t in xp if t is not None]
        _scan_bwd_timing(
            res, lambda: ssd_bwd_cuda(x, dt, A, Bm, Cm, h0, dy, ds),
            lambda: torch.autograd.grad(outs, wrt, (dy, ds), retain_graph=True),
            ("ssd_bwd_",), cost_bwd(B, S, H, P, N, tdt, init, True), dtype, SSD_BWD_PASSES)
        del outs
    emit("ssd_bwd_kernels", **res)
    return res


def phase_ssd_bwd_kernels():
    """The SSD backward kernel against its plain version: mamba2-2.7b's
    train shape (bf16, timed), a ragged S, an initial state, a strong
    decay (fp32) and the reduced config (fp32)."""
    cases = [ssd_bwd_case("mamba2_train", "bf16", 1, 2048, 80, 64, 128, timed=True),
             ssd_bwd_case("ragged_s2000", "bf16", 1, 2000, 80, 64, 128),
             ssd_bwd_case("init_state", "bf16", 2, 200, 80, 64, 128, init=True),
             ssd_bwd_case("strong_decay", "fp32", 1, 2048, 80, 64, 128, init=True,
                          decay=-50.0),
             ssd_bwd_case("reduced_fp32", "fp32", 2, 37, 16, 16, 16, init=True),
             ssd_bwd_case("mamba2_train_fp32", "fp32", 1, 2048, 80, 64, 128, timed=True)]
    emit("ssd_bwd_summary", cases=len(cases),
         worst_rel_err={d: max(c["max_rel_err"] for c in cases if c["dtype"] == d)
                        for d in ("bf16", "fp32")}, tol=SCAN_BWD_TOL)
    return cases


def rglru_bwd_case(name, B, S, D, init=False, last=False, ones=False, strided=False,
                   timed=False):
    """The RG-LRU backward kernel, through the op's autograd formula (one
    launch), against autograd through the plain version
    (``rglru_blocked``) on the same fp32 inputs; ``last``: a gradient of
    the last step given too; ``ones``: an eighth of the lanes at a = 1
    exactly, where the gate's slope is 0.  Then a second launch that must
    be bitwise equal."""
    import torch
    from repro_torch.kernels.rglru.kernel import cost_bwd, plan_bwd, rglru_bwd_cuda
    from repro_torch.kernels.rglru.ops import rglru
    from repro_torch.kernels.rglru.ref import rglru_blocked
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    if strided:   # x and a as slices of wider rows
        buf = torch.randn(B, S, 2 * D + 7, generator=g).to(dev)
        x, a = buf[..., :D], torch.sigmoid(buf * 2)[..., D:2 * D]
    else:
        x = torch.randn(B, S, D, generator=g).to(dev)
        a = torch.sigmoid(torch.randn(B, S, D, generator=g) * 2).to(dev)
    if ones:
        a = a.clone()
        a[..., : D // 8] = 1.0
    h0 = torch.randn(B, D, generator=g).to(dev) if init else None
    dh = torch.randn(B, S, D, generator=g).to(dev)
    dl = torch.randn(B, D, generator=g).to(dev) if last else None
    ins = [x, a, h0]
    names = ("dx", "da", "dinit")[:3 if init else 2]
    variant = plan_bwd(B, S, D)
    leaves = [None if t is None else t.clone().requires_grad_() for t in ins]
    before = dict(rglru_bwd_cuda.launches_by_variant)
    h, h_last = rglru(*leaves)
    torch.autograd.backward((h, h_last) if last else (h,), (dh, dl) if last else (dh,))
    torch.cuda.synchronize()
    check(rglru_bwd_cuda.launches_by_variant[variant] == before[variant] + 1,
          f"{name}: the RG-LRU backward's {variant} variant did not launch once")
    got = [t.grad for t in leaves if t is not None]
    lv = [None if t is None else t.clone().requires_grad_() for t in ins]
    hp = rglru_blocked(*lv)
    outs, grads = ((hp, hp[:, -1]), (dh, dl)) if last else ((hp,), (dh,))
    want = torch.autograd.grad(outs, [t for t in lv if t is not None], grads,
                               retain_graph=True)
    errs = _grad_errs(got, want, names)
    hk = h.detach().contiguous()
    xs, as_ = x.contiguous(), a.contiguous()
    runs = [rglru_bwd_cuda(x, a, hk, h0, dh, dl) for _ in range(2)]
    torch.cuda.synchronize()
    res = dict(case=name, dtype="fp32", shape=dict(B=B, S=S, D=D), init_state=init,
               dh_last=last, unit_lanes=ones, strided=strided, variant=variant,
               rel_err={n: e[1] for n, e in errs.items()},
               max_rel_err=max(e[1] for e in errs.values()),
               max_abs_err=max(e[0] for e in errs.values()), tol=SCAN_BWD_TOL["fp32"],
               bitwise_equal_rerun=all(torch.equal(p, q) for p, q in zip(*runs)),
               finite=all(bool(torch.isfinite(t).all().item()) for t in got))
    check(res["finite"] and res["bitwise_equal_rerun"]
          and res["max_rel_err"] <= SCAN_BWD_TOL["fp32"],
          f"RG-LRU backward disagrees with its plain version or is not deterministic: {res}")
    if timed:
        wrt = [t for t in lv if t is not None]
        _scan_bwd_timing(
            res, lambda: rglru_bwd_cuda(xs, as_, hk, h0, dh, dl),
            lambda: torch.autograd.grad(outs, wrt, grads, retain_graph=True),
            ("rglru_bwd_",), cost_bwd(B, S, D, init, last), "fp32")
        # not the same function: one elementwise call that moves the same
        # 24 bytes an element (four (B, S, D) fp32 tensors read, two written),
        # the rate a streaming kernel reaches on this card
        o1, o2 = torch.empty_like(dh), torch.empty_like(dh)
        res["stream_floor_device_ms"] = device_ms(
            lambda: (torch.addcmul(xs, as_, hk, out=o1), torch.mul(dh, 2.0, out=o2)))
    del outs
    emit("rglru_bwd_kernels", **res)
    return res


def phase_rglru_bwd_kernels():
    """The RG-LRU backward kernel against its plain version:
    recurrentgemma-9b's train shape (D = lru_width 4096, timed), a ragged
    S, an initial state with ``dh_last``, lanes at a = 1, strided inputs."""
    cases = [rglru_bwd_case("recurrentgemma_train", 1, 2048, 4096, timed=True),
             rglru_bwd_case("ragged_s2000", 1, 2000, 4096),
             rglru_bwd_case("init_dh_last", 2, 130, 4096, init=True, last=True),
             rglru_bwd_case("unit_lanes", 1, 2048, 4096, init=True, last=True, ones=True),
             rglru_bwd_case("strided_ragged", 3, 37, 300, init=True, last=True, strided=True)]
    emit("rglru_bwd_summary", cases=len(cases),
         worst_rel_err=max(c["max_rel_err"] for c in cases), tol=SCAN_BWD_TOL["fp32"])
    return cases


# the walls of the runner's phases in the last runs before their step cells
# compiled (PERF.md §6, the H100's runs before; runner_cell was not timed)
RUNNER_WALLS_BEFORE = {"runner": None, "dispatch": [80.0, 69.7], "nightly": [43.8, 42.0, 48.2],
                       "coverage": [0.8, 0.6, 0.7]}


# the runner's compiled step cells (B=2, S=48, the Figs. 3-4 matrix's
# shapes): the mamba2-2.7b and recurrentgemma-9b prefill cells, whose
# graphs the compilers and dispatch parts compile too (Inductor's cache
# serves the later ones); every arch's serve cell compiles its engine.  gemma-2b's
# train cell of the same shape and mode is the matrix's own
# (``phase_compilers``), not run twice.  The other step cells, each a cold
# TorchInductor compile of 12-25 s on the H100 (PERF.md §5), are cut for
# the script's time limit (ROADMAP item 13c)
RUNNER_STEP_CELLS = {"mamba2-2.7b": ("infer_prefill",), "recurrentgemma-9b": ("infer_prefill",)}
# the archs whose compiled serve engine (B=8, S=32) runs in runner_cell:
# gemma-2b's, mamba2-2.7b's and recurrentgemma-9b's run compiled in
# dispatch, loadgen and serve_compiled_*, so their runner_cell cells (three
# cold compiles) are cut for the script's time limit (PR 25)
RUNNER_SERVE_ARCHS = ("gemma3-12b", "nemotron-4-15b", "internlm2-20b", "paligemma-3b",
                      "whisper-large-v3")
RUNNER_SHAPE = dict(batch=2, seq=48)


def phase_runner(smi, runner):
    """The runner's cells on the card through ``runner``, which it closes
    after: the serve cell of every arch whose compiled engine no other phase
    runs (``RUNNER_SERVE_ARCHS``) and the step cells of
    ``RUNNER_STEP_CELLS``, each ok."""
    from repro_torch.runner import Scenario
    # the prefill cells last: by then the dispatch and compilers parts have
    # compiled their graphs, which then load from Inductor's cache
    for arch, task, kw in ([(a, "serve", dict(batch=8, seq=32)) for a in RUNNER_SERVE_ARCHS]
                           + [(a, t, RUNNER_SHAPE) for a, tasks in RUNNER_STEP_CELLS.items()
                              for t in tasks]):
        sc = Scenario(arch=arch, task=task, **kw)
        rr = runner.run(sc)
        compiled = rr.extra.get("compiled", rr.mode != "eager")
        emit("runner_cell", scenario=sc.name, status=rr.status, median_us=rr.median_us,
             compile_us=rr.compile_us, error=rr.error, compiled=compiled,
             prov_device=rr.extra.get("prov_device"))
        check(rr.status == "ok", f"runner cell {sc.name}: {rr.error}")
        check(compiled, f"runner cell {sc.name} ran uncompiled")
    runner.close()
    _free_card()


# the runner's reduced cells that dispatch carries: mamba2-2.7b's
# ``infer_prefill`` (B=2, S=48: compiled, the SSD op inside its graph; the
# serial run and each worker compile it) and a serve cell each of gemma-2b, mamba2-2.7b and
# recurrentgemma-9b (B=4, S=32: K1, K2 and K3 on the card), and the
# profiled gemma-2b serve cell (``DISPATCH_PROFILED``).  Fewer cells than
# before the step cells compiled (gemma-2b's prefill and decode and more
# serve cells: 157-162 s on the H100 compiled, 70-80 s uncompiled), for
# the script's time limit
DISPATCH_MATRIX = dict(archs=("gemma-2b", "mamba2-2.7b", "recurrentgemma-9b"),
                       tasks=("infer_prefill", "serve"), batches=(2, 4), seqs=(32, 48),
                       slots=(2,), traces=("bursty",),
                       exclude=(r"^(gemma-2b|recurrentgemma-9b)/infer_",
                                r"/infer_prefill/(b4|b2/s32)/", r"/serve/(b2|b4/s48)/"))
DISPATCH_PROFILED = dict(arch="gemma-2b", task="serve", batch=4, seq=32, slots=2)


def _emit_budget(process, budget, **kw):
    """One ``compile_budget`` line: a process's seconds inside compiles by
    phase, graphs made and Inductor's FX-graph and AOT-autograd cache hits,
    misses and bypasses (``harness.compile_budget``)."""
    emit("compile_budget", process=process, **kw, **budget)


def _worker_budgets(phase, records):
    """The ``compile_budget`` line of each worker process among
    ``records`` (a worker's records carry its running account: the last
    one counts), and those budgets."""
    last = {}
    for rr in records:
        b = rr.extra.get("compile_budget")
        if b and rr.extra.get("isolated") and (
                b["pid"] not in last or b["graphs"] >= last[b["pid"]]["graphs"]):
            last[b["pid"]] = b
    for b in last.values():
        _emit_budget("worker", b, in_phase=phase)
    return list(last.values())


def _pid_alive(pid):
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    return True


def phase_dispatch(smi):
    """One matrix of the runner's cells (``DISPATCH_MATRIX``: a compiled
    step cell and three serve cells) run four ways on the card: serially,
    across two shard workers (``jobs=2``, fence held), across two
    ``local:2`` cluster workers, and one serve cell in its own subprocess
    (``isolate=True``).  Every cell must be ok in every way, with names in
    matrix order and serve tokens byte-identical; a profiled gemma-2b
    serve cell must carry the same ``prof_*`` keys serially and from a
    worker, with attention time on the card; no worker may outlive
    ``close()``.  Each cell's line reports its median serially and under
    ``jobs=2`` and their ratio (reported, not gated)."""
    from repro_torch.runner import BenchmarkRunner, Scenario, ScenarioMatrix
    matrix = ScenarioMatrix(**DISPATCH_MATRIX)
    scenarios = matrix.expand()
    names = [sc.name for sc in scenarios]
    t0 = time.perf_counter()
    runner = BenchmarkRunner(device="cuda")
    ways, seconds, pids = {}, {}, set()
    try:
        for way, kw in (("serial", {}), ("jobs=2", dict(jobs=2)),
                        ("local:2", dict(cluster="local:2"))):
            tw = time.perf_counter()
            ways[way] = runner.run_matrix(matrix, **kw)
            seconds[way] = round(time.perf_counter() - tw, 3)
            pids.update(runner.worker_pids())
        iso_sc = next(sc for sc in scenarios if sc.task == "serve")
        tw = time.perf_counter()
        iso = BenchmarkRunner(device="cuda", isolate=True).run(iso_sc)
        seconds["isolate"] = round(time.perf_counter() - tw, 3)
        dec = Scenario(**DISPATCH_PROFILED)
        prof_serial = runner.run(dec, profile=True, record=False)
        (prof_worker,) = runner.run_matrix(ScenarioMatrix(
            archs=(dec.arch,), tasks=(dec.task,), batches=(dec.batch,), seqs=(dec.seq,),
            slots=(dec.slots,), traces=(dec.trace,)), jobs=2, profile=True)
        pids.update(runner.worker_pids())
    finally:
        runner.close()
    left, alive = runner.worker_pids(), sorted(p for p in pids if _pid_alive(p))
    serial = {rr.name: rr for rr in ways["serial"]}
    pooled = {rr.name: rr for rr in ways["jobs=2"]}
    for way, rrs in list(ways.items()) + [("isolate", [iso])]:
        for rr in rrs:
            base, shard = serial[rr.name].median_us, pooled[rr.name].median_us
            emit("dispatch_cell", cell=rr.name, transport=way, status=rr.status,
                 error=rr.error, median_us=rr.median_us, median_us_serial=base,
                 median_us_jobs2=shard, jobs2_over_serial=shard / base if base else None,
                 measure_fence=runner.measure_fence,
                 worker=rr.extra.get("shard", rr.extra.get("host")),
                 tokens_digest=rr.extra.get("tokens_digest"),
                 compiled=rr.extra.get("compiled", rr.mode != "eager"),
                 prov_device=rr.extra.get("prov_device"), card=smi)
    budgets = _worker_budgets("dispatch", [rr for way in ("jobs=2", "local:2")
                                           for rr in ways[way]] + [iso, prof_worker])
    prof_keys = {k for k in prof_serial.extra if k.startswith("prof_")}
    worker_keys = {k for k in prof_worker.extra if k.startswith("prof_")}
    attention_us = prof_worker.extra.get("prof_class_us", {}).get("attention", 0.0)
    emit("dispatch", card=smi, cells=len(names), seconds=seconds,
         seconds_total=round(time.perf_counter() - t0, 3), worker_pids=sorted(pids),
         worker_pids_after_close=left, alive_after_close=alive,
         profiled_cell=dec.name, prof_keys_equal=prof_keys == worker_keys,
         prof_keys_only_serial=sorted(prof_keys - worker_keys),
         prof_keys_only_worker=sorted(worker_keys - prof_keys),
         worker_attention_us=attention_us, worker_profile_error=prof_worker.extra.get(
             "prof_error"), worker_trace_clamp=prof_worker.extra.get("trace_clamp"))
    for way, rrs in list(ways.items()) + [("isolate", [iso])]:
        bad = [(rr.name, rr.error) for rr in rrs if rr.status != "ok"]
        check(not bad, f"dispatch {way}: cells failed: {bad}")
        if way != "isolate":
            check([rr.name for rr in rrs] == names, f"dispatch {way}: names out of order")
        for rr in rrs:
            ref = serial[rr.name]
            if rr.task == "serve":
                check(rr.extra["tokens"] == ref.extra["tokens"]
                      and rr.extra["tokens_digest"] == ref.extra["tokens_digest"],
                      f"dispatch {way}: {rr.name} tokens differ from the serial run")
            if way != "serial":
                check(rr.extra.get("isolated") and rr.extra.get("prov_device") ==
                      ref.extra["prov_device"], f"dispatch {way}: {rr.name} not from a "
                      f"worker on the card: {rr.extra.get('prov_device')}")
    check(prof_serial.status == prof_worker.status == "ok",
          f"dispatch profile: {prof_serial.error} / {prof_worker.error}")
    check(prof_keys == worker_keys, f"dispatch profile: prof_* keys differ: serial only "
          f"{sorted(prof_keys - worker_keys)}, worker only {sorted(worker_keys - prof_keys)}")
    check(attention_us > 0, "dispatch profile: no attention time in the worker's trace")
    check(not left and not alive, f"dispatch: workers left after close: {left}, {alive}")
    # every graph a worker compiles, the serial run compiled first: each
    # must load from Inductor's disk cache (checked at the script's end)
    return [f"dispatch worker {b['pid']}: {b['fxgraph_cache']['miss']} FX-graph cache "
            f"misses" for b in budgets if b["fxgraph_cache"]["miss"] or not b["graphs"]]



# the reference's fast load sweep (``benchmarks/loadgen_curve.py:36-49``):
# gemma-2b's reduced fp32 cells, bursty arrivals and bimodal prompts, 8
# requests of prompt 8 on 4 slots, four offered loads, both admission
# policies, each engine compiled (``jit_donated``)
LOADGEN_SWEEP = dict(archs=("gemma-2b",), tasks=("loadgen",), batches=(8,), seqs=(8,),
                     slots=(4,), traces=("bursty+bimodal",), loads=(0.5, 1.0, 2.0, 4.0),
                     admissions=("batched", "single"))
# the load whose cell is also split across two shard workers
LOADGEN_SPLIT_LOAD = 2.0
LOADGEN_CURVE = os.path.join(ROOT, "build", "chip_smoke_loadgen_curve.json")


def phase_loadgen(smi):
    """The load generator on the card (``task="loadgen"``, the reference's
    ``benchmarks/loadgen_curve.py --fast``): ``LOADGEN_SWEEP`` through the
    runner, every cell ok and every cell's tokens the same across loads
    and policies; each policy's knee (``find_knee``) and the curve, in the
    reference's layout, at ``LOADGEN_CURVE``; ``ScenarioMatrix(slots=
    ("auto",))`` expanded against that curve resolves a width with no
    fallback; the ``LOADGEN_SPLIT_LOAD`` cell split ``0/2`` and ``1/2``
    across two shard workers (``jobs=2``) gives shards whose tokens,
    together, are the unsplit cell's.  Returns the workers' compile
    budgets."""
    from repro_torch.runner import BenchmarkRunner, ScenarioMatrix
    from repro_torch.runner.loadgen import (CURVE_PATH_ENV, CURVE_SCHEMA, DEFAULT_SLOTS,
                                            find_knee, parse_split)
    t0 = time.perf_counter()
    runner = BenchmarkRunner(device="cuda")
    try:
        out = runner.run_matrix(ScenarioMatrix(**LOADGEN_SWEEP))
        sweep_s = time.perf_counter() - t0
        shards = runner.run_matrix(ScenarioMatrix(**dict(
            LOADGEN_SWEEP, loads=(LOADGEN_SPLIT_LOAD,), admissions=("batched",),
            splits=("0/2", "1/2"))), jobs=2)
    finally:
        runner.close()
    rows = {"batched": [], "single": []}
    for rr in out:
        ex = rr.extra
        emit("loadgen_cell", cell=rr.name, status=rr.status, error=rr.error, card=smi,
             **{k: ex.get(k) for k in (
                 "offered_load", "admission", "compiled", "tok_per_s", "ttft_p50",
                 "ttft_p99", "tok_lat_p50", "tok_lat_p99", "queue_depth_max",
                 "admit_calls", "admit_batch_max", "admit_shapes", "tokens_digest")},
             median_us=rr.median_us, compile_us=rr.compile_us)
        if rr.status == "ok":
            rows[ex["admission"]].append({"name": rr.name, "load": ex["offered_load"],
                                          "tok_per_s": ex["tok_per_s"],
                                          "ttft_p99": ex.get("ttft_p99", 0.0),
                                          "admit_calls": ex["admit_calls"],
                                          "tokens_digest": ex["tokens_digest"]})
    check(all(rr.status == "ok" for rr in out),
          f"loadgen: cells failed: {[(rr.name, rr.error) for rr in out if rr.status != 'ok']}")
    digests = {rr.extra["tokens_digest"] for rr in out}
    curves = {}
    for adm, pts in rows.items():
        knee = find_knee(pts)
        at = next(p for p in pts if p["load"] == knee["knee_load"])
        curves[adm] = {"knee": knee, "ttft_p99_at_knee": at["ttft_p99"],
                       "admit_calls_total": sum(p["admit_calls"] for p in pts)}
    os.makedirs(os.path.dirname(LOADGEN_CURVE), exist_ok=True)
    with open(LOADGEN_CURVE, "w") as f:
        json.dump({"schema": CURVE_SCHEMA, "arch": "gemma-2b", "slots": DEFAULT_SLOTS,
                   "fast": True, "rows": rows["batched"] + rows["single"], "curves": curves,
                   "comparison": {"digests_match": len(digests) == 1}}, f, indent=1)
    before = os.environ.get(CURVE_PATH_ENV)
    os.environ[CURVE_PATH_ENV] = LOADGEN_CURVE
    try:
        auto = ScenarioMatrix(**dict(LOADGEN_SWEEP, slots=("auto",)))
        auto_slots = sorted({sc.slots for sc in auto.expand()})
        fallback = auto.slots_fallback()
    finally:
        if before is None:
            del os.environ[CURVE_PATH_ENV]
        else:
            os.environ[CURVE_PATH_ENV] = before
    whole = next(rr for rr in out if rr.extra["admission"] == "batched"
                 and rr.extra["offered_load"] == LOADGEN_SPLIT_LOAD)
    n = whole.batch
    union = {}
    for rr in shards:
        if rr.status == "ok":
            i, k = parse_split(rr.extra["split"])
            union.update(zip(range(i, n, k), rr.extra["tokens"]))
    budgets = _worker_budgets("loadgen", shards)
    emit("loadgen", card=smi, cells=len(out), digests=sorted(digests), curves=curves,
         knee_load_batched=curves["batched"]["knee"]["knee_load"],
         knee_load_single=curves["single"]["knee"]["knee_load"], curve_path=LOADGEN_CURVE,
         auto_slots=auto_slots, slots_fallback=fallback,
         shards=[(rr.name, rr.status, rr.error, rr.extra.get("shard")) for rr in shards],
         shard_union_equals_whole=[union.get(r) for r in range(n)] == whole.extra["tokens"],
         sweep_s=sweep_s, seconds_total=time.perf_counter() - t0)
    check(len(digests) == 1, f"loadgen: tokens differ across loads or policies: {digests}")
    check(not fallback and len(auto_slots) == 1,
          f"loadgen: slots='auto' resolved {auto_slots}, fell back {fallback}")
    check(all(rr.status == "ok" for rr in shards),
          f"loadgen: shards failed: {[(rr.name, rr.error) for rr in shards]}")
    check([union.get(r) for r in range(n)] == whole.extra["tokens"],
          "loadgen: the shards' tokens together are not the unsplit cell's")
    return budgets


# the nightly run's cells: gemma-2b's decode cell, which a worker compiles,
# and the train cell of each family that trains on the card from PR 25 on
# (ssm, hybrid, vlm, encdec), uncompiled.  Compiled (``jit_donated``, the
# reference nightly's mode), each is a cold compile of 218-360 s in its
# worker beside the other parts on the H100, and with them (and the new
# families' compiled matrix cells on their graphs) the script took
# 1,277.9 s, past its limit (PERF.md §6, PR 25).  The other cells of the
# eight archs x {train, infer_decode} are excluded for the time limit too
NIGHTLY_ARCHS = ("gemma-2b", "mamba2-2.7b", "recurrentgemma-9b", "paligemma-3b",
                 "whisper-large-v3")
NIGHTLY_TASKS = ("train", "infer_decode")
NIGHTLY_MODES = ("jit_donated", "eager")
NIGHTLY_EXCLUDE = (r"^gemma-2b/train/", r"^(?!gemma-2b/).*/infer_decode/",
                   r"/infer_decode/.*/eager$", r"/train/.*/jit_donated$")
NIGHTLY_HOOKED = "gemma-2b/infer_decode"
NIGHTLY_CELLS = 5
NIGHTLY_SLOWDOWN_S = 0.25


def phase_nightly(smi):
    """The paper's nightly CI run (``core.ci.run_nightly``) on the card:
    ``NIGHTLY_ARCHS`` x ``NIGHTLY_TASKS`` less ``NIGHTLY_EXCLUDE`` at the
    runner cells' shapes (B=2, S=48), across two shard workers
    (``jobs=2``) without the measurement fence: fenced, the decode cell's
    cold compile (a cell's warm pass runs under the fence) would hold the
    dispatch part's and loadgen's workers, which share the fence.  So the
    night's medians are taken beside the other parts' work (reported; the
    injected slowdown is 20x a clean median).  gemma-2b's decode cell is
    compiled in its worker, the train cells run uncompiled
    (``NIGHTLY_MODES``).  Night 0 records the baselines;
    every cell must come back ok, with no ``status`` issue, and record its
    baseline: five.  Night 1
    injects a 0.25 s slowdown into ``NIGHTLY_HOOKED`` (through the pool's
    hook parameters) and must file its ``median_us`` issue; the other
    issues of that clean night are reported (host noise at these reduced
    cells), not gated."""
    import tempfile
    from repro_torch.core.ci import run_nightly
    from repro_torch.core.harness import RegressionHook
    from repro_torch.core.regression import MetricStore
    from repro_torch.runner import BenchmarkRunner
    t0 = time.perf_counter()
    runner = BenchmarkRunner(device="cuda", runs=3, measure_fence=False)
    pids = set()
    try:
        with tempfile.TemporaryDirectory() as d:
            store = MetricStore(os.path.join(d, "metrics.json"))
            night = dict(archs=list(NIGHTLY_ARCHS), tasks=NIGHTLY_TASKS,
                         exclude=NIGHTLY_EXCLUDE, batches=(RUNNER_SHAPE["batch"],),
                         seqs=(RUNNER_SHAPE["seq"],), modes=NIGHTLY_MODES, runs=3,
                         runner=runner, jobs=2)
            night0 = run_nightly(store, update_baseline=True, **night)
            pids.update(runner.worker_pids())
            hooks = {NIGHTLY_HOOKED: RegressionHook(slowdown_s=NIGHTLY_SLOWDOWN_S)}
            night1 = run_nightly(store, hooks=hooks, **night)
            pids.update(runner.worker_pids())
            baselines = store.data
    finally:
        runner.close()
    alive = sorted(p for p in pids if _pid_alive(p))
    nights = []
    for night, rep in enumerate((night0, night1)):
        status = {i.benchmark: i.culprit for i in rep.issues if i.metric == "status"}
        others = [i.to_dict() for i in rep.issues if i.metric != "status"]
        nights.append((status, others))
        emit("nightly", night=night, card=smi, ran=rep.ran, wall_s=rep.wall_s,
             status_issues=status, issues=others, baselines=len(baselines),
             hook={NIGHTLY_HOOKED: NIGHTLY_SLOWDOWN_S} if night else {})
    hit = [i for i in nights[1][1]
           if i["benchmark"] == NIGHTLY_HOOKED and i["metric"] == "median_us"]
    false = [i for i in nights[1][1] if i["benchmark"] != NIGHTLY_HOOKED]
    emit("nightly_summary", card=smi, wall_s=time.perf_counter() - t0,
         injected_issue=hit, false_issues_clean_cells=len(false),
         false_issue_cells=sorted({i["benchmark"] for i in false}),
         worker_pids=sorted(pids), alive_after_close=alive)
    for night, (rep, (status, _)) in enumerate(zip((night0, night1), nights)):
        check(rep.ran == NIGHTLY_CELLS,
              f"nightly {night}: {rep.ran} of {NIGHTLY_CELLS} cells came back")
        check(not status, f"nightly {night}: status issues {status}")
    check(not nights[0][1], f"nightly 0 filed issues on its baseline night: {nights[0][1]}")
    check(len(baselines) == NIGHTLY_CELLS, f"nightly: {len(baselines)} baselines")
    check(bool(hit), f"nightly 1: the injected {NIGHTLY_HOOKED} slowdown was not filed")
    check(not alive, f"nightly: workers alive after close: {alive}")


# the suite steps of the coverage comparison: gemma-2b's, mamba2-2.7b's and
# recurrentgemma-9b's train and prefill steps (every kernel and backward
# kernel), whisper-large-v3's prefill
COVERAGE_SUITE = (("gemma-2b", "train"), ("gemma-2b", "infer_prefill"),
                  ("mamba2-2.7b", "train"), ("mamba2-2.7b", "infer_prefill"),
                  ("recurrentgemma-9b", "train"), ("recurrentgemma-9b", "infer_prefill"),
                  ("whisper-large-v3", "infer_prefill"))


def phase_coverage(smi):
    """API-surface coverage (``core.coverage.coverage_report``) of
    ``COVERAGE_SUITE``'s reduced steps (B=2, S=32) on the card and on the
    CPU: each step's torch API set and ATen op set must be the same on
    both devices (each kernel call one op, ``repro_torch.kernel::<name>``),
    every kernel of the suite must be in them, and the suite must cover
    more than 1.1x the gemma-2b sub-suite's torch API."""
    from repro_torch.core.coverage import coverage_report
    from repro_torch.core.suite import get_benchmark
    from repro_torch.kernels.accounting import SCOPE_PREFIX
    from repro_torch.runner import BenchmarkRunner
    t0 = time.perf_counter()
    benches = [get_benchmark(a, t) for a, t in COVERAGE_SUITE]
    reports = {dev: coverage_report(benches, runner=BenchmarkRunner(device=dev))
               for dev in ("cuda", "cpu")}
    card, cpu = reports["cuda"], reports["cpu"]
    diffs = {}
    for name, got in card["per_benchmark"].items():
        want = cpu["per_benchmark"][name]
        for key in ("primitives", "stablehlo_ops"):
            a, b = set(got[key]), set(want[key])
            if a != b:
                diffs[f"{name} {key}"] = {"card_only": sorted(a - b), "cpu_only": sorted(b - a)}
    kernels = sorted(op for op in card["union_primitives"] if op.startswith(SCOPE_PREFIX))
    emit("coverage", card=smi, wall_s=time.perf_counter() - t0,
         **{k: card[k] for k in ("suite_primitives", "suite_stablehlo_ops",
                                 "baseline_primitives", "baseline_stablehlo_ops",
                                 "coverage_x_primitives", "coverage_x_stablehlo")},
         cpu_coverage_x_primitives=cpu["coverage_x_primitives"],
         per_benchmark={n: [d["n_primitives"], d["n_stablehlo_ops"]]
                        for n, d in card["per_benchmark"].items()},
         kernels=kernels, card_cpu_differences=diffs)
    check(not diffs, f"coverage: the card's surfaces differ from the CPU's: {diffs}")
    check(kernels == [SCOPE_PREFIX + k for k in ("flash_attention", "flash_attention_bwd",
                                                 "rglru", "rglru_bwd", "ssd", "ssd_bwd")],
          f"coverage: kernels {kernels}")
    # each backward kernel one op of its train step's torch API and ATen
    # sets on both devices
    for arch, op in (("mamba2-2.7b", "ssd_bwd"), ("recurrentgemma-9b", "rglru_bwd")):
        for dev, rep in reports.items():
            for key in ("primitives", "stablehlo_ops"):
                check(SCOPE_PREFIX + op in rep["per_benchmark"][f"{arch}/train"][key],
                      f"coverage: {arch}/train's {key} on {dev} lack {op}")
    check(card["coverage_x_primitives"] > 1.1,
          f"coverage: {card['coverage_x_primitives']} x the gemma-2b sub-suite")


# clean profiled measures of each profiled cell: five for the two cells
# whose spread sets ``ci_full``'s bisection gate (with two, host noise put
# the gate under the spread and bisection blamed c00), three for the
# others, cut from five for the script's time limit
NOISE_RUNS_CI = 5
NOISE_RUNS = 3


def _run_metrics(meas, extra):
    """What ``detect`` reads of one measure, and what the noise phase reads
    of its profile (``extra``, when it was profiled)."""
    return {"median_us": meas.median_us, "host_peak_bytes": meas.host_peak_bytes,
            "device_bytes_delta": meas.device_bytes_delta,
            **{k: extra[k] for k in ("prof_dispatch_us_mean", "prof_device_us_mean")
               if k in extra}}


def _noise(name, task, runs, perf, wall_s):
    """One ``noise`` line for a profiled cell: min, median and max over
    ``runs`` (``NOISE_RUNS`` or ``NOISE_RUNS_CI`` clean measures, separate
    ``measure`` calls) of
    its median and of its exposed host and device busy time per step;
    ``spread_rel`` = max / min - 1 of the medians, the largest increase
    ``detect`` could see between two of them; and how many of the clean
    re-runs ``runs[1:]`` ``detect`` at ``THRESHOLD`` flags against
    ``runs[0]`` (reported, not gated)."""
    import tempfile
    from repro_torch.core.regression import METRICS, THRESHOLD, MetricStore, detect

    def spread(key):
        v = sorted(r[key] for r in runs)
        return {"min": v[0], "median": v[len(v) // 2], "max": v[-1]}

    with tempfile.TemporaryDirectory() as d:
        store = MetricStore(os.path.join(d, "metrics.json"))
        store.update(name, {k: runs[0][k] for k in METRICS if k in runs[0]})
        flagged = [[i.metric for i in detect(store, name, r)] for r in runs[1:]]
    med = spread("median_us")
    rel = med["max"] / med["min"] - 1.0
    dev = spread("prof_device_us_mean")
    line = dict(cell=name, task=task, compiled=False, runs=len(runs), median_us=med,
                prof_dispatch_us_mean=spread("prof_dispatch_us_mean"),
                prof_device_us_mean=dev, spread_rel=rel,
                device_spread_rel=dev["max"] / dev["min"] - 1.0 if dev["min"] else None,
                threshold=THRESHOLD, threshold_exceeds_spread=THRESHOLD > rel,
                false_issues=sum(bool(f) for f in flagged),
                false_median_issues=sum("median_us" in f for f in flagged),
                flagged_metrics=flagged, medians_us=[r["median_us"] for r in runs],
                wall_s=wall_s)
    emit("noise", **line)
    perf["noise"].append(line)
    perf["walls"]["noise"] += wall_s
    return dict(med, base=next(r for r in runs if r["median_us"] == med["median"]))


def _ci_full(name, measure, med, perf, bisect=False):
    """The perf-CI flow at full width on one cell (the paper's Tables 4-5
    pattern): the baseline is the clean run of median median (``med``,
    from the noise phase) in a ``MetricStore``; a ``RegressionHook``
    slowdown of 3x the larger of the cell's spread and the 7% gate must be
    filed as a ``median_us`` issue, and a 64 MiB leak on the card per timed
    step as a ``device_bytes_delta`` issue.  With ``bisect``: 12 commits,
    each ``run`` a real measure, the slowdown from ``c08`` on, bisected at
    a gate above the cell's spread (1.5x it, at least ``THRESHOLD``); the
    culprit must be ``c08`` within ceil(log2 12) + 1 measures.
    ``measure(hook)`` -> the metrics of one measure of the cell."""
    import math
    import tempfile
    from repro_torch.core.harness import RegressionHook
    from repro_torch.core.regression import (THRESHOLD, Commit, MetricStore,
                                             bisect_commits, detect)
    t0 = time.perf_counter()
    base, spread_us = med["base"], med["max"] - med["min"]
    slowdown_s = 3 * max(spread_us, THRESHOLD * base["median_us"]) * 1e-6
    with tempfile.TemporaryDirectory() as d:
        store = MetricStore(os.path.join(d, "metrics.json"))
        store.update(name, {k: base[k] for k in ("median_us", "host_peak_bytes",
                                                  "device_bytes_delta")})
        slow = measure(RegressionHook(slowdown_s=slowdown_s))
        slow_issues = detect(store, name, slow)
        leak = measure(RegressionHook(leak_bytes=1 << 26, device="cuda"))
        leak_issues = detect(store, name, leak)
    line = dict(cell=name, compiled=False, baseline=base, spread_us=spread_us,
                slowdown_s=slowdown_s,
                slowdown_over_spread=slowdown_s * 1e6 / spread_us if spread_us else None,
                slowed_median_us=slow["median_us"],
                slow_issues=[i.to_dict() for i in slow_issues],
                leak_device_bytes_delta=leak["device_bytes_delta"],
                leak_issues=[i.to_dict() for i in leak_issues])
    culprit = trace = None
    if bisect:
        threshold = max(THRESHOLD, 1.5 * spread_us / base["median_us"])
        hook = RegressionHook(slowdown_s=slowdown_s)
        commits = [Commit(sha=f"c{i:02d}", timestamp=i,
                          run=lambda bench, bad=i >= 8: measure(hook if bad else None))
                   for i in range(12)]
        trace = []
        culprit = bisect_commits(commits, name, "median_us", base["median_us"],
                                 threshold=threshold, trace=trace)
        line.update(bisect_threshold=threshold, bisect_trace=trace,
                    culprit=culprit and culprit.sha, measures=len(trace))
    line["wall_s"] = time.perf_counter() - t0
    emit("ci_full", **line)
    perf["ci_full"].append(line)
    perf["walls"]["ci_full"] += line["wall_s"]
    check(any(i.metric == "median_us" for i in slow_issues),
          f"ci_full {name}: a {slowdown_s} s slowdown was not filed: {slow}")
    check(any(i.metric == "device_bytes_delta" for i in leak_issues),
          f"ci_full {name}: the 64 MiB leak a step was not filed: {leak}")
    if bisect:
        check(culprit is not None and culprit.sha == "c08"
              and len(trace) <= math.ceil(math.log2(12)) + 1,
              f"ci_full {name}: bisection found {culprit and culprit.sha} in {trace}")

def _stub_inputs(cfg, batch):
    """The vlm family's ``patch_embeds`` and the encdec family's
    ``frames`` for ``batch`` rows, from numpy seed 2 (as the suite draws
    them), on the CPU."""
    import numpy as np
    import torch
    rng = np.random.default_rng(2)
    out = {}
    if cfg.family == "encdec":
        out["frames"] = rng.standard_normal((batch, cfg.enc_seq, cfg.d_model)) * 0.1
    if cfg.family == "vlm":
        out["patch_embeds"] = rng.standard_normal((batch, cfg.n_prefix, cfg.d_model)) * 0.02
    return {k: torch.from_numpy(v.astype(np.float32)) for k, v in out.items()}


def phase_reference_check(arch, seq=24, max_len=32, prompt_len=16):
    """The kernel path against the plain path on a small input: the same
    reduced weights (fp32 compute) on the card and on the CPU give logits
    within 1e-4 and equal greedy serve tokens (bimodal prompts of
    ``prompt_len`` / 2 and 2 x ``prompt_len`` tokens; both engines
    uncompiled).  The vlm family's cache holds its patch prefix besides
    ``max_len``."""
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.core.suite import Built
    from repro_torch.launch.serve import ServeEngine, summarize_metrics
    from repro_torch.models import build_model
    from repro_torch.runner.traces import TraceSpec, cache_len_bound, generate
    cfg = get_arch(arch).reduced(compute_dtype=torch.float32)
    cpu = build_model(cfg, device="cpu", seed=0)
    gpu = copy.deepcopy(cpu).to("cuda")
    prefix = cfg.n_prefix if cfg.family == "vlm" else 0
    batch = {"tokens": torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, seq)).astype(np.int32)), **_stub_inputs(cfg, 2)}
    lc, _ = cpu.prefill(batch, cpu.init_cache(2, max_len + prefix))
    lg, _ = gpu.prefill({k: v.cuda() for k, v in batch.items()},
                        gpu.init_cache(2, max_len + prefix))
    err = (lg.cpu() - lc).abs().max().item()
    reqs = generate(TraceSpec(profile="bursty", requests=8, prompt_len=prompt_len,
                              max_new=8, prompt_profile="bimodal"), vocab=cfg.vocab)
    serve_max_len = cache_len_bound(reqs, prefix=prefix)
    digests = {}
    for name, model in (("cpu", cpu), ("cuda", gpu)):
        eng = ServeEngine(Built(cfg, model), slots=4, max_len=serve_max_len, compiled=False)
        digests[name] = summarize_metrics(eng.run(reqs))["tokens_digest"]
    emit("reference_check", arch=arch, prompt=seq, max_len=max_len + prefix,
         serve_prompt_lens=sorted({len(r.prompt) for r in reqs}),
         serve_max_len=serve_max_len, local_window=cfg.local_window,
         logits_max_abs_err=err, tol=1e-4,
         digest_cpu=digests["cpu"], digest_cuda=digests["cuda"])
    check(err <= 1e-4, f"{arch}: card vs CPU logits differ by {err}")
    check(digests["cpu"] == digests["cuda"], f"{arch}: card vs CPU serve tokens differ")


def phase_serve_compiled_reduced(smi):
    """The serve engine compiled (TorchInductor) against uncompiled on the
    card at reduced fp32 gemma-2b and mamba2-2.7b (TF32 off; mamba2's
    admission runs the SSD op inside a compiled graph), on
    ``phase_reference_check``'s serve trace (``_serve_compiled_reduced``)."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.core.suite import Built
    from repro_torch.models import build_model
    from repro_torch.runner.traces import TraceSpec, cache_len_bound, generate
    for arch in ("gemma-2b", "mamba2-2.7b"):
        cfg = get_arch(arch).reduced(compute_dtype=torch.float32)
        reqs = generate(TraceSpec(profile="bursty", requests=8, prompt_len=16, max_new=8,
                                  prompt_profile="bimodal"), vocab=cfg.vocab)
        _serve_compiled_reduced(arch, Built(cfg, build_model(cfg, device="cuda", seed=0)),
                                reqs, cache_len_bound(reqs), smi)


def _serve_launches():
    """Each kernel's launches by variant since the last ``_reset_counts``."""
    return {"flash_attention": _read_variants(), "ssd": _read_ssd_variants(),
            "rglru": _read_rglru_variants()}


def _serve_pair(built, reqs, max_len, slots=4):
    """``ServeEngine`` on ``built`` compiled and uncompiled over ``reqs``,
    each engine a warm replay (the compiles) and a counted one: per way the
    engine, its counted replay's metrics, its launches by variant, the
    first decode step's logits over the first wave (``_first_wave``),
    Dynamo's graphs and breaks of its warm replay, the seconds compiled
    (``compile_budget``), the warm replay's wall and the counted replay's
    ``admit_new_shapes``; for the compiled way also the first decode
    step's logits from the uncompiled engine's admitted state and tokens
    (``logits_same_state``), its admission's largest difference from that
    state, and whether the first tokens agree."""
    import torch
    from repro_torch.core.harness import clone_tree, compile_budget, dynamo_counts
    from repro_torch.launch.serve import ServeEngine, summarize_metrics
    got = {}
    for compiled in (True, False):
        engine = ServeEngine(built, slots=slots, max_len=max_len, compiled=compiled)
        c0, b0 = dynamo_counts(), compile_budget()
        t0 = time.perf_counter()
        engine.run(reqs)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        c1, b1 = dynamo_counts(), compile_budget()
        _reset_counts()
        out = engine.run(reqs)
        torch.cuda.synchronize()
        launches = _serve_launches()
        got[compiled] = dict(engine=engine, metrics=summarize_metrics(out), out=out,
                             launches=launches, dynamo=_dynamo_delta(c0, c1),
                             compile_s=b1["seconds"]["total"] - b0["seconds"]["total"],
                             fxgraph_cache={k: b1["fxgraph_cache"][k] - b0["fxgraph_cache"][k]
                                            for k in b1["fxgraph_cache"]},
                             warm_s=warm_s, new_shapes=out["admit_new_shapes"])
    # the first decode step over the trace's first wave: each engine from
    # its own admission, and the compiled step from the uncompiled
    # engine's admitted state and tokens
    c, u = got[True], got[False]
    u_toks = _first_wave(u["engine"], reqs)
    admitted = clone_tree(u["engine"].cache)
    u["logits"] = u["engine"]._decode(u_toks).float()
    c_toks = _first_wave(c["engine"], reqs)
    c["admission_cache_err"] = max(
        float((a.float() - b.float()).abs().max())
        for (_, a), (_, b) in zip(_leaves(c["engine"].cache), _leaves(admitted)))
    c["first_tokens_equal"] = bool(torch.equal(c_toks, u_toks))
    c["logits"] = c["engine"]._decode(c_toks).float()
    c["engine"].cache = clone_tree(admitted)
    c["logits_same_state"] = c["engine"]._decode(u_toks).float()
    for g in (c, u):
        g["engine"]._reset()
    return got


def _first_wave(engine, reqs):
    """Reset ``engine`` and admit ``reqs``' first wave (its first ``slots``
    requests by arrival) as ``run()`` would; returns the first tokens, a
    (slots, 1) tensor for the first decode step."""
    import numpy as np
    import torch
    engine._reset()
    first = sorted(reqs, key=lambda r: (r.arrival_step, r.rid))[: engine.slots]
    toks = np.zeros(engine.slots, np.int32)
    toks[: len(first)] = engine._admit_wave(list(enumerate(first)))
    # contiguous, as run()'s: another stride would be another graph
    return torch.from_numpy(toks[:, None].copy()).to(engine.device)


def _serve_compiled_reduced(arch, built, reqs, max_len, smi):
    """The reduced fp32 serve cell of ``phase_reference_check`` on the card
    compiled (TorchInductor) against uncompiled: equal token digests, the
    first decode step's logits within ``COMPILED_TOL["fp32"]``, equal
    launches by variant, no graph break, and a replay that compiles
    nothing."""
    got = _serve_pair(built, reqs, max_len)
    c, u = got[True], got[False]
    err = float((c["logits"] - u["logits"]).abs().max())
    emit("serve_compiled_reduced", arch=arch, dtype="fp32", tf32=False, card=smi,
         logits_same_state_err=float((c["logits_same_state"] - u["logits"]).abs().max()),
         admission_cache_err=c["admission_cache_err"],
         first_tokens_equal=c["first_tokens_equal"],
         compiled_digest=c["metrics"]["tokens_digest"],
         uncompiled_digest=u["metrics"]["tokens_digest"], logits_max_abs_err=err,
         tol=COMPILED_TOL["fp32"], launches_compiled=c["launches"],
         launches_uncompiled=u["launches"], admit_shapes=c["out"]["admit_shapes"],
         compile_s=c["compile_s"], fxgraph_cache=c["fxgraph_cache"], warm_s=c["warm_s"],
         replay_new_shapes=c["new_shapes"], **c["dynamo"])
    check(c["metrics"]["tokens_digest"] == u["metrics"]["tokens_digest"],
          f"{arch}: compiled serve tokens differ from the uncompiled engine's")
    check(err <= COMPILED_TOL["fp32"], f"{arch}: compiled serve logits differ by {err}")
    check(c["launches"] == u["launches"], f"{arch}: compiled serve launches "
          f"{c['launches']}, uncompiled {u['launches']}")
    check(c["dynamo"]["graph_breaks"] == 0 and c["dynamo"]["graphs"] > 0
          and c["new_shapes"] == 0, f"{arch}: compiled serve graphs {c['dynamo']}, "
          f"{c['new_shapes']} compiled in the replay")


def _train_launches(cfg):
    """Each kernel's launches in one train step of ``cfg``: per attention
    call (the encdec family's encoder, decoder self and cross attention),
    per Mamba-2 layer and per RG-LRU layer one backward launch, and two
    forward launches under ``remat`` "full" or "dots" (the forward again
    in the backward; the kernels' custom ops are recomputed under both),
    one under "none"."""
    from repro_torch.models.model import _hybrid_split
    n = cfg.n_layers
    if cfg.family == "ssm":
        per = {"ssd": n}
    elif cfg.family == "hybrid":
        groups, tail = _hybrid_split(cfg)
        per = {"rglru": groups * cfg.pattern_rec + tail, "flash_attention": groups}
    elif cfg.family == "encdec":
        per = {"flash_attention": cfg.n_enc_layers + 2 * n}
    else:
        per = {"flash_attention": n}
    forward = 1 if cfg.remat == "none" else 2
    out = dict.fromkeys(_counters(), 0)
    for kernel, calls in per.items():
        out[kernel], out[f"{kernel}_bwd"] = forward * calls, calls
    return out


def phase_train_reference_check(arch="gemma-2b", steps=2, batch=2, seq=24, moments_tol=1e-4):
    """Training on the card against the CPU: the same reduced ``arch``
    weights (fp32 compute), the suite's train step (uncompiled) twice on
    each (the same numpy tokens, patch embeddings or frames), then loss
    and grad_norm within 1e-4 relative, mu and nu within ``moments_tol``
    of each leaf's largest |value| (1e-4; recurrentgemma 5e-4, the bound
    its CPU step holds against the reference: the gate and decay
    gradients sum in other orders), params within 1e-4 absolute (the
    default schedule's lr is 3e-6 and 6e-6 here); on the card every
    kernel launched as ``_train_launches`` counts (each backward op once
    per layer per step), every backward through its fp32 variant."""
    import numpy as np
    import torch
    from repro_torch.bridge import opt_state_to_numpy, params_to_numpy
    from repro_torch.configs import get_arch
    from repro_torch.core.suite import Built, get_benchmark
    from repro_torch.models import build_model
    cfg = get_arch(arch).reduced(compute_dtype=torch.float32)
    cpu = build_model(cfg, device="cpu", seed=0)
    runs = {}
    for name, model in (("cpu", cpu), ("cuda", copy.deepcopy(cpu).to("cuda"))):
        step, (state, inputs), _ = get_benchmark(arch, "train").make(
            batch=batch, seq=seq, built=Built(cfg, model))
        _reset_counts()
        metrics = []
        for _ in range(steps):
            state, m = step(state, inputs)
            metrics.append({k: float(v) for k, v in m.items()})
        runs[name] = (metrics, _read_counts(), params_to_numpy(state[0]),
                      opt_state_to_numpy(state[1]))
        # the card's run is the last
        bwd_variants, scan_bwd_variants = _read_bwd_variants(), _read_scan_bwd_variants()
    (mc, _, pc, oc), (mg, counts, pg, og) = runs["cpu"], runs["cuda"]
    rel = lambda a, b: abs(a - b) / abs(b)   # noqa: E731
    leaf_err = lambda got, want: max(   # noqa: E731
        float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30))
        for (_, g), (_, w) in zip(_leaves(got), _leaves(want)))
    want = {k: steps * v for k, v in _train_launches(cfg).items()}
    res = dict(arch=arch, family=cfg.family, steps=steps, batch=batch, seq=seq, tol=1e-4,
               moments_tol=moments_tol,
               loss_cpu=[m["loss"] for m in mc], loss_cuda=[m["loss"] for m in mg],
               loss_rel_err=max(rel(g["loss"], c["loss"]) for g, c in zip(mg, mc)),
               grad_norm_rel_err=max(rel(g["grad_norm"], c["grad_norm"]) for g, c in zip(mg, mc)),
               params_max_abs_err=max(float(np.abs(g - w).max())
                                      for (_, g), (_, w) in zip(_leaves(pg), _leaves(pc))),
               mu_rel_err=leaf_err(og["mu"], oc["mu"]), nu_rel_err=leaf_err(og["nu"], oc["nu"]),
               kernel_launches_cuda=counts, expected_launches_cuda=want,
               bwd_launches_by_variant_cuda=bwd_variants,
               scan_bwd_launches_by_variant_cuda=scan_bwd_variants)
    emit("train_reference_check", **res)
    # fp32 compute: the flash backward's CUDA-core variant
    check(counts == want and bwd_variants == {"tc": 0, "simt": want["flash_attention_bwd"]}
          and scan_bwd_variants == {"ssd_bwd": {"simt": want["ssd_bwd"]},
                                    "rglru_bwd": {"seq": want["rglru_bwd"]}},
          f"train reference check {arch}: launches {counts} (expected {want}), flash "
          f"backward by variant {bwd_variants}, scan backward {scan_bwd_variants}")
    check(max(res["loss_rel_err"], res["grad_norm_rel_err"], res["params_max_abs_err"]) <= 1e-4
          and max(res["mu_rel_err"], res["nu_rel_err"]) <= moments_tol,
          f"training {arch} on the card differs from the CPU: {res}")


# finer kernel classes of a profile than the profiler's op classes, by
# substrings of the kernels' names (the first class that matches takes the
# kernel; the rest is "other")
FORWARD_CLASSES = (("flash_fwd", ("fa_tc_kernel", "fa_kernel<", "fa_split", "fa_decode_combine")),
                   ("ssd", ("ssd_",)), ("rglru", ("rglru_",)),
                   ("matmul_cublas", ("gemm", "xmma", "nvjet", "cutlass", "sm90_")),
                   ("casts_copies", ("copy", "Copy")))
TRAIN_CLASSES = (("flash_bwd_lse_delta", ("fa_bwd_lse", "fa_bwd_tc_lse")),
                 ("flash_bwd_dk_dv", ("fa_bwd_dkv", "fa_bwd_tc_dkv")),   # the pass and its combine
                 ("flash_bwd_dq", ("fa_bwd_dq", "fa_bwd_tc_dq")),
                 ("ssd_bwd", ("ssd_bwd_",)), ("rglru_bwd", ("rglru_bwd_",)),
                 FORWARD_CLASSES[0], FORWARD_CLASSES[1], FORWARD_CLASSES[2], FORWARD_CLASSES[3],
                 ("adamw_foreach", ("multi_tensor_apply", "foreach")),
                 FORWARD_CLASSES[4])


def _device_ms_by_class(kernels, subclasses, per=1):
    """Device ms of profiled ``kernels``, divided by ``per``: by the
    profiler's op class (``hloanalysis.op_class``, as
    ``trace_device_time`` classes a trace) and by the finer
    ``subclasses``."""
    from repro_torch.core.hloanalysis import OP_CLASSES, op_class
    by_class = dict.fromkeys(OP_CLASSES, 0.0)
    by_sub = dict.fromkeys([c for c, _ in subclasses] + ["other"], 0.0)
    for e in kernels:
        ms = e.self_device_time_total / 1e3 / per
        by_class[op_class(e.key)] += ms
        by_sub[next((c for c, keys in subclasses if any(k in e.key for k in keys)), "other")] += ms
    return by_class, by_sub


def _profile_train_step(call, arch="gemma-2b"):
    """Device time of one train step by kernel class (``torch.profiler``):
    flash forward and backward (by pass), the SSD and RG-LRU forward and
    backward, cuBLAS matmuls, the AdamW ``foreach`` kernels, casts and
    copies, the rest; and the top kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    by_class, by_sub = _device_ms_by_class(kernels, TRAIN_CLASSES)
    dev_ms = sum(by_class.values())
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
    emit("profile_train_step_full", arch=arch, wall_ms_profiled=wall_ms,
         device_ms=dev_ms if dev_ms else "not measured",
         device_busy_share=dev_ms / wall_ms if dev_ms else "not measured",
         device_ms_by_class=by_class, device_ms_by_subclass=by_sub,
         share_by_class={k: v / dev_ms for k, v in by_class.items()} if dev_ms else {},
         share_by_subclass={k: v / dev_ms for k, v in by_sub.items()} if dev_ms else {},
         top_kernels=[dict(name=e.key[:80], calls=e.count, ms=e.self_device_time_total / 1e3)
                      for e in top])


# gemma-2b's train_full run at full width and a cut depth, for the script's
# time limit (18 layers before the compiler phases).  The compilers phase
# trains all 18, eager and compiled, and holds there what this phase held
# at full depth: each way's peak under TRAIN_MEMORY_LIMIT and a falling loss
TRAIN_FULL_LAYERS = 2


def phase_train_full(profiles, perf, arch="gemma-2b", batch=1, seq=2048):
    """``arch`` trained at its full published width through the suite's
    train step (``jit_donated``: the state updated in place), random
    weights from seed 0.  The main path is one train step, with every
    launch count set to 0 just before it and read just after: 36 forward
    launches (18 layers, each recomputed once under ``remat="full"``), all
    ``tc``, and 18 backward launches, all ``tc``.  Then ``harness.measure`` (median of
    5 after a warmup), a profile of one step, four steps of a schedule
    with one warmup step on the same batch (the loss must fall), and the
    peak device memory.  The train cell's profile (``profile_cell_full``,
    its record added to ``profiles``): ``harness.measure(phase_log=...)``
    over 3 more steps, and the step's op-class cost with the state
    restored after it (a host copy of the 30 GB of weights and moments);
    after the checks, ``NOISE_RUNS - 1`` more profiled measures, the state
    threaded on, for the cell's ``noise`` line."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.core import harness
    from repro_torch.core.suite import get_benchmark
    from repro_torch.launch import serve
    from repro_torch.launch.steps import TrainHyper, make_train_step
    from repro_torch.core.hloanalysis import analyze_step
    from repro_torch.profiler.attribution import profile_extra
    cfg = dataclasses.replace(get_arch(arch), n_layers=TRAIN_FULL_LAYERS)
    left = _free_card()
    check(left < 1e9, f"{arch} train: {left} bytes still allocated before the phase")
    torch.cuda.reset_peak_memory_stats()
    built = serve.built_for_cfg(cfg)
    step, args, mutable = get_benchmark(arch, "train").make(batch=batch, seq=seq, built=built)
    losses = []

    def recorded(state, tokens):
        out = step(state, tokens)
        losses.append(out[1]["loss"])
        return out

    fn = harness.prepare(recorded, (0,), mutable=mutable)
    model = args[0][0]
    probe = model.blocks[0].attn["wq"][0, 0].detach().clone()
    _reset_counts()                      # main path: one train step
    state, metrics = fn(*args)
    torch.cuda.synchronize()
    counts, variants, bwd_variants = _read_counts(), _read_variants(), _read_bwd_variants()
    n = cfg.n_layers
    want = {"flash_attention": 2 * n, "flash_attention_bwd": n, "ssd": 0, "rglru": 0,
            "ssd_bwd": 0, "rglru_bwd": 0}
    want_variants = {"tc": 2 * n, "split": 0, "simt": 0}
    want_bwd_variants = {"tc": n, "simt": 0}
    args = (state, args[1])
    final = []
    meas = harness.measure(f"{arch}/train/b{batch}/s{seq}/fp32/jit_donated", recorded, args,
                           (0,), runs=5, warmup=1, jitted=fn, final_args=final)
    args = final[0]

    def one_step():
        nonlocal args
        args = (fn(*args)[0], args[1])

    _profile_train_step(one_step)
    log, trace, final = [], {}, []
    t_prof = time.perf_counter()
    prof_meas = harness.measure(f"{arch}/train/b{batch}/s{seq}/full/jit_donated", recorded,
                                args, (0,), runs=3, warmup=0, jitted=fn, final_args=final,
                                phase_log=log, device_trace=trace, device="cuda")
    args = final[0]
    cost = analyze_step(fn, args, (0,))
    name = f"{arch}/train/b{batch}/s{seq}/full/jit_donated"
    extra = profile_extra(log, cost, device_trace=trace, device="cuda")
    _profile_record(name, "train", extra,
                    meas.median_us, prof_meas.median_us, profiles, compile_us=meas.compile_us,
                    wall_s=time.perf_counter() - t_prof, arch=arch, batch=batch, seq=seq,
                    trace=trace, kernel_calls=cost.notes)
    changed = not torch.equal(probe, model.blocks[0].attn["wq"][0, 0])
    all_finite = all(bool(torch.isfinite(x).item()) for x in losses)
    fast = make_train_step(cfg, TrainHyper(warmup_steps=1))
    state, tokens = args
    repeated = []
    for _ in range(4):
        state, m = fast(state, tokens)
        repeated.append(float(m["loss"]))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    emit("train_full", arch=arch, batch=batch, seq=seq, mode="jit_donated", compiled=False,
         median_us=meas.median_us, p10_us=meas.p10_us, p90_us=meas.p90_us,
         tokens_per_s=batch * seq / (meas.median_us * 1e-6),
         kernel_launches_per_step=counts, expected_launches_per_step=want,
         flash_launches_by_variant=variants, expected_flash_launches_by_variant=want_variants,
         bwd_launches_by_variant=bwd_variants, expected_bwd_launches_by_variant=want_bwd_variants,
         losses=[float(x) for x in losses], steps=len(losses), all_losses_finite=all_finite,
         params_changed=changed, repeated_batch_losses=repeated,
         max_memory_allocated=peak, limit=TRAIN_MEMORY_LIMIT,
         param_bytes=sum(p.numel() * p.element_size() for p in model.parameters()))
    check(counts == want, f"{arch} train: launches {counts} in one step, expected {want}")
    check(variants == want_variants,
          f"{arch} train: flash launches by variant {variants}, expected {want_variants}")
    check(bwd_variants == want_bwd_variants, f"{arch} train: backward launches by variant "
          f"{bwd_variants}, expected {want_bwd_variants}")
    check(all_finite and changed, f"{arch} train: losses {losses}, params changed {changed}")
    check(repeated[-1] < repeated[0], f"{arch} train: loss did not fall on one batch: {repeated}")
    check(peak < TRAIN_MEMORY_LIMIT, f"{arch} train: peak device memory {peak} bytes")
    # the noise runs after the checks, which read the loss of the steps
    # above: their steps train the state on (unrecorded), as a nightly
    # re-run would, and the step's work does not depend on the values
    runs = [_run_metrics(prof_meas, extra)]
    args = (state, tokens)
    t_noise = time.perf_counter()
    for _ in range(NOISE_RUNS - 1):
        log, trace, final = [], {}, []
        m = harness.measure(name, step, args, (0,), runs=3, warmup=0, final_args=final,
                            phase_log=log, device_trace=trace, device="cuda")
        args = final[0]
        runs.append(_run_metrics(m, profile_extra(log, cost, device_trace=trace,
                                                  device="cuda")))
    _noise(name, "train", runs, perf, time.perf_counter() - t_noise)
    del built, step, args, fn, model, state, fast
    _free_card()
    return counts, bwd_variants


def phase_train_full_family(arch, cfg, smi, batch=1, seq=2048, runs=2):
    """``arch`` trained at its full published width (``cfg``: its depth cut
    or not) through the suite's train step, eager (uncompiled; the state
    updated in place), random weights from seed 0, B=1 S=2048 (the vlm
    family's 256 patch positions ahead of the tokens, the encdec family's
    1,500 frames encoded under the loss).  The main path is one train
    step, with every launch count set to 0 just before it and read just
    after: ``_train_launches(cfg)`` (each backward op once per layer), the
    bf16 flash calls through the tensor-core variants.  Then
    ``harness.measure`` (median of ``runs`` after a warmup), a profiled
    step's device time by class (``profile_train_step_full``) and the peak
    device memory, under ``TRAIN_MEMORY_LIMIT``."""
    import torch
    from repro_torch.core import harness
    from repro_torch.core.suite import get_benchmark
    from repro_torch.launch import serve
    left = _free_card()
    check(left < 1e9, f"{arch} train: {left} bytes still allocated before the phase")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    built = serve.built_for_cfg(cfg)
    step, args, mutable = get_benchmark(arch, "train").make(batch=batch, seq=seq, built=built)
    del built          # the state holds its own copy of the weights
    fn = harness.prepare(step, (0,), mutable=mutable)
    model = args[0][0]
    param_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    probe = next(model.parameters()).detach().flatten()[:64].clone()
    _reset_counts()                      # main path: one train step
    state, metrics = fn(*args)
    torch.cuda.synchronize()
    counts, variants = _read_counts(), _read_variants()
    bwd_variants, scan_bwd = _read_bwd_variants(), _read_scan_bwd_variants()
    ssd_variants, rglru_variants = _read_ssd_variants(), _read_rglru_variants()
    want = _train_launches(cfg)
    want_variants = {"tc": want["flash_attention"], "split": 0, "simt": 0}
    want_bwd = {"tc": want["flash_attention_bwd"], "simt": 0}
    want_scan_bwd = {"ssd_bwd": {"simt": want["ssd_bwd"]}, "rglru_bwd": {"seq": want["rglru_bwd"]}}
    want_ssd = {"tc": want["ssd"], "simt": 0}
    losses = [float(metrics["loss"])]
    args = (state, args[1])
    final = []
    meas = harness.measure(f"{arch}/train/b{batch}/s{seq}/full/eager", step, args, (0,),
                           runs=runs, warmup=1, jitted=fn, final_args=final)
    args = final[0]

    def one_step():
        nonlocal args
        out = fn(*args)
        losses.append(float(out[1]["loss"]))
        args = (out[0], args[1])

    _profile_train_step(one_step, arch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    changed = not torch.equal(probe, next(model.parameters()).detach().flatten()[:64])
    emit("train_full", arch=arch, family=cfg.family, n_layers=cfg.n_layers,
         n_enc_layers=cfg.n_enc_layers or None, batch=batch, seq=seq, mode="eager",
         compiled=False, card=smi, median_us=meas.median_us, p10_us=meas.p10_us,
         p90_us=meas.p90_us, tokens_per_s=batch * seq / (meas.median_us * 1e-6),
         kernel_launches_per_step=counts, expected_launches_per_step=want,
         flash_launches_by_variant=variants, bwd_launches_by_variant=bwd_variants,
         scan_bwd_launches_by_variant=scan_bwd, ssd_launches_by_variant=ssd_variants,
         rglru_launches_by_variant=rglru_variants, losses=losses,
         params_changed=changed, max_memory_allocated=peak, limit=TRAIN_MEMORY_LIMIT,
         param_bytes=param_bytes, state_bytes=4 * param_bytes,
         wall_s=time.perf_counter() - t0)
    check(counts == want, f"{arch} train: launches {counts} in one step, expected {want}")
    check(variants == want_variants and bwd_variants == want_bwd and scan_bwd == want_scan_bwd
          and ssd_variants == want_ssd and sum(rglru_variants.values()) == want["rglru"],
          f"{arch} train: launches by variant: flash {variants}, backward {bwd_variants}, "
          f"scans' backward {scan_bwd}, SSD {ssd_variants}, RG-LRU {rglru_variants}")
    check(all(math.isfinite(x) for x in losses) and changed,
          f"{arch} train: losses {losses}, params changed {changed}")
    check(peak < TRAIN_MEMORY_LIMIT, f"{arch} train: peak device memory {peak} bytes "
          f"(limit {TRAIN_MEMORY_LIMIT:.0f})")
    del step, args, fn, model, state, metrics
    _free_card()
    return counts, scan_bwd


def _counters():
    """Each kernel wrapper, whose ``launches`` counts its kernel's launches."""
    from repro_torch.kernels.flash_attention.kernel import (flash_attention_bwd_cuda,
                                                            flash_attention_cuda)
    from repro_torch.kernels.rglru.kernel import rglru_bwd_cuda, rglru_cuda
    from repro_torch.kernels.ssd.kernel import ssd_bwd_cuda, ssd_cuda
    return {"flash_attention": flash_attention_cuda,
            "flash_attention_bwd": flash_attention_bwd_cuda, "ssd": ssd_cuda,
            "rglru": rglru_cuda, "ssd_bwd": ssd_bwd_cuda, "rglru_bwd": rglru_bwd_cuda}


def _reset_counts():
    for fn in _counters().values():
        fn.launches = 0
        for name in fn.launches_by_variant:
            fn.launches_by_variant[name] = 0


def _read_counts():
    return {name: fn.launches for name, fn in _counters().items()}


def _read_variants():
    """Flash-attention launches by variant (tc, split, simt)."""
    return dict(_counters()["flash_attention"].launches_by_variant)


def _read_bwd_variants():
    """Flash-attention backward launches by variant (tc, simt)."""
    return dict(_counters()["flash_attention_bwd"].launches_by_variant)


def _read_ssd_variants():
    """SSD launches by variant (tc, simt)."""
    return dict(_counters()["ssd"].launches_by_variant)


def _read_rglru_variants():
    """RG-LRU launches by variant (seq, chunked)."""
    return dict(_counters()["rglru"].launches_by_variant)


def _read_scan_bwd_variants():
    """The SSD and RG-LRU backward launches by variant."""
    return {k: dict(_counters()[k].launches_by_variant) for k in ("ssd_bwd", "rglru_bwd")}


def phase_profile(arch, model, steps=5):
    """Where a full-width decode step's time goes, at the serve run's
    shape (4 slots, positions ~130 of a 144-token cache, past the vlm
    family's patch prefix): wall per step without the profiler, device
    time per step and its top kernels from ``torch.profiler`` (device busy
    share = device time / wall)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    cfg = model.cfg
    cache = model.init_cache(4, 144 + (cfg.n_prefix if cfg.family == "vlm" else 0))
    g = torch.Generator().manual_seed(0)
    toks = torch.randint(0, cfg.vocab, (4, 128), generator=g,
                         dtype=torch.int32).cuda()
    stubs = {k: v.cuda() for k, v in _stub_inputs(cfg, 4).items()}
    model.prefill({"tokens": toks, **stubs}, cache)
    one = toks[:, :1].contiguous()

    def decode_steps():
        for _ in range(steps):
            logits, _ = model.decode_step(one, cache)
            logits[:, 0].argmax(dim=-1).cpu()   # the engine's readback

    decode_steps()                      # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    decode_steps()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        decode_steps()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in kernels) / steps
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    by_class, by_sub = _device_ms_by_class(kernels, FORWARD_CLASSES, steps)
    emit("profile_decode_full", arch=arch, steps=steps, wall_ms_per_step=wall_ms,
         device_ms_per_step=dev_us / 1e3 if dev_us else "not measured",
         device_ms_per_step_by_class=by_class, device_ms_per_step_by_subclass=by_sub,
         device_busy_share=dev_us / 1e3 / wall_ms if dev_us else "not measured",
         device_kernel_calls_per_step=sum(e.count for e in kernels) / steps,
         top_kernels=[dict(name=e.key[:80], calls_per_step=e.count / steps,
                           ms_per_step=e.self_device_time_total / steps / 1e3)
                      for e in top])


def _profile_step(arch, task, call):
    """Device time of one step by kernel (``torch.profiler``): the total,
    the top kernels, and the share of each of the port's kernels (the
    flash-attention variants, SSD, RG-LRU) by name."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    ours = {name: sum(e.self_device_time_total for e in kernels if key in e.key) / 1e3
            for name, key in (("flash_tc", "fa_tc_kernel"), ("flash_split", "split::fa_split"),
                              ("flash_split_mma", "fa_split_mma"),
                              ("flash_combine", "fa_decode_combine"),
                              ("flash_simt", "fa_kernel<"),
                              ("ssd", "ssd_"),   # every SSD kernel: the tc passes summed
                              ("ssd_chunk_state", "ssd_chunk_state"),
                              ("ssd_state_pass", "ssd_state_pass"),
                              ("ssd_chunk_scan", "ssd_chunk_scan"),
                              ("ssd_simt", "simt::ssd_kernel"),
                              ("rglru", "rglru_"),   # every RG-LRU kernel
                              ("rglru_seq", "rglru_seq_kernel"),
                              ("rglru_chunked", "rglru_chunked_kernel"))}
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    by_class, by_sub = _device_ms_by_class(kernels, FORWARD_CLASSES)
    emit("profile_step_full", arch=arch, task=task, wall_ms_profiled=wall_ms,
         device_ms=dev_ms if dev_ms else "not measured",
         device_ms_by_class=by_class, device_ms_by_subclass=by_sub,
         device_busy_share=dev_ms / wall_ms if dev_ms else "not measured",
         port_kernels_ms={k: v for k, v in ours.items() if v},
         port_kernels_share={k: v / dev_ms for k, v in ours.items() if v and dev_ms},
         top_kernels=[dict(name=e.key[:80], calls=e.count,
                           ms=e.self_device_time_total / 1e3) for e in top])


PROF_FRACS = ("prof_frac_compute", "prof_frac_memory", "prof_frac_collective",
              "prof_frac_dispatch", "prof_frac_idle")
PROF_KEYS = PROF_FRACS + ("prof_kind", "prof_steps", "prof_dispatch_us_mean",
                          "prof_device_us_mean", "prof_idle_us", "prof_class_us",
                          "prof_class_frac", "prof_flops", "prof_bytes", "prof_bound_us",
                          "prof_util", "prof_device_peak_bytes", "prof_error")
PROFILE_FRAC_TOL = 1e-6
# an analytic bound above the measured busy time means a wrong count; 5% is
# room for L2 hits, which the bytes count cannot see
PROFILE_UTIL_MAX = 1.05
# the traced steps' busy time B against a timed sample's wall W: B above W
# clamps the sample (its host part reads 0); a few percent is the samples'
# own spread, more means the trace ran other steps than the timed ones
PROFILE_BUSY_OVER_WALL_MAX = 1.05


def _profile_record(name, task, extra, median_us, median_us_profiled, profiles,
                    compile_us=0.0, wall_s=0.0, record_extra=None, trace=None,
                    compiled=False, **line):
    """Print one ``profile_cell_full`` line, check the profile, and add the
    cell's record (the runner's layout, which ``detect`` reads) to
    ``profiles``.  ``trace`` is the measure's ``device_trace``; ``compiled``
    says whether the profiled step ran compiled."""
    frac_sum = sum(extra[k] for k in PROF_FRACS)
    trace = trace or {}
    busy_over_wall = trace.get("busy_over_wall_max", 0.0)
    emit("profile_cell_full", cell=name, task=task, compiled=compiled, **line,
         trace_busy_us=trace.get("busy_us"), clamped_samples=trace.get("clamped_samples"),
         busy_over_wall_max=busy_over_wall,
         **{k: extra[k] for k in PROF_KEYS if k in extra}, frac_sum=frac_sum,
         median_us=median_us, median_us_profiled=median_us_profiled,
         timeline_head=extra["prof_timeline"][:6])
    check("prof_error" not in extra, f"{name}: profile failed: {extra.get('prof_error')}")
    check(abs(frac_sum - 1.0) <= PROFILE_FRAC_TOL, f"{name}: fractions sum to {frac_sum}")
    check(0.0 < extra["prof_util"] <= PROFILE_UTIL_MAX,
          f"{name}: prof_util {extra['prof_util']} outside (0, {PROFILE_UTIL_MAX}]")
    check(extra["prof_class_us"]["attention"] > 0, f"{name}: no attention time")
    check(busy_over_wall <= PROFILE_BUSY_OVER_WALL_MAX,
          f"{name}: the traced busy time per step is {busy_over_wall} of a timed sample's "
          f"wall (limit {PROFILE_BUSY_OVER_WALL_MAX}; {trace.get('clamped_samples')} clamped)")
    profiles.append({"name": name, "task": task, "status": "ok", "compile_us": compile_us,
                     "wall_s": wall_s, "extra": {**(record_extra or {}), **extra}})


def _profile_step_cell(arch, task, built, batch, profiles, perf, seq=2048, ci=False):
    """``task`` at full width through ``Benchmark.make(built=...)``:
    ``harness.measure`` unprofiled, then profiled ``NOISE_RUNS`` times,
    ``NOISE_RUNS_CI`` with ``ci`` (``phase_log``: each sample split by the busy time a kernel trace of 3
    more steps measures), each on a fresh ``make``, median of 3 after one
    warmup; then the step's op-class cost (``analyze_step``) and the
    profile (``profile_extra``) of each.  The first profiled run is the
    cell's ``profile_cell_full`` record, all of them its ``noise`` line.
    Prefill runs as the runner's ``jit`` cell (the cache copied at every
    call, so every call is a prefill from position 0, as ``step_full``
    measures it); decode as ``jit_donated`` (the cache updated in place and
    threaded: its 8 steps from position 2048 fit the cache, the cost pass
    restores it).  ``ci``: then the perf-CI flow on the cell
    (``_ci_full``), bisecting on gemma-2b."""
    from repro_torch.core import harness
    from repro_torch.core.suite import get_benchmark
    from repro_torch.core.hloanalysis import analyze_step
    from repro_torch.profiler.attribution import profile_extra
    mode = "jit" if task == "infer_prefill" else "jit_donated"
    name = f"{arch}/{task}/b{batch}/s{seq}/full/{mode}"

    def measure(hook=None, profiled=False):
        step, args, mutable = get_benchmark(arch, task).make(batch=batch, seq=seq, built=built)
        donate = mutable if mode == "jit_donated" else ()
        fn = harness.prepare(step, donate, mutable=mutable)
        log, trace, final = [], {}, []
        meas = harness.measure(name, step, args, donate, runs=3, warmup=1, jitted=fn,
                               hook=hook, final_args=final,
                               phase_log=log if profiled else None,
                               device_trace=trace, device=built.model.device)
        return meas, log, trace, (fn, final[0], donate)

    t0 = time.perf_counter()
    base = measure()[0]
    first = list(measure(profiled=True))
    fn, final, donate = first[3]
    cost = analyze_step(fn, final, donate)
    del fn, final, first[3:]
    wall_s = time.perf_counter() - t0
    n_runs = NOISE_RUNS_CI if ci else NOISE_RUNS
    runs = [first[:3]] + [measure(profiled=True)[:3] for _ in range(n_runs - 1)]
    noise_wall = time.perf_counter() - t0 - wall_s
    extras = [profile_extra(log, cost, device_trace=trace, device=built.model.device)
              for _, log, trace in runs]
    meas, _, trace = runs[0]
    _profile_record(name, task, extras[0], base.median_us, meas.median_us, profiles,
                    compile_us=meas.compile_us, wall_s=wall_s, arch=arch, batch=batch,
                    seq=seq, trace=trace, kernel_calls=cost.notes)
    med = _noise(name, task, [_run_metrics(m, e) for (m, _, _), e in zip(runs, extras)],
                 perf, noise_wall)
    if ci:
        _ci_full(name, lambda hook: _run_metrics(measure(hook)[0], {}), med, perf,
                 bisect=arch == "gemma-2b")


def _profile_serve_cell(arch, built, profiles, perf, engine=None):
    """The serve run's trace (8 requests, 4 slots, prompt 128, 16 new) at
    full width through ``ServeEngine``: a warm replay, an unprofiled one
    and ``NOISE_RUNS`` profiled ones (``run(phase_log=...)``: every decode
    step split by the busy time a kernel trace of decode steps outside the
    replay measures; admission and prefill are its idle share), then the
    decode step's op-class cost (``decode_probe`` + ``analyze_step``).  The
    first profiled replay is the cell's ``profile_cell_full`` record, all
    of them its ``noise`` line (median: the replay's ``tok_lat_p50``).
    ``engine`` (gemma-2b's: compiled, from ``_serve_compiled_full``) serves
    the trace if given, else an uncompiled engine on ``built``."""
    from repro_torch.launch.serve import ServeEngine, summarize_metrics
    from repro_torch.core.hloanalysis import analyze_step
    from repro_torch.profiler.attribution import profile_extra
    from repro_torch.runner.traces import TraceSpec, cache_len_bound, generate
    cfg = built.cfg
    name = f"{arch}/serve/b8/s128/full/jit_donated/x4/uniform"
    reqs = generate(TraceSpec(profile="uniform", requests=8, prompt_len=128, max_new=16,
                              seed=0, prompt_profile="fixed"), vocab=cfg.vocab)
    prefix = cfg.n_prefix if cfg.family == "vlm" else 0
    if engine is None:
        engine = ServeEngine(built, slots=4, max_len=cache_len_bound(reqs, prefix=prefix),
                             compiled=False)
    t0 = time.perf_counter()
    engine.run(reqs)                     # first calls
    compile_us = (time.perf_counter() - t0) * 1e6
    base = summarize_metrics(engine.run(reqs))
    replays = []
    for _ in range(NOISE_RUNS):
        log, trace = [], {}
        out = engine.run(reqs, phase_log=log, device_trace=trace)
        replays.append((out, summarize_metrics(out), log, trace))
        if len(replays) == 1:
            wall_s = time.perf_counter() - t0
    noise_wall = time.perf_counter() - t0 - wall_s
    with engine.decode_probe(reqs) as (step, _):
        cost = analyze_step(step)
    extras = [profile_extra(log, cost, kind="decode_step", wall_s=out["wall_s"],
                            device_trace=trace, device=engine.device)
              for out, _, log, trace in replays]
    out, sx, _, trace = replays[0]
    extra = extras[0]
    check(all(r[1]["tokens_digest"] == base["tokens_digest"] for r in replays),
          f"{arch} serve: a profiled replay's tokens differ")
    check(extra["prof_steps"] == out["decode_steps"] and extra.get("prof_idle_us", 0) > 0,
          f"{arch} serve: {extra['prof_steps']} profiled of {out['decode_steps']} decode "
          f"steps, idle {extra.get('prof_idle_us')}")
    _profile_record(name, "serve", extra,
                    base["tok_lat_p50"], sx["tok_lat_p50"], profiles, compile_us=compile_us,
                    wall_s=wall_s, record_extra=dict(sx, slots=4, trace="uniform",
                                                     compiled=engine.compiled),
                    arch=arch, medians_are="tok_lat_p50 (us)", tok_per_s=sx["tok_per_s"],
                    compiled=engine.compiled,
                    decode_steps=out["decode_steps"], trace=trace, kernel_calls=cost.notes)
    _noise(name, "serve", [{"median_us": r[1]["tok_lat_p50"], **{
        k: e[k] for k in ("prof_dispatch_us_mean", "prof_device_us_mean")}}
        for r, e in zip(replays, extras)], perf, noise_wall)
    del engine


def phase_profile_report(profiles):
    """The profiler's findings over the profiled full-width cells
    (``detect``, ``build_report``, ``format_table``)."""
    from repro_torch.profiler import build_report, detect, format_table
    findings = detect(profiles)
    report = build_report(profiles, findings, meta={"source": "chip_smoke.py profile_cell_full"})
    emit("profile_report", cells=report["cells"], cells_profiled=report["cells_profiled"],
         by_rule=report["by_rule"], by_severity=report["by_severity"],
         findings=[dict(rule=f.rule, severity=f.severity, cell=f.cell, score=f.score,
                        summary=f.summary) for f in findings],
         table=format_table(report).splitlines())
    check(report["cells_profiled"] == len(profiles),
          f"profile report: {report['cells_profiled']} of {len(profiles)} cells profiled")


def _free_card():
    """Drop what the last phase left on the card (one full model at a
    time); returns the bytes still allocated."""
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated()


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


SERVE_ARGV = ["--requests", "8", "--slots", "4", "--prompt-len", "128", "--max-new", "16"]


def _serve_cli(arch):
    """The serve CLI at ``arch``'s full config (its main path):
    (requests, tokens, decode steps, admission calls, tok/s, TTFT p50 us,
    per-token p50 us, argv)."""
    from repro_torch.launch import serve
    argv = ["--arch", arch, "--full"] + SERVE_ARGV
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = serve.main(argv)
    text = buf.getvalue()
    print(text, end="", flush=True)
    m = re.search(r"served (\d+) requests .*?: (\d+) tokens in ([\d.]+)s \(([\d.]+) tok/s, "
                  r"(\d+) steps, \w+ admission: (\d+) prefill calls\)", text)
    check(rc == 0 and m, f"{arch}: serve CLI failed: {text}")
    return (*(int(m.group(i)) for i in (1, 2, 5, 6)), float(m.group(4)),
            float(re.search(r"ttft_us\s+p50=(\d+)", text).group(1)),
            float(re.search(r"tok_lat_us\s+p50=(\d+)", text).group(1)), argv)


def _serve_engine(cfg):
    """The CLI's run through ``serve.built_for_cfg`` and ``ServeEngine``
    for a config the CLI cannot name (a cut depth): the same trace, slots
    and cache bound, the engine uncompiled; returns what ``_serve_cli``
    does."""
    from repro_torch.launch import serve
    from repro_torch.runner.traces import TraceSpec, cache_len_bound, generate
    built = serve.built_for_cfg(cfg)
    reqs = generate(TraceSpec(profile="uniform", requests=8, prompt_len=128, max_new=16,
                              seed=0, prompt_profile="fixed"), vocab=cfg.vocab)
    prefix = cfg.n_prefix if cfg.family == "vlm" else 0
    engine = serve.ServeEngine(built, slots=4, max_len=cache_len_bound(reqs, prefix=prefix),
                               compiled=False)
    out = engine.run(reqs)
    m = serve.summarize_metrics(out)
    del built, engine
    return (out["requests"], out["tokens"], out["decode_steps"], out["admit_calls"],
            m["tok_per_s"], m.get("ttft_p50", 0.0), m.get("tok_lat_p50", 0.0),
            f"serve.ServeEngine(serve.built_for_cfg(n_layers={cfg.n_layers})), "
            + " ".join(SERVE_ARGV))


def _serve_compiled_full(arch, built, per_forward, cli_compile, smi, serve_warm=None):
    """The serve CLI's trace (8 requests, 4 slots, prompt 128, 16 new) on
    ``built`` at full width through a compiled ``ServeEngine`` (its graphs
    from Inductor's cache, which the CLI's compile filled) and an
    uncompiled one (``_serve_pair``): launches by variant equal between
    the two and ``per_forward``'s rates (flash ``tc`` a layer per
    admission forward, ``split`` a layer per decode step), the compiled
    first decode step's logits within ``COMPILED_TOL["bf16"]`` of the
    uncompiled one's, both from each engine's own admission and from the
    same admitted state, the first tokens and the token digests equal, no
    graph break; tok/s, TTFT and per-token p50 both ways, the admission's
    cache difference (reported), peak device memory, and
    the cold compile of the same graphs (``serve_warm``, from the
    compilers part, else the CLI's).  Returns the compiled engine."""
    import torch
    from repro_torch.runner.traces import TraceSpec, cache_len_bound, generate
    reqs = generate(TraceSpec(profile="uniform", requests=8, prompt_len=128, max_new=16,
                              seed=0, prompt_profile="fixed"), vocab=built.cfg.vocab)
    torch.cuda.reset_peak_memory_stats()
    got = _serve_pair(built, reqs, cache_len_bound(reqs))
    peak = torch.cuda.max_memory_allocated()
    c, u = got[True], got[False]
    err = float((c["logits_same_state"] - u["logits"]).abs().max())
    own_err = float((c["logits"] - u["logits"]).abs().max())
    fa_pre, fa_dec = per_forward["flash_attention"]
    cold = serve_warm or dict(compile_seconds=cli_compile["compile_seconds"],
                              graphs=cli_compile["graphs"],
                              graph_breaks=cli_compile["graph_breaks"])
    want = {"tc": fa_pre * c["out"]["admit_calls"], "split": fa_dec * c["out"]["decode_steps"],
            "simt": 0}
    ways = {}
    for way, g in (("compiled", c), ("uncompiled", u)):
        m = g["metrics"]
        ways[way] = dict(tok_per_s=m["tok_per_s"], ttft_p50_us=m.get("ttft_p50"),
                         tok_lat_p50_us=m.get("tok_lat_p50"), tokens_digest=m["tokens_digest"],
                         launches=g["launches"], warm_replay_s=g["warm_s"])
    emit("serve_compiled_full", arch=arch, card=smi, n_layers=built.cfg.n_layers,
         cold_compile_s=cold["compile_seconds"]["total"],
         cold_compile_seconds=cold["compile_seconds"], cold_graphs=cold["graphs"],
         cold_graph_breaks=cold["graph_breaks"], cli_compile_s=cli_compile["compile_s"],
         cli_fxgraph_cache=cli_compile.get("fxgraph_cache"), engine_compile_s=c["compile_s"],
         engine_fxgraph_cache=c["fxgraph_cache"], engine_graphs=c["dynamo"]["graphs"],
         engine_graph_breaks=c["dynamo"]["graph_breaks"], expected_flash=want,
         logits_max_abs_err=err, tol=COMPILED_TOL["bf16"],
         logits_own_admission_err=own_err,
         admission_cache_err=c["admission_cache_err"],
         first_tokens_equal=c["first_tokens_equal"],
         digests_agree=ways["compiled"]["tokens_digest"] == ways["uncompiled"]["tokens_digest"],
         replay_new_shapes=c["new_shapes"], max_memory_allocated=peak, **ways)
    check(c["launches"] == u["launches"] and c["launches"]["flash_attention"] == want,
          f"{arch}: compiled serve launches {c['launches']}, uncompiled {u['launches']}, "
          f"expected flash {want}")
    check(err <= COMPILED_TOL["bf16"] and own_err <= COMPILED_TOL["bf16"],
          f"{arch}: compiled serve logits differ by {err} from the same state, "
          f"{own_err} from each engine's own admission")
    check(c["first_tokens_equal"] and ways["compiled"]["tokens_digest"]
          == ways["uncompiled"]["tokens_digest"],
          f"{arch}: the compiled engine's tokens differ from the uncompiled one's")
    check(c["dynamo"]["graph_breaks"] == 0 and c["new_shapes"] == 0,
          f"{arch}: compiled serve {c['dynamo']}, {c['new_shapes']} compiled in the replay")
    check(bool(torch.isfinite(c["logits"]).all()), f"{arch}: compiled serve logits not finite")
    del got, u
    return c["engine"]


def _param_bytes(cfg):
    """The fp32 parameter bytes of ``cfg``, reckoned from its ParamDefs."""
    import math
    import torch
    from repro_torch.models.layers import map_defs
    from repro_torch.models.model import param_defs
    sizes = []
    map_defs(lambda d: sizes.append(math.prod(d.shape) * torch.empty((), dtype=d.dtype)
                                    .element_size()), param_defs(cfg))
    return sum(sizes)


def phase_full_width(arch, per_forward, cfg=None, memory_limit=MEMORY_LIMIT, profile=(),
                     profiles=None, perf=None, ci=False, smi="", serve_warm=None):
    """``arch`` at its full published config (or at ``cfg``, a cut of it),
    random weights from seed 0: its main path (the serve CLI; for a cut
    config the same run through ``ServeEngine``) with every launch count
    set to 0 just before it and read just after, then a decode-step
    profile, the ``infer_prefill`` b1 s2048 and ``infer_decode`` b4 at
    2048 steps, and the peak device memory (under ``memory_limit``).
    The tasks in ``profile`` (of ``infer_prefill``, ``infer_decode``,
    ``serve``) are then profiled on the same build, their records added
    to ``profiles`` (``_profile_step_cell``, ``_profile_serve_cell``), their
    spread to ``perf``; with ``ci``, the perf-CI flow runs on the profiled
    ``infer_prefill`` cell (``_ci_full``).
    ``per_forward`` maps each kernel of the path to its launches (per
    prefill forward, per decode step); every other kernel must not launch.
    At full depth the serve CLI compiles its engine (its graphs load from
    Inductor's cache, which ``_warm_serve_full`` filled in the compilers
    part: ``serve_warm``, that cold compile's account; its line reports
    the CLI's own compile seconds, graphs, breaks and cache hits), and
    ``_serve_compiled_full`` then holds a compiled engine on the phase's
    build against an uncompiled one; a cut config's engine runs
    uncompiled.  Returns the serve run's launch counts and its
    flash-attention, SSD and RG-LRU launches by variant."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.core import harness
    from repro_torch.core.suite import get_benchmark
    from repro_torch.kernels.rglru.kernel import plan as rglru_plan
    from repro_torch.launch import serve
    cut = cfg is not None
    cfg = cfg if cut else get_arch(arch)
    left = _free_card()
    check(left < 1e9, f"{arch}: {left} bytes still allocated before the phase")
    torch.cuda.reset_peak_memory_stats()
    c0, b0 = harness.dynamo_counts(), harness.compile_budget()
    _reset_counts()                      # main path: the serve run
    (served, tokens, steps, admits, tok_per_s, ttft_p50, tok_p50,
     argv) = _serve_engine(cfg) if cut else _serve_cli(arch)
    counts = _read_counts()
    b1 = harness.compile_budget()
    cli_compile = dict(compiled=not cut, compile_s=b1["seconds"]["total"] - b0["seconds"]["total"],
                       compile_seconds={k: b1["seconds"][k] - b0["seconds"][k]
                                        for k in b1["seconds"]},
                       fxgraph_cache={k: b1["fxgraph_cache"][k] - b0["fxgraph_cache"][k]
                                      for k in b1["fxgraph_cache"]},
                       **_dynamo_delta(c0, harness.dynamo_counts()))
    variants = _read_variants()
    ssd_variants = _read_ssd_variants()
    rglru_variants = _read_rglru_variants()
    rate = {k: per_forward.get(k, (0, 0)) for k in counts}
    expected = {k: pre * admits + dec * steps for k, (pre, dec) in rate.items()}
    # full-width prefill (admission) runs only the tensor-core variant,
    # decode only the split one
    fa_pre, fa_dec = rate["flash_attention"]
    expected_variants = {"tc": fa_pre * admits, "split": fa_dec * steps, "simt": 0}
    # full-width bf16 prefill runs only the SSD's tensor-core variant
    expected_ssd_variants = {"tc": expected["ssd"], "simt": 0}
    # admissions of 1, 2 or 4 rows (rounded to powers of two) of 128-token
    # prompts: plan() picks per shape, so each variant runs whole forwards
    rg_pre = rate["rglru"][0]
    rglru_whole = all(n % rg_pre == 0 for n in rglru_variants.values()) if rg_pre else True
    emit("serve_full", arch=arch, n_layers=cfg.n_layers, argv=argv, requests=served,
         tokens=tokens, tok_per_s=tok_per_s, ttft_p50_us=ttft_p50, tok_lat_p50_us=tok_p50,
         decode_steps=steps, admit_calls=admits, kernel_launches=counts,
         expected_launches=expected, flash_launches_by_variant=variants,
         expected_flash_launches_by_variant=expected_variants,
         ssd_launches_by_variant=ssd_variants,
         expected_ssd_launches_by_variant=expected_ssd_variants,
         rglru_launches_by_variant=rglru_variants, **cli_compile)
    check(served == 8 and tokens == 8 * 16, f"{arch}: not every request was answered")
    check(cli_compile["graph_breaks"] == 0 and (cut or cli_compile["graphs"] > 0),
          f"{arch}: the serve CLI's compile: {cli_compile}")
    check(counts == expected and all(counts[k] > 0 for k in per_forward),
          f"{arch}: launches {counts} for {admits} admission prefills and {steps} "
          f"decode steps (expected {expected})")
    check(variants == expected_variants,
          f"{arch}: flash launches by variant {variants}, expected {expected_variants}")
    check(ssd_variants == expected_ssd_variants,
          f"{arch}: SSD launches by variant {ssd_variants}, expected {expected_ssd_variants}")
    check(sum(rglru_variants.values()) == counts["rglru"] and rglru_whole,
          f"{arch}: RG-LRU launches by variant {rglru_variants} for {counts['rglru']} "
          f"launches, {rg_pre} a forward")
    freed = _free_card()                 # the CLI's model is gone
    check(freed < 1e9, f"{arch}: {freed} bytes still allocated after the serve CLI")

    built = serve.built_for_cfg(cfg)
    phase_profile(arch, built.model)
    for task, batch, donate, col in (("infer_prefill", 1, (), 0),
                                     ("infer_decode", 4, (2,), 1)):
        step, args, mutable = get_benchmark(arch, task).make(
            batch=batch, seq=2048, built=built)
        # prefill is measured fresh every call (its cache copied); decode
        # threads its cache, 7 steps from position 2048 (inside max_len
        # 2056; a ring of 2048 slots wraps at the first of them)
        fn = harness.prepare(step, donate, mutable=mutable)
        _reset_counts()
        out = fn(*args)
        torch.cuda.synchronize()
        got = _read_counts()
        got_variants = _read_variants()
        got_ssd_variants = _read_ssd_variants()
        got_rglru_variants = _read_rglru_variants()
        want = {k: pre_dec[col] for k, pre_dec in rate.items()}
        want_variants = dict.fromkeys(got_variants, 0)
        want_variants["split" if col else "tc"] = want["flash_attention"]
        want_ssd_variants = {"tc": want["ssd"], "simt": 0}
        want_rglru_variants = dict.fromkeys(got_rglru_variants, 0)
        if want["rglru"]:   # the b1 s2048 prefill: the variant plan() picks
            want_rglru_variants[rglru_plan(batch, 2048, cfg.lru_width)[0]] = want["rglru"]
        logits = out[0]
        check(tuple(logits.shape) == (batch, 1, cfg.vocab)
              and bool(torch.isfinite(logits.float()).all().item()),
              f"{arch} {task}: logits {tuple(logits.shape)} not finite or misshapen")
        kv_slots = sorted({t.shape[-3] for p, t in _leaves(args[2]) if p[-1] == "k"})
        meas = harness.measure(f"{arch}/{task}/b{batch}/s2048", step, args, donate,
                               runs=5, warmup=1, jitted=fn)
        emit("step_full", arch=arch, task=task, batch=batch, seq=2048, compiled=False,
             median_us=meas.median_us, p10_us=meas.p10_us, p90_us=meas.p90_us,
             launches_per_forward=got, flash_launches_by_variant=got_variants,
             ssd_launches_by_variant=got_ssd_variants,
             rglru_launches_by_variant=got_rglru_variants, kv_cache_slots=kv_slots)
        check(got == want, f"{arch} {task}: launches {got} in one forward, expected {want}")
        check(got_variants == want_variants, f"{arch} {task}: flash launches by variant "
              f"{got_variants}, expected {want_variants}")
        check(got_ssd_variants == want_ssd_variants, f"{arch} {task}: SSD launches by "
              f"variant {got_ssd_variants}, expected {want_ssd_variants}")
        check(got_rglru_variants == want_rglru_variants, f"{arch} {task}: RG-LRU launches "
              f"by variant {got_rglru_variants}, expected {want_rglru_variants}")
        if task == "infer_prefill":
            _profile_step(arch, task, lambda: fn(*args))
        del step, args, out, fn
        if task in profile:
            _profile_step_cell(arch, task, built, batch, profiles, perf,
                               ci=ci and task == "infer_prefill")
    engine = None
    if not cut:
        engine = _serve_compiled_full(arch, built, per_forward, cli_compile, smi, serve_warm)
    if "serve" in profile:
        _profile_serve_cell(arch, built, profiles, perf, engine=engine)
    del engine
    peak = torch.cuda.max_memory_allocated()
    emit("memory", arch=arch, n_layers=cfg.n_layers, max_memory_allocated=peak,
         limit=memory_limit,
         param_bytes=sum(p.numel() * p.element_size() for p in built.model.parameters()))
    check(peak < memory_limit, f"{arch}: peak device memory {peak} bytes")
    del built
    _free_card()
    return counts, variants, ssd_variants, rglru_variants


# ---------------------------------------------------------------------------
# The compiler modes (paper §3.2, Figs. 3-4): eager against torch.compile
# ---------------------------------------------------------------------------

# the matrix of the reference's benchmarks/fig34_compilers.py (ARCHS_FULL:
# gemma-2b, mamba2-2.7b, recurrentgemma-9b, internlm2-20b, whisper-large-v3;
# train, B=2, S=48, every mode), less mixtral-8x7b, which waits for the moe
# family (ROADMAP item 6), in three parts: gemma-2b's and internlm2-20b's
# cells in every mode, each arch in a part of its own (``compilers``,
# ``compilers_internlm2``), and the cells of the families that train on the
# card from PR 25 on eager, in the ``nightly`` part (``FIG34_FAMILIES``).
# Their compiled cells are graphs no other phase compiles, a cold compile
# of 218-360 s each beside the other parts on the H100: with mamba2's and
# recurrentgemma's ``jit`` and ``jit_donated`` cells (and the nightly's
# train cells compiled) the script took 1,277.9 s, past its limit (PERF.md
# §6, PR 25).  Their train steps run compiled under ``aot_eager`` instead
# (``FIG34_AOT_EAGER``, ``_aot_eager_train``)
FIG34_DENSE = ("gemma-2b", "internlm2-20b")
FIG34_FAMILIES = {"mamba2-2.7b": ("eager",), "recurrentgemma-9b": ("eager",),
                  "whisper-large-v3": ("eager",)}
FIG34_AOT_EAGER = ("mamba2-2.7b", "recurrentgemma-9b")
# a compiled step's logits or loss against the eager step's, on the card
COMPILED_TOL = {"bf16": 5e-2, "fp32": 1e-4}


def _dynamo_delta(c0, c1):
    """Dynamo's graphs, breaks (by reason) and compiled-graph calls between
    two ``dynamo_counts()``."""
    breaks = {k[:120]: v - c0["graph_breaks"].get(k, 0)
              for k, v in c1["graph_breaks"].items() if v != c0["graph_breaks"].get(k, 0)}
    return {"graphs": c1["graphs"] - c0["graphs"], "frames": c1["frames"] - c0["frames"],
            "graph_breaks": sum(breaks.values()), "graph_break_reasons": breaks,
            "graph_calls": c1["graph_calls"] - c0["graph_calls"]}


def _runner_calls(rr, runner, runs):
    """The step calls one runner cell made: ``measure_eager``'s warm call and
    timed calls, or ``measure``'s first call, warmups and timed calls."""
    if rr.mode == "eager":
        return 1 + max(2, runs // 2)
    fresh = 0 if rr.cache.get("executable_reused") else runner.compile_warmup
    return 1 + runner.warmup + fresh + runs


def _compiler_cell(runner, sc, runs, smi):
    """One runner cell, its line (median, compile, memory, Dynamo's graphs
    and breaks, kernel launches per step call) and its record."""
    from repro_torch.core.harness import dynamo_counts
    c0 = dynamo_counts()
    _reset_counts()
    t0 = time.perf_counter()
    rr = runner.run(sc, runs=runs)
    wall = time.perf_counter() - t0
    calls = _runner_calls(rr, runner, runs)
    launches = _read_counts()
    emit("compilers_cell", cell=rr.name, status=rr.status, error=rr.error,
         compiled=rr.mode != "eager", median_us=rr.median_us, p10_us=rr.p10_us,
         p90_us=rr.p90_us, compile_us=rr.compile_us, host_peak_bytes=rr.host_peak_bytes,
         device_bytes_delta=rr.device_bytes_delta, runs=rr.runs, step_calls=calls,
         launches_per_call={k: v / calls for k, v in launches.items()}, wall_s=wall,
         **_dynamo_delta(c0, dynamo_counts()), card=smi)
    return rr, {k: v / calls for k, v in launches.items()}


def _compiled_pair(name, step, args, mutable, mode, device, dtype, smi, want_launches,
                   profile=False):
    """``step`` at full width, compiled in ``mode`` (``harness.measure`` of
    ``compile_step``, its first call the cold compile) and uncompiled
    (``harness.measure_eager``); then one call of each, whose kernel
    launches must equal each other and ``want_launches``, and whose output
    must agree within ``COMPILED_TOL``: the logits of the two calls on the
    same cache (restored between them: ``hloanalysis.preserved``), or for
    a train step the compiled step's loss against the eager model's loss
    on the same state.  The eager train step updates its state in place
    (a copy of the 30 GB of weights and moments at every call would not
    fit beside it).  A train cell also holds the compiled step's gradient
    norm against the eager backward's on the same state (Inductor's
    backward and update graphs), its losses over its calls on one batch
    (finite, falling) and the peak device memory of each way against
    ``TRAIN_MEMORY_LIMIT``.  A profiled compiled cell also prints its
    dispatch share and op classes."""
    import torch
    from repro_torch.core import harness
    from repro_torch.core.hloanalysis import analyze_step, preserved
    from repro_torch.optim.adamw import global_norm
    from repro_torch.profiler.attribution import profile_extra
    train = "train" in name
    donate = mutable if mode == "jit_donated" else ()
    eager_fn = step if train else harness.prepare(step, (), mutable=mutable)
    compiled, losses = harness.compile_step(step, device), []

    def recorded(*a):
        out = compiled(*a)
        if train:
            losses.append(out[1]["loss"])
        return out
    compiled_fn = harness.prepare(recorded, donate, mutable=mutable)
    torch.cuda.reset_peak_memory_stats()
    c0 = harness.dynamo_counts()
    log, trace, final = ([] if profile else None), {}, []
    # 1 + 1 + 3 calls, and 3 traced ones when profiled: a decode cell's 8
    # steps from position 2048 fill its cache's 2056 slots
    meas = harness.measure(f"{name}/{mode}", step, args, donate, runs=3, warmup=1,
                           jitted=compiled_fn, final_args=final, phase_log=log,
                           device_trace=trace, device=device, compiled=True)
    dyn = _dynamo_delta(c0, harness.dynamo_counts())
    peak = torch.cuda.max_memory_allocated()
    args = final[0]
    prof = {}
    if profile:
        extra = profile_extra(log, analyze_step(compiled_fn, args, mutable),
                              device_trace=trace, device=device)
        prof = {k: extra.get(k) for k in ("prof_frac_dispatch", "prof_frac_compute",
                                          "prof_frac_memory", "prof_frac_idle",
                                          "prof_class_frac", "prof_device_us_mean",
                                          "prof_dispatch_us_mean", "prof_error")}
    torch.cuda.reset_peak_memory_stats()
    eager = harness.measure_eager(f"{name}/eager", eager_fn, args, runs=3, device=device)
    eager_peak = torch.cuda.max_memory_allocated()
    outs, launches, grad_norm = {}, {}, {}
    if train:
        # the eager loss and gradient norm at the state the compiled call
        # below starts from; no update
        model = args[0][0]
        loss, _ = model.loss(args[1])
        loss.backward()
        outs["eager"] = loss.detach().float()
        grad_norm["eager"] = global_norm([p.grad for p in model.parameters()])
        for p in model.parameters():
            p.grad = None
        del loss, model
    for way, fn in (((mode, compiled_fn), ("eager", eager_fn)) if train
                    else (("eager", eager_fn), (mode, compiled_fn))):
        with (contextlib.nullcontext() if train else preserved(args, mutable)):
            _reset_counts()
            out = fn(*args)
            torch.cuda.synchronize()
            launches[way] = _read_counts()
            if not (train and way == "eager"):
                outs[way] = (out[1]["loss"] if train else out[0]).detach().float().clone()
            if train and way == mode:
                grad_norm[way] = out[1]["grad_norm"].detach().float().clone()
            del out
    err = float((outs[mode] - outs["eager"]).abs().max())
    finite = bool(torch.isfinite(outs[mode]).all())
    if train:
        gn_err = float((grad_norm[mode] - grad_norm["eager"]).abs()
                       / grad_norm["eager"].abs())
        losses = [float(x) for x in losses]
    for way, m, pk in (("eager", eager, eager_peak), (mode, meas, peak)):
        line = dict(cell=f"{name}/{way}", compiled=way != "eager",
                    median_us=m.median_us, p10_us=m.p10_us, p90_us=m.p90_us,
                    compile_us=m.compile_us, host_peak_bytes=m.host_peak_bytes,
                    device_bytes_delta=m.device_bytes_delta, max_memory_allocated=pk,
                    launches_per_step=launches[way], card=smi)
        if train:
            line.update(limit=TRAIN_MEMORY_LIMIT)
        if way == mode:
            line.update(dyn, **prof, max_abs_err_vs_eager=err, tol=COMPILED_TOL[dtype])
            if train:
                line.update(grad_norm=float(grad_norm[mode]),
                            grad_norm_eager=float(grad_norm["eager"]),
                            grad_norm_rel_err_vs_eager=gn_err, losses=losses)
        emit("compilers_full", **line)
    check(finite, f"{name} {mode}: non-finite output")
    if train:
        check(gn_err <= COMPILED_TOL[dtype], f"{name} {mode}: grad norm "
              f"{float(grad_norm[mode])} against eager's {float(grad_norm['eager'])}")
        check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
              f"{name} {mode}: losses over its calls on one batch {losses}")
        for way, pk in (("eager", eager_peak), (mode, peak)):
            check(pk < TRAIN_MEMORY_LIMIT, f"{name} {way}: peak device memory {pk} bytes "
                  f"(limit {TRAIN_MEMORY_LIMIT:.0f})")
    check(err <= COMPILED_TOL[dtype], f"{name} {mode}: {err} from the eager step's output "
          f"(tolerance {COMPILED_TOL[dtype]})")
    check(launches[mode] == launches["eager"] == want_launches,
          f"{name}: launches compiled {launches[mode]}, eager {launches['eager']}, "
          f"expected {want_launches}")
    check(not prof.get("prof_error"), f"{name} {mode}: profile failed: {prof}")
    return launches[mode]


def _matrix_launches_check(results, launches):
    """Each compiled matrix cell launches what its eager cell launches a
    step call, but ``jit_noremat``'s, whose build recomputes no forward:
    one forward launch a layer, as many as the backward's."""
    for bench, modes in results.items():
        eager = launches[modes["eager"].name]
        for mode, rr in modes.items():
            want = ({k: eager.get(f"{k}_bwd", v) for k, v in eager.items()}
                    if mode == "jit_noremat" else eager)
            check(launches[rr.name] == want,
                  f"compilers: {rr.name} launches {launches[rr.name]} a call, expected "
                  f"{want} (eager, remat full: {eager})")


def _matrix(runner, modes_by_arch, smi):
    """The Figs. 3-4 cells of each arch of ``modes_by_arch`` x ``train``
    (B=2, S=48) in its modes, mode by mode in ``MODES``'s order: each
    cell's line, and their ``ratio_table`` (``base="jit"``).  Every cell
    must be ok, and launch as its eager cell does.  Returns the results
    (bench -> mode -> record) and each cell's launches a step call."""
    from repro_torch.core.compilers import ratio_table
    from repro_torch.runner import Scenario
    from repro_torch.runner.scenario import MODES
    results, launches, bad = {}, {}, []
    cells = [Scenario(arch=arch, task="train", batch=2, seq=48, mode=mode)
             for mode in MODES for arch, modes in modes_by_arch.items() if mode in modes]
    for sc in cells:
        rr, per_call = _compiler_cell(runner, sc, 3, smi)
        launches[sc.name] = per_call
        if rr.status == "ok":
            results.setdefault(rr.bench, {})[rr.mode] = rr
        else:
            bad.append((sc.name, rr.error))
    rows = ratio_table(results, base="jit")
    eager_speedups = [r["time_ratio"] for r in rows if r["mode"] == "eager"]
    emit("compilers_ratios", base="jit", modes_by_arch=modes_by_arch, rows=rows,
         card=smi, jit_speedup_vs_eager_geomean=(
             math.exp(sum(math.log(x) for x in eager_speedups) / len(eager_speedups))
             if eager_speedups else None))
    check(not bad, f"compilers: matrix cells failed: {bad}")
    got = {b: sorted(m) for b, m in results.items()}
    check(got == {f"{a}/train": sorted(m) for a, m in modes_by_arch.items()},
          f"compilers: matrix results {got}")
    _matrix_launches_check(results, launches)
    return results, launches


def phase_compilers(smi):
    """The compiler modes on the card (paper §3.2, Figs. 3-4), through the
    runner and the harness, in parts, each in a process of its own
    (``PARTS``): the reduced cells (this function and
    ``phase_compilers_families``, in the ``nightly`` part) and the
    full-width cells
    (``phase_compilers_full``: the inference pairs, and the train pair):

    * the Figs. 3-4 matrix's gemma-2b cells (``train``, B=2, S=48, every
      mode; internlm2-20b's in ``phase_compilers_internlm2``, a part of
      its own), each cell's line with its median,
      ``compile_us``, host peak, device delta, Dynamo's graphs and breaks
      and its launches per step call; every cell ok, and a compiled
      cell's launches per call equal to its eager cell's (but
      ``jit_noremat``'s, whose build recomputes no forward: one forward
      launch a layer); ``ratio_table`` over it (``base="jit"``);
    * mamba2-2.7b's and recurrentgemma-9b's reduced ``infer_prefill`` cells
      under ``eager`` and ``jit``: the SSD and RG-LRU ops inside compiled
      graphs, as many launches a call as eager;
    * gemma-2b at full width: ``infer_prefill`` B=1 S=2048 (``jit``),
      ``infer_decode`` B=4 at 2048 (``jit_donated``) and ``train`` B=1
      S=2048 under ``remat="full"`` (``jit_donated``), each against its
      eager step (``_compiled_pair``), the inference cells profiled.

    No timed call may recompile (``harness.measure`` raises).  The Inductor
    cache was emptied at the start of the script, so each graph's first
    ``compile_us`` is cold.  Returns the phase's wall and its matrix
    cells' modes by bench."""
    from repro_torch.runner import BenchmarkRunner
    from repro_torch.runner.scenario import MODES, Scenario
    t0 = time.perf_counter()
    runner = BenchmarkRunner(device="cuda")
    results, _ = _matrix(runner, {"gemma-2b": MODES}, smi)
    for arch, kernel in (("mamba2-2.7b", "ssd"), ("recurrentgemma-9b", "rglru")):
        per = {}
        for mode in ("eager", "jit"):
            rr, per[mode] = _compiler_cell(
                runner, Scenario(arch=arch, task="infer_prefill", batch=2, seq=48, mode=mode),
                3, smi)
            check(rr.status == "ok", f"compilers: {rr.name}: {rr.error}")
        check(per["jit"] == per["eager"] and per["jit"][kernel] > 0,
              f"compilers: {arch} prefill launches a call: jit {per['jit']}, "
              f"eager {per['eager']}")
    runner.close()
    return time.perf_counter() - t0, {b: sorted(m) for b, m in results.items()}


def phase_compilers_internlm2(smi):
    """The Figs. 3-4 matrix's internlm2-20b cells (``train``, B=2, S=48,
    every mode), as ``phase_compilers``'s gemma-2b cells.  Returns the
    phase's wall and its cells' modes by bench."""
    from repro_torch.runner import BenchmarkRunner
    from repro_torch.runner.scenario import MODES
    t0 = time.perf_counter()
    runner = BenchmarkRunner(device="cuda")
    results, _ = _matrix(runner, {"internlm2-20b": MODES}, smi)
    runner.close()
    return time.perf_counter() - t0, {b: sorted(m) for b, m in results.items()}


def _aot_eager_train(arch, smi):
    """``arch``'s reduced train step (B=2, S=48, its matrix cell's shape)
    under ``torch.compile(backend="aot_eager")`` on the card: Dynamo and AOT
    autograd trace it, the SSD's and RG-LRU's ops and their backward ops
    staying opaque through their fake implementations, and the traced
    graphs run without Inductor's codegen.  Against the eager step on a
    copy of the same weights: the first step's loss and grad_norm within
    ``COMPILED_TOL`` (relative), a later call's launches equal to an eager
    call's and to ``_train_launches`` (each backward op once a layer), and
    no recompile."""
    import torch
    from repro_torch.core.harness import dynamo_counts
    from repro_torch.core.suite import build_arch, get_benchmark
    built = build_arch(arch, {}, "cuda")
    bench = get_benchmark(arch, "train")
    step, (state_e, batch), _ = bench.make(batch=2, seq=48, built=built)
    _, (state_c, _), _ = bench.make(batch=2, seq=48, built=built)
    compiled = torch.compile(step, backend="aot_eager", dynamic=False)
    c0 = dynamo_counts()
    t0 = time.perf_counter()
    state_c, mc = compiled(state_c, batch)          # the compile, then a step
    torch.cuda.synchronize()
    compile_s = time.perf_counter() - t0
    c1 = dynamo_counts()
    state_e, me = step(state_e, batch)
    launches = {}
    for way, fn in (("eager", step), ("aot_eager", compiled)):
        _reset_counts()
        state = state_e if way == "eager" else state_c
        state, _ = fn(state, batch)
        torch.cuda.synchronize()
        launches[way] = _read_counts()
    recompiled = _dynamo_delta(c1, dynamo_counts())["graphs"]
    dtype = "bf16" if built.cfg.compute_dtype == torch.bfloat16 else "fp32"
    rel = {k: abs(float(mc[k]) - float(me[k])) / abs(float(me[k]))
           for k in ("loss", "grad_norm")}
    want = _train_launches(built.cfg)
    res = dict(arch=arch, task="train", batch=2, seq=48, backend="aot_eager", dtype=dtype,
               compile_s=compile_s, first_call=_dynamo_delta(c0, c1),
               graphs_on_later_calls=recompiled, rel_err=rel, tol=COMPILED_TOL[dtype],
               launches_per_call=launches, expected=want, card=smi)
    emit("compilers_aot_eager_train", **res)
    check(res["first_call"]["graphs"] > 0 and recompiled == 0,
          f"{arch}: aot_eager train step graphs {res['first_call']}, {recompiled} later")
    check(max(rel.values()) <= COMPILED_TOL[dtype],
          f"{arch}: aot_eager train step differs from eager: {rel}")
    check(launches["aot_eager"] == launches["eager"] == want,
          f"{arch}: aot_eager train step launches {launches}, expected {want}")
    return res


def phase_compilers_families(smi):
    """The Figs. 3-4 matrix's cells of the families that train on the card
    from PR 25 on (``FIG34_FAMILIES``), eager: each launching a step call
    what ``_train_launches`` counts, the SSD's and RG-LRU's backward
    kernels included.  Returns the phase's wall and its cells' modes by
    bench."""
    from repro_torch.configs import get_arch
    from repro_torch.runner import BenchmarkRunner
    t0 = time.perf_counter()
    runner = BenchmarkRunner(device="cuda")
    results, launches = _matrix(runner, FIG34_FAMILIES, smi)
    runner.close()
    for arch in FIG34_FAMILIES:
        want = _train_launches(get_arch(arch).reduced())
        rr = results[f"{arch}/train"]["eager"]
        check(launches[rr.name] == want,
              f"compilers: {rr.name} launches {launches[rr.name]} a call, expected {want}")
    return time.perf_counter() - t0, {b: sorted(m) for b, m in results.items()}


def phase_compilers_full(smi, tasks):
    """The full-width part of the compilers phase (``phase_compilers``):
    gemma-2b's cells of ``tasks`` (of ``infer_prefill``, ``infer_decode``,
    ``train``) against their eager steps; with the inference cells, the
    serve CLI's compiled engine warmed on the same build
    (``_warm_serve_full``).  Returns their launches, each cell's wall and
    the warm-up's compile account."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.core.suite import get_benchmark
    from repro_torch.launch import serve
    cfg = get_arch("gemma-2b")
    built = serve.built_for_cfg(cfg)
    dtype = "bf16" if cfg.compute_dtype == torch.bfloat16 else "fp32"
    n = cfg.n_layers
    none = {"flash_attention_bwd": 0, "ssd": 0, "rglru": 0, "ssd_bwd": 0, "rglru_bwd": 0}
    walls, launches, warm = {}, {}, None
    for task, batch, mode, want, profile in (
            ("infer_prefill", 1, "jit", {"flash_attention": n, **none}, True),
            ("infer_decode", 4, "jit_donated", {"flash_attention": n, **none}, True),
            ("train", 1, "jit_donated", {**none, "flash_attention": 2 * n,
                                         "flash_attention_bwd": n}, False)):
        if task not in tasks:
            continue
        tc = time.perf_counter()
        step, args, mutable = get_benchmark("gemma-2b", task).make(batch=batch, seq=2048,
                                                                    built=built)
        launches[f"gemma-2b/{task}/b{batch}/s2048/{mode}"] = _compiled_pair(
            f"gemma-2b/{task}/b{batch}/s2048/full", step, args, mutable, mode,
            built.model.device, dtype, smi, want, profile=profile)
        del step, args
        _free_card()
        walls[task] = time.perf_counter() - tc
    if "infer_decode" in tasks:
        tc = time.perf_counter()
        warm = _warm_serve_full(built, smi)
        walls["serve_warm"] = time.perf_counter() - tc
    del built
    _free_card()
    return launches, walls, warm


def _warm_serve_full(built, smi):
    """The serve CLI's engine at full width (its trace, slots and cache
    bound: ``SERVE_ARGV``), compiled on ``built`` and run once, so that its
    graphs' first, cold compile lies here and the timed full-width phase's
    CLI run and ``_serve_compiled_full`` load them from Inductor's cache.
    Prints and returns the compile's account (seconds by phase, graphs,
    breaks, cache misses)."""
    import torch
    from repro_torch.core.harness import compile_budget, dynamo_counts
    from repro_torch.launch.serve import ServeEngine
    from repro_torch.runner.traces import TraceSpec, cache_len_bound, generate
    reqs = generate(TraceSpec(profile="uniform", requests=8, prompt_len=128, max_new=16,
                              seed=0, prompt_profile="fixed"), vocab=built.cfg.vocab)
    engine = ServeEngine(built, slots=4, max_len=cache_len_bound(reqs))
    c0, b0 = dynamo_counts(), compile_budget()
    t0 = time.perf_counter()
    out = engine.run(reqs)
    torch.cuda.synchronize()
    b1 = compile_budget()
    warm = dict(wall_s=time.perf_counter() - t0,
                compile_seconds={k: b1["seconds"][k] - b0["seconds"][k] for k in b1["seconds"]},
                fxgraph_cache={k: b1["fxgraph_cache"][k] - b0["fxgraph_cache"][k]
                               for k in b1["fxgraph_cache"]},
                admit_shapes=out["admit_shapes"], **_dynamo_delta(c0, dynamo_counts()))
    emit("serve_warm_full", arch="gemma-2b", card=smi, **warm)
    check(warm["graph_breaks"] == 0 and warm["graphs"] > 0,
          f"gemma-2b: the full-width serve engine's compile: {warm}")
    del engine
    return warm


def _part_compilers(smi):
    """The reduced part of the compilers phase: the Figs. 3-4 matrix's
    gemma-2b cells and the reduced prefills."""
    wall, matrix = phase_compilers(smi)
    return {"compilers_wall": wall, "matrix": matrix}


def _part_compilers_internlm2(smi):
    """The Figs. 3-4 matrix's internlm2-20b cells."""
    wall, matrix = phase_compilers_internlm2(smi)
    return {"internlm2_wall": wall, "matrix": matrix}


def _part_nightly(smi):
    """The nightly run, the Figs. 3-4 matrix's cells of the families that
    train on the card from PR 25 on, then ``serve_compiled_reduced``."""
    t0 = time.perf_counter()
    phase_nightly(smi)
    t1 = time.perf_counter()
    families, matrix = phase_compilers_families(smi)
    t2 = time.perf_counter()
    phase_serve_compiled_reduced(smi)
    return {"nightly_wall": t1 - t0, "families_wall": families, "matrix": matrix,
            "serve_compiled_reduced_wall": time.perf_counter() - t2}


def _part_runner(smi):
    """``runner_cell`` through a runner of its own (the matrix's prefill
    graphs load from Inductor's cache)."""
    from repro_torch.runner import BenchmarkRunner
    t0 = time.perf_counter()
    phase_runner(smi, BenchmarkRunner(device="cuda"))
    return {"runner_wall": time.perf_counter() - t0}


def _part_compilers_full(smi):
    """gemma-2b's full-width inference pairs and the serve engine's warm
    compile."""
    t0 = time.perf_counter()
    launches, walls, warm = phase_compilers_full(smi, ("infer_prefill", "infer_decode"))
    return {"launches": launches, "full_wall": time.perf_counter() - t0, "walls": walls,
            "serve_warm": warm}


def _part_dispatch(smi):
    """``phase_dispatch``; its cache faults go back to the main process,
    which checks them at the end."""
    t0 = time.perf_counter()
    faults = phase_dispatch(smi)
    return {"dispatch_wall": time.perf_counter() - t0, "cache_faults": faults}


def _part_compilers_train(smi):
    """gemma-2b's full-width train pair (54 GB at its peak, beside the
    inference part's 11 GB: 66 GB of the card's 80)."""
    t0 = time.perf_counter()
    launches, walls, _ = phase_compilers_full(smi, ("train",))
    return {"launches": launches, "train_wall": time.perf_counter() - t0, "walls": walls}


# the compile-bound parts, each run in a process of its own while the main
# one runs the phases that gate no time (``main``): a cold TorchInductor
# compile holds one host core for tens of seconds (a reduced graph ~20 s,
# half of it Triton's kernel builds) and leaves the card nearly idle, so
# run one after the other they took ~1,500 s.  Their medians are taken
# beside the other processes' work on the card and the host: reported,
# not gated (no check of this script reads a time of theirs)
PARTS = {"compilers": _part_compilers, "runner": _part_runner, "dispatch": _part_dispatch,
         "compilers_full": _part_compilers_full, "compilers_train": _part_compilers_train,
         "compilers_internlm2": _part_compilers_internlm2, "nightly": _part_nightly}


def _start_part(name, smi):
    """Start ``PARTS[name]`` as ``chip_smoke.py --part name`` in a session of
    its own (``_stop_part`` ends it and whatever it started); its lines go
    to a file that ``_join_part`` prints."""
    import types
    os.makedirs(PART_DIR, exist_ok=True)
    out, result = (os.path.join(PART_DIR, f"{name}.{ext}") for ext in ("log", "json"))
    for path in (out, result):
        if os.path.exists(path):
            os.remove(path)
    from repro_torch.core.harness import compile_env
    env = dict(os.environ, **compile_env(),
               CHIP_SMOKE_EPOCH=repr(time.time() - (time.perf_counter() - _T0)),
               CHIP_SMOKE_CARD=smi, CHIP_SMOKE_PARENT=str(os.getpid()))
    with open(out, "w") as f:
        proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--part", name,
                                 result], stdout=f, env=env, cwd=ROOT,
                                start_new_session=True)
    return types.SimpleNamespace(name=name, proc=proc, out=out, result=result)


def _stop_part(part):
    """Kill ``part``'s session: the part, if it still runs, and whatever it
    left (its compile workers)."""
    import signal
    try:
        os.killpg(part.proc.pid, signal.SIGKILL)
    except ProcessLookupError:
        pass
    part.proc.wait()


def _join_part(part):
    """Wait for ``part``, print its lines and return its result; a part that
    failed fails the script."""
    rc = part.proc.wait()
    _stop_part(part)
    with open(part.out) as f:
        sys.stdout.write(f.read())
    sys.stdout.flush()
    check(rc == 0, f"part {part.name} (chip_smoke.py --part {part.name}) exited {rc}")
    with open(part.result) as f:
        return json.load(f)


def part_main(name, result):
    """``chip_smoke.py --part name result``: run ``PARTS[name]`` and write its
    result, as JSON, to ``result``.  The kernels are the parent's builds.
    The part dies with its parent (Linux's ``PR_SET_PDEATHSIG``)."""
    import ctypes
    import signal
    import torch
    ctypes.CDLL(None, use_errno=True).prctl(1, signal.SIGKILL)   # PR_SET_PDEATHSIG
    if os.getppid() != int(os.environ["CHIP_SMOKE_PARENT"]):
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    got = PARTS[name](os.environ["CHIP_SMOKE_CARD"])
    from repro_torch.core.harness import compile_budget
    _emit_budget(f"part:{name}", compile_budget())
    with open(result, "w") as f:
        json.dump(got, f)
    return 0


def _kernel_entry(name, source, replaces, launches, cases, main_case, dtype="bf16"):
    main = next(c for c in cases if c["case"] == main_case and c["dtype"] == dtype)
    keys = ("case", "dtype", "variant", "n_split", "heads_per_block", "chunk", "ms",
            "device_ms", "passes_device_ms", "variants_device_ms", "variants_ms",
            "stream_floor_device_ms",
            "plain_ms", "bound_ms", "bound_by", "bound_share", "bound_share_device", "tflops",
            "gbytes_per_s", "tflops_device", "gbytes_per_s_device", "library_ms",
            "library_device_ms", "max_abs_err", "max_rel_err")
    timed = [{k: c[k] for k in keys if k in c} for c in cases if "ms" in c]
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": main["library_ms"],
            "timed_case": f"{main_case}/{dtype}", "cases": timed}


def main():
    if sys.argv[1:2] == ["--part"]:
        return part_main(*sys.argv[2:4])
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: this script "
              "needs a CUDA card", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)
    from repro_torch.core.harness import INDUCTOR_CACHE_DIR
    t0 = time.perf_counter()
    smi = phase_device()
    # every compile of this run is cold: no graph of an earlier run is reused
    shutil.rmtree(INDUCTOR_CACHE_DIR, ignore_errors=True)
    phase_build()
    # dispatch's and runner_cell's first minutes are cold compiles on the
    # host, and the card is the kernel phases' alone meanwhile: they start now
    parts = []
    try:
        parts += [_start_part(name, smi) for name in ("dispatch", "runner")]
        fa_cases = phase_kernels()
        bwd_cases = phase_fa_backward_kernels()
        ssd_cases = phase_ssd_kernels()
        rglru_cases = phase_rglru_kernels()
        phase_rglru_plan_sweep()
        ssd_bwd_cases = phase_ssd_bwd_kernels()
        rglru_bwd_cases = phase_rglru_bwd_kernels()
        perf = {"noise": [], "ci_full": [], "walls": dict.fromkeys(
            ("ci_full", "nightly", "noise", "coverage"), 0.0)}
        # the compile-bound phases in processes of their own (``PARTS``)
        # while this one runs the phases that gate no time; the timed
        # full-width phases run after every part has ended
        t_parts = time.perf_counter()
        parts += [_start_part(name, smi) for name in ("compilers_train", "compilers_full",
                                                      "compilers", "compilers_internlm2",
                                                      "nightly")]
        # the runner's phases, whose step cells compile now (TorchInductor)
        compiled_walls = {}
        for name, phase in (("coverage", lambda: phase_coverage(smi)),
                            ("loadgen", lambda: phase_loadgen(smi))):
            t_phase = time.perf_counter()
            phase()
            compiled_walls[name] = time.perf_counter() - t_phase
        phase_reference_check("gemma-2b")
        phase_reference_check("mamba2-2.7b")
        # a prompt past the reduced window (64): the ring and its gather
        phase_reference_check("recurrentgemma-9b", seq=88, max_len=100, prompt_len=40)
        # gemma3: past the reduced window (64) too, so its local layers' rings wrap
        phase_reference_check("gemma3-12b", seq=88, max_len=100, prompt_len=40)
        for arch in ("nemotron-4-15b", "internlm2-20b", "paligemma-3b", "whisper-large-v3"):
            phase_reference_check(arch)
        phase_train_reference_check()
        # the dense family's other archs: gemma3's local layers past their
        # reduced window (64), so the backward's sliding-window mask is live
        phase_train_reference_check("gemma3-12b", seq=88)
        phase_train_reference_check("nemotron-4-15b")
        # the families that train on the card from PR 25 on; recurrentgemma
        # past its reduced window (64), so its local layers' backward slides
        phase_train_reference_check("mamba2-2.7b")
        phase_train_reference_check("recurrentgemma-9b", seq=88, moments_tol=5e-4)
        phase_train_reference_check("paligemma-3b")
        phase_train_reference_check("whisper-large-v3")
        # mamba2's and recurrentgemma's train steps compiled under
        # aot_eager: here, where this process would wait for the parts
        for arch in FIG34_AOT_EAGER:
            _aot_eager_train(arch, smi)
        t_main = time.perf_counter() - t_parts
        got = {p.name: _join_part(p) for p in parts}
    finally:
        for p in parts:
            _stop_part(p)
    compiled_walls["nightly"] = got["nightly"]["nightly_wall"]
    compiled_walls["serve_compiled_reduced"] = got["nightly"]["serve_compiled_reduced_wall"]
    compiled_walls["runner"] = got["runner"]["runner_wall"]
    compiled_walls["dispatch"] = got["dispatch"]["dispatch_wall"]
    cache_faults = got["dispatch"]["cache_faults"]
    for name in ("nightly", "coverage"):
        perf["walls"][name] = compiled_walls[name]
    emit("runner_phase_walls", card=smi, walls_s=compiled_walls,
         compiled_mode="jit_donated (TorchInductor)", before_uncompiled_s=RUNNER_WALLS_BEFORE,
         beside_the_compilers_parts=True)
    # the Figs. 3-4 matrix across its three parts: gemma-2b and
    # internlm2-20b in every mode, the new families in FIG34_FAMILIES's
    from repro_torch.runner.scenario import MODES
    matrix = {**got["compilers"]["matrix"], **got["compilers_internlm2"]["matrix"],
              **got["nightly"]["matrix"]}
    want_matrix = {**{f"{a}/train": sorted(MODES) for a in FIG34_DENSE},
                   **{f"{a}/train": sorted(m) for a, m in FIG34_FAMILIES.items()}}
    check(matrix == want_matrix, f"compilers: matrix {matrix}, expected {want_matrix}")
    emit("compilers", card=smi, reduced_wall_s=got["compilers"]["compilers_wall"],
         internlm2_wall_s=got["compilers_internlm2"]["internlm2_wall"],
         families_wall_s=got["nightly"]["families_wall"], matrix=matrix,
         full_wall_s=got["compilers_full"]["full_wall"],
         train_wall_s=got["compilers_train"]["train_wall"],
         full_width_walls_s={**got["compilers_full"]["walls"],
                             **got["compilers_train"]["walls"]},
         concurrent_wall_s=time.perf_counter() - t_parts, main_process_wall_s=t_main)
    launches, variants, ssd_variants, rglru_variants = {}, {}, {}, {}
    profiles = []     # the profiled full-width cells' records
    from repro_torch.configs import get_arch
    # full width; mamba2-2.7b, recurrentgemma-9b and slice 5's models at a
    # cut depth, for the script's time limit since the compiler phases took
    # half of it (full depth before: mamba2 64 layers, recurrentgemma 38,
    # gemma3 48, nemotron 32, internlm2 24 of 48, paligemma 18, whisper 32
    # and 32)
    cut = lambda arch, **kw: dataclasses.replace(get_arch(arch), **kw)   # noqa: E731
    for arch, per_forward, profile, cfg in (
            ("gemma-2b", {"flash_attention": (18, 18)},
             ("infer_prefill", "infer_decode", "serve"), None),
            ("mamba2-2.7b", {"ssd": (16, 0)}, ("infer_prefill",),
             cut("mamba2-2.7b", n_layers=16)),
            # 2 groups (2 recurrent layers, 1 local attention) and 2 recurrent:
            # 6 RG-LRU (on prefill only) and 2 attention layers
            ("recurrentgemma-9b", {"rglru": (6, 0), "flash_attention": (2, 2)},
             ("infer_prefill",), cut("recurrentgemma-9b", n_layers=8))):
        (launches[arch], variants[arch], ssd_variants[arch],
         rglru_variants[arch]) = phase_full_width(
             arch, per_forward, cfg, profile=profile, profiles=profiles, perf=perf,
             ci=arch in ("gemma-2b", "mamba2-2.7b"), smi=smi,
             serve_warm=got["compilers_full"]["serve_warm"])
    for arch, per_forward, cfg in (
            # 1 group of 5 local layers and 1 global
            ("gemma3-12b", {"flash_attention": (6, 6)}, cut("gemma3-12b", n_layers=6)),
            ("nemotron-4-15b", {"flash_attention": (2, 2)}, cut("nemotron-4-15b", n_layers=2)),
            ("internlm2-20b", {"flash_attention": (2, 2)}, cut("internlm2-20b", n_layers=2)),
            ("paligemma-3b", {"flash_attention": (6, 6)}, cut("paligemma-3b", n_layers=6)),
            # prefill: 2 encoder, 2 self and 2 cross attention layers;
            # decode: 2 self and 2 cross
            ("whisper-large-v3", {"flash_attention": (6, 4)},
             cut("whisper-large-v3", n_layers=2, n_enc_layers=2))):
        limit = _param_bytes(cfg or get_arch(arch)) + MEMORY_HEADROOM
        launches[arch], variants[arch], _, _ = phase_full_width(arch, per_forward, cfg, limit)
    train_launches, train_bwd_variants = phase_train_full(profiles, perf)
    # every other family trained at full width, eager: mamba2-2.7b at its
    # full depth; recurrentgemma-9b at 8 of its 38 layers (at full depth
    # its fp32 weights, gradients and moments are 137 GB); paligemma-3b and
    # whisper-large-v3 at the cut depths of their inference phases
    family_launches, family_scan_bwd = {}, {}
    for arch, cfg in (("mamba2-2.7b", get_arch("mamba2-2.7b")),
                      ("recurrentgemma-9b", cut("recurrentgemma-9b", n_layers=8)),
                      ("paligemma-3b", cut("paligemma-3b", n_layers=6)),
                      ("whisper-large-v3", cut("whisper-large-v3", n_layers=2, n_enc_layers=2))):
        family_launches[arch], family_scan_bwd[arch] = phase_train_full_family(arch, cfg, smi)
    phase_profile_report(profiles)
    compiled_launches = {**got["compilers_full"]["launches"],
                         **got["compilers_train"]["launches"]}
    emit("perf_ci", card=smi, walls_s=perf["walls"],
         seconds_total=sum(perf["walls"].values()),
         noise={n["cell"]: dict(spread_rel=n["spread_rel"], false_issues=n["false_issues"],
                                threshold_exceeds_spread=n["threshold_exceeds_spread"])
                for n in perf["noise"]},
         ci_full={c["cell"]: dict(slowdown_s=c["slowdown_s"], culprit=c.get("culprit"),
                                  measures=c.get("measures"))
                  for c in perf["ci_full"]})
    check(len(perf["noise"]) == 6 and len(perf["ci_full"]) == 2,
          f"perf_ci: {len(perf['noise'])} noise cells, {len(perf['ci_full'])} ci cells")
    from repro_torch.core.harness import compile_budget
    _emit_budget("main", compile_budget())
    check(not cache_faults, f"Inductor's disk cache missed graphs another process compiled: "
                            f"{cache_faults}")
    print(smi, flush=True)
    print(json.dumps({"kernels": [
        dict(_kernel_entry("flash_attention", FA_SOURCE, FA_REPLACES,
                           launches["gemma-2b"]["flash_attention"], fa_cases, "gemma2b_prefill"),
             variants={"tc": "bf16 prefill, wgmma + TMA", "split": "split-KV decode + combine",
                       "simt": "fp32 prefill and other head dims, CUDA cores"},
             launches_by_variant=variants["gemma-2b"]),
        dict(_kernel_entry("ssd", SSD_SOURCE, SSD_REPLACES, launches["mamba2-2.7b"]["ssd"],
                           ssd_cases, "mamba2_prefill"),
             variants={"tc": "bf16, P=64 N=128: chunk states, state pass, chunk scan "
                             "(mma.sync, cp.async)",
                       "simt": "fp32 and other head sizes, CUDA cores"},
             launches_by_variant=ssd_variants["mamba2-2.7b"]),
        dict(_kernel_entry("rglru", RGLRU_SOURCE, RGLRU_REPLACES,
                           launches["recurrentgemma-9b"]["rglru"], rglru_cases,
                           "recurrentgemma_prefill", dtype="fp32"),
             variants={"chunked": "32-step chunks, decoupled look-back over time, rescan",
                       "seq": "one thread per (row, lane) walks every step"},
             launches_by_variant=rglru_variants["recurrentgemma-9b"]),
        dict(_kernel_entry("flash_attention_bwd", FA_BWD_SOURCE, FA_BWD_REPLACES,
                           train_launches["flash_attention_bwd"], bwd_cases, "gemma2b_train"),
             max_rel_err=max(c["max_rel_err"] for c in bwd_cases),
             variants={"tc": "bf16, D in {32, 64, 128, 256}, H / K dividing 64: wgmma, TMA "
                             "rings, two warpgroups exchanging P and dS through shared memory",
                       "simt": "fp32 and other head dims, CUDA cores"},
             launches_by_variant=train_bwd_variants,
             launches_per="gemma-2b full-width train step (B=1, S=2048)"),
        dict(_kernel_entry("ssd_bwd", SSD_BWD_SOURCE, SSD_BWD_REPLACES,
                           family_launches["mamba2-2.7b"]["ssd_bwd"], ssd_bwd_cases,
                           "mamba2_train"),
             max_rel_err=max(c["max_rel_err"] for c in ssd_bwd_cases),
             variants={"simt": "chunk and gradient states, the two carries, the chunks' "
                               "gradients and the heads' sums: CUDA cores, fp32"},
             launches_by_variant=family_scan_bwd["mamba2-2.7b"]["ssd_bwd"],
             launches_per="mamba2-2.7b full-width train step (64 layers, B=1, S=2048)"),
        dict(_kernel_entry("rglru_bwd", RGLRU_BWD_SOURCE, RGLRU_BWD_REPLACES,
                           family_launches["recurrentgemma-9b"]["rglru_bwd"], rglru_bwd_cases,
                           "recurrentgemma_train", dtype="fp32"),
             max_rel_err=max(c["max_rel_err"] for c in rglru_bwd_cases),
             variants={"seq": "one thread per (row, lane) walks the steps backward"},
             launches_by_variant=family_scan_bwd["recurrentgemma-9b"]["rglru_bwd"],
             launches_per="recurrentgemma-9b full-width train step (8 of 38 layers, B=1, "
                          "S=2048)")],
        "train_launches_per_step_by_family": family_launches,
        "gemma2b_train_flash_forward_launches_per_step": train_launches["flash_attention"],
        "recurrentgemma_flash_attention_launches":
            launches["recurrentgemma-9b"]["flash_attention"],
        "recurrentgemma_flash_launches_by_variant": variants["recurrentgemma-9b"],
        # each full-width serve run of the dense-variant, vlm and encdec slice
        "flash_attention_launches_by_model": {
            a: launches[a]["flash_attention"] for a in ("gemma3-12b", "nemotron-4-15b",
                                                        "internlm2-20b", "paligemma-3b",
                                                        "whisper-large-v3")},
        # each compiled full-width gemma-2b step's launches, equal to eager's
        "compiled_step_launches": compiled_launches,
        "flash_launches_by_variant_by_model": {
            a: variants[a] for a in ("gemma3-12b", "nemotron-4-15b", "internlm2-20b",
                                     "paligemma-3b", "whisper-large-v3")},
        "seconds": round(time.perf_counter() - t0, 1)}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
