#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA card.

Run from the root of a checkout, with one CUDA card visible:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from the checkout's sources, holds
each against its plain PyTorch version on the card, runs the runner's
reduced gemma-2b cells, then serves and steps gemma-2b at its full
published width through the user entry points, and checks that every
attention call of that run went through the kernel.  One JSON line per
phase; the last line is the ``{"ok": true, "device": ...}`` summary.  Any
failed phase raises and the script exits non-zero, printing no summary;
so it does without a card, and outside a checkout of the repository.

TF32 is switched off for matrix products and cuDNN, so fp32 plain versions
are full fp32 on the card.
"""
import contextlib
import copy
import io
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# H100 SXM published peaks (NVIDIA data sheet; dense, at the 700 W limit)
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}   # fp32 outside the tensor cores
PEAK_BYTES = 3.35e12
TOL = {"fp32": 2e-5, "bf16": 2e-2}             # as tests/test_kernels.py
FA_SOURCE = "src/repro_torch/csrc/flash_attention.cu"
FA_REPLACES = "src/repro/kernels/flash_attention/kernel.py:123"


def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


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
    from repro_torch.kernels.flash_attention import kernel as fa
    t0 = time.perf_counter()
    fa.library()
    ptxas = fa.build_info.get("ptxas", "")
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", ptxas)]
    spills = re.findall(r"(\d+) bytes spill stores", ptxas)
    emit("build", kernel="flash_attention", source=FA_SOURCE,
         seconds=round(time.perf_counter() - t0, 3),
         nvcc_seconds=fa.build_info.get("seconds"), registers=regs,
         spill_store_bytes=[int(s) for s in spills],
         dynamic_smem_bytes_d256=fa.shared_memory_bytes(256),
         ptxas=ptxas.splitlines())


def _visible(B, Sq, Sk, mask_type, window, prefix_len, q_offset, kv_len, dev):
    """(B, Sq, Sk) bool: which keys each query of each row attends to."""
    import torch
    from repro_torch.kernels.flash_attention.ref import allowed_mask
    qo = torch.as_tensor(q_offset, device=dev).reshape(-1)
    q_pos = qo[:, None] + torch.arange(Sq, device=dev)
    k_pos = torch.arange(Sk, device=dev)
    vis = allowed_mask(q_pos, k_pos, mask_type, window, prefix_len)
    vis = vis.expand(B, Sq, Sk)
    if kv_len is not None:
        lim = torch.as_tensor(kv_len, device=dev).reshape(-1)[:, None, None]
        vis = vis & (k_pos < lim)
    return vis


def _bound(dtype, B, Sq, H, K, D, vis):
    """Least time for this call's work: the visible (query, key) pairs'
    FLOPs at the type's peak, or the bytes of q, the output and the keys
    and values some query sees, at the memory rate."""
    elem = 2 if dtype == "bf16" else 4
    flops = 4.0 * D * H * int(vis.sum().item())
    kv_rows = int(vis.any(dim=1).sum().item())
    nbytes = elem * (2 * B * Sq * H * D + 2 * kv_rows * K * D)
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def kernel_case(name, dtype, B, Sq, Sk, H, K, D, timed=False, mask_type="causal",
                window=0, prefix_len=0, q_offset=0, kv_len=None, softcap=0.0):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref
    dev = torch.device("cuda")
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    g = torch.Generator().manual_seed(0)
    q, k, v = [torch.randn(s, generator=g).to(dev, tdt)
               for s in ((B, Sq, H, D), (B, Sk, K, D), (B, Sk, K, D))]
    kw = dict(mask_type=mask_type, window=window, prefix_len=prefix_len,
              q_offset=q_offset, kv_len=kv_len, softcap=softcap)
    out = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    want = attention_ref(q, k, v, **kw)
    err = (out.float() - want.float()).abs().max().item()
    res = dict(case=name, dtype=dtype, shape=dict(B=B, Sq=Sq, Sk=Sk, H=H, K=K, D=D),
               mask=mask_type, max_abs_err=err, tol=TOL[dtype],
               finite=bool(torch.isfinite(out).all().item()))
    check(res["finite"] and err <= TOL[dtype],
          f"kernel disagrees with its plain version: {res}")
    if timed:
        vis = _visible(B, Sq, Sk, mask_type, window, prefix_len, q_offset, kv_len, dev)
        res["bound_ms"], res["bound_by"] = _bound(dtype, B, Sq, H, K, D, vis)
        res["ms"] = time_ms(lambda: flash_attention(q, k, v, **kw))
        res["plain_ms"] = time_ms(lambda: attention_ref(q, k, v, **kw), iters=3, warmup=1)
        # yardstick only, never called by the port: one library call on the
        # same inputs (kv heads repeated, explicit mask)
        qt = q.transpose(1, 2)
        kt = k.transpose(1, 2).repeat_interleave(H // K, dim=1)
        vt = v.transpose(1, 2).repeat_interleave(H // K, dim=1)
        am = vis[:, None]
        res["library_ms"] = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=am, scale=D ** -0.5), iters=5, warmup=2)
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
    return cases


def phase_runner():
    from repro_torch.runner import BenchmarkRunner, Scenario
    runner = BenchmarkRunner(device="cuda")
    for task, kw in (("infer_prefill", {}), ("infer_decode", {}),
                     ("serve", dict(batch=8, seq=32))):
        sc = Scenario(arch="gemma-2b", task=task, **kw)
        rr = runner.run(sc)
        emit("runner_cell", scenario=sc.name, status=rr.status, median_us=rr.median_us,
             compile_us=rr.compile_us, error=rr.error,
             prov_device=rr.extra.get("prov_device"))
        check(rr.status == "ok", f"runner cell {sc.name}: {rr.error}")


def phase_reference_check():
    """The kernel path against the plain path on a small input: the same
    reduced gemma-2b weights (fp32 compute) on the card and on the CPU give
    logits within 1e-4 and equal greedy serve tokens."""
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.core.suite import Built
    from repro_torch.launch.serve import ServeEngine, summarize_metrics
    from repro_torch.models import build_model
    from repro_torch.runner.traces import TraceSpec, cache_len_bound, generate
    cfg = get_arch("gemma-2b").reduced(compute_dtype=torch.float32)
    cpu = build_model(cfg, device="cpu", seed=0)
    gpu = copy.deepcopy(cpu).to("cuda")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 24)).astype(np.int32))
    lc, _ = cpu.prefill({"tokens": toks}, cpu.init_cache(2, 32))
    lg, _ = gpu.prefill({"tokens": toks.cuda()}, gpu.init_cache(2, 32))
    err = (lg.cpu() - lc).abs().max().item()
    reqs = generate(TraceSpec(profile="bursty", requests=8, prompt_len=16, max_new=8,
                              prompt_profile="bimodal"), vocab=cfg.vocab)
    digests = {}
    for name, model in (("cpu", cpu), ("cuda", gpu)):
        eng = ServeEngine(Built(cfg, model), slots=4, max_len=cache_len_bound(reqs))
        digests[name] = summarize_metrics(eng.run(reqs))["tokens_digest"]
    emit("reference_check", logits_max_abs_err=err, tol=1e-4,
         digest_cpu=digests["cpu"], digest_cuda=digests["cuda"])
    check(err <= 1e-4, f"card vs CPU logits differ by {err}")
    check(digests["cpu"] == digests["cuda"], "card vs CPU serve tokens differ")


def phase_profile(model, steps=5):
    """Where a full-width decode step's time goes, at the serve run's
    shape (4 slots, positions ~130 of a 144-token cache): wall per step
    without the profiler, device time per step and its top kernels from
    ``torch.profiler`` (device busy share = device time / wall)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    cache = model.init_cache(4, 144)
    g = torch.Generator().manual_seed(0)
    toks = torch.randint(0, model.cfg.vocab, (4, 128), generator=g,
                         dtype=torch.int32).cuda()
    model.prefill({"tokens": toks}, cache)
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
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    emit("profile_decode_full", steps=steps, wall_ms_per_step=wall_ms,
         device_ms_per_step=dev_us / 1e3 if dev_us else "not measured",
         device_busy_share=dev_us / 1e3 / wall_ms if dev_us else "not measured",
         top_kernels=[dict(name=e.key[:80], calls_per_step=e.count / steps,
                           ms_per_step=e.self_device_time_total / steps / 1e3)
                      for e in top])


def phase_full_width():
    """gemma-2b at its full published config (18 layers, d_model 2048, MQA
    head_dim 256, vocab 256000), random weights from seed 0."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.core import harness
    from repro_torch.core.suite import get_benchmark
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda as fa
    from repro_torch.launch import serve
    cfg = get_arch("gemma-2b")
    torch.cuda.reset_peak_memory_stats()
    argv = ["--arch", "gemma-2b", "--full", "--requests", "8", "--slots", "4",
            "--prompt-len", "128", "--max-new", "16"]
    buf = io.StringIO()
    fa.launches = 0                      # main path: serve through the CLI
    with contextlib.redirect_stdout(buf):
        rc = serve.main(argv)
    launches = fa.launches
    text = buf.getvalue()
    print(text, end="", flush=True)
    m = re.search(r"served (\d+) requests .*?: (\d+) tokens in ([\d.]+)s \(([\d.]+) tok/s, "
                  r"(\d+) steps, \w+ admission: (\d+) prefill calls\)", text)
    check(rc == 0 and m, f"serve CLI failed: {text}")
    served, tokens, steps, admits = (int(m.group(i)) for i in (1, 2, 5, 6))
    ttft_p50 = float(re.search(r"ttft_us\s+p50=(\d+)", text).group(1))
    forwards = steps + admits
    emit("serve_full", argv=argv, requests=served, tokens=tokens,
         tok_per_s=float(m.group(4)), ttft_p50_us=ttft_p50, decode_steps=steps,
         admit_calls=admits, kernel_launches=launches, forwards=forwards,
         launches_per_forward=launches / forwards)
    check(served == 8 and tokens == 8 * 16, "not every request was answered")
    check(launches == cfg.n_layers * forwards,
          f"{launches} kernel launches for {forwards} forwards of {cfg.n_layers} layers")

    built = serve.built_for_cfg(cfg)
    phase_profile(built.model)
    steps_out = {}
    for task, batch, donate in (("infer_prefill", 1, ()), ("infer_decode", 4, (2,))):
        step, args, mutable = get_benchmark("gemma-2b", task).make(
            batch=batch, seq=2048, built=built)
        # prefill is measured fresh every call (its cache copied); decode
        # threads its cache, 7 steps from position 2048 inside max_len 2056
        fn = harness.prepare(step, donate, mutable=mutable)
        fa.launches = 0
        out = fn(*args)
        torch.cuda.synchronize()
        per_forward = fa.launches
        logits = out[0]
        check(tuple(logits.shape) == (batch, 1, cfg.vocab)
              and bool(torch.isfinite(logits.float()).all().item()),
              f"{task}: logits {tuple(logits.shape)} not finite or misshapen")
        meas = harness.measure(f"gemma-2b/{task}/b{batch}/s2048", step, args, donate,
                               runs=5, warmup=1, jitted=fn)
        steps_out[task] = meas
        emit("step_full", task=task, batch=batch, seq=2048, median_us=meas.median_us,
             p10_us=meas.p10_us, p90_us=meas.p90_us, launches_per_forward=per_forward)
        check(per_forward == cfg.n_layers,
              f"{task}: {per_forward} kernel launches in one forward")
    emit("memory", max_memory_allocated=torch.cuda.max_memory_allocated(),
         param_bytes=sum(p.numel() * p.element_size() for p in built.model.parameters()))
    return launches


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: this script "
              "needs a CUDA card", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)
    t0 = time.perf_counter()
    smi = phase_device()
    phase_build()
    cases = phase_kernels()
    phase_runner()
    phase_reference_check()
    launches = phase_full_width()
    main_case = next(c for c in cases if c["case"] == "gemma2b_prefill" and c["dtype"] == "bf16")
    timed = [{k: c[k] for k in ("case", "dtype", "ms", "plain_ms", "bound_ms",
                                "bound_by", "library_ms", "max_abs_err")}
             for c in cases if "ms" in c]
    print(smi, flush=True)
    print(json.dumps({"kernels": [{
        "name": "flash_attention", "route": "cuda", "source": FA_SOURCE,
        "replaces": FA_REPLACES, "launches": launches,
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"], "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"], "timed_case": "gemma2b_prefill/bf16",
        "cases": timed}], "seconds": round(time.perf_counter() - t0, 1)}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
