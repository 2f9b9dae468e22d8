"""Execution-mode ("compiler backend") comparison (port of
``repro.core.compilers``, paper §3.2 and Figs. 3-4).

TorchBench compares PyTorch eager against TorchInductor in time, host
memory and device memory.  The port's modes (``runner/scenario.py``):

  eager          the step uncompiled, op by op (``harness.measure_eager``)
  jit            ``torch.compile`` of the step: TorchInductor on the card
                 (``aot_eager`` on the CPU; ``harness.compile_step``)
  jit_donated    + the state updated in place and threaded (donation)
  jit_unrolled   the layer loop traced inline (no nested compile region)
  jit_noremat    no activation rematerialisation (``remat="none"``)

Mode execution lives in the ``BenchmarkRunner`` (one arch build is shared
by eager, jit and jit_donated; the override modes build their own).
This module keeps the comparison front end: ``compare_modes`` for one
benchmark and ``ratio_table`` for the paper's T/CM/GM ratios.  A runner
this module creates runs on the card, as every entry point of the port
does unless the caller asks for the CPU.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

from repro_torch.core.harness import Measurement
from repro_torch.runner.scenario import MODES, Scenario

__all__ = ["MODES", "compare_modes", "ratio_table"]


def compare_modes(bench, *, batch: int = 2, seq: int = 64, runs: int = 5,
                  modes: Tuple[str, ...] = MODES,
                  runner=None) -> Dict[str, Measurement]:
    """Measure one suite benchmark under each execution mode; a mode whose
    cell fails raises, naming it."""
    from repro_torch.runner.runner import BenchmarkRunner
    runner = runner or BenchmarkRunner(runs=runs)
    out: Dict[str, Measurement] = {}
    for mode in modes:
        sc = Scenario(arch=bench.arch, task=bench.task, batch=batch, seq=seq,
                      mode=mode)
        rr = runner.run(sc, runs=runs)
        if rr.status != "ok":
            raise RuntimeError(f"{sc.name}: {rr.error}")
        out[mode] = Measurement(
            name=f"{bench.name}/{mode}", median_us=rr.median_us,
            mean_us=rr.mean_us, p10_us=rr.p10_us, p90_us=rr.p90_us,
            compile_us=rr.compile_us, host_peak_bytes=rr.host_peak_bytes,
            device_bytes_delta=rr.device_bytes_delta, runs=rr.runs)
    return out


def ratio_table(results: Dict[str, Dict[str, Any]], base: str = "jit",
                rel: str = "eager") -> List[Dict[str, Any]]:
    """Per-benchmark T/CM/GM ratios (mode / base), like the paper's <1 / >1
    bars.

    ``results`` maps benchmark -> mode -> any object with ``median_us`` /
    ``host_peak_bytes`` / ``device_bytes_delta`` attributes (Measurement or
    RunResult).  A ratio over a base of 0 is 0.0, as in the reference.
    """
    rows = []
    for bname, modes in results.items():
        if base not in modes:
            continue
        b = modes[base]
        for mode, m in modes.items():
            if mode == base:
                continue
            rows.append({
                "benchmark": bname, "mode": mode,
                "time_ratio": m.median_us / b.median_us if b.median_us else 0.0,
                "host_mem_ratio": (m.host_peak_bytes / b.host_peak_bytes)
                if b.host_peak_bytes else 0.0,
                "device_mem_ratio": (m.device_bytes_delta / b.device_bytes_delta)
                if b.device_bytes_delta else 0.0,
            })
    return rows
