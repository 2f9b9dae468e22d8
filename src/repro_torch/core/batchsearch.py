"""Inference batch-size search (port of ``repro.core.batchsearch``, paper
§2.2 batch-size configuration).

TorchBench doubles the inference batch size until GPU utilization peaks;
the analogue here maximizes the measured step's throughput (items/s),
stopping when throughput stops improving or a cell fails (out of memory
among them).

The doubling loop runs through the ``BenchmarkRunner``: one arch build
(model and weights) is shared by every batch size probed, so each probe
pays only for its own cache and compile.  A runner this module creates
runs on the card, as every entry point of the port does unless the
caller asks for the CPU.
"""
from __future__ import annotations

from typing import Dict, List, Tuple


def search_batch_size(bench, *, seq: int = 64, start: int = 1, max_batch: int = 64,
                      runs: int = 3, runner=None) -> Tuple[int, List[Dict]]:
    """-> (best batch, the probes' history): doubling from ``start`` up to
    ``max_batch``; a probe more than 5% faster in items/s becomes the best,
    one more than 5% slower than the best ends the search."""
    from repro_torch.runner.runner import BenchmarkRunner
    from repro_torch.runner.scenario import Scenario
    runner = runner or BenchmarkRunner(runs=runs)
    best_b, best_tps = start, 0.0
    history = []
    b = start
    while b <= max_batch:
        sc = Scenario(arch=bench.arch, task=bench.task, batch=b, seq=seq)
        rr = runner.run(sc, runs=runs)
        if rr.status != "ok":
            history.append({"batch": b, "error": (rr.error or "")[:100]})
            break
        tps = b / (rr.median_us / 1e6)
        history.append({"batch": b, "median_us": rr.median_us, "items_per_s": tps})
        if tps > best_tps * 1.05:
            best_tps, best_b = tps, b
        elif tps < best_tps * 0.95:
            break   # throughput declining: past the knee
        b *= 2
    return best_b, history
