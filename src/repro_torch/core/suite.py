"""The benchmark suite registry (port of ``repro.core.suite``).

Every entry is a computation-phase benchmark (paper §2.2): one step over
device-resident inputs, no data loading inside the measured region.  The
port registers the inference tasks of the archs it has ported;
``task="train"`` comes with the training slice (ROADMAP Queue 1, slice 2).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.configs import ARCHS, get_arch
from repro_torch.device import DeviceLike, resolve_device

CRITERIA = {
    "gemma-2b": "popular",
    "internlm2-20b": "popular",
    "nemotron-4-15b": "industrial",
    "gemma3-12b": "industrial",
    "deepseek-v2-236b": "popular",
    "mixtral-8x7b": "popular",
    "whisper-large-v3": "industrial",
    "paligemma-3b": "industrial",
    "mamba2-2.7b": "classic-successor",
    "recurrentgemma-9b": "diverse",
}


@dataclasses.dataclass
class Built:
    """A reusable arch build: config + model.  The model holds its weights
    (the reference keeps them beside it as ``params``) on its device."""
    cfg: Any
    model: Any


def build_arch(arch: str, overrides: Optional[Dict[str, Any]] = None,
               device: DeviceLike = "cuda") -> Built:
    """Build the reduced config and the model (weights from seed 0) for one
    arch on ``device``; raises when the card is asked for and absent."""
    from repro_torch.models import build_model
    cfg = get_arch(arch).reduced(**(overrides or {}))
    return Built(cfg=cfg, model=build_model(cfg, device=resolve_device(device)))


@dataclasses.dataclass
class Benchmark:
    name: str                 # e.g. "gemma-2b/infer_decode"
    arch: str
    task: str                 # train | infer_prefill | infer_decode
    domain: str
    criteria: str

    def make(self, *, batch: int = 2, seq: int = 64,
             built: Optional[Built] = None,
             overrides: Optional[Dict[str, Any]] = None,
             device: DeviceLike = "cuda"):
        """-> (step_fn, args, donate_argnums).

        The arguments are ``(model, batch-or-tokens, cache)``; the step
        updates the cache (slot 2) in place.  Tokens are drawn from numpy
        with seed 1, on the model's device.  ``device`` is used only when
        ``built`` is not given.
        """
        if self.task == "train":
            raise NotImplementedError(
                "task='train' comes with the training slice (ROADMAP "
                "Queue 1, slice 2: optim/, launch/steps.py, loss)")
        if self.task not in ("infer_prefill", "infer_decode"):
            raise ValueError(self.task)
        if built is None:
            built = build_arch(self.arch, overrides, device)
        cfg, model = built.cfg, built.model
        rng = np.random.default_rng(1)
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, (batch, seq),
                                             dtype=np.int64).astype(np.int32))
        toks = toks.to(model.device)
        cache = model.init_cache(batch, seq + 8)
        if self.task == "infer_prefill":
            return ((lambda m, b, c: m.prefill(b, c)),
                    (model, {"tokens": toks}, cache), (2,))
        model.prefill({"tokens": toks}, cache)
        return ((lambda m, t, c: m.decode_step(t, c)),
                (model, toks[:, :1].contiguous(), cache), (2,))


def get_benchmark(arch: str, task: str) -> Benchmark:
    """Registry lookup: one suite entry by (arch, task)."""
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r} (known: {sorted(ARCHS)})")
    return Benchmark(name=f"{arch}/{task}", arch=arch, task=task,
                     domain=ARCHS[arch].domain,
                     criteria=CRITERIA.get(arch, "diverse"))
