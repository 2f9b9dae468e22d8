"""The benchmark suite registry (port of ``repro.core.suite``).

Every entry is a computation-phase benchmark (paper §2.2): one step over
device-resident inputs, no data loading inside the measured region.  The
port registers the train, prefill and decode tasks of the archs it has
ported.  Every family trains on both devices: on the card each kernel's
gradient is a hand-written backward kernel (flash attention, the SSD and
the RG-LRU, ``kernels/library.py``).
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

        Inference: the arguments are ``(model, batch-or-tokens, cache)``;
        the step updates the cache (slot 2) in place.  Training: the
        arguments are ``(state, batch)`` with ``state = (model, OptState)``
        over a copy of the build's weights (the cached ``Built`` stays
        frozen for the other tasks), and the step updates the state (slot
        0) in place.  Tokens are drawn from numpy with seed 1, the encdec
        family's ``frames`` (B, enc_seq, d_model) x 0.1 and the vlm
        family's ``patch_embeds`` (B, n_prefix, d_model) x 0.02 from numpy
        with seed 2 (standard normal, as float32), all on the model's
        device; the caches hold ``seq + 8 + n_prefix`` positions.
        ``device`` is used only when ``built`` is not given.
        """
        if self.task not in ("train", "infer_prefill", "infer_decode"):
            raise ValueError(self.task)
        if built is None:
            built = build_arch(self.arch, overrides, device)
        cfg, model = built.cfg, built.model
        rng = np.random.default_rng(1)
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, (batch, seq),
                                             dtype=np.int64).astype(np.int32))
        toks = toks.to(model.device)
        batch_dict = {"tokens": toks}
        rng2 = np.random.default_rng(2)
        if cfg.family == "encdec":
            frames = rng2.standard_normal((batch, cfg.enc_seq, cfg.d_model)) * 0.1
            batch_dict["frames"] = torch.from_numpy(frames.astype(np.float32)).to(model.device)
        if cfg.family == "vlm":
            pe = rng2.standard_normal((batch, cfg.n_prefix, cfg.d_model)) * 0.02
            batch_dict["patch_embeds"] = torch.from_numpy(pe.astype(np.float32)).to(model.device)
        if self.task == "train":
            from repro_torch.launch.steps import make_train_step
            from repro_torch.models.model import Model
            from repro_torch.optim.adamw import adamw_init
            # the state's own model over a copy of the weights: the state
            # is updated in place, and the cached Built must stay valid
            # (and grad-free) for the other tasks of this arch
            params = model.stacked_params()
            trained = Model(cfg, params).requires_grad_(True)
            state = (trained, adamw_init(params))
            return make_train_step(cfg), (state, batch_dict), (0,)
        cache = model.init_cache(batch, seq + 8 + (cfg.n_prefix or 0))
        if self.task == "infer_prefill":
            return ((lambda m, b, c: m.prefill(b, c)),
                    (model, batch_dict, cache), (2,))
        model.prefill(batch_dict, cache)
        return ((lambda m, t, c: m.decode_step(t, c)),
                (model, toks[:, :1].contiguous(), cache), (2,))


def get_benchmark(arch: str, task: str) -> Benchmark:
    """Registry lookup: one suite entry by (arch, task)."""
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r} (known: {sorted(ARCHS)})")
    return Benchmark(name=f"{arch}/{task}", arch=arch, task=task,
                     domain=ARCHS[arch].domain,
                     criteria=CRITERIA.get(arch, "diverse"))
