"""Learning-rate schedules (port of ``repro.optim.schedule``): pure
functions of the step that return fp32 tensors on the step's device."""
from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def linear_warmup(step, warmup_steps: int, peak: float) -> torch.Tensor:
    s = _f32(step)
    return peak * torch.clamp((s + 1) / max(warmup_steps, 1), max=1.0)


def cosine_schedule(step, warmup_steps: int, total_steps: int, peak: float,
                    floor_frac: float = 0.1) -> torch.Tensor:
    s = _f32(step)
    warm = peak * torch.clamp((s + 1) / max(warmup_steps, 1), max=1.0)
    prog = torch.clamp((s - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = peak * (floor_frac + (1 - floor_frac) * 0.5 * (1 + torch.cos(math.pi * prog)))
    return torch.where(s < warmup_steps, warm, cos)
