"""Accelerator profiles for roofline bounds (port of ``repro.core.hardware``).

The port measures on one NVIDIA H100 SXM, so its one profile, and the
default of the profiler's attribution, is that card's: NVIDIA's published
dense peaks at the 700 W limit (the numbers ``chip_smoke.py`` holds its
kernels to).  The reference's other profiles wait for the hardware
comparison (``hwcompare.py``, ROADMAP Queue 1, item 13).
"""
from __future__ import annotations

import dataclasses
from typing import Dict


@dataclasses.dataclass(frozen=True)
class HardwareProfile:
    name: str
    peak_flops_bf16: float      # FLOP/s per chip
    peak_flops_fp32: float
    hbm_bw: float               # bytes/s per chip
    hbm_bytes: float            # capacity per chip
    link_bw: float              # bytes/s per inter-chip link
    chips_per_pod: int

    def peak(self, dtype: str = "bf16") -> float:
        return self.peak_flops_bf16 if dtype == "bf16" else self.peak_flops_fp32


HW_PROFILES: Dict[str, HardwareProfile] = {
    # bf16 dense on the tensor cores, fp32 on the CUDA cores; 80 GB of HBM3
    # at 3.35 TB/s; NVLink 4 at 450 GB/s each way; 8 cards to a node
    "h100_sxm": HardwareProfile("h100_sxm", 989e12, 67e12, 3.35e12, 80e9, 450e9, 8),
}

DEFAULT_HW = HW_PROFILES["h100_sxm"]
