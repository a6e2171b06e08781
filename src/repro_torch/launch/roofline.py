"""Single-kernel roofline placement on one NVIDIA H100.

Counterpart of ``RoofPoint`` and ``kernel_roof_point`` in
``src/repro/launch/roofline.py``, with the H100's roofs in place of the
TPU's. The reference's HLO half (``collective_stats``,
``build_roofline``, ``cost_analysis_dict``) reads XLA's compiled HLO and
serves only its dry run; it is ported with that (ROADMAP queue A item 6).

The peaks are NVIDIA's data sheet figures for the SXM part at its 700 W
limit (dense rates, no sparsity). ``chip_smoke.py`` takes its bounds from
here, so the repository has one source of them.
"""
from __future__ import annotations

import dataclasses

PEAK_BYTES_S = 3.35e12   # HBM3
PEAK_FP32_S = 67e12      # outside the tensor cores
PEAK_BF16_S = 989e12     # dense tensor-core rate
PEAK_TF32_S = 495e12     # dense tensor-core rate


@dataclasses.dataclass
class RoofPoint:
    """Placement of ONE kernel on the card's roofline: where its analytic
    arithmetic intensity (flop/byte) falls relative to the ridge point
    ``peak_flops / hbm_bw`` and what fraction of peak the roof allows
    there. Shape-derived, not timed."""
    flops: float
    bytes: float
    intensity: float         # flop / byte
    ridge: float             # peak_flops / hbm_bw (flop/byte)
    bound: str               # "memory" when intensity < ridge else "compute"
    peak_fraction: float     # attainable FLOP/s at this intensity / peak
    t_compute: float         # seconds at peak compute
    t_memory: float          # seconds at peak HBM bandwidth


def kernel_roof_point(flops: float, bytes_: float, *,
                      peak_flops: float = PEAK_FP32_S,
                      hbm_bw: float = PEAK_BYTES_S) -> RoofPoint:
    """Place a kernel with analytic ``flops``/``bytes_`` on the roofline."""
    intensity = flops / max(bytes_, 1.0)
    ridge = peak_flops / hbm_bw
    attainable = min(peak_flops, intensity * hbm_bw)
    return RoofPoint(
        flops=float(flops), bytes=float(bytes_), intensity=intensity,
        ridge=ridge, bound="memory" if intensity < ridge else "compute",
        peak_fraction=attainable / peak_flops,
        t_compute=flops / peak_flops, t_memory=bytes_ / hbm_bw)
