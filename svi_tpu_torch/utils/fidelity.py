"""Fidelity measures of generated clips (port of svi_tpu/utils/fidelity.py).

`psnr` and `clip_psnr` are numpy only, as there: the clip-level gate of the
quantized modes against bf16 (tests/test_torch_fidelity.py on the CPU,
chip_smoke.py on the card) and real-weight validation against reference
clips score with them.
"""

from __future__ import annotations

import numpy as np


def psnr(a: np.ndarray, b: np.ndarray, peak: float | None = None) -> float:
    """Peak signal-to-noise ratio in dB. Arrays in [0, 255] (peak 255) or
    [-1, 1] (peak 2), inferred from a's largest value when not given."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if peak is None:
        peak = 255.0 if a.max() > 2.0 else 2.0
    mse = np.mean((a - b) ** 2)
    return float(10 * np.log10(peak * peak / max(mse, 1e-12)))


def clip_psnr(frames_a, frames_b) -> float:
    """PSNR over two clips given as sequences of HWC uint8 frames (arrays or
    PIL images)."""
    a = np.stack([np.asarray(f) for f in frames_a]).astype(np.float64)
    b = np.stack([np.asarray(f) for f in frames_b]).astype(np.float64)
    if a.shape != b.shape:
        raise ValueError(f"clips of different shapes: {a.shape} vs {b.shape}")
    return psnr(a, b, peak=255.0)
