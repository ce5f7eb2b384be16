"""svi_tpu_torch: the SVI-Shot inference path (bf16 and quantized, from
checkpoint files and text prompts through the clip-loop driver
`scripts/test_svi.py`) and Error-Recycling LoRA training in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

It mirrors the layout of the JAX package `svi_tpu` (ops/, models/,
schedulers/, pipelines/, prompters/, training/, utils/, scripts/) and
imports no JAX. On a CPU tensor each kernel
wrapper runs its plain PyTorch version; on a CUDA tensor it launches the
kernel or raises.
"""

from __future__ import annotations

import shutil
import subprocess

__version__ = "0.1.0"


def _run(cmd: list[str]) -> str:
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    if proc.returncode != 0:
        return f"error (rc {proc.returncode}): {proc.stderr.strip()}"
    return proc.stdout.strip()


def capability_probe() -> dict:
    """What this machine offers the port: torch and its CUDA runtime, nvcc,
    triton, and the card's name and power limit (as nvidia-smi reports them)."""
    import torch

    from .kernels.build import find_nvcc

    info = {
        "torch": torch.__version__,
        "torch_cuda": torch.version.cuda,
        "cuda_available": torch.cuda.is_available(),
        "device_count": torch.cuda.device_count() if torch.cuda.is_available() else 0,
    }
    try:
        nvcc = find_nvcc()
    except RuntimeError:
        info["nvcc"] = None
    else:
        lines = _run([nvcc, "--version"]).splitlines()
        info["nvcc"] = {"path": nvcc, "version": lines[-1] if lines else ""}
    try:
        import triton
    except ImportError:
        info["triton"] = None
    else:
        info["triton"] = triton.__version__
    if shutil.which("nvidia-smi"):
        info["nvidia_smi"] = _run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]
        )
    else:
        info["nvidia_smi"] = None
    if info["cuda_available"]:
        info["device_name"] = torch.cuda.get_device_name(0)
    return info
