"""Int4 unpack + per-channel int8 requantization for the W4A8 linear path.

Port of svi_tpu/ops/quant_matmul.py. The production shape of a W4A8 linear:

    w8 = unpack_requant_int4(w_q4, r_q4)   # K3: csrc/quant_unpack.cu
    y  = dynamic per-token int8 activations x w8 (models.wan_dit._int8_exec)

Layout: the port keeps linear weights as (out, in) = (N, K). The packed int4
weight is (N, K/2) int8, HALF-SPLIT: byte [n, i] holds input i as its low
nibble and input i + K/2 as its high nibble (the JAX package's (K/2, N)
transposed). `r` (N, K/G) f32 is the per-group requantization ratio
scale_g / smax_c * 127/7 (models.wan_dit._w4a8_leaves), so the (N, K) int8
output lives on the per-output-channel s8 grid.

`unpack_requant_int4` counts its kernel launches in `.launches`. CPU tensors
take the plain version `_unpack_requant_reference`; CUDA tensors launch the
kernel or raise.
"""

from __future__ import annotations

import torch


def supports_unpack_requant(w_packed: torch.Tensor, r: torch.Tensor) -> bool:
    """Whether (w_packed, r) is a packed weight and ratio table the kernel
    takes: 2-D int8 (N, K/2) and f32 (N, K/G) with G dividing K. The JAX
    package's gate of the same name also asks for Mosaic's 128-multiple
    tiles; the CUDA kernel takes every shape the quantizer produces."""
    if w_packed.ndim != 2 or r.ndim != 2 or w_packed.dtype != torch.int8:
        return False
    n, kh = w_packed.shape
    return (r.dtype == torch.float32 and r.shape[0] == n and r.shape[1] > 0
            and (2 * kh) % r.shape[1] == 0)


def unpack_int4(w_packed: torch.Tensor) -> torch.Tensor:
    """(N, K/2) half-split packed int4 -> (N, K) int32 in [-8, 7]."""
    w = w_packed.to(torch.int32)
    lo = ((w & 0xF) ^ 8) - 8  # sign-extended low nibble
    hi = w >> 4  # arithmetic shift of the signed byte: sign-extended high nibble
    return torch.cat([lo, hi], dim=1)


def _unpack_requant_reference(w_packed: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version (mirrors the XLA unpack in the JAX package's
    `_dense`, svi_tpu/models/wan_dit.py:284-292): one f32 product per
    weight, rounded half to even, clipped to +-127."""
    w8 = unpack_int4(w_packed)
    n, k = w8.shape
    g = k // r.shape[1]
    w = w8.reshape(n, r.shape[1], g).to(torch.float32) * r[:, :, None]
    return torch.round(w).clamp_(-127, 127).to(torch.int8).reshape(n, k)


def unpack_requant_int4(w_packed: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """K3's contract: (N, K/2) half-split packed int4 + (N, K/G) f32 ratios ->
    (N, K) int8 on the per-channel s8 grid (multiply the int32 product by s8
    afterwards). Both inputs contiguous."""
    if not supports_unpack_requant(w_packed, r):
        raise ValueError(f"unpack_requant_int4: packed {tuple(w_packed.shape)} "
                         f"{w_packed.dtype} and ratios {tuple(r.shape)} {r.dtype} are not a "
                         "(N, K/2) int8 weight with (N, K/G) f32 group ratios")
    if w_packed.device.type == "cpu" and r.device.type == "cpu":
        return _unpack_requant_reference(w_packed, r)
    if not (w_packed.is_cuda and r.is_cuda) or w_packed.device != r.device:
        raise RuntimeError("unpack_requant_int4: both tensors must be on one CUDA device "
                           f"(got {w_packed.device} and {r.device})")
    if not (w_packed.is_contiguous() and r.is_contiguous()):
        raise ValueError("unpack_requant_int4: the kernel takes contiguous tensors")
    n, kh = w_packed.shape
    out = torch.empty((n, 2 * kh), dtype=torch.int8, device=w_packed.device)
    from ..kernels.build import load_quant_unpack

    err = load_quant_unpack().svi_unpack_requant_int4(
        w_packed.data_ptr(), r.data_ptr(), out.data_ptr(), n, kh, (2 * kh) // r.shape[1],
        torch.cuda.current_stream(w_packed.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"unpack_requant_int4 kernel launch failed: cudaError {err}")
    unpack_requant_int4.launches += 1
    return out


unpack_requant_int4.launches = 0
