"""The W4A8 linear, the int4 unpack + per-channel int8 requantization, and a
fused kernel for the linear's straight-through input gradient.

Port of svi_tpu/ops/quant_matmul.py and of the W4A8 branch of the JAX
package's `_dense`, which unpacks the weight (K3) and hands it to
`_int8_exec` (dynamic per-token int8 activations, an int32 product, the
scales) and then adds the bias:

    y = w4a8_linear(x, w_q4, r_q4, s8_q4, b)   # csrc/w4a8_gemm_sm90.cu

runs all of it in two kernels: `quantize_rows_int8` (x -> x8, xs) and the
GEMM, which unpacks and requantizes the int4 weight in shared memory, so
neither the int8 weight nor the int32 product reaches device memory.
`unpack_requant_int4` (K3: csrc/quant_unpack.cu) stays as the standalone
unpack, which the straight-through backward (`_int8_exec_bwd`, dx = (g * s8)
@ W8 in g's dtype) uses before the bf16 cast, the scaling and cuBLAS.

    dx = w4a8_dgrad(g, w_q4, r_q4, s8_q4)      # csrc/w4a8_dgrad_sm90.cu

computes that backward in one kernel (the bf16 W8 tile made in shared
memory, g scaled in registers). On the H100 it is slower than the chain at
the 14B's shapes, so no path calls it yet.

Layout: the port keeps linear weights as (out, in) = (N, K). The packed int4
weight is (N, K/2) int8, HALF-SPLIT: byte [n, i] holds input i as its low
nibble and input i + K/2 as its high nibble (the JAX package's (K/2, N)
transposed). `r` (N, K/G) f32 is the per-group requantization ratio
scale_g / smax_c * 127/7 (models.wan_dit._w4a8_leaves), so the (N, K) int8
output lives on the per-output-channel s8 grid.

`unpack_requant_int4`, `quantize_rows_int8`, `w4a8_linear` and `w4a8_dgrad`
count their kernel launches in `.launches`. CPU tensors take the plain versions
(`_unpack_requant_reference`, `_quantize_rows_reference`,
`_w4a8_linear_reference`, `_w4a8_dgrad_reference`); CUDA tensors launch the
kernels or raise.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .attention import div_exact


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


# ---------------------------------------------------------------------------
# The W4A8 linear: activation pre-pass + the int4-unpacking int8 GEMM
# ---------------------------------------------------------------------------


def _quantize_rows_reference(x2: torch.Tensor):
    """Plain version of the activation pre-pass (`_int8_exec`'s prologue):
    per row of x2 (M, K), xs = amax|x| / 127 (an IEEE division) + 1e-12 and
    x8 = clamp(round(x / xs), -127, 127). Returns (x8 (M, K) int8, xs (M,)
    f32)."""
    xf = x2.float()
    xs = div_exact(xf.abs().amax(-1, keepdim=True), 127.0) + 1e-12
    x8 = torch.round(xf / xs).clamp_(-127, 127).to(torch.int8)
    return x8, xs[:, 0]


def quantize_rows_int8(x2: torch.Tensor):
    """The activation pre-pass of `w4a8_linear`: x2 (M, K) bf16 or f32,
    contiguous -> (x8 (M, K) int8, xs (M,) f32), bit-equal to
    `_quantize_rows_reference`. The kernel takes K % 8 == 0."""
    if x2.ndim != 2:
        raise ValueError(f"quantize_rows_int8: x must be (M, K), got {tuple(x2.shape)}")
    if x2.device.type == "cpu":
        return _quantize_rows_reference(x2)
    if not x2.is_cuda:
        raise RuntimeError(f"quantize_rows_int8: no kernel for a tensor on {x2.device}")
    if x2.dtype not in (torch.bfloat16, torch.float32) or not x2.is_contiguous() \
            or x2.shape[1] % 8 or x2.data_ptr() % 16:
        raise ValueError("quantize_rows_int8 kernel: x must be contiguous bf16 or f32, 16-byte "
                         f"aligned, K % 8 == 0 (got {x2.dtype} {tuple(x2.shape)})")
    m, k = x2.shape
    x8 = torch.empty((m, k), dtype=torch.int8, device=x2.device)
    xs = torch.empty((m,), dtype=torch.float32, device=x2.device)
    from ..kernels.build import load_w4a8_gemm

    err = load_w4a8_gemm().svi_w4a8_quantize_rows(
        int(x2.dtype == torch.float32), x2.data_ptr(), x8.data_ptr(), xs.data_ptr(), m, k,
        torch.cuda.current_stream(x2.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"quantize_rows_int8 kernel launch failed: cudaError {err}")
    quantize_rows_int8.launches += 1
    return x8, xs


quantize_rows_int8.launches = 0


def _w4a8_linear_reference(x, w_q4, r_q4, s8_q4, b=None):
    """Plain version of `w4a8_linear`: K3's plain unpack, the activation
    quantization, the int32 product (exact: each |sum| < 2^53 in f64) and
    `_int8_exec`'s epilogue, then `_plus_bias`'s add."""
    n, kh = w_q4.shape
    w8 = _unpack_requant_reference(w_q4, r_q4)
    x8, xs = _quantize_rows_reference(x.reshape(-1, 2 * kh))
    y32 = x8.double() @ w8.double().t()
    y = (y32.float() * xs[:, None] * s8_q4.reshape(-1)).to(x.dtype)
    if b is not None:
        y = y + b.to(y.dtype)
    return y.reshape(*x.shape[:-1], n)


def w4a8_shape_error(k: int, n: int, group: int) -> Optional[str]:
    """Why the W4A8 kernel does not take a (N, K) weight with groups of
    `group` inputs, or None. The shapes `quantize_params_int4` produces for
    the DiTs of this repo are all taken: the 14B's K in {256, 1280, 4096,
    5120, 13824} and N in {64, 1280, 5120, 13824, 30720} with groups of 128
    (the fast path: one 16-entry table per row and group), and the tiny test
    configs' K in {32, 48, 64, 128, 256} with groups of 16."""
    if k % 16:
        return f"K = {k} is not a multiple of 16 (x8's rows for TMA)"
    if n % 8:
        return f"N = {n} is not a multiple of 8"
    if group <= 0 or group % 4 or k % group:
        return f"group {group} does not divide K = {k} in multiples of 4"
    return None


def w4a8_linear(x: torch.Tensor, w_q4: torch.Tensor, r_q4: torch.Tensor, s8_q4: torch.Tensor,
                b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The W4A8 linear: x (..., K) bf16 or f32; w_q4 (N, K/2) half-split
    packed int4; r_q4 (N, K/G) f32 requantization ratios; s8_q4 (N, 1) f32
    per-channel scales; b (N,) or None. Returns y (..., N) in x's dtype:
    y = ((float(Qtok(x) . W8^T) * xs) * s8) rounded to x's dtype, then
    + b, with W8 = K3's requantized weight. Bit-equal to
    `_w4a8_linear_reference`. Every M >= 1 is taken; the shapes are those of
    `w4a8_shape_error`."""
    if not supports_unpack_requant(w_q4, r_q4):
        raise ValueError(f"w4a8_linear: packed {tuple(w_q4.shape)} {w_q4.dtype} and ratios "
                         f"{tuple(r_q4.shape)} {r_q4.dtype} are not a (N, K/2) int8 weight with "
                         "(N, K/G) f32 group ratios")
    n, kh = w_q4.shape
    k = 2 * kh
    if x.shape[-1] != k or s8_q4.numel() != n or (b is not None and b.numel() != n):
        raise ValueError(f"w4a8_linear: x {tuple(x.shape)}, weight (N={n}, K={k}), s8 "
                         f"{tuple(s8_q4.shape)}, bias {None if b is None else tuple(b.shape)}")
    named = [t for t in (x, w_q4, r_q4, s8_q4, b) if t is not None]
    if all(t.device.type == "cpu" for t in named):
        return _w4a8_linear_reference(x, w_q4, r_q4, s8_q4, b)
    if not all(t.is_cuda for t in named) or len({t.device for t in named}) != 1:
        raise RuntimeError("w4a8_linear: every tensor must be on one CUDA device (got "
                           f"{sorted({str(t.device) for t in named})})")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"w4a8_linear kernel: x must be bfloat16 or float32, got {x.dtype}")
    why = w4a8_shape_error(k, n, k // r_q4.shape[1])
    if why is not None:
        raise ValueError(f"w4a8_linear kernel: {why}")
    x2 = x.reshape(-1, k).contiguous()
    m = x2.shape[0]
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0:
        return y.reshape(*x.shape[:-1], n)
    x8, xs = quantize_rows_int8(x2)
    w, x_hi = w_q4.contiguous(), kh
    if kh % 16:
        # TMA boxes start on 16-byte columns and rows: with K/2 % 16 != 0
        # (only the tiny test configs) x8's high half moves to a 16-byte
        # column and the packed weight is read from a copy with padded rows
        x_hi = kh + (-kh % 16)
        x8 = torch.cat([F.pad(x8[:, :kh], (0, x_hi - kh)), F.pad(x8[:, kh:], (0, x_hi - kh))],
                       dim=1)
        w = F.pad(w_q4, (0, x_hi - kh))
    r = r_q4.contiguous()
    s8 = s8_q4.reshape(-1).float().contiguous()
    bias = None if b is None else b.to(x.dtype).contiguous()
    from ..kernels.build import load_w4a8_gemm

    err = load_w4a8_gemm().svi_w4a8_gemm(
        int(x.dtype == torch.float32), x8.data_ptr(), x8.shape[1], x_hi, xs.data_ptr(),
        w.data_ptr(), w.shape[1],
        r.data_ptr(), s8.data_ptr(), None if bias is None else bias.data_ptr(), y.data_ptr(),
        m, n, k, k // r.shape[1], torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"w4a8_linear kernel launch failed: {err} (a cudaError; 10000: "
                           "cuTensorMapEncodeTiled not found; 20000 + r: the tensor-map encode "
                           "returned CUresult r)")
    w4a8_linear.launches += 1
    return y.reshape(*x.shape[:-1], n)


w4a8_linear.launches = 0


# ---------------------------------------------------------------------------
# The straight-through input gradient of the W4A8 linear
# ---------------------------------------------------------------------------


def _straight_through_dx(g: torch.Tensor, w8i: torch.Tensor, col_scale: torch.Tensor):
    """`_int8_exec_bwd`: dx = (g · col_scale) @ w8i in g's dtype."""
    return (g * col_scale.reshape(-1).to(g.dtype)) @ w8i.to(g.dtype)


def _w4a8_dgrad_reference(g, w_q4, r_q4, s8_q4):
    """Plain version of `w4a8_dgrad`: the chain it fuses, K3's plain unpack
    then `_int8_exec_bwd`'s dx = bf16(g · bf16(s8)) @ bf16(W8)."""
    return _straight_through_dx(g, _unpack_requant_reference(w_q4, r_q4), s8_q4)


def w4a8_dgrad(g: torch.Tensor, w_q4: torch.Tensor, r_q4: torch.Tensor,
               s8_q4: torch.Tensor) -> torch.Tensor:
    """The W4A8 linear's straight-through input gradient in one kernel: g
    (..., N) bf16, the cotangent of `w4a8_linear`'s output; w_q4 (N, K/2),
    r_q4 (N, K/G), s8_q4 (N, 1) its weight leaves. Returns dx (..., K) bf16:
    dx = (g · s8) @ W8 with W8 = K3's requantized weight (`_int8_exec_bwd`).
    On the card it launches csrc/w4a8_dgrad_sm90.cu (W8 made in shared
    memory, g scaled in registers, f32 sums; its launches in `.launches`),
    within f32 summation order and one bf16 rounding of the plain version.
    Every M >= 1 is taken; the shapes are those of `w4a8_shape_error`."""
    if not supports_unpack_requant(w_q4, r_q4):
        raise ValueError(f"w4a8_dgrad: packed {tuple(w_q4.shape)} {w_q4.dtype} and ratios "
                         f"{tuple(r_q4.shape)} {r_q4.dtype} are not a (N, K/2) int8 weight with "
                         "(N, K/G) f32 group ratios")
    n, kh = w_q4.shape
    k = 2 * kh
    if g.shape[-1] != n or s8_q4.numel() != n:
        raise ValueError(f"w4a8_dgrad: g {tuple(g.shape)}, weight (N={n}, K={k}), s8 "
                         f"{tuple(s8_q4.shape)}")
    named = (g, w_q4, r_q4, s8_q4)
    if all(t.device.type == "cpu" for t in named):
        return _w4a8_dgrad_reference(g, w_q4, r_q4, s8_q4)
    if not all(t.is_cuda for t in named) or len({t.device for t in named}) != 1:
        raise RuntimeError("w4a8_dgrad: every tensor must be on one CUDA device (got "
                           f"{sorted({str(t.device) for t in named})})")
    if g.dtype != torch.bfloat16:
        raise TypeError(f"w4a8_dgrad kernel: g must be bfloat16, got {g.dtype}")
    why = w4a8_shape_error(k, n, k // r_q4.shape[1])
    if why is not None:
        raise ValueError(f"w4a8_dgrad kernel: {why}")
    g2 = g.reshape(-1, n).contiguous()
    m = g2.shape[0]
    dx = torch.empty((m, k), dtype=g.dtype, device=g.device)
    if m == 0:
        return dx.reshape(*g.shape[:-1], k)
    # TMA reads the packed weight: its rows must be 16-byte multiples, so with
    # K/2 % 16 != 0 (only the tiny test configs) it is read from a copy with
    # padded rows
    w = w_q4.contiguous() if kh % 16 == 0 else F.pad(w_q4, (0, -kh % 16))
    r = r_q4.contiguous()
    s8 = s8_q4.reshape(-1).float().contiguous()
    from ..kernels.build import load_w4a8_dgrad

    err = load_w4a8_dgrad().svi_w4a8_dgrad(
        g2.data_ptr(), w.data_ptr(), w.shape[1], r.data_ptr(), s8.data_ptr(), dx.data_ptr(), m,
        n, k, k // r.shape[1], torch.cuda.current_stream(g.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"w4a8_dgrad kernel launch failed: {err} (a cudaError; 10000: "
                           "cuTensorMapEncodeTiled not found; 20000 + r: the tensor-map encode "
                           "returned CUresult r)")
    w4a8_dgrad.launches += 1
    return dx.reshape(*g.shape[:-1], k)


w4a8_dgrad.launches = 0
