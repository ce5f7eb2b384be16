"""Flash attention, forward and backward: the hand-written CUDA kernels and
their plain versions.

Port of svi_tpu/ops/attention.py. Seven kernel entry points, each with its own
launch counter (`.launches`, a plain int that counts kernel launches and
nothing else; the split backward's entries count per route in `.routes`
instead):

  * `flash_fwd_flat`  -- K1's contract (`_fwd_kernel_flat`): q, k, v flat
    (B, S, N*D), optional fused interleaved-pair RoPE, keys >= kv_len masked;
    returns out (B, Sq, N*D) in q's dtype and base-e lse (B, N, Sq) f32;
  * `flash_fwd_bnsd` -- K2's contract (`_fwd_kernel`): the same on (B, N, S, D);
  * `rope_rotate_flat` -- the RoPE K1 applies in its kernel (`_rope_in_kernel`),
    as a pre-pass into a contiguous buffer;
  * `flash_bwd_onepass` -- K4's contract (`_bwd_onepass_kernel_flat`): dq, dk,
    dv in one pass over KV tiles, dq summed across them in f32;
  * `flash_bwd_dq`, `flash_bwd_dkv` -- K5a's and K5b's contracts
    (`_bwd_dq_kernel_flat`, `_bwd_dkv_kernel_flat`): the split backward, in
    bf16 and, on the (B, N, S, D) route's f32 head dims, in f32;
  * `flash_fwd_flat_q8` -- K6's contract (`_fwd_kernel_flat_q8`): the int8
    forward on operands quantized by `_quant_prep` (the torch version of
    `_quant_prep_xla`), modes qk8 (int8 Q.K^T, P.V in v's type: bf16, or
    f32 in 3xTF32 at D = 128) and qk8pv8 (int8 P.V too).

The forward entries (a layout is only strides) take the route `_fwd_route`
names for the dtype and head dim: bf16 at every head dim runs
csrc/flash_fwd_sm90.cu (TMA + wgmma, warp-specialised): D = 128 (every DiT
attention) and D = 64 (CogVideoX's 48 heads) as they were, D = 32, 40, 80,
88, 160 (the SD family's UNets, ControlNets and motion modules,
Hunyuan-DiT's 16 heads of 88) on the same kernel over zero-filled head-dim
boxes (short sequences, Sq and Sk <= 16, on a packed kernel of four
(batch, head) items a tile), D = 384, 512 (the VAE mid-blocks' one head)
on a kernel whose two warpgroups split O's columns; it runs the RoPE
pre-pass `rope_rotate_flat` first when tables are given. f32 (the VAEs,
CLIP, the SD 1.5 UNet, ControlNet and motion modules, Hunyuan-DiT's D = 88)
runs csrc/flash_fwd_f32.cu (3xTF32 on the tensor cores), at the same head
dims as bf16. Each entry counts its launches per (route, dtype, head_dim)
in `.routes`. The one-pass backward (K4) launches
csrc/flash_bwd_sm90.cu (TMA + wgmma) on q and k rotated by the pre-pass;
the split backward (K5a, K5b) takes the route `_split_bwd_route` names:
bf16 D = 128 runs csrc/flash_bwd_split_sm90.cu (TMA + wgmma, on q and k
rotated by the pre-pass), bf16 D = 64 csrc/flash_bwd.cu, f32 D = 40, 64,
80, 160 (the SD 1.5 and SDXL UNets, whose backward the JAX package runs in
XLA, `_flash_bwd_xla`) csrc/flash_bwd_f32.cu, each entry counting its
launches in `.launches` and per (route, dtype, head_dim) in `.routes`. The int8
forward takes the route `_q8_route` names for the head dim: D = 128 runs
csrc/flash_fwd_q8_sm90.cu (TMA + integer wgmma, 128-key tiles), D = 64
csrc/flash_fwd_q8.cu (mma.sync, 64-key tiles); it counts its launches in
`.launches` and per (route, mode, head_dim) in `.routes`.
Dispatch: tensors on the CPU take the plain PyTorch version
(`_flash_fwd_reference`, `_flash_bwd_reference`, which mirror the JAX
package's `_flash_fwd_xla` and `_flash_bwd_xla`, and
`_flash_fwd_q8_reference`, which mirrors `_fwd_kernel_flat_q8`); CUDA tensors
launch the kernel or raise. There is no fallback between them. The public ops
(`flash_attention`, `flash_attention_rope`, `flash_attention_flat`) are
differentiable in q, k and v and route as the JAX package does: forward
through the flat kernel when D % 128 == 0 or N == 1 and the (B, N, S, D)
entry otherwise (CLIP's D = 80); backward through K4 for long self-attention
and K5a + K5b otherwise (`flash_bwd_flat`; the (B, N, S, D) route's f32
head dims take the f32 K5a + K5b). `attention_bnsd` is `flash_attention`
on (B, N, S, D) tensors. `flash_attention_flat(quant=...)`
runs the int8 forward, inference only: its backward raises.
`flash_attention_with_lse` is forward only.
"""

from __future__ import annotations

import collections
import ctypes
from typing import Optional

import torch

_NEG_INF = -1e30
_LOG2E = 1.4426950408889634
# the forward kernel that serves each (dtype, head_dim) on the card, and the
# `kernels.build` loader of each route's library: 'sm90' is
# csrc/flash_fwd_sm90.cu (TMA + wgmma: every bf16 head dim), 'f32'
# csrc/flash_fwd_f32.cu (3xTF32 mma.sync)
_HEAD_DIMS = (32, 40, 64, 80, 88, 128, 160, 384, 512)
_FWD_ROUTES = {**{(torch.bfloat16, d): "sm90" for d in _HEAD_DIMS},
               **{(torch.float32, d): "f32" for d in _HEAD_DIMS}}
_FWD_LOADERS = {"sm90": "load_flash_fwd_sm90", "f32": "load_flash_fwd_f32"}
_KERNEL_HEAD_DIMS = {dt: tuple(d for (t, d) in _FWD_ROUTES if t == dt)
                     for dt in (torch.bfloat16, torch.float32)}
_REFERENCE_TILE_BYTES = 1 << 30  # bound on one f32 score tile of the plain version


def _apply_rope_reference(x4: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Interleaved-pair rotation (mirrors `_apply_rope_xla`). x4: (B, S, N, D);
    cos/sin: (S, D/2). Computed in f32, cast back to x4's dtype."""
    b, s, n, d = x4.shape
    xf = x4.float().reshape(b, s, n, d // 2, 2)
    xr, xi = xf[..., 0], xf[..., 1]
    c = cos.float()[None, :, None, :]
    si = sin.float()[None, :, None, :]
    out = torch.stack([xr * c - xi * si, xr * si + xi * c], dim=-1).reshape(b, s, n, d)
    return out.to(x4.dtype)


def _reference_block_k(sk: int, d: int) -> int:
    """Key block of the plain version: the JAX package's `_choose_blocks`."""
    bk_max = 2048 if d <= 128 else (1024 if d <= 256 else 512)
    return bk_max if sk >= bk_max else -(-max(sk, 128) // 128) * 128


def _flash_fwd_reference(q4, k4, v4, cos, sin, kv_len: int, scale: float):
    """Plain PyTorch forward (mirrors `_flash_fwd_xla`): blockwise online
    softmax in f32 over key blocks, never the full Sq x Sk matrix; query rows
    are chunked so one f32 score tile stays under 1 GiB at any sequence length.

    q4: (B, Sq, N, D); k4, v4: (B, Sk, N, D). Returns out (B, Sq, N, D) in
    q4's dtype and lse (B, N, Sq) f32."""
    b, sq, n, d = q4.shape
    sk = k4.shape[1]
    if cos is not None:
        q4 = _apply_rope_reference(q4, cos[:sq], sin[:sq])
        k4 = _apply_rope_reference(k4, cos[:sk], sin[:sk])
    qt = q4.transpose(1, 2).float() * scale
    kt = k4.transpose(1, 2).float()
    vt = v4.transpose(1, 2).float()
    block_k = _reference_block_k(sk, d)
    rows = max(1, min(sq, _REFERENCE_TILE_BYTES // (4 * b * n * block_k)))
    outs, lses = [], []
    for r0 in range(0, sq, rows):
        qc = qt[:, :, r0:r0 + rows]
        m = torch.full(qc.shape[:-1] + (1,), _NEG_INF, dtype=torch.float32, device=q4.device)
        l = torch.zeros_like(m)
        acc = torch.zeros(qc.shape, dtype=torch.float32, device=q4.device)
        for j0 in range(0, sk, block_k):
            s = qc @ kt[:, :, j0:j0 + block_k].transpose(-1, -2)
            col = torch.arange(j0, j0 + s.shape[-1], device=q4.device)
            s = s.masked_fill(col >= kv_len, _NEG_INF)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            p = torch.exp(s - m_new)
            alpha = torch.exp(m - m_new)
            l = alpha * l + p.sum(-1, keepdim=True)
            acc = acc * alpha + p @ vt[:, :, j0:j0 + block_k]
            m = m_new
        lc = l.clamp_min(1e-30)
        outs.append(acc / lc)
        lses.append((m + torch.log(lc))[..., 0])
    out = torch.cat(outs, dim=2).to(q4.dtype).transpose(1, 2)
    return out, torch.cat(lses, dim=2)


def _check_inputs(q4, k4, v4, cos, sin, kv_len: int) -> None:
    """Shape and type checks shared by the kernel and the plain version."""
    if q4.ndim != 4 or k4.ndim != 4 or v4.ndim != 4:
        raise ValueError("q, k, v must be 4-D (B, S, N, D) views")
    b, sq, n, d = q4.shape
    if k4.shape != v4.shape or k4.shape[0] != b or k4.shape[2:] != (n, d):
        raise ValueError(f"shape mismatch: q {tuple(q4.shape)}, k {tuple(k4.shape)}, "
                         f"v {tuple(v4.shape)}")
    if not (q4.dtype == k4.dtype == v4.dtype):
        raise ValueError(f"dtype mismatch: {q4.dtype}, {k4.dtype}, {v4.dtype}")
    if kv_len < 0:
        raise ValueError(f"kv_len must be >= 0, got {kv_len}")
    if (cos is None) != (sin is None):
        raise ValueError("cos and sin must be given together")
    if cos is not None:
        need = max(sq, k4.shape[1])
        if d % 2 or cos.shape != sin.shape or cos.ndim != 2 or cos.shape[1] != d // 2 \
                or cos.shape[0] < need:
            raise ValueError(f"rope tables {tuple(cos.shape)} do not cover ({need}, {d // 2})")


def _check_kernel_tensors(what: str, named: dict, head_dims: dict, cos, sin) -> list:
    """Device, type, head dim, stride and alignment checks of a kernel launch;
    raises on anything the kernel does not take. Returns the (b, s, n)
    element strides of the named (B, S, N, D) views, in their order (one
    pass over each view: the forward's wrappers run at every call)."""
    first = next(iter(named.values()))
    device, dtype, d = first.device, first.dtype, first.shape[-1]
    tensors = (*named.values(), *((cos, sin) if cos is not None else ()))
    if device.type != "cuda" or any(t.device != device for t in tensors):
        raise RuntimeError(f"{what}: every tensor must be on one CUDA device "
                           f"(got {sorted({str(t.device) for t in tensors})})")
    if dtype not in head_dims or any(t.dtype != dtype for t in named.values()):
        raise TypeError(f"{what} kernel takes {sorted(map(str, head_dims))} inputs of one "
                        f"dtype, not {sorted({str(t.dtype) for t in named.values()})}")
    if d not in head_dims[dtype]:
        raise ValueError(f"{what} kernel: head_dim {d} not built for {dtype} "
                         f"(built: {head_dims[dtype]})")
    size = first.element_size()  # a power of two: the or of the strides tests them all
    strides = []
    for name, t in named.items():
        st = t.stride()
        if st[-1] != 1:
            raise ValueError(f"{what} kernel: {name} must be contiguous in its last dim")
        if t.data_ptr() % 16 or ((st[0] | st[1] | st[2]) * size) % 16:
            raise ValueError(f"{what} kernel: {name} must be 16-byte aligned with strides "
                             "that are multiples of 16 bytes")
        strides += st[:3]
    if cos is not None:
        if cos.dtype != torch.float32 or sin.dtype != torch.float32 \
                or not cos.is_contiguous() or not sin.is_contiguous():
            raise ValueError("rope tables must be contiguous float32")
    return strides


def _strides12(*views) -> ctypes.Array:
    """(b, s, n) element strides of four (B, S, N, D) views, for the C interface."""
    return (ctypes.c_int64 * 12)(*(s for t in views for s in t.stride()[:3]))


def _fwd_route(dtype: torch.dtype, head_dim: int) -> str:
    """The forward kernel a CUDA call at (dtype, head_dim) takes, for D in
    32, 40, 64, 80, 88, 128, 160, 384, 512: 'sm90' (bf16; TMA + wgmma) or
    'f32' (f32; 3xTF32). Raises for any other pair: nothing falls back."""
    if dtype not in _KERNEL_HEAD_DIMS:
        raise TypeError(f"flash forward kernel takes bfloat16 or float32, not {dtype}")
    route = _FWD_ROUTES.get((dtype, head_dim))
    if route is None:
        raise ValueError(f"flash forward kernel: head_dim {head_dim} not built for {dtype} "
                         f"(built: {_KERNEL_HEAD_DIMS[dtype]})")
    return route


def _on_cpu(*tensors) -> bool:
    return all(t is None or t.device.type == "cpu" for t in tensors)


def _rope_rotate4(x4: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """`rope_rotate_flat` on a (B, S, N, D) view; returns a contiguous
    (B, S, N, D) tensor."""
    s, d = x4.shape[1], x4.shape[3]
    if d % 2 or cos.shape != sin.shape or cos.ndim != 2 or cos.shape[1] != d // 2 \
            or cos.shape[0] < s:
        raise ValueError(f"rope tables {tuple(cos.shape)} do not cover ({s}, {d // 2})")
    if _on_cpu(x4, cos, sin):
        return _apply_rope_reference(x4, cos[:s], sin[:s])
    if x4.dtype != torch.bfloat16 or d % 8:
        raise TypeError(f"the RoPE pre-pass kernel takes bfloat16 with D % 8 == 0, not "
                        f"{x4.dtype} D={d}")
    _check_kernel_tensors("RoPE pre-pass", dict(q=x4), {torch.bfloat16: (d,)}, cos, sin)
    y = torch.empty(x4.shape, dtype=x4.dtype, device=x4.device)
    from ..kernels.build import load_flash_fwd_sm90

    b, _, n, _ = x4.shape
    err = load_flash_fwd_sm90().svi_rope_rotate(
        x4.data_ptr(), y.data_ptr(), cos.data_ptr(), sin.data_ptr(), b, s, n, d,
        *x4.stride()[:3], torch.cuda.current_stream(x4.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"RoPE pre-pass kernel launch failed: cudaError {err}")
    rope_rotate_flat.launches += 1
    return y


def rope_rotate_flat(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                     head_dim: int) -> torch.Tensor:
    """Interleaved-pair RoPE of a flat (B, S, N*D) tensor (last dim
    contiguous, rows may be strided) into a new contiguous one, in f32 with
    one rounding to x's dtype: the values K1 rotates inside its kernel. On
    the card csrc/flash_fwd_sm90.cu's pre-pass kernel (bf16) computes it; on
    the CPU `_apply_rope_reference`."""
    x4 = x.unflatten(-1, (x.shape[-1] // head_dim, head_dim))
    return _rope_rotate4(x4, cos, sin).flatten(2)


rope_rotate_flat.launches = 0


_DTYPE_NAMES = {torch.bfloat16: "bfloat16", torch.float32: "float32"}
_FWD_LIBS: dict = {}  # route -> its library, loaded at the route's first launch


def _launch(q4, k4, v4, out4, cos, sin, kv_len: int, scale: float) -> tuple:
    """Launch the forward kernel of the route on the current stream (no
    synchronisation). out4 is a preallocated (B, Sq, N, D) view. The bf16
    route ('sm90') rotates q and k with the RoPE pre-pass first.
    Returns (lse (B, N, Sq), the route's counter key (route, dtype,
    head_dim)). Host time is what a short call costs (the card runs a
    short sequence's kernel in 10-20 us): the checks take one pass over each
    view, the library is looked up once per route, the stream is read raw."""
    strides = _check_kernel_tensors("flash forward", dict(q=q4, k=k4, v=v4, out=out4),
                                    _KERNEL_HEAD_DIMS, cos, sin)
    b, sq, n, d = q4.shape
    dtype = q4.dtype
    route = _fwd_route(dtype, d)
    lse = torch.empty((b, n, sq), dtype=torch.float32, device=q4.device)
    stream = torch._C._cuda_getCurrentRawStream(q4.device.index)
    lib = _FWD_LIBS.get(route)
    if lib is None:
        from ..kernels import build

        lib = _FWD_LIBS[route] = getattr(build, _FWD_LOADERS[route])()
    if route != "f32" and cos is not None:
        q4, k4 = _rope_rotate4(q4, cos, sin), _rope_rotate4(k4, cos, sin)
        strides[:6] = (*q4.stride()[:3], *k4.stride()[:3])
        cos = sin = None
    if route == "sm90":
        err = lib.svi_flash_fwd_sm90(
            d, q4.data_ptr(), k4.data_ptr(), v4.data_ptr(), out4.data_ptr(), lse.data_ptr(),
            b, n, sq, k4.shape[1], kv_len, float(scale), (ctypes.c_int64 * 12)(*strides),
            stream)
        if err != 0:
            raise RuntimeError(
                f"flash forward (sm90) launch failed: code {err} (a cudaError; 10000: "
                "cuTensorMapEncodeTiled not found; 20000 + r: the tensor-map encode returned "
                "CUresult r)")
    else:
        err = lib.svi_flash_fwd_f32(
            d, q4.data_ptr(), k4.data_ptr(), v4.data_ptr(), out4.data_ptr(), lse.data_ptr(),
            cos.data_ptr() if cos is not None else None,
            sin.data_ptr() if sin is not None else None,
            b, n, sq, k4.shape[1], kv_len, float(scale), (ctypes.c_int64 * 12)(*strides),
            stream)
        if err != 0:
            raise RuntimeError(f"flash forward ({route}) launch failed: cudaError {err}")
    return lse, (route, _DTYPE_NAMES[dtype], d)


def flash_fwd_flat(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, head_dim: int,
                   cos: Optional[torch.Tensor] = None, sin: Optional[torch.Tensor] = None,
                   kv_len: Optional[int] = None, scale: Optional[float] = None):
    """K1's contract. q: (B, Sq, N*D); k, v: (B, Sk, N*D), each contiguous in
    its last dim (rows may be strided). cos/sin: (>= S, D/2) f32 RoPE tables
    applied to q and k. Returns (out (B, Sq, N*D) in q's dtype, lse (B, N, Sq))."""
    n = q.shape[-1] // head_dim
    q4, k4, v4 = (t.unflatten(-1, (n, head_dim)) for t in (q, k, v))
    kv_len = k.shape[1] if kv_len is None else int(kv_len)
    scale = head_dim ** -0.5 if scale is None else float(scale)
    _check_inputs(q4, k4, v4, cos, sin, kv_len)
    if _on_cpu(q, k, v, cos, sin):
        out4, lse = _flash_fwd_reference(q4, k4, v4, cos, sin, kv_len, scale)
        return out4.flatten(2), lse
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse, route = _launch(q4, k4, v4, out.unflatten(-1, (n, head_dim)), cos, sin, kv_len, scale)
    flash_fwd_flat.launches += 1
    flash_fwd_flat.routes[route] += 1
    return out, lse


# launches, and launches per (route, dtype, head_dim)
flash_fwd_flat.launches = 0
flash_fwd_flat.routes = collections.Counter()


def flash_fwd_bnsd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   kv_len: Optional[int] = None, scale: Optional[float] = None,
                   cos: Optional[torch.Tensor] = None, sin: Optional[torch.Tensor] = None):
    """K2's contract. q: (B, N, Sq, D); k, v: (B, N, Sk, D). Returns
    (out (B, N, Sq, D) in q's dtype, lse (B, N, Sq) f32)."""
    q4, k4, v4 = (t.transpose(1, 2) for t in (q, k, v))
    kv_len = k.shape[2] if kv_len is None else int(kv_len)
    scale = q.shape[-1] ** -0.5 if scale is None else float(scale)
    _check_inputs(q4, k4, v4, cos, sin, kv_len)
    if _on_cpu(q, k, v, cos, sin):
        out4, lse = _flash_fwd_reference(q4, k4, v4, cos, sin, kv_len, scale)
        return out4.transpose(1, 2), lse
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse, route = _launch(q4, k4, v4, out.transpose(1, 2), cos, sin, kv_len, scale)
    flash_fwd_bnsd.launches += 1
    flash_fwd_bnsd.routes[route] += 1
    return out, lse


flash_fwd_bnsd.launches = 0
flash_fwd_bnsd.routes = collections.Counter()


def _flat_ok(n: int, head_dim: int) -> bool:
    # the JAX package's routing (_flash_core_flat_fwd): the flat kernel for
    # 128-multiple head dims or a single head, the (B, N, S, D) one otherwise
    return head_dim % 128 == 0 or n == 1


# ---------------------------------------------------------------------------
# Backward: the plain version, three kernel entry points, and the router
# ---------------------------------------------------------------------------

# the split backward's kernels (K5a, K5b) per (dtype, head_dim): 'sm90' is
# csrc/flash_bwd_split_sm90.cu (TMA + wgmma: the DiT's cross-attention and
# short self-attention in training), 'mma' csrc/flash_bwd.cu (mma.sync),
# 'f32' csrc/flash_bwd_f32.cu (f32 FMA: the head dims of the SD 1.5 (40, 80,
# 160) and SDXL (64) UNets, which the JAX package's flat layout does not
# take, on the (B, N, S, D) route)
_SPLIT_BWD_ROUTES = {(torch.bfloat16, 128): "sm90", (torch.bfloat16, 64): "mma",
                     **{(torch.float32, d): "f32" for d in (40, 64, 80, 160)}}
_BWD_HEAD_DIMS = {t: tuple(d for (t_, d) in _SPLIT_BWD_ROUTES if t_ == t)
                  for t in (torch.bfloat16, torch.float32)}


def _flash_bwd_reference(q4, k4, v4, out4, lse, g4, cos, sin, kv_len: int, scale: float):
    """Plain PyTorch backward (mirrors `_flash_bwd_xla` and the RoPE handling
    around it in `_flash_core_flat_bwd`): p recomputed from lse in f32 over key
    blocks and query-row chunks (one f32 score tile stays under 1 GiB),
    delta = rowsum(dO * O). q4, out4, g4: (B, Sq, N, D); k4, v4: (B, Sk, N, D);
    lse (B, N, Sq). Returns (dq4, dk4, dv4) in the inputs' dtypes; with RoPE
    the gradients are rotated back by -theta."""
    b, sq, n, d = q4.shape
    sk = k4.shape[1]
    if cos is not None:
        q4 = _apply_rope_reference(q4, cos[:sq], sin[:sq])
        k4 = _apply_rope_reference(k4, cos[:sk], sin[:sk])
    qt, kt, vt, gt = (t.transpose(1, 2).float() for t in (q4, k4, v4, g4))
    delta = (gt * out4.transpose(1, 2).float()).sum(-1, keepdim=True)
    lse = lse[..., None]
    block_k = _reference_block_k(sk, d)
    rows = max(1, min(sq, _REFERENCE_TILE_BYTES // (4 * b * n * block_k)))
    dq = torch.zeros_like(qt)
    dks, dvs = [], []
    for j0 in range(0, sk, block_k):
        kj, vj = kt[:, :, j0:j0 + block_k], vt[:, :, j0:j0 + block_k]
        masked = torch.arange(j0, j0 + kj.shape[2], device=q4.device) >= kv_len
        dkj, dvj = torch.zeros_like(kj), torch.zeros_like(vj)
        for r0 in range(0, sq, rows):
            qc, gc = qt[:, :, r0:r0 + rows], gt[:, :, r0:r0 + rows]
            s = (qc @ kj.transpose(-1, -2)) * scale
            p = torch.exp(s.masked_fill(masked, _NEG_INF) - lse[:, :, r0:r0 + rows])
            ds = p * (gc @ vj.transpose(-1, -2) - delta[:, :, r0:r0 + rows])
            dq[:, :, r0:r0 + rows] += (ds @ kj) * scale
            dkj += (ds.transpose(-1, -2) @ qc) * scale
            dvj += p.transpose(-1, -2) @ gc
        dks.append(dkj)
        dvs.append(dvj)
    dq4 = dq.to(q4.dtype).transpose(1, 2)
    dk4 = torch.cat(dks, dim=2).to(k4.dtype).transpose(1, 2)
    dv4 = torch.cat(dvs, dim=2).to(v4.dtype).transpose(1, 2)
    if cos is not None:  # the rotation is orthogonal: its gradient is the inverse rotation
        dq4 = _apply_rope_reference(dq4, cos[:sq], -sin[:sq])
        dk4 = _apply_rope_reference(dk4, cos[:sk], -sin[:sk])
    return dq4, dk4, dv4


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def _onepass_bwd_ok(sq_p: int, sk: int, head_dim: int) -> bool:
    """The JAX package's gate for the one-pass backward (K4), kept as is so
    the port takes the kernel the TPU takes: D = 128, both sequences >= 4096,
    and Sq within the one-pass kernel's resident-row budget."""
    if head_dim != 128:
        return False
    return sq_p >= 4096 and sk >= 4096 and 8 * sq_p * head_dim <= 36 * 1024 * 1024


def _bwd_route(n: int, head_dim: int, sq: int, sk: int, kv_len: int) -> str:
    """The backward `_flash_core_flat_bwd` takes for these shapes: 'onepass'
    (K4), 'split' (K5a + K5b), or 'xla' (kv_len < Sk, or a head dim the flat
    layout cannot take). On the card `flash_bwd_flat` runs a kv_len < Sk call
    as the kernels' route of the cut shapes (Sk = kv_len)."""
    if kv_len < sk or not _flat_ok(n, head_dim):
        return "xla"
    return "onepass" if _onepass_bwd_ok(_ceil_to(sq, 1024), sk, head_dim) else "split"


def _bwd_views(q, k, v, out, lse, g, head_dim, cos, sin):
    """Checks shapes and returns the (B, S, N, D) views of the flat tensors."""
    n = q.shape[-1] // head_dim
    q4, k4, v4, o4, g4 = (t.unflatten(-1, (n, head_dim)) for t in (q, k, v, out, g))
    _check_inputs(q4, k4, v4, cos, sin, k.shape[1])
    if o4.shape != q4.shape or g4.shape != q4.shape:
        raise ValueError(f"out {tuple(out.shape)} and dO {tuple(g.shape)} must match q "
                         f"{tuple(q.shape)}")
    if lse.shape != (q.shape[0], n, q.shape[1]):
        raise ValueError(f"lse {tuple(lse.shape)} must be (B, N, Sq)")
    return q4, k4, v4, o4, g4


def _plain_bwd_flat(views, lse, cos, sin, kv_len, scale):
    q4, k4, v4, o4, g4 = views
    return tuple(t.flatten(2) for t in _flash_bwd_reference(q4, k4, v4, o4, lse, g4, cos, sin,
                                                           kv_len, scale))


_LAUNCH_FAILED = ("(a cudaError; 10000: cuTensorMapEncodeTiled not found; 20000 + r: the "
                  "tensor-map encode returned CUresult r)")


def _bwd_prep_reference(o4, g4, lse, sq_pad: int):
    """Plain version of the prep kernel: lse * log2(e) and delta =
    rowsum(dO * O) in f32, (B, N, sq_pad), padded with +inf and 0 so that
    queries past Sq get P = 0."""
    pad = sq_pad - lse.shape[-1]
    lse2 = torch.nn.functional.pad(lse * _LOG2E, (0, pad), value=float("inf"))
    delta = (g4.float() * o4.float()).sum(-1).transpose(1, 2)
    return lse2, torch.nn.functional.pad(delta, (0, pad)).contiguous()


def _bwd_prep(o4, g4, lse, rows: int):
    """(lse * log2(e), delta) as the sm90 backward kernels read them, padded
    to a multiple of `rows`: on the card by csrc/flash_bwd_split_sm90.cu's
    prep kernel, in one pass over dO and O with no f32 copy of either; on the
    CPU by `_bwd_prep_reference`."""
    sq_pad = _ceil_to(lse.shape[-1], rows)
    if _on_cpu(o4, g4, lse):
        return _bwd_prep_reference(o4, g4, lse, sq_pad)
    _check_kernel_tensors("backward prep", dict(out=o4, dO=g4), {torch.bfloat16: (128,)},
                          None, None)
    if lse.dtype != torch.float32 or not lse.is_contiguous() or lse.device != o4.device:
        raise ValueError("lse must be contiguous float32 (B, N, Sq) on out's device")
    b, sq, n, _ = o4.shape
    lse2 = torch.empty((b, n, sq_pad), dtype=torch.float32, device=lse.device)
    delta = torch.empty_like(lse2)
    from ..kernels.build import load_flash_bwd_split_sm90

    err = load_flash_bwd_split_sm90().svi_flash_bwd_prep(
        o4.data_ptr(), g4.data_ptr(), lse.data_ptr(), lse2.data_ptr(), delta.data_ptr(), b, n,
        sq, sq_pad, (ctypes.c_int64 * 6)(*o4.stride()[:3], *g4.stride()[:3]),
        torch.cuda.current_stream(o4.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"backward prep kernel launch failed: cudaError {err}")
    return lse2, delta


_ONEPASS_ROWS = 64  # query rows per step of csrc/flash_bwd_sm90.cu


def _launch_bwd_sm90(q4, k4, v4, o4, lse, g4, cos, sin, scale: float):
    """Launch csrc/flash_bwd_sm90.cu (K4) and its dq finalize on the current
    stream. With RoPE, q and k are first rotated by the forward's pre-pass
    (`_rope_rotate4`, bit-identical to the rotation the forward applied), as
    the JAX package rotates them outside its one-pass kernel; the kernel
    rotates dk back and the finalize dq. lse * log2(e) and delta =
    rowsum(dO * O) come from `_bwd_prep`, padded to a multiple of the
    kernel's 64-row step. Returns (dq, dk, dv) flat."""
    _check_kernel_tensors("one-pass flash backward", dict(q=q4, k=k4, v=v4, dO=g4),
                          {torch.bfloat16: (128,)}, cos, sin)
    b, sq, n, d = q4.shape
    sk = k4.shape[1]
    lse2, delta = _bwd_prep(o4, g4, lse, _ONEPASS_ROWS)
    if cos is not None:
        q4, k4 = _rope_rotate4(q4, cos, sin), _rope_rotate4(k4, cos, sin)
    dq32 = torch.zeros(q4.shape, dtype=torch.float32, device=q4.device)
    dq = torch.empty((b, sq, n * d), dtype=q4.dtype, device=q4.device)
    dk = torch.empty((b, sk, n * d), dtype=k4.dtype, device=k4.device)
    dv = torch.empty((b, sk, n * d), dtype=v4.dtype, device=v4.device)
    from ..kernels.build import load_flash_bwd_sm90

    err = load_flash_bwd_sm90().svi_flash_bwd_sm90(
        q4.data_ptr(), k4.data_ptr(), v4.data_ptr(), g4.data_ptr(), lse2.data_ptr(),
        delta.data_ptr(), cos.data_ptr() if cos is not None else None,
        sin.data_ptr() if sin is not None else None, dq32.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), b, n, sq, sk, lse2.shape[-1], float(scale),
        _strides12(q4, k4, v4, g4), torch.cuda.current_stream(q4.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"one-pass flash backward (sm90) launch failed: code {err} "
                           + _LAUNCH_FAILED)
    return dq, dk, dv


def flash_bwd_onepass(q, k, v, out, lse, g, head_dim: int, cos=None, sin=None,
                      scale: Optional[float] = None):
    """K4's contract (`_bwd_onepass_kernel_flat`): q, k, v, out, dO flat
    (B, S, N*D), lse (B, N, Sq) from the forward, cos/sin (>= S, D/2) RoPE
    tables of the forward. Returns (dq, dk, dv), flat, contiguous, in q's
    dtype; dq is summed across KV tiles in f32 before it is rounded. The
    kernel (csrc/flash_bwd_sm90.cu) takes bf16 with head_dim 128."""
    views = _bwd_views(q, k, v, out, lse, g, head_dim, cos, sin)
    scale = head_dim ** -0.5 if scale is None else float(scale)
    if _on_cpu(q, k, v, out, lse, g, cos, sin):
        return _plain_bwd_flat(views, lse, cos, sin, k.shape[1], scale)
    if head_dim != 128:
        raise ValueError(f"flash_bwd_onepass: head_dim {head_dim}; the kernel is built for 128")
    grads = _launch_bwd_sm90(*views[:4], lse, views[4], cos, sin, scale)
    flash_bwd_onepass.launches += 1
    return grads


flash_bwd_onepass.launches = 0


def _split_bwd_route(dtype: torch.dtype, head_dim: int, cos=None) -> str:
    """The split-backward kernels a CUDA call at (dtype, head_dim) takes:
    'sm90' (bf16, D = 128), 'mma' (bf16, D = 64) or 'f32' (f32, D = 40, 64,
    80, 160; no RoPE tables: the SD UNets have none). Raises for any other
    pair: nothing falls back."""
    if dtype not in _BWD_HEAD_DIMS:
        raise TypeError(f"split flash backward kernels take bfloat16 or float32, not {dtype}")
    route = _SPLIT_BWD_ROUTES.get((dtype, head_dim))
    if route is None:
        raise ValueError(f"split flash backward kernels: head_dim {head_dim} not built for "
                         f"{dtype} (built: {_BWD_HEAD_DIMS[dtype]})")
    if route == "f32" and cos is not None:
        raise NotImplementedError("f32 flash backward kernels take no RoPE tables (the SD "
                                  "UNets have none)")
    return route


_SPLIT_ROWS = 128  # query rows per CTA of the sm90 dq kernel: lse2 and delta are padded to it


def _split_prep(views, lse, cos, sin):
    """What K5a and K5b both read, checked and computed once per backward:
    (route, q4, k4, the route's lse, delta). 'sm90': q and k rotated by the
    forward's RoPE pre-pass (the kernels rotate dq and dk back), lse * log2(e)
    and delta from `_bwd_prep`, padded to 128 rows; 'mma' and 'f32': q and k
    as given (the 'mma' kernels rotate them), the base-e lse, and delta in
    f32 (B, N, Sq)."""
    q4, k4, v4, o4, g4 = views
    _check_kernel_tensors("split flash backward", dict(q=q4, k=k4, v=v4, out=o4, dO=g4),
                          _BWD_HEAD_DIMS, cos, sin)
    if lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError("lse must be contiguous float32 (B, N, Sq)")
    route = _split_bwd_route(q4.dtype, q4.shape[-1], cos)
    if route == "sm90":
        lse2, delta = _bwd_prep(o4, g4, lse, _SPLIT_ROWS)
        if cos is not None:
            q4, k4 = _rope_rotate4(q4, cos, sin), _rope_rotate4(k4, cos, sin)
        return route, q4, k4, lse2, delta
    return route, q4, k4, lse, torch.einsum("bsnd,bsnd->bns", g4.float(), o4.float()).contiguous()


def _launch_split(entry: str, prep, v4, g4, cos, sin, scale: float):
    """Launch K5a (entry 'dq'; returns dq) or K5b (entry 'dkv'; returns (dk,
    dv)) on the current stream, on `_split_prep`'s result, and count it in
    the entry's `.routes`."""
    route, q4, k4, lse_k, delta = prep
    b, sq, n, d = q4.shape
    sk = k4.shape[1]
    dev = q4.device
    tables = (cos.data_ptr() if cos is not None else None,
              sin.data_ptr() if sin is not None else None)
    head = (q4.data_ptr(), k4.data_ptr(), v4.data_ptr(), g4.data_ptr(), lse_k.data_ptr(),
            delta.data_ptr(), *tables)
    strides, stream = _strides12(q4, k4, v4, g4), torch.cuda.current_stream(dev).cuda_stream
    rows = sq if entry == "dq" else sk
    grads = tuple(torch.empty((b, rows, n * d), dtype=q4.dtype, device=dev)
                  for _ in range(1 if entry == "dq" else 2))
    outs = grads
    if route == "sm90":
        from ..kernels.build import load_flash_bwd_split_sm90

        if entry == "dkv":  # dk, dv summed across query chunks in f32, freed on return
            outs = tuple(torch.zeros((b, sk, n, d), dtype=torch.float32, device=dev)
                         for _ in range(2)) + grads
        err = getattr(load_flash_bwd_split_sm90(), f"svi_flash_bwd_split_{entry}")(
            *head, *(t.data_ptr() for t in outs), b, n, sq, sk, lse_k.shape[-1], float(scale),
            strides, stream)
        if err != 0:
            raise RuntimeError(f"split flash backward ({entry}, sm90) launch failed: code {err} "
                               + _LAUNCH_FAILED)
    elif route == "f32":
        from ..kernels.build import load_flash_bwd_f32

        err = getattr(load_flash_bwd_f32(), f"svi_flash_bwd_f32_{entry}")(
            d, *head[:6], *(t.data_ptr() for t in outs), b, n, sq, sk, float(scale), strides,
            stream)
        if err != 0:
            raise RuntimeError(f"split flash backward ({entry}, f32) launch failed: cudaError "
                               f"{err}")
    else:
        from ..kernels.build import load_flash_bwd

        err = getattr(load_flash_bwd(), f"svi_flash_bwd_{entry}")(
            d, *head, *(t.data_ptr() for t in outs), b, n, sq, sk, float(scale), strides, stream)
        if err != 0:
            raise RuntimeError(f"split flash backward ({entry}, mma) launch failed: cudaError "
                               f"{err}")
    counter = flash_bwd_dq if entry == "dq" else flash_bwd_dkv
    counter.launches += 1
    counter.routes[(route, str(q4.dtype).removeprefix("torch."), d)] += 1
    return grads[0] if entry == "dq" else grads


def flash_bwd_dq(q, k, v, out, lse, g, head_dim: int, cos=None, sin=None,
                 scale: Optional[float] = None) -> torch.Tensor:
    """K5a's contract (`_bwd_dq_kernel_flat`): arguments as `flash_bwd_onepass`;
    returns dq (B, Sq, N*D), rotated back when RoPE is given. Counts its
    launches in `.launches` and per (route, dtype, head_dim) in `.routes`."""
    views = _bwd_views(q, k, v, out, lse, g, head_dim, cos, sin)
    scale = head_dim ** -0.5 if scale is None else float(scale)
    if _on_cpu(q, k, v, out, lse, g, cos, sin):
        return _plain_bwd_flat(views, lse, cos, sin, k.shape[1], scale)[0]
    return _launch_split("dq", _split_prep(views, lse, cos, sin), views[2], views[4], cos, sin,
                         scale)


flash_bwd_dq.launches = 0
flash_bwd_dq.routes = collections.Counter()


def flash_bwd_dkv(q, k, v, out, lse, g, head_dim: int, cos=None, sin=None,
                  scale: Optional[float] = None):
    """K5b's contract (`_bwd_dkv_kernel_flat`): arguments as `flash_bwd_onepass`;
    returns (dk, dv) (B, Sk, N*D), dk rotated back when RoPE is given. Counts
    its launches in `.launches` and per (route, dtype, head_dim) in `.routes`."""
    views = _bwd_views(q, k, v, out, lse, g, head_dim, cos, sin)
    scale = head_dim ** -0.5 if scale is None else float(scale)
    if _on_cpu(q, k, v, out, lse, g, cos, sin):
        return _plain_bwd_flat(views, lse, cos, sin, k.shape[1], scale)[1:]
    return _launch_split("dkv", _split_prep(views, lse, cos, sin), views[2], views[4], cos, sin,
                         scale)


flash_bwd_dkv.launches = 0
flash_bwd_dkv.routes = collections.Counter()


def flash_bwd_flat(q, k, v, out, lse, g, head_dim: int, cos=None, sin=None,
                   kv_len: Optional[int] = None, scale: Optional[float] = None):
    """The attention backward on flat (B, S, N*D) tensors, routed as the JAX
    package routes it (`_flash_core_flat_bwd`): K4 for long self-attention,
    K5a + K5b otherwise, with delta (and, on the sm90 route, the rotated q
    and k) computed once for both. CPU tensors take the plain version.

    kv_len < Sk (a padded sequence-parallel shard's keys) runs the same
    kernels on k[:, :kv_len] and v[:, :kv_len], routed by the cut shapes,
    and pads dk and dv with zeros: a key the forward masked had p = 0, so it
    adds nothing to dq and its dk and dv are exactly 0, and the lse the
    forward saved is the one over the cut keys. With RoPE tables it raises
    (nothing calls it: the sequence-parallel path rotates q and k first).
    The (B, N, S, D) route (the JAX package's `_flash_bwd_xla`: head dims
    the flat layout does not take) runs the f32 K5a + K5b of
    csrc/flash_bwd_f32.cu at f32 D = 40, 64, 80, 160, with delta computed
    once for both, and raises on the card for any other dtype or head dim."""
    sk = k.shape[1]
    kv_len = sk if kv_len is None else min(int(kv_len), sk)
    scale = head_dim ** -0.5 if scale is None else float(scale)
    if _on_cpu(q, k, v, out, lse, g, cos, sin):
        views = _bwd_views(q, k, v, out, lse, g, head_dim, cos, sin)
        return _plain_bwd_flat(views, lse, cos, sin, kv_len, scale)
    if kv_len < sk:
        if cos is not None:
            raise NotImplementedError(f"attention backward with kv_len {kv_len} < Sk {sk} and "
                                      "RoPE tables: rotate q and k before the call")
        dq, dk, dv = flash_bwd_flat(q, k[:, :kv_len], v[:, :kv_len], out, lse, g, head_dim,
                                    scale=scale)
        pad = (0, 0, 0, sk - kv_len)
        return dq, torch.nn.functional.pad(dk, pad), torch.nn.functional.pad(dv, pad)
    n = q.shape[-1] // head_dim
    route = _bwd_route(n, head_dim, q.shape[1], sk, sk)
    if route == "xla" and _SPLIT_BWD_ROUTES.get((q.dtype, head_dim)) != "f32":
        raise NotImplementedError(
            f"attention backward for {n} heads of {head_dim} in {q.dtype}: the (B, N, S, D) "
            f"route's backward kernel takes float32 with head_dim in "
            f"{_BWD_HEAD_DIMS[torch.float32]}")
    if route == "onepass":
        return flash_bwd_onepass(q, k, v, out, lse, g, head_dim, cos, sin, scale)
    views = _bwd_views(q, k, v, out, lse, g, head_dim, cos, sin)
    prep = _split_prep(views, lse, cos, sin)
    dq = _launch_split("dq", prep, views[2], views[4], cos, sin, scale)
    return (dq, *_launch_split("dkv", prep, views[2], views[4], cos, sin, scale))


# ---------------------------------------------------------------------------
# Int8 forward (K6): the operand prep, the plain version, the kernel entry
# ---------------------------------------------------------------------------

_LOG2_127 = 6.9886846867721655  # log2(127): the qk8pv8 shift that puts P in [0, 127]
# head dim -> the int8 forward's route, and the keys per tile of that route's
# kernel: its row max runs per tile, so the plain version walks the same
# tiles. D = 128 (the DiT) takes the Hopper kernel, whose 128-key tiles
# match its m64n128 products; D = 64 the mma.sync kernel's 64-key tiles.
_Q8_ROUTES = {128: "sm90", 64: "mma"}
Q8_BLOCK_K = {128: 128, 64: 64}
_Q8_PV8_MAX_SK = 131072  # the sm90 qk8pv8 kernel's int32 P.V8 sums: 127 * 127 * Sk < 2^31


def div_exact(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c rounded as an IEEE division. On CUDA, dividing by a Python
    scalar multiplies by its reciprocal instead, which can differ in the last
    bit; a one-element tensor divisor keeps the quantizers (here and in
    models.wan_dit) bit-equal to the JAX package's on every device."""
    return x / x.new_full((1,), c)


def _quant_prep(q, k, v, cos, sin, head_dim: int, pv8: bool):
    """The torch version of `_quant_prep_xla`: RoPE on q and k (once); q
    quantized per token, scales qs (B, N, Sq); k centred per (batch, head,
    channel) over its tokens (softmax-invariant) and quantized with one scale
    per (batch, head), kscale (B, N); with pv8, v quantized per (batch, head,
    channel), vss (B, N, D). q, k, v: (B, S, N*D). Returns (q8, qs, k8,
    kscale, v8, vss), the int8 tensors flat (B, S, N*D); v8 and vss are None
    without pv8."""
    b, sq, nd = q.shape
    sk = k.shape[1]
    n = nd // head_dim
    q4 = q.unflatten(-1, (n, head_dim))
    k4 = k.unflatten(-1, (n, head_dim))
    if cos is not None:
        q4 = _apply_rope_reference(q4, cos[:sq], sin[:sq])
        k4 = _apply_rope_reference(k4, cos[:sk], sin[:sk])
    q4 = q4.float()
    qs = div_exact(q4.abs().amax(3, keepdim=True), 127.0) + 1e-12  # (b, sq, n, 1)
    q8 = torch.round(q4 / qs).to(torch.int8).reshape(b, sq, nd)
    qs = qs[..., 0].transpose(1, 2).contiguous()
    k4 = k4.float()
    k4 = k4 - k4.mean(1, keepdim=True)
    kscale = div_exact(k4.abs().amax((1, 3)), 127.0) + 1e-12  # (b, n)
    k8 = torch.round(k4 / kscale[:, None, :, None]).to(torch.int8).reshape(b, sk, nd)
    if not pv8:
        return q8, qs, k8, kscale, None, None
    v4 = v.unflatten(-1, (n, head_dim)).float()
    vss = div_exact(v4.abs().amax(1), 127.0) + 1e-12  # (b, n, d)
    v8 = torch.round(v4 / vss[:, None]).to(torch.int8).reshape(b, sk, nd)
    return q8, qs, k8, kscale, v8, vss


def _flash_fwd_q8_reference(q8, qs, k8, kscale, v, vss, kv_len: int, scale: float,
                            out_dtype: torch.dtype, block_k: Optional[int] = None,
                            nsub: int = 1):
    """Plain PyTorch version of K6 (mirrors `_fwd_kernel_flat_q8` step by
    step). The keys are zero-padded to a multiple of block_k and walked in
    sub-blocks of block_k // nsub; each sub-block's row max is taken on the
    integer scores of all its keys, the masked and the padded ones too, as
    the TPU kernel does. P's rounding depends on that running max, so the
    sub-block width is an argument: the JAX package's `block_k // nsub`
    (`_choose_blocks_flat`) to match it, the kernel's tile
    (Q8_BLOCK_K[head dim], the default) to match the card. Integer products
    are computed in f32, exactly (each sum stays below 2^24). v is v's float
    (qk8) or v8 (qk8pv8, with vss). Returns out (B, Sq, N*D) in out_dtype
    and lse (B, N, Sq) of the centred logits."""
    b, sq, nd = q8.shape
    sk = k8.shape[1]
    n = qs.shape[1]
    d = nd // n
    pv8 = vss is not None
    if block_k is None:
        block_k = Q8_BLOCK_K.get(d, 64)
    sk_p = _ceil_to(max(sk, 1), block_k)
    h = block_k // nsub
    masked = kv_len < sk_p
    heads = lambda t: t.unflatten(-1, (n, d)).transpose(1, 2)  # noqa: E731
    qt = heads(q8).float()
    kt = torch.nn.functional.pad(heads(k8).float(), (0, 0, 0, sk_p - sk))
    vt = torch.nn.functional.pad(heads(v), (0, 0, 0, sk_p - sk))
    p_dtype = torch.float32 if pv8 else v.dtype
    vt = vt.float()
    c_row = qs[..., None] * (kscale * scale * _LOG2E)[:, :, None, None]  # (b, n, sq, 1)
    p_shift = _LOG2_127 if pv8 else 0.0
    rows = max(1, min(sq, _REFERENCE_TILE_BYTES // (4 * b * n * h)))
    outs, lses = [], []
    for r0 in range(0, sq, rows):
        qc, cc = qt[:, :, r0:r0 + rows], c_row[:, :, r0:r0 + rows]
        m = torch.full(cc.shape, _NEG_INF, dtype=torch.float32, device=q8.device)
        l = torch.zeros_like(m)
        acc = torch.zeros(qc.shape, dtype=torch.float32, device=q8.device)
        for j0 in range(0, sk_p, h):
            s = qc @ kt[:, :, j0:j0 + h].transpose(-1, -2)  # integer-valued, exact
            m_t = torch.maximum(m, s.amax(-1, keepdim=True) * cc)
            sf = s * cc
            if masked:
                col = torch.arange(j0, j0 + h, device=q8.device)
                penalty = torch.where(col < kv_len, 0.0, _NEG_INF).to(torch.float32)
                p = torch.exp2(sf - m_t + (penalty + p_shift))
            else:
                p = torch.exp2(sf - m_t + p_shift)
            alpha = torch.exp2(m - m_t)
            pq = torch.round(p) if pv8 else p.to(p_dtype).float()
            pv = pq @ vt[:, :, j0:j0 + h]
            l = alpha * l + p.sum(-1, keepdim=True)
            acc = acc * alpha + pv
            m = m_t
        lc = l.clamp_min(1e-30)
        outs.append((acc / lc).to(out_dtype))
        lses.append((m / _LOG2E + torch.log(lc) - p_shift / _LOG2E)[..., 0])
    out = torch.cat(outs, dim=2)
    if pv8:  # out left in v8 channel units
        out = (out.float() * vss[:, :, None, :]).to(out_dtype)
    return out.transpose(1, 2).flatten(2), torch.cat(lses, dim=2)


def _check_q8_inputs(q8, qs, k8, kscale, v, vss, head_dim: int) -> None:
    """Shape and type checks shared by the kernel and the plain version."""
    if q8.ndim != 3 or k8.ndim != 3 or v.ndim != 3 or q8.shape[-1] % head_dim:
        raise ValueError(f"q8 {tuple(q8.shape)}, k8 {tuple(k8.shape)}, v {tuple(v.shape)} "
                         f"must be flat (B, S, N*{head_dim})")
    b, sq, nd = q8.shape
    n = nd // head_dim
    if k8.shape[0] != b or k8.shape[2] != nd or v.shape != k8.shape:
        raise ValueError(f"shape mismatch: q8 {tuple(q8.shape)}, k8 {tuple(k8.shape)}, "
                         f"v {tuple(v.shape)}")
    if q8.dtype != torch.int8 or k8.dtype != torch.int8:
        raise TypeError("q8 and k8 must be int8")
    if qs.shape != (b, n, sq) or kscale.shape != (b, n):
        raise ValueError(f"scales qs {tuple(qs.shape)} / kscale {tuple(kscale.shape)} must be "
                         f"{(b, n, sq)} / {(b, n)}")
    if (vss is None) == (v.dtype == torch.int8):
        raise TypeError("qk8pv8 takes int8 v with vss; qk8 takes a float v without vss")
    if vss is not None and vss.shape != (b, n, head_dim):
        raise ValueError(f"vss {tuple(vss.shape)} must be {(b, n, head_dim)}")


def _q8_route(head_dim: int) -> str:
    """The int8 forward's kernel for a head dim: "sm90" (D = 128) or "mma"
    (D = 64); anything else raises (no fallback)."""
    route = _Q8_ROUTES.get(head_dim)
    if route is None:
        raise ValueError(f"int8 flash forward kernel: head_dim {head_dim} not built "
                         f"(built: {tuple(_Q8_ROUTES)})")
    return route


# v8^T's key order inside each 32-key chunk: slot 16h + 4t + i holds key
# 16h + (2t, 2t+1, 8+2t, 9+2t)[i], so that the int8 accumulator values of P a
# thread holds after Q.K^T are, in this order, its A fragment of P.V8
_V8_SLOT_KEYS = tuple(16 * h + (2 * t, 2 * t + 1, 8 + 2 * t, 9 + 2 * t)[i]
                      for h in range(2) for t in range(4) for i in range(4))
_V8_KEY_SLOTS = tuple(sorted(range(32), key=_V8_SLOT_KEYS.__getitem__))


def _v8_keys_major_reference(v8: torch.Tensor, head_dim: int) -> torch.Tensor:
    """Plain version of `v8_keys_major`: one gather and transposition."""
    b, sk, nd = v8.shape
    n = nd // head_dim
    sk_pad = _ceil_to(max(sk, 1), Q8_BLOCK_K[128])
    x = torch.nn.functional.pad(v8.unflatten(-1, (n, head_dim)), (0, 0, 0, 0, 0, sk_pad - sk))
    perm = torch.tensor(_V8_SLOT_KEYS, device=v8.device)
    x = x.unflatten(1, (sk_pad // 32, 32)).index_select(2, perm)  # (b, chunks, slot, n, d)
    return x.permute(0, 3, 4, 1, 2).reshape(b, n, head_dim, sk_pad).contiguous()


def v8_keys_major(v8: torch.Tensor, head_dim: int) -> torch.Tensor:
    """qk8pv8's v8 (B, Sk, N*D) int8 -> (B, N, D, Sk_pad) contiguous: keys
    contiguous per channel (the integer wgmma takes K-major operands only),
    zero-padded to a multiple of the sm90 kernel's key tile, and permuted
    inside each 32-key chunk by `_V8_SLOT_KEYS`. On the card a pre-pass
    kernel of csrc/flash_fwd_q8_sm90.cu (part of K6: it counts no launch of
    its own); on the CPU the plain version."""
    if _on_cpu(v8):
        return _v8_keys_major_reference(v8, head_dim)
    b, sk, nd = v8.shape
    if head_dim != 128 or v8.dtype != torch.int8 or v8.stride(-1) != 1 or v8.data_ptr() % 16 \
            or any(st % 16 for st in v8.stride()[:2]):
        raise ValueError("v8_keys_major kernel: int8 v8 with head_dim 128, contiguous in its "
                         "last dim, 16-byte aligned, with 16-byte multiple row strides")
    n = nd // head_dim
    sk_pad = _ceil_to(max(sk, 1), Q8_BLOCK_K[128])
    vt = torch.empty((b, n, head_dim, sk_pad), dtype=torch.int8, device=v8.device)
    from ..kernels.build import load_flash_fwd_q8_sm90

    err = load_flash_fwd_q8_sm90().svi_v8_keys_major(
        v8.data_ptr(), vt.data_ptr(), b, n, sk, sk_pad, v8.stride(0), v8.stride(1),
        torch.cuda.current_stream(v8.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"v8_keys_major kernel launch failed: cudaError {err}")
    return vt


def v8_from_keys_major(v8t: torch.Tensor, sk: int) -> torch.Tensor:
    """The inverse of `v8_keys_major`: (B, N, D, Sk_pad) -> (B, Sk, N*D)."""
    b, n, d, sk_pad = v8t.shape
    perm = torch.tensor(_V8_KEY_SLOTS, device=v8t.device)
    x = v8t.unflatten(-1, (sk_pad // 32, 32)).index_select(-1, perm)  # slots back to keys
    return x.flatten(-2)[..., :sk].permute(0, 3, 1, 2).reshape(b, sk, n * d)


def _launch_q8(q8, qs, k8, kscale, v, vss, out, head_dim, kv_len, scale) -> tuple:
    """Launch the int8 forward of `_q8_route(head_dim)` on the current
    stream; returns (lse, route)."""
    named = dict(q8=q8, qs=qs, k8=k8, kscale=kscale, v=v, out=out)
    if vss is not None:
        named["vss"] = vss
    tensors = list(named.values())
    if not all(t.is_cuda for t in tensors) or len({t.device for t in tensors}) != 1:
        raise RuntimeError("int8 flash forward: every tensor must be on one CUDA device "
                           f"(got {sorted({str(t.device) for t in tensors})})")
    route = _q8_route(head_dim)
    # qk8 takes v and out of one type: bf16 on both routes, f32 on the sm90
    # route (the JAX kernel's P.V in v's dtype when q is f32)
    qk8_types = [(torch.bfloat16, torch.bfloat16)] + (
        [(torch.float32, torch.float32)] if route == "sm90" else [])
    if (vss is None and (v.dtype, out.dtype) not in qk8_types) or \
            out.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"int8 flash forward kernel ({route}): qk8 takes v and out both "
                        f"bfloat16{' or both float32' if route == 'sm90' else ''}; qk8pv8 "
                        f"bfloat16 or float32 out (got v {v.dtype}, out {out.dtype})")
    for name, t in dict(q8=q8, k8=k8, v=v, out=out).items():
        if t.stride(-1) != 1 or t.data_ptr() % 16 or any(
                (st * t.element_size()) % 16 for st in t.stride()[:2]):
            raise ValueError(f"int8 flash forward kernel: {name} must be contiguous in its "
                             "last dim, 16-byte aligned, with 16-byte multiple row strides")
    for name, t in dict(qs=qs, kscale=kscale, vss=vss).items():
        if t is not None and (t.dtype != torch.float32 or not t.is_contiguous()):
            raise ValueError(f"int8 flash forward kernel: {name} must be contiguous float32")
    b, sq, nd = q8.shape
    n, sk = nd // head_dim, k8.shape[1]
    lse = torch.empty((b, n, sq), dtype=torch.float32, device=q8.device)
    views = [t.unflatten(-1, (n, head_dim)) for t in (q8, k8, v, out)]
    pv8, out_f32 = int(vss is not None), int(out.dtype == torch.float32)
    vss_ptr = vss.data_ptr() if vss is not None else None
    stream = torch.cuda.current_stream(q8.device).cuda_stream
    if route == "sm90":
        from ..kernels.build import load_flash_fwd_q8_sm90

        if sk == 0 or (pv8 and sk > _Q8_PV8_MAX_SK):
            raise ValueError(f"int8 flash forward kernel (sm90): Sk = {sk} must be at least 1 "
                             f"(and at most {_Q8_PV8_MAX_SK} for qk8pv8: its int32 sums)")
        vt = v8_keys_major(v, head_dim) if pv8 else v
        if not pv8 and out_f32:
            route = "sm90_f32"  # qk8 with f32 v and out: a kernel of its own (3xTF32 P.V)
        err = load_flash_fwd_q8_sm90().svi_flash_fwd_q8_sm90(
            pv8, out_f32, q8.data_ptr(), qs.data_ptr(), k8.data_ptr(), kscale.data_ptr(),
            vt.data_ptr(), vss_ptr, out.data_ptr(), lse.data_ptr(), b, n, sq, sk,
            vt.shape[-1] if pv8 else sk, kv_len, float(scale), _strides12(*views), stream)
    else:
        from ..kernels.build import load_flash_fwd_q8

        err = load_flash_fwd_q8().svi_flash_fwd_q8(
            pv8, out_f32, head_dim, q8.data_ptr(), qs.data_ptr(), k8.data_ptr(),
            kscale.data_ptr(), v.data_ptr(), vss_ptr, out.data_ptr(), lse.data_ptr(), b, n, sq,
            sk, kv_len, float(scale), _strides12(*views), stream)
    if err != 0:
        raise RuntimeError(f"int8 flash forward kernel ({route}) launch failed: {err} "
                           + _LAUNCH_FAILED)
    return lse, route


def flash_fwd_flat_q8(q8: torch.Tensor, qs: torch.Tensor, k8: torch.Tensor,
                      kscale: torch.Tensor, v: torch.Tensor, vss: Optional[torch.Tensor],
                      head_dim: int, kv_len: Optional[int] = None,
                      scale: Optional[float] = None, out_dtype: torch.dtype = torch.bfloat16):
    """K6's contract, on `_quant_prep`'s outputs: q8 (B, Sq, N*D) int8 with
    qs (B, N, Sq); k8 (B, Sk, N*D) int8 with kscale (B, N); v (B, Sk, N*D)
    float (qk8) or int8 with vss (B, N, D) (qk8pv8). Keys >= kv_len are
    masked. Returns (out (B, Sq, N*D) in out_dtype, lse (B, N, Sq) of the
    centred logits). The kernel takes v and out both bf16 for qk8 (both f32
    too on the sm90 route, D = 128, counted as route "sm90_f32"), and bf16
    or f32 out for qk8pv8; other types raise on the card. Launches count in
    `.launches` and per (route, mode, head_dim) in `.routes`."""
    _check_q8_inputs(q8, qs, k8, kscale, v, vss, head_dim)
    kv_len = k8.shape[1] if kv_len is None else min(int(kv_len), k8.shape[1])
    if kv_len < 0:
        raise ValueError(f"kv_len must be >= 0, got {kv_len}")
    scale = head_dim ** -0.5 if scale is None else float(scale)
    if _on_cpu(q8, qs, k8, kscale, v, vss):
        return _flash_fwd_q8_reference(q8, qs, k8, kscale, v, vss, kv_len, scale, out_dtype)
    out = torch.empty(q8.shape, dtype=out_dtype, device=q8.device)
    lse, route = _launch_q8(q8, qs, k8, kscale, v, vss, out, head_dim, kv_len, scale)
    flash_fwd_flat_q8.launches += 1
    flash_fwd_flat_q8.routes[(route, "qk8" if vss is None else "qk8pv8", head_dim)] += 1
    return out, lse


flash_fwd_flat_q8.launches = 0
flash_fwd_flat_q8.routes = collections.Counter()


class _QuantFlashAttention(torch.autograd.Function):
    """The int8 forward of `_flash_core_flat_fwd(quant=...)`: `_quant_prep`,
    then K6. Inference only: the lse it would save is that of the centred
    logits, so a backward through it raises instead of giving wrong
    gradients."""

    @staticmethod
    def forward(ctx, q, k, v, cos, sin, head_dim, kv_len, scale, quant):
        pv8 = quant == "qk8pv8"
        q8, qs, k8, kscale, v8, vss = _quant_prep(q, k, v, cos, sin, head_dim, pv8)
        out, _ = flash_fwd_flat_q8(q8, qs, k8, kscale, v8 if pv8 else v, vss, head_dim,
                                   kv_len=kv_len, scale=scale, out_dtype=q.dtype)
        return out

    @staticmethod
    def backward(ctx, g):
        raise RuntimeError(
            "quantized attention (qk8 / qk8pv8) is inference-only: its lse is that of the "
            "centred logits, so it has no backward; use quant=None to train")


# ---------------------------------------------------------------------------
# Differentiable public ops
# ---------------------------------------------------------------------------


def _forward_flat(q, k, v, head_dim, cos, sin, kv_len, scale):
    """Flat (B, S, N*D) forward through whichever entry the JAX package uses."""
    n = q.shape[-1] // head_dim
    if _flat_ok(n, head_dim):
        return flash_fwd_flat(q, k, v, head_dim, cos=cos, sin=sin, kv_len=kv_len, scale=scale)
    q4, k4, v4 = (t.unflatten(-1, (n, head_dim)).transpose(1, 2) for t in (q, k, v))
    out, lse = flash_fwd_bnsd(q4, k4, v4, kv_len=kv_len, scale=scale, cos=cos, sin=sin)
    return out.transpose(1, 2).flatten(2), lse


@torch.library.custom_op("svi_tpu_torch::flash_fwd_rope", mutates_args=(),
                         schema="(Tensor q, Tensor k, Tensor v, Tensor cos, Tensor sin, "
                                "int head_dim, int kv_len, float scale) -> (Tensor, Tensor)")
def flash_fwd_rope(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cos: torch.Tensor,
                   sin: torch.Tensor, head_dim: int, kv_len: int,
                   scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    """The RoPE self-attention's forward (out, lse) as one operator, so that a
    selective checkpoint policy can save its outputs (`save_attention_policy`):
    a ctypes launch inside an autograd.Function is invisible to it. The
    cross-attentions (no RoPE) call `_forward_flat` directly and are
    recomputed, as the JAX package's save-attention policy keeps only the
    self-attention's "flash_out" / "flash_lse"."""
    return _forward_flat(q, k, v, head_dim, cos, sin, kv_len, scale)


@torch.library.custom_op("svi_tpu_torch::flash_fwd_self", mutates_args=(),
                         schema="(Tensor q, Tensor k, Tensor v, int head_dim, int kv_len, "
                                "float scale) -> (Tensor, Tensor)")
def flash_fwd_self(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, head_dim: int,
                   kv_len: int, scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    """The self-attention forward (out, lse) on q and k rotated before the
    call (the sequence-parallel path rotates its shard and then gathers the
    keys), an operator of its own for `save_attention_policy` as
    `flash_fwd_rope` is."""
    return _forward_flat(q, k, v, head_dim, None, None, kv_len, scale)


def save_attention_policy(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of `WanDiT.forward_blocks(save_attention=True)`:
    keep the self-attention forward's (out, lse) from the forward, recompute
    everything else."""
    from torch.utils.checkpoint import CheckpointPolicy

    if op in (torch.ops.svi_tpu_torch.flash_fwd_rope.default,
              torch.ops.svi_tpu_torch.flash_fwd_self.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


class _FlashAttention(torch.autograd.Function):
    """Mirrors `_flash_core_flat` + `_attn_with_saved`: the forward kernel,
    saving (q, k, v, cos, sin, out, lse); the backward through
    `flash_bwd_flat`. Gradients flow to q, k and v only. With RoPE the
    forward goes through the `flash_fwd_rope` operator, a self-attention on
    rotated q and k (self_attn) through `flash_fwd_self`."""

    @staticmethod
    def forward(ctx, q, k, v, cos, sin, head_dim, kv_len, scale, self_attn=False):
        if cos is not None:
            out, lse = flash_fwd_rope(q, k, v, cos, sin, head_dim, kv_len, scale)
        elif self_attn:
            out, lse = flash_fwd_self(q, k, v, head_dim, kv_len, scale)
        else:
            out, lse = _forward_flat(q, k, v, head_dim, cos, sin, kv_len, scale)
        ctx.save_for_backward(q, k, v, cos, sin, out, lse)
        ctx.args = (head_dim, kv_len, scale)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, cos, sin, out, lse = ctx.saved_tensors
        head_dim, kv_len, scale = ctx.args
        dq, dk, dv = flash_bwd_flat(q, k, v, out, lse, g.contiguous(), head_dim, cos=cos,
                                    sin=sin, kv_len=kv_len, scale=scale)
        return dq, dk, dv, None, None, None, None, None, None


def _attention_flat(q, k, v, head_dim, cos, sin, kv_len, scale, self_attn=False):
    kv_len = k.shape[1] if kv_len is None else int(kv_len)
    scale = head_dim ** -0.5 if scale is None else float(scale)
    return _FlashAttention.apply(q, k, v, cos, sin, head_dim, kv_len, scale, self_attn)


def _attention4(q, k, v, cos, sin, kv_len, scale):
    """(B, S, N, D) in and out."""
    n, d = q.shape[2], q.shape[3]
    out = _attention_flat(q.flatten(2), k.flatten(2), v.flatten(2), d, cos, sin, kv_len, scale)
    return out.unflatten(-1, (n, d))


def _rope_tables(cos, sin, s: int, device):
    return (torch.as_tensor(cos, dtype=torch.float32, device=device)[:s].contiguous(),
            torch.as_tensor(sin, dtype=torch.float32, device=device)[:s].contiguous())


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_len: Optional[int] = None, scale: Optional[float] = None) -> torch.Tensor:
    """Full (non-causal) attention, differentiable in q, k and v.
    q: (B, Sq, N, D); k, v: (B, Sk, N, D). Keys at positions >= kv_len are
    masked. Returns (B, Sq, N, D) in q.dtype."""
    return _attention4(q, k, v, None, None, kv_len, scale)


def flash_attention_rope(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cos, sin,
                         kv_len: Optional[int] = None,
                         scale: Optional[float] = None) -> torch.Tensor:
    """Self-attention with interleaved-pair RoPE applied to q and k inside the
    kernel. q, k, v: (B, S, N, D); cos/sin: (>= S, D/2) tables."""
    cos, sin = _rope_tables(cos, sin, q.shape[1], q.device)
    return _attention4(q, k, v, cos, sin, kv_len, scale)


def flash_attention_flat(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, head_dim: int,
                         cos=None, sin=None, kv_len: Optional[int] = None,
                         scale: Optional[float] = None,
                         quant: Optional[str] = None) -> torch.Tensor:
    """Flat-layout entry: q, k, v (B, S, N*head_dim) straight from the
    projections, optional RoPE, differentiable in q, k and v. quant: None |
    'qk8' | 'qk8pv8' runs the int8 forward (K6), inference only: a backward
    through it raises. The int8 forward needs the flat layout (head_dim %
    128 == 0 or one head); elsewhere a quant request raises, where the JAX
    package would quietly run bf16."""
    if quant is not None and quant not in ("qk8", "qk8pv8"):
        raise ValueError(f"quant={quant!r}: expected None, 'qk8', or 'qk8pv8'")
    if cos is not None:
        cos, sin = _rope_tables(cos, sin, q.shape[1], q.device)
    if quant is None:
        return _attention_flat(q, k, v, head_dim, cos, sin, kv_len, scale)
    n = q.shape[-1] // head_dim
    if not _flat_ok(n, head_dim):
        raise NotImplementedError(
            f"quant={quant!r} with {n} heads of {head_dim}: the int8 forward takes the flat "
            "layout only (head_dim % 128 == 0 or one head)")
    kv_len = k.shape[1] if kv_len is None else int(kv_len)
    scale = head_dim ** -0.5 if scale is None else float(scale)
    return _QuantFlashAttention.apply(q, k, v, cos, sin, head_dim, kv_len, scale, quant)


def flash_attention_self(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, head_dim: int,
                         kv_len: Optional[int] = None,
                         scale: Optional[float] = None) -> torch.Tensor:
    """Self-attention on flat (B, S, N*head_dim) q and k that are already
    rotated (the sequence-parallel path: a shard's queries against the
    gathered keys, padding masked by kv_len), differentiable in q, k and v;
    its forward is the `flash_fwd_self` operator that the save-attention
    policy keeps."""
    return _attention_flat(q, k, v, head_dim, None, None, kv_len, scale, self_attn=True)


def attention_bnsd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   kv_len: Optional[int] = None, scale: Optional[float] = None) -> torch.Tensor:
    """`flash_attention` on the (B, N, S, D) layout: q (B, N, Sq, D); k, v
    (B, N, Sk, D). Differentiable in q, k and v; returns (B, N, Sq, D)."""
    out = flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                          kv_len=kv_len, scale=scale)
    return out.transpose(1, 2)


def flash_attention_with_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             kv_len: Optional[int] = None, scale: Optional[float] = None):
    """Forward attention returning (out, lse) on the (B, N, S, D) layout (for
    cross-device softmax merging)."""
    return flash_fwd_bnsd(q, k, v, kv_len=kv_len, scale=scale)
