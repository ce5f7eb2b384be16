"""Build and load the hand-written CUDA kernels (nvcc -> .so -> ctypes).

Each source `svi_tpu_torch/csrc/*.cu` is compiled at first use into its own
library in `svi_tpu_torch/kernels/_build` (listed in `.gitignore`), named by
a hash of the source and the headers beside it, so a fresh checkout builds
itself and an edited source rebuilds. The libraries have a plain C interface:
no PyTorch headers, so a build takes seconds instead of minutes. The two
forwards and the f32 backward (`HEAD_DIM_GROUPS`) are built as one library per
group of head dims, each an nvcc of its own, so that `build_all`, which
starts every nvcc at once, is not held up by one long compile.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import time
import types
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC = PACKAGE_DIR / "csrc"
SM90_SOURCE = CSRC / "flash_fwd_sm90.cu"
F32_SOURCE = CSRC / "flash_fwd_f32.cu"
BWD_SOURCE = CSRC / "flash_bwd.cu"
BWD_F32_SOURCE = CSRC / "flash_bwd_f32.cu"
BWD_SM90_SOURCE = CSRC / "flash_bwd_sm90.cu"
BWD_SPLIT_SM90_SOURCE = CSRC / "flash_bwd_split_sm90.cu"
Q8_SOURCE = CSRC / "flash_fwd_q8.cu"
Q8_SM90_SOURCE = CSRC / "flash_fwd_q8_sm90.cu"
UNPACK_SOURCE = CSRC / "quant_unpack.cu"
W4A8_SOURCE = CSRC / "w4a8_gemm_sm90.cu"
DGRAD_SOURCE = CSRC / "w4a8_dgrad_sm90.cu"
BUILD_DIR = PACKAGE_DIR / "kernels" / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
# sources built as one library per group of head dims (-DSVI_GROUP -DSVI_D<d>
# for each head dim of a group; the source compiles only those): all nine f32
# head dims with and without RoPE in one nvcc took 47.7 s against <= 17 s for
# each other source; the f32 backward's D = 80 and 160 in one nvcc took 28.2 s
# among all the builds, the longest. The bf16 forward's first group (D = 64
# and 128, the DiTs' and CogVideoX's) also serves the RoPE pre-pass
# (`ROPE_GROUP`).
HEAD_DIM_GROUPS = {
    F32_SOURCE: ((32, 40), (64, 80), (88, 128), (160, 384), (512,)),
    SM90_SOURCE: ((64, 128), (32, 40), (80, 88), (160,), (384, 512)),
    BWD_F32_SOURCE: ((40,), (64,), (80,), (160,)),
}
ROPE_GROUP = (64, 128)


@dataclasses.dataclass(frozen=True)
class BuildResult:
    path: Path
    seconds: float  # 0.0 when the library for this source hash already existed
    log: str  # nvcc's output (-Xptxas -v: registers, shared memory, spills)


def find_nvcc() -> str:
    """nvcc from CUDA_HOME, then PATH, then /usr/local/cuda/bin; raises if absent."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file() and os.access(c, os.X_OK):
            return str(c)
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and /usr/local/cuda/bin); "
        "the CUDA kernels cannot be built"
    )


def group_flags(head_dims: tuple = ()) -> list[str]:
    """The defines that build one group of head dims of a source (none: all)."""
    return ["-DSVI_GROUP", *(f"-DSVI_D{d}" for d in head_dims)] if head_dims else []


def nvcc_command(nvcc: str, source: Path, output: Path, head_dims: tuple = ()) -> list[str]:
    return [
        nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
        "-Xptxas", "-v", *group_flags(head_dims), "-o", str(output), str(source),
    ]


def library_path(source: Path, head_dims: tuple = ()) -> Path:
    digest = hashlib.sha256(source.read_bytes())
    for header in sorted(source.parent.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(group_flags(head_dims)).encode())
    group = "_d" + "-".join(map(str, head_dims)) if head_dims else ""
    return BUILD_DIR / f"lib{source.stem}{group}_{digest.hexdigest()[:16]}.so"


def build(source: Path, head_dims: tuple = ()) -> BuildResult:
    """Compile `source` (only the head dims `head_dims` of a grouped source;
    all when empty) unless the library for its hash exists. The output is
    written to a temporary name and renamed, so a concurrent build never
    loads a half-written library."""
    out = library_path(source, head_dims)
    if out.exists():
        return BuildResult(out, 0.0, "cached")
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
    t0 = time.perf_counter()
    proc = subprocess.run(nvcc_command(nvcc, source, tmp, head_dims), capture_output=True,
                          text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {source.name} ({proc.returncode}):\n{log}")
    os.replace(tmp, out)
    return BuildResult(out, seconds, log)


def units() -> list[tuple[Path, tuple]]:
    """(source, head dims) of every library: each source under csrc/ once,
    the grouped ones once per group."""
    return [(src, group) for src in sorted(CSRC.glob("*.cu"))
            for group in HEAD_DIM_GROUPS.get(src, ((),))]


def build_all() -> dict[str, BuildResult]:
    """Every library of `units()`, one nvcc each, all started together."""
    todo = units()
    names = [src.name + (f" (D {', '.join(map(str, g))})" if g else "") for src, g in todo]
    with ThreadPoolExecutor(max_workers=len(todo)) as pool:
        return dict(zip(names, pool.map(lambda u: build(*u), todo)))


_i64, _ptr = ctypes.c_int64, ctypes.c_void_p
_STRIDES = ctypes.POINTER(_i64)
# the C entry of flash_fwd_f32.cu
_FWD_ARGTYPES = [
    ctypes.c_int,  # head_dim
    _ptr, _ptr, _ptr, _ptr, _ptr, _ptr, _ptr,  # q, k, v, out, lse, cos, sin
    _i64, _i64, _i64, _i64, _i64,  # batch, heads, sq, sk, kv_len
    ctypes.c_float,  # scale
    _STRIDES,  # 12 strides
    _ptr,  # cudaStream_t
]


@functools.lru_cache(maxsize=None)
def _load_fwd_group(source: Path, head_dims: tuple) -> ctypes.CDLL:
    """The library of one group of head dims of a grouped source (the two
    forwards, and the f32 backward), its entries declared."""
    path = build(source, head_dims).path
    if source == SM90_SOURCE:
        return bind_flash_fwd_sm90(path)
    if source == BWD_F32_SOURCE:
        return bind_flash_bwd_f32(path)
    lib = ctypes.CDLL(str(path))
    entry = getattr(lib, f"svi_{source.stem}")
    entry.argtypes = _FWD_ARGTYPES
    entry.restype = ctypes.c_int
    return lib


class _ByHeadDim:
    """The C entry `svi_<stem>(head_dim, ...)` (or `name`) of a grouped
    source: each call goes to the library of the group that holds head_dim,
    built (if needed) and loaded at the first call of that group; the entry
    is looked up once per head dim."""

    def __init__(self, source: Path, name: str = ""):
        self.source = source
        self.name = name or f"svi_{source.stem}"
        self.entries = {}

    def __call__(self, head_dim: int, *args) -> int:
        entry = self.entries.get(head_dim)
        if entry is None:
            group = next((g for g in HEAD_DIM_GROUPS[self.source] if head_dim in g), None)
            if group is None:
                raise ValueError(f"no library of {self.source.name} holds head_dim {head_dim}")
            entry = getattr(_load_fwd_group(self.source, group), self.name)
            self.entries[head_dim] = entry
        return entry(head_dim, *args)


@functools.lru_cache(maxsize=None)
def load_flash_fwd_f32() -> types.SimpleNamespace:
    """The f32 forward (3xTF32 tensor cores): `svi_flash_fwd_f32(head_dim,
    ...)` builds (if needed) and loads its head dim's library once per
    process."""
    return types.SimpleNamespace(svi_flash_fwd_f32=_ByHeadDim(F32_SOURCE))


@functools.lru_cache(maxsize=None)
def load_flash_fwd_sm90() -> types.SimpleNamespace:
    """The Hopper bf16 forward (TMA + wgmma) at every head dim:
    `svi_flash_fwd_sm90(head_dim, ...)` builds (if needed) and loads its head
    dim's library once per process; `svi_rope_rotate(...)`, the RoPE
    pre-pass, is ROPE_GROUP's library's."""
    rope = _load_fwd_group(SM90_SOURCE, ROPE_GROUP).svi_rope_rotate
    return types.SimpleNamespace(svi_flash_fwd_sm90=_ByHeadDim(SM90_SOURCE),
                                 svi_rope_rotate=rope)


def bind_flash_fwd_sm90(path: Path) -> ctypes.CDLL:
    """Load a library built from flash_fwd_sm90.cu (all head dims, or one
    group's) and declare its entries."""
    lib = ctypes.CDLL(str(path))
    lib.svi_flash_fwd_sm90.argtypes = [
        ctypes.c_int,  # head_dim
        _ptr, _ptr, _ptr, _ptr, _ptr,  # q, k, v, out, lse
        _i64, _i64, _i64, _i64, _i64,  # batch, heads, sq, sk, kv_len
        ctypes.c_float,  # scale
        _STRIDES,  # 12 strides
        _ptr,  # cudaStream_t
    ]
    lib.svi_rope_rotate.argtypes = [
        _ptr, _ptr, _ptr, _ptr,  # x, y, cos, sin
        _i64, _i64, _i64, ctypes.c_int,  # batch, seq, heads, head_dim
        _i64, _i64, _i64,  # x's (b, s, n) element strides
        _ptr,  # cudaStream_t
    ]
    for fn in (lib.svi_flash_fwd_sm90, lib.svi_rope_rotate):
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def load_flash_bwd() -> ctypes.CDLL:
    """Build (if needed) and load the bf16 D=64 split backward (K5a, K5b on
    mma.sync, route "mma") once per process."""
    lib = ctypes.CDLL(str(build(BWD_SOURCE).path))
    head = [ctypes.c_int, _ptr, _ptr, _ptr, _ptr,  # head_dim, q, k, v, dO
            _ptr, _ptr, _ptr, _ptr]  # lse, delta, cos, sin
    tail = [_i64, _i64, _i64, _i64, ctypes.c_float, _STRIDES, _ptr]  # b, n, sq, sk, scale, ., stream
    lib.svi_flash_bwd_dq.argtypes = head + [_ptr] + tail  # dq
    lib.svi_flash_bwd_dkv.argtypes = head + [_ptr, _ptr] + tail  # dk, dv
    for fn in (lib.svi_flash_bwd_dq, lib.svi_flash_bwd_dkv):
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def load_flash_bwd_f32() -> types.SimpleNamespace:
    """The f32 split backward on the (B, N, S, D) route (K5a's and K5b's
    function at head dims 40, 64, 80, 160; 3xTF32 tensor cores):
    `svi_flash_bwd_f32_dq(head_dim, ...)` and `svi_flash_bwd_f32_dkv(head_dim,
    ...)` build (if needed) and load their head dim's library once per
    process."""
    return types.SimpleNamespace(**{name: _ByHeadDim(BWD_F32_SOURCE, name) for name in
                                    ("svi_flash_bwd_f32_dq", "svi_flash_bwd_f32_dkv")})


def bind_flash_bwd_f32(path: Path) -> ctypes.CDLL:
    """Load a library built from flash_bwd_f32.cu (all head dims, or one
    group's) and declare its two entries."""
    lib = ctypes.CDLL(str(path))
    head = [ctypes.c_int, _ptr, _ptr, _ptr, _ptr,  # head_dim, q, k, v, dO
            _ptr, _ptr]  # lse, delta
    tail = [_i64, _i64, _i64, _i64, ctypes.c_float, _STRIDES, _ptr]  # b, n, sq, sk, scale, ., stream
    lib.svi_flash_bwd_f32_dq.argtypes = head + [_ptr] + tail  # dq
    # dk, dv, dk and dv scratch of the query chunks, the chunk count
    lib.svi_flash_bwd_f32_dkv.argtypes = head + [_ptr, _ptr, _ptr, _ptr, _i64] + tail
    for fn in (lib.svi_flash_bwd_f32_dq, lib.svi_flash_bwd_f32_dkv):
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def load_flash_bwd_sm90() -> ctypes.CDLL:
    """Build (if needed) and load the one-pass backward (K4: TMA + wgmma) once
    per process."""
    lib = ctypes.CDLL(str(build(BWD_SM90_SOURCE).path))
    lib.svi_flash_bwd_sm90.argtypes = [
        _ptr, _ptr, _ptr, _ptr,  # q, k (rotated), v, dO
        _ptr, _ptr, _ptr, _ptr,  # lse * log2(e), delta (padded), cos, sin
        _ptr, _ptr, _ptr, _ptr,  # dq32, dq, dk, dv
        _i64, _i64, _i64, _i64, _i64,  # batch, heads, sq, sk, sq_pad
        ctypes.c_float,  # scale
        _STRIDES,  # 12 strides
        _ptr,  # cudaStream_t
    ]
    lib.svi_flash_bwd_sm90.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def load_flash_bwd_split_sm90() -> ctypes.CDLL:
    """Build (if needed) and load the Hopper bf16 D=128 split backward (K5a,
    K5b: TMA + wgmma) and its lse / delta prep once per process."""
    lib = ctypes.CDLL(str(build(BWD_SPLIT_SM90_SOURCE).path))
    head = [_ptr, _ptr, _ptr, _ptr,  # q, k (rotated), v, dO
            _ptr, _ptr, _ptr, _ptr]  # lse * log2(e), delta (padded), cos, sin
    tail = [_i64, _i64, _i64, _i64, _i64,  # batch, heads, sq, sk, sq_pad
            ctypes.c_float, _STRIDES, _ptr]  # scale, 12 strides, cudaStream_t
    lib.svi_flash_bwd_split_dq.argtypes = head + [_ptr] + tail  # dq
    lib.svi_flash_bwd_split_dkv.argtypes = head + [_ptr, _ptr, _ptr, _ptr] + tail  # dk32, dv32, dk, dv
    lib.svi_flash_bwd_prep.argtypes = [
        _ptr, _ptr, _ptr, _ptr, _ptr,  # out, dO, lse, lse2, delta
        _i64, _i64, _i64, _i64,  # batch, heads, sq, sq_pad
        _STRIDES,  # (b, s, n) element strides of out, then of dO
        _ptr,  # cudaStream_t
    ]
    for fn in (lib.svi_flash_bwd_split_dq, lib.svi_flash_bwd_split_dkv, lib.svi_flash_bwd_prep):
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def load_flash_fwd_q8_sm90() -> ctypes.CDLL:
    """Build (if needed) and load the Hopper int8 forward at D=128 (K6, route
    "sm90": TMA + integer wgmma) and its qk8pv8 V8 pre-pass once per
    process."""
    lib = ctypes.CDLL(str(build(Q8_SM90_SOURCE).path))
    lib.svi_flash_fwd_q8_sm90.argtypes = [
        ctypes.c_int, ctypes.c_int,  # pv8, out_f32
        _ptr, _ptr, _ptr, _ptr, _ptr, _ptr,  # q8, qs, k8, kscale, v (bf16 or v8^T), vss
        _ptr, _ptr,  # out, lse
        _i64, _i64, _i64, _i64, _i64, _i64,  # batch, heads, sq, sk, sk_pad, kv_len
        ctypes.c_float,  # scale
        _STRIDES,  # 12 strides
        _ptr,  # cudaStream_t
    ]
    lib.svi_v8_keys_major.argtypes = [
        _ptr, _ptr,  # v8, v8^T
        _i64, _i64, _i64, _i64,  # batch, heads, sk, sk_pad
        _i64, _i64,  # v8's batch and key element strides
        _ptr,  # cudaStream_t
    ]
    for fn in (lib.svi_flash_fwd_q8_sm90, lib.svi_v8_keys_major):
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def load_w4a8_gemm() -> ctypes.CDLL:
    """Build (if needed) and load the W4A8 linear (the activation pre-pass and
    the int4-unpacking int8 GEMM with its epilogue) once per process."""
    lib = ctypes.CDLL(str(build(W4A8_SOURCE).path))
    lib.svi_w4a8_quantize_rows.argtypes = [
        ctypes.c_int, _ptr, _ptr, _ptr,  # in_f32, x, x8, xs
        _i64, _i64,  # m, k
        _ptr,  # cudaStream_t
    ]
    lib.svi_w4a8_gemm.argtypes = [
        ctypes.c_int, _ptr, _i64, _i64,  # out_f32, x8, its columns, its high half's column
        _ptr, _ptr, _i64,  # xs, packed weight, its row bytes
        _ptr, _ptr, _ptr, _ptr,  # r, s8, bias (or null), y
        _i64, _i64, _i64, ctypes.c_int,  # m, n, k, group
        _ptr,  # cudaStream_t
    ]
    for fn in (lib.svi_w4a8_quantize_rows, lib.svi_w4a8_gemm):
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def load_w4a8_dgrad() -> ctypes.CDLL:
    """Build (if needed) and load the W4A8 linear's straight-through input
    gradient (W8 made in shared memory, bf16 wgmma) once per process."""
    lib = ctypes.CDLL(str(build(DGRAD_SOURCE).path))
    lib.svi_w4a8_dgrad.argtypes = [
        _ptr, _ptr, _i64,  # g, packed weight, its row bytes
        _ptr, _ptr, _ptr,  # r, s8, dx
        _i64, _i64, _i64, ctypes.c_int,  # m, n, k, group
        _ptr,  # cudaStream_t
    ]
    lib.svi_w4a8_dgrad.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def load_flash_fwd_q8() -> ctypes.CDLL:
    """Build (if needed) and load the int8 flash-forward library (K6 at D=64,
    route "mma") once."""
    lib = ctypes.CDLL(str(build(Q8_SOURCE).path))
    lib.svi_flash_fwd_q8.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # pv8, out_f32, head_dim
        _ptr, _ptr, _ptr, _ptr, _ptr, _ptr,  # q8, qs, k8, kscale, v (bf16 or int8), vss
        _ptr, _ptr,  # out, lse
        _i64, _i64, _i64, _i64, _i64,  # batch, heads, sq, sk, kv_len
        ctypes.c_float,  # scale
        _STRIDES,  # 12 strides
        _ptr,  # cudaStream_t
    ]
    lib.svi_flash_fwd_q8.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def load_quant_unpack() -> ctypes.CDLL:
    """Build (if needed) and load the int4 unpack/requant library (K3) once."""
    lib = ctypes.CDLL(str(build(UNPACK_SOURCE).path))
    lib.svi_unpack_requant_int4.argtypes = [
        _ptr, _ptr, _ptr,  # packed (N, K/2) int8, r (N, K/G) f32, out (N, K) int8
        _i64, _i64, ctypes.c_int,  # n_rows, kh = K/2, group
        _ptr,  # cudaStream_t
    ]
    lib.svi_unpack_requant_int4.restype = ctypes.c_int
    return lib
