"""Build and load the hand-written CUDA kernels (nvcc -> .so -> ctypes).

Each source `svi_tpu_torch/csrc/*.cu` is compiled at first use into its own
library in `svi_tpu_torch/kernels/_build` (listed in `.gitignore`), named by
a hash of the source and the headers beside it, so a fresh checkout builds
itself and an edited source rebuilds. The libraries have a plain C interface:
no PyTorch headers, so a build takes seconds instead of minutes.
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
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC = PACKAGE_DIR / "csrc"
SOURCE = CSRC / "flash_fwd.cu"
SM90_SOURCE = CSRC / "flash_fwd_sm90.cu"
F32_SOURCE = CSRC / "flash_fwd_f32.cu"
BWD_SOURCE = CSRC / "flash_bwd.cu"
BWD_SM90_SOURCE = CSRC / "flash_bwd_sm90.cu"
BWD_SPLIT_SM90_SOURCE = CSRC / "flash_bwd_split_sm90.cu"
Q8_SOURCE = CSRC / "flash_fwd_q8.cu"
UNPACK_SOURCE = CSRC / "quant_unpack.cu"
BUILD_DIR = PACKAGE_DIR / "kernels" / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]


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


def nvcc_command(nvcc: str, source: Path, output: Path) -> list[str]:
    return [
        nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
        "-Xptxas", "-v", "-o", str(output), str(source),
    ]


def library_path(source: Path = SOURCE) -> Path:
    digest = hashlib.sha256(source.read_bytes())
    for header in sorted(source.parent.glob("*.cuh")):
        digest.update(header.read_bytes())
    return BUILD_DIR / f"lib{source.stem}_{digest.hexdigest()[:16]}.so"


def build(source: Path = SOURCE) -> BuildResult:
    """Compile `source` unless the library for its hash exists. The output is
    written to a temporary name and renamed, so a concurrent build never
    loads a half-written library."""
    out = library_path(source)
    if out.exists():
        return BuildResult(out, 0.0, "cached")
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
    t0 = time.perf_counter()
    proc = subprocess.run(nvcc_command(nvcc, source, tmp), capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {source.name} ({proc.returncode}):\n{log}")
    os.replace(tmp, out)
    return BuildResult(out, seconds, log)


def build_all() -> dict[str, BuildResult]:
    """Every source under csrc/, one nvcc each, all started together."""
    sources = sorted(CSRC.glob("*.cu"))
    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        return dict(zip((s.name for s in sources), pool.map(build, sources)))


_i64, _ptr = ctypes.c_int64, ctypes.c_void_p
_STRIDES = ctypes.POINTER(_i64)


@functools.lru_cache(maxsize=None)
def load_flash_fwd() -> ctypes.CDLL:
    """Build (if needed) and load the bf16 D=64 forward (route "mma") once per
    process."""
    lib = ctypes.CDLL(str(build(SOURCE).path))
    lib.svi_flash_fwd.argtypes = [
        ctypes.c_int, ctypes.c_int,  # head_dim, rope
        _ptr, _ptr, _ptr, _ptr, _ptr, _ptr, _ptr,  # q, k, v, out, lse, cos, sin
        _i64, _i64, _i64, _i64, _i64,  # batch, heads, sq, sk, kv_len
        ctypes.c_float,  # scale
        _STRIDES,  # 12 strides
        _ptr,  # cudaStream_t
    ]
    lib.svi_flash_fwd.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def load_flash_fwd_f32() -> ctypes.CDLL:
    """Build (if needed) and load the f32 forward (3xTF32 tensor cores) once
    per process."""
    lib = ctypes.CDLL(str(build(F32_SOURCE).path))
    lib.svi_flash_fwd_f32.argtypes = [
        ctypes.c_int,  # head_dim
        _ptr, _ptr, _ptr, _ptr, _ptr, _ptr, _ptr,  # q, k, v, out, lse, cos, sin
        _i64, _i64, _i64, _i64, _i64,  # batch, heads, sq, sk, kv_len
        ctypes.c_float,  # scale
        _STRIDES,  # 12 strides
        _ptr,  # cudaStream_t
    ]
    lib.svi_flash_fwd_f32.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def load_flash_fwd_sm90() -> ctypes.CDLL:
    """Build (if needed) and load the Hopper bf16 D=128 forward (TMA + wgmma)
    and its RoPE pre-pass once per process."""
    lib = ctypes.CDLL(str(build(SM90_SOURCE).path))
    lib.svi_flash_fwd_sm90.argtypes = [
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
def load_flash_fwd_q8() -> ctypes.CDLL:
    """Build (if needed) and load the int8 flash-forward library (K6) once."""
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
