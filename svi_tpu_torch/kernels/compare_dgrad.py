"""Time builds of the W4A8 straight-through input gradient
(`csrc/w4a8_dgrad_sm90.cu`) against each other on one card.

    python -m svi_tpu_torch.kernels.compare_dgrad [--other SRC ...] [--diagnostic SRC ...]
        [--rows NAME,...] [--rounds N]

Builds the checkout's source and each `--other` w4a8_dgrad_sm90.cu (another
tree's source with its `sm90_common.cuh` beside it, its C entry taking the
packed weight's row bytes after the weight), one nvcc each, all at once,
each into its own library under a scratch directory, and prints each
build's ptxas register and spill lines (a build that fails is reported and
left out). `--diagnostic` sources are built and timed the same way, their
error printed but not held to the bound: copies with a part of the kernel
taken out, to see what that part costs. Then, at the rows of chip_smoke.py
phase 3 (`--rows`, default all: the 14B's ffn.0, ffn.2, a 5120 x 5120
projection and the head at the training slice's 9360 tokens), every build
is held against the plain version (`quant_matmul._w4a8_dgrad_reference`:
K3's plain unpack, g * bf16(s8), cuBLAS) within chip_smoke.py's
`dgrad_err_bound`, and timed in turns with the chain the training backward
runs (the standalone K3, then `_straight_through_dx`) and torch.matmul(gs,
W8 in bf16) alone (first, others, others reversed, first, `--rounds`
times): the median device time of a call queued behind a device sleep
(chip_smoke.py's `device_ms`). Exits 1 if an `--other` build or the
checkout's disagrees with the plain version.

Needs a CUDA card and nvcc; run from the root of a checkout.
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import statistics
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from . import build

ROWS = {  # name: (m, n, k), chip_smoke.py's phase-3 rows
    "w4a8_dgrad_ffn_0": (9360, 13824, 5120),
    "w4a8_dgrad_ffn_2": (9360, 5120, 13824),
    "w4a8_dgrad_self_attn_q": (9360, 5120, 5120),
    "w4a8_dgrad_head": (9360, 64, 5120),
}


def build_all(sources: dict[str, Path], out_dir: Path) -> dict[str, ctypes.CDLL]:
    """One nvcc per source (its headers copied beside it), all at once."""
    nvcc = build.find_nvcc()

    def one(item):
        name, src = item
        work = out_dir / name
        work.mkdir()
        for f in [src, *src.parent.glob("*.cuh")]:
            shutil.copy(f, work / f.name)
        lib = work / f"lib{name}.so"
        proc = subprocess.run(build.nvcc_command(nvcc, work / src.name, lib),
                              capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode:
            print(f"[build] {name} FAILED:\n{log[-3000:]}", flush=True)
            return name, None
        print(f"[build] {name}: " + " | ".join(
            line.strip() for line in log.splitlines() if "registers" in line or "spill" in line or "C7513" in line),
            flush=True)
        dll = ctypes.CDLL(str(lib))
        dll.svi_w4a8_dgrad.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int64] + [
            ctypes.c_void_p] * 3 + [ctypes.c_int64] * 3 + [ctypes.c_int, ctypes.c_void_p]
        dll.svi_w4a8_dgrad.restype = ctypes.c_int
        return name, dll

    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        return {k: v for k, v in pool.map(one, sources.items()) if v is not None}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", nargs="*", default=[], help="other w4a8_dgrad_sm90.cu sources")
    ap.add_argument("--diagnostic", nargs="*", default=[],
                    help="sources timed without holding them to the bound")
    ap.add_argument("--rows", default=",".join(ROWS))
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)
    root = Path.cwd()
    sys.path.insert(0, str(root))
    import chip_smoke as cs  # the bounds, rates and timers of the smoke run

    from ..models import wan_dit
    from ..ops import quant_matmul as Q

    sources = {"this": build.DGRAD_SOURCE}
    sources.update({f"other{i}": Path(p).resolve() for i, p in enumerate(args.other)})
    sources.update({f"diag{i}": Path(p).resolve() for i, p in enumerate(args.diagnostic)})
    card = cs.nvidia_smi_line()
    print(card, flush=True)
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    failed = False
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as tmp:
        libs = build_all(sources, Path(tmp))
        gen = torch.Generator(device="cuda").manual_seed(0)
        for row in args.rows.split(","):
            m, n, k = ROWS[row]
            w = torch.randn((n, k), generator=gen, device="cuda").to(torch.bfloat16) * 0.02
            packed, scale = wan_dit._quantize_leaf_int4(w)
            r, s8 = wan_dit._w4a8_leaves(scale)
            g = torch.randn((m, n), generator=gen, device="cuda").to(torch.bfloat16) * 1e-3
            s8f = s8.reshape(-1).float().contiguous()
            gs = g * s8.reshape(-1).to(torch.bfloat16)
            wb = Q.unpack_requant_int4(packed, r).to(torch.bfloat16)
            ref = Q._w4a8_dgrad_reference(g, packed, r, s8)
            exact = gs.double() @ wb.double()
            bound = cs.dgrad_err_bound(gs, wb, exact)
            del exact
            stream = torch.cuda.current_stream().cuda_stream

            def call(dll):
                dx = torch.empty((m, k), dtype=torch.bfloat16, device="cuda")
                err = dll.svi_w4a8_dgrad(g.data_ptr(), packed.data_ptr(), k // 2, r.data_ptr(),
                                         s8f.data_ptr(), dx.data_ptr(), m, n, k,
                                         k // r.shape[1], stream)
                if err:
                    raise RuntimeError(f"launch failed: {err}")
                return dx

            fns = {name: (lambda d=dll: call(d)) for name, dll in libs.items()}
            for name, fn in fns.items():
                e = (fn().float() - ref.float()).abs().max().item()
                print(f"[compare-dgrad] {row} {name}: max abs err {e:.3e} (bound {bound:.3e})",
                      flush=True)
                if not e <= bound and not name.startswith("diag"):
                    print(f"[compare-dgrad] {row}: {name} DISAGREES with the plain version",
                          flush=True)
                    failed = True
            fns["chain"] = lambda: Q._straight_through_dx(g, Q.unpack_requant_int4(packed, r), s8)
            fns["torch.matmul"] = lambda: torch.matmul(gs, wb)
            names = list(fns)
            times = {name: [] for name in names}
            for _ in range(args.rounds):
                for name in names + names[::-1]:
                    times[name].append(cs.device_ms(fns[name]))
            bound_ms = cs.bound(2 * m * n * k, cs._nbytes(g, packed, r, s8) + 2 * m * k,
                                cs.PEAK_BF16)[0]
            med = {name: statistics.median(t) for name, t in times.items()}
            print(f"[compare-dgrad] {row} M{m} N{n} K{k}: device ms (median of "
                  f"{2 * args.rounds}) " + ", ".join(f"{name} {v:.4f}" for name, v in med.items())
                  + f"; bound {bound_ms:.4f}; {card}", flush=True)
            del g, packed, r, s8, s8f, gs, wb, ref
            torch.cuda.empty_cache()
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
