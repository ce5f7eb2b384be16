"""Time builds of the bf16 flash forward (`csrc/flash_fwd_sm90.cu`) against
each other on one card.

    python -m svi_tpu_torch.kernels.compare_fwd_sm90 [--variant D,WG,STAGES,FUSED[,BN] ...]
        [--other SRC ...] [--mma SRC] [--rows d64,d128,...] [--rounds N] [--host]

Builds the checkout's source (every head dim in one library); one copy of it
for each `--variant`, whose `using FwdCfg<D> = FwdCfg<...>;` line is set to
the given configuration (head dim, consumer warpgroups of 64 query rows, K/V
stages, 1 to fold the softmax scale into the exp2's FMA, keys per tile); each
`--other` flash_fwd_sm90.cu, another tree's source with the same C entry and
its headers beside it; and with `--mma` a flash_fwd_bf16.cu (the mma.sync
bf16 forward that served D = 32-160, 384 and 512 before the TMA + wgmma
kernels took them, e.g. from an older tree unpacked with `git archive`). One
nvcc each, all at once, each into its own library under a scratch
directory; prints each build's ptxas register and spill lines.

Then, at each shape of the main paths (`--rows`: `d64` CogVideoX-5B's joint
attention and a ragged S514; `d128` the 14B DiT's self-attention with its
RoPE pre-pass, FLUX.1-dev's joint attention, HunyuanVideo's image group;
`d32`, `d40`, `d80`, `d88`, `d160`, `d384`, `d512` the rows of chip_smoke.py
phase 3 at those head dims: the SD 1.5 UNet's self- and cross-attention and
AnimateDiff's temporal attention at 16 frames, Hunyuan-DiT, the VAE
mid-blocks), every build that holds the head dim (a build whose entry
returns cudaErrorInvalidValue for it is left out of that row) is held
against the plain version (`attention._flash_fwd_reference`, under
chip_smoke.py's bf16 bounds) and against the first build bit for bit, then
timed in turns (first, others, others reversed, first, `--rounds` times):
the median CUDA-event time of one call, each call timed alone from an idle
card (`ms`, the wrapper's host work included where the card waits on it),
and the median device time of a call queued behind a device sleep
(`device_ms`, chip_smoke.py's `device_ms`). SDPA on the same tensors is
timed beside every row, with the bound (chip_smoke.py's rates: operations
at the true head dim, or bytes) and the exp2 floor.

`--host` prints, at four short rows (SD 1.5's D80, D160 and D40 cross
rows, FLUX's IP-Adapter attention at D = 128), the host time a call spends
in each piece of the public wrapper `attention.flash_fwd_bnsd` (host clock,
the median of 300 calls of each piece, the card idle before each piece): the
input checks, the kernel-tensor checks, the stride array, the stream, the
output allocations, the C entry through `kernels.build`'s per-head-dim
dispatch and the same entry called directly, the entry at batch 0 (ctypes
alone, nothing encoded or launched) and the whole wrapper. With
`--host-tree DIR` (another checkout, e.g. an older one unpacked with `git
archive`), the whole wrapper's host time and its CUDA-event time from an
idle card (the median of 50 calls) at those rows, in DIR's package and in
this one, each in a process of its own, in turns (DIR, this, this, DIR,
`--rounds` times).

Needs a CUDA card and nvcc; run from the root of a checkout.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from . import build

_INVALID_VALUE = 1  # cudaErrorInvalidValue: the build does not hold the head dim


class Build:
    """One library built from a flash_fwd_sm90.cu (or, with mma=True, a
    flash_fwd_bf16.cu)."""

    def __init__(self, name: str, source: Path, out_dir: Path, mma: bool = False):
        self.name, self.source, self.mma = name, source, mma
        self.path = out_dir / f"lib_{name}.so"
        self.log = ""
        self.lib = None

    def compile(self) -> None:
        cmd = build.nvcc_command(build.find_nvcc(), self.source, self.path)
        proc = subprocess.run(cmd, capture_output=True, text=True)
        self.log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {self.name}:\n{self.log}")

    def bind(self) -> None:
        if self.mma:
            self.lib = ctypes.CDLL(str(self.path))
            self.lib.svi_flash_fwd_bf16.argtypes = build._FWD_ARGTYPES
            self.lib.svi_flash_fwd_bf16.restype = ctypes.c_int
        else:
            self.lib = build.bind_flash_fwd_sm90(self.path)

    def ptxas(self) -> str:
        return " | ".join(line.strip() for line in self.log.splitlines()
                          if "registers" in line or "spill" in line)

    def entry(self, d, q4, k4, v4, out, lse, kv_len, batch=None):
        """The C entry on prepared tensors; returns its code."""
        b, sq, n, _ = q4.shape
        stream = torch.cuda.current_stream().cuda_stream
        strides = (ctypes.c_int64 * 12)(*(s for t in (q4, k4, v4, out) for s in t.stride()[:3]))
        ptrs = [t.data_ptr() for t in (q4, k4, v4, out, lse)]
        b = b if batch is None else batch
        if self.mma:
            return self.lib.svi_flash_fwd_bf16(d, *ptrs, None, None, b, n, sq, k4.shape[1],
                                               kv_len, d ** -0.5, strides, stream)
        return self.lib.svi_flash_fwd_sm90(d, *ptrs, b, n, sq, k4.shape[1], kv_len, d ** -0.5,
                                           strides, stream)

    def forward(self, q4, k4, v4, kv_len, cos=None, sin=None):
        """out (B, Sq, N, D) and lse (B, N, Sq) of (B, S, N, D) views, or None
        where the build does not hold the head dim."""
        b, sq, n, d = q4.shape
        if cos is not None:
            q4, k4 = (self._rope(t, cos, sin) for t in (q4, k4))
        out = torch.empty((b, sq, n, d), dtype=q4.dtype, device=q4.device)
        lse = torch.empty((b, n, sq), dtype=torch.float32, device=q4.device)
        err = self.entry(d, q4, k4, v4, out, lse, kv_len)
        if err == _INVALID_VALUE:
            return None
        if err != 0:
            raise RuntimeError(f"{self.name}: launch failed with code {err}")
        return out, lse

    def _rope(self, x4, cos, sin):
        b, s, n, d = x4.shape
        y = torch.empty(x4.shape, dtype=x4.dtype, device=x4.device)
        err = self.lib.svi_rope_rotate(x4.data_ptr(), y.data_ptr(), cos.data_ptr(),
                                       sin.data_ptr(), b, s, n, d, *x4.stride()[:3],
                                       torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"{self.name}: RoPE pre-pass failed with code {err}")
        return y


def variant_source(spec: str, out_dir: Path) -> tuple:
    """(name, path): a copy of the checkout's csrc/ whose FwdCfg<D> line is
    set to `spec` = 'D,WG,STAGES,FUSED[,BN]'."""
    d, wg, stages, fused, *bn = (int(x) for x in spec.split(","))
    name = f"d{d}_wg{wg}_st{stages}_f{fused}" + (f"_bn{bn[0]}" if bn else "")
    src_dir = out_dir / name
    shutil.copytree(build.CSRC, src_dir)
    source = src_dir / build.SM90_SOURCE.name
    cfg = f"{d}, {wg}, {stages}, {'true' if fused else 'false'}" + (f", {bn[0]}" if bn else "")
    text, count = re.subn(rf"using FwdCfg{d} = FwdCfg<[^;]*>;", f"using FwdCfg{d} = FwdCfg<{cfg}>;",
                          source.read_text())
    if count != 1:
        raise ValueError(f"no single `using FwdCfg{d} = ...;` line in {build.SM90_SOURCE}")
    source.write_text(text)
    return name, source


def event_ms(fn) -> float:
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def rows(which: set):
    """(name, b, sq, sk, n, d, kv_len, rope grid or None, flat): the main
    paths' shapes. q, k, v are (B, S, N, D) views of (B, S, N*D) projections
    (flat: column slices of one (B, S, 3 D) tensor, one head)."""
    if "d64" in which:
        yield "cogvideox_joint_attn_d64", 2, 17776, 17776, 48, 64, 17776, None, False
        yield "cogvideox_ragged_s514_kv500", 2, 514, 514, 48, 64, 500, None, False
    if "d128" in which:
        yield "dit_self_attn_rope", 1, 32760, 32760, 40, 128, 32760, (21, 30, 52), False
        yield "flux_joint_attn", 1, 4608, 4608, 24, 128, 4608, None, False
        yield "hunyuan_video_group_a", 1, 118871, 118871, 24, 128, 118871, None, False
    if "d32" in which:
        yield "tiny_dit_self_attn_d32", 1, 4680, 4680, 8, 32, 4680, None, False
    if "d40" in which:
        yield "sd_unet_self_attn_d40", 2, 4096, 4096, 8, 40, 4096, None, False
        yield "sd_unet_cross_attn_d40", 2, 4096, 77, 8, 40, 77, None, False
        yield "animatediff_motion_d40", 4096, 16, 16, 8, 40, 16, None, False
    if "d80" in which:
        yield "sd_unet_self_attn_d80", 2, 1024, 1024, 8, 80, 1024, None, False
    if "d88" in which:
        yield "hunyuan_dit_self_attn_d88", 2, 4096, 4096, 16, 88, 4096, None, False
        yield "hunyuan_dit_cross_attn_d88", 2, 4096, 333, 16, 88, 333, None, False
    if "d160" in which:
        yield "sd_unet_self_attn_d160", 2, 256, 256, 8, 160, 256, None, False
    if "d384" in which:
        yield "wan_vae_mid_attn_d384", 2, 6240, 6240, 1, 384, 6240, None, False
    if "d512" in which:
        yield "sd_vae_mid_attn_d512", 1, 4096, 4096, 1, 512, 4096, None, True
        yield "vae_mid_attn_d512_s16384", 1, 16384, 16384, 1, 512, 16384, None, True


HOST_ROWS = (("sd_unet_self_attn_d80", 2, 1024, 1024, 8, 80),
             ("sd_unet_self_attn_d160", 2, 256, 256, 8, 160),
             ("sd_unet_cross_attn_d40", 2, 4096, 77, 8, 40),
             ("flux_ip_adapter_d128", 1, 4096, 128, 24, 128))

# run with `python -c` from the root of a checkout: the public wrapper's host
# and event time at HOST_ROWS, one JSON line a row
WRAPPER_SNIPPET = """
import json, statistics, sys, time
import torch
from svi_tpu_torch.ops import attention as A
for name, b, sq, sk, n, d in json.loads(sys.argv[1]):
    q = torch.randn((b, n, sq, d), device="cuda").bfloat16()
    k, v = (torch.randn((b, n, sk, d), device="cuda").bfloat16() for _ in range(2))
    A.flash_fwd_bnsd(q, k, v)
    torch.cuda.synchronize()
    host = []
    for _ in range(300):
        t0 = time.perf_counter()
        A.flash_fwd_bnsd(q, k, v)
        host.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    ev = []
    for _ in range(50):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        s.record()
        A.flash_fwd_bnsd(q, k, v)
        e.record()
        e.synchronize()
        ev.append(s.elapsed_time(e))
    print(json.dumps(dict(row=name, host_us=1e6 * statistics.median(host),
                          event_ms=statistics.median(ev))), flush=True)
"""


def wrapper_times(tree: Path) -> list:
    proc = subprocess.run([sys.executable, "-c", WRAPPER_SNIPPET, json.dumps(HOST_ROWS)],
                          cwd=tree, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"the wrapper's timing in {tree} failed:\n{proc.stderr[-3000:]}")
    return [json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{")]


def host_pieces(builds, reps: int = 300) -> None:
    """The host time of each piece of `flash_fwd_bnsd` at HOST_ROWS."""
    from ..ops import attention as A

    def host_us(fn) -> float:
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        return 1e6 * statistics.median(times)

    for name, b, sq, sk, n, d in HOST_ROWS:
        q = torch.randn((b, sq, n * d), device="cuda").bfloat16()
        k, v = (torch.randn((b, sk, n * d), device="cuda").bfloat16() for _ in range(2))
        q4, k4, v4 = (t.unflatten(-1, (n, d)) for t in (q, k, v))
        qh, kh, vh = (t.transpose(1, 2) for t in (q4, k4, v4))
        out = torch.empty((b, sq, n, d), dtype=q.dtype, device="cuda")
        lse = torch.empty((b, n, sq), dtype=torch.float32, device="cuda")
        lib = build.load_flash_fwd_sm90()
        stream = torch.cuda.current_stream(q.device).cuda_stream
        strides = A._strides12(q4, k4, v4, out)
        ptrs = [t.data_ptr() for t in (q4, k4, v4, out, lse)]
        A.flash_fwd_bnsd(qh, kh, vh)  # builds and loads the group
        pieces = {
            "check_inputs": lambda: A._check_inputs(q4, k4, v4, None, None, sk),
            "check_kernel_tensors": lambda: A._check_kernel_tensors(
                "flash forward", dict(q=q4, k=k4, v=v4, out=out), A._KERNEL_HEAD_DIMS, None,
                None),
            "strides12": lambda: A._strides12(q4, k4, v4, out),
            "current_stream": lambda: torch.cuda.current_stream(q.device).cuda_stream,
            "empty_out_lse": lambda: (torch.empty(q.shape, dtype=q.dtype, device=q.device),
                                      torch.empty((b, n, sq), dtype=torch.float32,
                                                  device=q.device)),
            "entry_via_build": lambda: lib.svi_flash_fwd_sm90(d, *ptrs, b, n, sq, sk, sk,
                                                              d ** -0.5, strides, stream),
            "wrapper_flash_fwd_bnsd": lambda: A.flash_fwd_bnsd(qh, kh, vh),
        }
        for bd in builds:
            if bd.mma:
                continue
            pieces[f"entry_{bd.name}"] = (lambda bd=bd: bd.entry(d, q4, k4, v4, out, lse, sk))
            pieces[f"entry_{bd.name}_batch0"] = (
                lambda bd=bd: bd.entry(d, q4, k4, v4, out, lse, sk, batch=0))
        us = {key: host_us(fn) for key, fn in pieces.items()}
        print(f"[host] {json.dumps(dict(row=name, shape=[b, sq, sk, n, d], us=us))}", flush=True)


def main(argv=None) -> int:
    import chip_smoke as yardstick  # the bounds and peak rates of phase 3

    from ..ops import attention as A
    from ..ops.rope import rope_angles_for_grid

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", action="append", default=[],
                    help="D,WG,STAGES,FUSED[,BN]: a build with that configuration (repeatable)")
    ap.add_argument("--other", action="append", default=[], type=Path,
                    help="another flash_fwd_sm90.cu with the same C entry (repeatable)")
    ap.add_argument("--mma", type=Path, default=None,
                    help="a flash_fwd_bf16.cu (the mma.sync bf16 forward) to time beside")
    ap.add_argument("--rows", default="d64,d128")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--host", action="store_true", help="the wrapper's host time by piece")
    ap.add_argument("--host-tree", type=Path, default=None,
                    help="another checkout whose public wrapper is timed beside this one's")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    card = yardstick.nvidia_smi_line()
    print(f"[env] {card}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    out_dir = Path(tempfile.mkdtemp(prefix="compare_fwd_sm90_"))
    builds = [Build("checkout", build.SM90_SOURCE, out_dir)]
    builds += [Build(*variant_source(spec, out_dir), out_dir) for spec in args.variant]
    builds += [Build(f"other{i}", src, out_dir) for i, src in enumerate(args.other)]
    if args.mma is not None:
        builds.append(Build("mma", args.mma, out_dir, mma=True))
    with ThreadPoolExecutor(max_workers=len(builds)) as pool:
        list(pool.map(Build.compile, builds))
    for bd in builds:
        bd.bind()
        print(f"[build] {bd.name} ({bd.source}): ptxas: {bd.ptxas()}", flush=True)
    if args.host:
        host_pieces(builds)
    if args.host_tree is not None:
        here = Path(__file__).resolve().parents[2]
        for tree in (args.host_tree, here, here, args.host_tree) * args.rounds:
            for row in wrapper_times(tree):
                print(f"[wrapper] {json.dumps(dict(tree=str(tree), **row, card=card))}",
                      flush=True)

    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, b, sq, sk, n, d, kv_len, grid, flat in rows(set(args.rows.split(","))):
        if flat:
            qkv = torch.randn((b, sq, 3 * d), generator=gen, device="cuda").bfloat16()
            q, k, v = qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:]
        else:
            q = torch.randn((b, sq, n * d), generator=gen, device="cuda").bfloat16()
            k, v = (torch.randn((b, sk, n * d), generator=gen, device="cuda").bfloat16()
                    for _ in range(2))
        q4, k4, v4 = (t.unflatten(-1, (n, d)) for t in (q, k, v))
        cos = sin = None
        if grid is not None:
            c, sn = rope_angles_for_grid(grid, d)
            cos, sin = torch.from_numpy(c).cuda(), torch.from_numpy(sn).cuda()
        ref_out, ref_lse = A._flash_fwd_reference(q4, k4, v4, cos, sin, kv_len, d ** -0.5)
        out_bound = min(yardstick.BF16_OUT_BOUND,
                        yardstick.BF16_OUT_REL * ref_out.float().abs().max().item())
        first, held = None, []
        for bd in builds:
            if bd.mma and cos is not None:
                continue
            got = bd.forward(q4, k4, v4, kv_len, cos, sin)
            if got is None:
                continue
            held.append(bd)
            out, lse = got
            torch.cuda.synchronize()
            out_err = (out.float() - ref_out.float()).abs().max().item()
            lse_err = (lse - ref_lse).abs().max().item()
            same = None if first is None else bool(torch.equal(out, first[0])
                                                   and torch.equal(lse, first[1]))
            first = first or (out, lse)
            ok = out_err <= out_bound and lse_err <= yardstick.BF16_LSE_BOUND
            print(f"[check] {name} {bd.name}: out err {out_err:.3e} (bound {out_bound:.3e}), "
                  f"lse err {lse_err:.3e} (bound {yardstick.BF16_LSE_BOUND}), bit-equal to "
                  f"{held[0].name}: {same}, ok {ok}", flush=True)
            if not ok:
                raise RuntimeError(f"{name}: {bd.name} disagrees with the plain version")
        del ref_out, ref_lse, first
        calls = {bd.name: (lambda bd=bd: bd.forward(q4, k4, v4, kv_len, cos, sin))
                 for bd in held}
        qh, kh, vh = (t.transpose(1, 2) for t in (q4, k4, v4))
        if cos is None:
            mask = None if kv_len == sk else (torch.arange(sk, device="cuda") < kv_len)[
                None, None, None]
            calls["sdpa"] = lambda: torch.nn.functional.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=mask)
        times = {key: [] for key in calls}
        order = list(calls)
        for fn in calls.values():  # warm-up
            fn()
        for _ in range(args.rounds):
            for key in order[:1] + order[1:] + order[1:][::-1] + order[:1]:
                times[key].append(event_ms(calls[key]))
        dev = {key: statistics.median(yardstick.device_ms(fn) for _ in range(args.rounds))
               for key, fn in calls.items()}
        nbytes = 2 * (2 * b * sq * n * d + 2 * b * sk * n * d) + 4 * b * n * sq
        bound_ms, bound_by, _ = yardstick.bound(4 * b * n * sq * kv_len * d, nbytes,
                                                yardstick.PEAK_BF16)
        row = dict(row=name, shape=[b, sq, sk, n, d], kv_len=kv_len, card=card,
                   bound_ms=bound_ms, bound_by=bound_by,
                   exp2_floor_ms=1e3 * b * n * sq * kv_len / yardstick.EXP2_PER_S,
                   ms={key: statistics.median(t) for key, t in times.items()},
                   device_ms=dev, calls_ms=times)
        print(f"[time] {json.dumps(row)}", flush=True)
        del q, k, v, q4, k4, v4, calls
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
