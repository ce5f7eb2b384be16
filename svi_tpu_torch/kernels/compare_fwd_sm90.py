"""Time builds of the bf16 flash forward (`csrc/flash_fwd_sm90.cu`) against
each other on one card.

    python -m svi_tpu_torch.kernels.compare_fwd_sm90 [--variant D,WG,STAGES,FUSED ...]
        [--other SRC ...] [--rows d64,d128] [--rounds N]

Builds the checkout's source; one copy of it for each `--variant`, whose
`using FwdCfg<D> = FwdCfg<...>;` line is set to the given configuration
(head dim, consumer warpgroups of 64 query rows, K/V stages, 1 to fold the
softmax scale into the exp2's FMA); and each `--other` flash_fwd_sm90.cu,
another tree's source with the same C entry and its headers beside it. One
nvcc each, all at once, each into its own library under a scratch
directory; prints each build's ptxas register and spill lines.

Then, at each shape of the main paths (`d64`: CogVideoX-5B's joint attention,
B2 S17776 N48 D64, and a ragged S514 with kv_len 500; `d128`: the 14B DiT's
self-attention at 480x832x81 with its RoPE pre-pass, FLUX.1-dev's joint
attention, HunyuanVideo's image group), every build is held against the
plain version (`attention._flash_fwd_reference`, under chip_smoke.py's bf16
bounds) and against the first build bit for bit, then timed in turns (first,
others, others reversed, first, `--rounds` times): the median CUDA-event
time of one call, each call timed alone from an idle card. SDPA on the same
tensors is timed beside the D = 64 rows, and the exp2 floor printed beside
their tensor-core bound (chip_smoke.py's rates). Every build runs every row
asked for: give an `--other` that serves one head dim only that head dim's
rows.

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
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from . import build


class Build:
    """One library built from a flash_fwd_sm90.cu."""

    def __init__(self, name: str, source: Path, out_dir: Path):
        self.name, self.source = name, source
        self.path = out_dir / f"lib_{name}.so"
        self.log = ""
        self.lib = None

    def compile(self) -> None:
        cmd = build.nvcc_command(build.find_nvcc(), self.source, self.path)
        proc = subprocess.run(cmd, capture_output=True, text=True)
        self.log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {self.name}:\n{self.log}")

    def ptxas(self) -> str:
        return " | ".join(line.strip() for line in self.log.splitlines()
                          if "registers" in line or "spill" in line)

    def forward(self, q4, k4, v4, kv_len, cos=None, sin=None):
        """out (B, Sq, N, D) and lse (B, N, Sq) of (B, S, N, D) views."""
        b, sq, n, d = q4.shape
        stream = torch.cuda.current_stream().cuda_stream
        if cos is not None:
            q4, k4 = (self._rope(t, cos, sin, stream) for t in (q4, k4))
        out = torch.empty((b, sq, n, d), dtype=q4.dtype, device=q4.device)
        lse = torch.empty((b, n, sq), dtype=torch.float32, device=q4.device)
        strides = [s for t in (q4, k4, v4, out) for s in t.stride()[:3]]
        err = self.lib.svi_flash_fwd_sm90(
            d, *(t.data_ptr() for t in (q4, k4, v4, out, lse)), b, n, sq, k4.shape[1], kv_len,
            d ** -0.5, (ctypes.c_int64 * 12)(*strides), stream)
        if err != 0:
            raise RuntimeError(f"{self.name}: launch failed with code {err}")
        return out, lse

    def _rope(self, x4, cos, sin, stream):
        b, s, n, d = x4.shape
        y = torch.empty(x4.shape, dtype=x4.dtype, device=x4.device)
        err = self.lib.svi_rope_rotate(x4.data_ptr(), y.data_ptr(), cos.data_ptr(),
                                       sin.data_ptr(), b, s, n, d, *x4.stride()[:3], stream)
        if err != 0:
            raise RuntimeError(f"{self.name}: RoPE pre-pass failed with code {err}")
        return y


def variant_source(spec: str, out_dir: Path) -> tuple:
    """(name, path): a copy of the checkout's csrc/ whose FwdCfg<D> line is
    set to `spec` = 'D,WG,STAGES,FUSED'."""
    d, wg, stages, fused = (int(x) for x in spec.split(","))
    name = f"d{d}_wg{wg}_st{stages}_f{fused}"
    src_dir = out_dir / name
    shutil.copytree(build.CSRC, src_dir)
    source = src_dir / build.SM90_SOURCE.name
    text, count = re.subn(rf"using FwdCfg{d} = FwdCfg<[^;]*>;",
                          f"using FwdCfg{d} = FwdCfg<{d}, {wg}, {stages}, "
                          f"{'true' if fused else 'false'}>;", source.read_text())
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
    """(name, b, s, n, d, kv_len, rope grid or None): the main paths' shapes.
    q, k, v are (B, S, N, D) views of (B, S, N*D) projections: the strides
    CogVideoX's (B, N, S, D) views hand the kernel."""
    if "d64" in which:
        yield "cogvideox_joint_attn_d64", 2, 17776, 48, 64, 17776, None
        yield "cogvideox_ragged_s514_kv500", 2, 514, 48, 64, 500, None
    if "d128" in which:
        yield "dit_self_attn_rope", 1, 32760, 40, 128, 32760, (21, 30, 52)
        yield "flux_joint_attn", 1, 4608, 24, 128, 4608, None
        yield "hunyuan_video_group_a", 1, 118871, 24, 128, 118871, None


def main(argv=None) -> int:
    import chip_smoke as yardstick  # the bounds and peak rates of phase 3

    from ..ops import attention as A
    from ..ops.rope import rope_angles_for_grid

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", action="append", default=[],
                    help="D,WG,STAGES,FUSED: a build with that configuration (repeatable)")
    ap.add_argument("--other", action="append", default=[], type=Path,
                    help="another flash_fwd_sm90.cu with the same C entry (repeatable)")
    ap.add_argument("--rows", default="d64,d128")
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    card = yardstick.nvidia_smi_line()
    print(f"[env] {card}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    out_dir = Path(tempfile.mkdtemp(prefix="compare_fwd_sm90_"))
    builds = [Build("checkout", build.SM90_SOURCE, out_dir)]
    builds += [Build(*variant_source(spec, out_dir), out_dir) for spec in args.variant]
    builds += [Build(f"other{i}", src, out_dir) for i, src in enumerate(args.other)]
    with ThreadPoolExecutor(max_workers=len(builds)) as pool:
        list(pool.map(Build.compile, builds))
    for bd in builds:
        bd.lib = build.bind_flash_fwd_sm90(bd.path)
        print(f"[build] {bd.name} ({bd.source}): ptxas: {bd.ptxas()}", flush=True)

    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, b, s, n, d, kv_len, grid in rows(set(args.rows.split(","))):
        q, k, v = (torch.randn((b, s, n * d), generator=gen, device="cuda").bfloat16()
                   for _ in range(3))
        q4, k4, v4 = (t.unflatten(-1, (n, d)) for t in (q, k, v))
        cos = sin = None
        if grid is not None:
            c, sn = rope_angles_for_grid(grid, d)
            cos, sin = torch.from_numpy(c).cuda(), torch.from_numpy(sn).cuda()
        ref_out, ref_lse = A._flash_fwd_reference(q4, k4, v4, cos, sin, kv_len, d ** -0.5)
        out_bound = min(yardstick.BF16_OUT_BOUND,
                        yardstick.BF16_OUT_REL * ref_out.float().abs().max().item())
        first = None
        for bd in builds:
            out, lse = bd.forward(q4, k4, v4, kv_len, cos, sin)
            torch.cuda.synchronize()
            out_err = (out.float() - ref_out.float()).abs().max().item()
            lse_err = (lse - ref_lse).abs().max().item()
            same = None if first is None else bool(torch.equal(out, first[0])
                                                   and torch.equal(lse, first[1]))
            first = first or (out, lse)
            ok = out_err <= out_bound and lse_err <= yardstick.BF16_LSE_BOUND
            print(f"[check] {name} {bd.name}: out err {out_err:.3e} (bound {out_bound:.3e}), "
                  f"lse err {lse_err:.3e} (bound {yardstick.BF16_LSE_BOUND}), bit-equal to "
                  f"{builds[0].name}: {same}, ok {ok}", flush=True)
            if not ok:
                raise RuntimeError(f"{name}: {bd.name} disagrees with the plain version")
        del ref_out, ref_lse, first
        calls = {bd.name: (lambda bd=bd: bd.forward(q4, k4, v4, kv_len, cos, sin))
                 for bd in builds}
        if d == 64:
            qh, kh, vh = (t.transpose(1, 2) for t in (q4, k4, v4))
            mask = None if kv_len == s else (torch.arange(s, device="cuda") < kv_len)[
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
        row = dict(row=name, shape=[b, s, n, d], kv_len=kv_len, card=card,
                   bound_ms=1e3 * 4 * b * n * s * kv_len * d / yardstick.PEAK_BF16,
                   ms={key: statistics.median(t) for key, t in times.items()},
                   calls_ms=times)
        if d == 64:
            row["exp2_floor_ms"] = 1e3 * b * n * s * kv_len / yardstick.EXP2_PER_S
        print(f"[time] {json.dumps(row)}", flush=True)
        del q, k, v, q4, k4, v4, calls
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
