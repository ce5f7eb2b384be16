"""Time builds of the f32 attention backward (`csrc/flash_bwd_f32.cu`: K5a's
and K5b's function on the (B, N, S, D) route) against each other on one
card.

    python -m svi_tpu_torch.kernels.compare_bwd_f32 [--other SRC ...]
        [--variant NAME=ARGS ...] [--rows NAME,...] [--rounds N] [--t2i-tree DIR]

Builds the checkout's source (every head dim in one library); one copy of it
for each `--variant`, whose `using NAME = ...;` line is given the template
arguments ARGS (e.g. `DqCfg40=40,1,64,2`, `DkvCfg64=64,32,1,2`); and each
`--other` flash_bwd_f32.cu, another tree's source with its headers beside it
(e.g. an older tree unpacked with `git archive`; a source whose dk / dv entry
takes no query chunks is called without them). One nvcc each, all at once,
each into its own library under a scratch directory; prints each build's
ptxas register and spill lines.

Then, at the rows of chip_smoke.py phase 3 (`--rows`, default all: SD
1.5's D40 self S4096 and cross Sk77, D80 S1024 and its cross, D160 S256 and
the mid-block's S64; SDXL's D64 S4096 N10, S1024 N20 and cross Sk77), every
build's dq and dk / dv are held against the plain backward
(`attention._flash_bwd_reference`, TF32 off) under chip_smoke.py's
`F32_BWD_REL_BOUND` and `f32_bwd_floor`, and against a second run of
themselves bit for bit; then timed in turns (first, others, others
reversed, first, `--rounds` times): the median CUDA-event time of one call,
each call timed alone from an idle card (`ms`), and the median device time
of a call queued behind a device sleep (`device_ms`, chip_smoke.py's
`device_ms`), of dq, of dk / dv and of the two in one call. SDPA's f32
backward on its saved forward is timed beside every row, with the 3xTF32
bounds of dq and dk / dv (chip_smoke.py's `bound`) and the query chunks the
checkout's wrapper picks for dk / dv.

`--t2i-tree DIR` (another checkout, e.g. the parent unpacked with `git
archive`) then times chip_smoke.py phase 8e's SD 1.5 text-to-image LoRA
train step at 512x512 (f32, rank 4) in DIR's package and in this one, each
in a process of its own, in turns (DIR, this, this, DIR), on SD files this
checkout's chip_smoke.py writes once (a `_sd_ckpt_*` directory of the
checkout, deleted after): one warm-up step, the host seconds of each of
`T2I_STEPS` steps (synchronised), then three steps under torch.profiler:
the device time a step by kernel, the f32 backward's kernels, and the wall.

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

ROWS = (  # name, b, sq, sk, n, d: chip_smoke.py's phase-3 f32 backward rows
    ("sd_unet_self_attn_d40_bwd", 1, 4096, 4096, 8, 40),
    ("sd_unet_cross_attn_d40_bwd", 1, 4096, 77, 8, 40),
    ("sd_unet_self_attn_d80_bwd", 1, 1024, 1024, 8, 80),
    ("sd_unet_cross_attn_d80_bwd", 1, 1024, 77, 8, 80),
    ("sd_unet_self_attn_d160_bwd", 1, 256, 256, 8, 160),
    ("sd_unet_mid_attn_d160_bwd", 1, 64, 64, 8, 160),
    ("sdxl_unet_self_attn_d64_bwd", 1, 4096, 4096, 10, 64),
    ("sdxl_unet_self_attn_d64_n20_bwd", 1, 1024, 1024, 20, 64),
    ("sdxl_unet_cross_attn_d64_bwd", 1, 4096, 77, 10, 64),
)


class Build:
    """One library built from a flash_bwd_f32.cu."""

    def __init__(self, name: str, source: Path, out_dir: Path):
        self.name, self.source = name, source
        self.path = out_dir / f"lib_{name}.so"
        self.chunked = "dk_part" in source.read_text()  # the dk / dv entry takes query chunks
        self.log = ""
        self.lib = None

    def compile(self) -> None:
        cmd = build.nvcc_command(build.find_nvcc(), self.source, self.path)
        proc = subprocess.run(cmd, capture_output=True, text=True)
        self.log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {self.name}:\n{self.log}")

    def bind(self) -> None:
        if self.chunked:
            self.lib = build.bind_flash_bwd_f32(self.path)
            return
        self.lib = ctypes.CDLL(str(self.path))
        head = [ctypes.c_int] + [ctypes.c_void_p] * 6
        tail = [ctypes.c_int64] * 4 + [ctypes.c_float, ctypes.POINTER(ctypes.c_int64),
                                       ctypes.c_void_p]
        self.lib.svi_flash_bwd_f32_dq.argtypes = head + [ctypes.c_void_p] + tail
        self.lib.svi_flash_bwd_f32_dkv.argtypes = head + [ctypes.c_void_p] * 2 + tail
        for fn in (self.lib.svi_flash_bwd_f32_dq, self.lib.svi_flash_bwd_f32_dkv):
            fn.restype = ctypes.c_int

    def ptxas(self) -> str:
        return " | ".join(line.strip() for line in self.log.splitlines()
                          if "registers" in line or "spill" in line)

    def dq(self, q4, k4, v4, g4, lse, delta):
        b, sq, n, d = q4.shape
        dq = torch.empty((b, sq, n * d), dtype=torch.float32, device=q4.device)
        err = self.lib.svi_flash_bwd_f32_dq(
            d, *(t.data_ptr() for t in (q4, k4, v4, g4, lse, delta, dq)), b, n, sq,
            k4.shape[1], d ** -0.5, _strides(q4, k4, v4, g4),
            torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"{self.name}: dq launch failed with code {err}")
        return dq

    def dkv(self, q4, k4, v4, g4, lse, delta, chunks: int):
        b, sq, n, d = q4.shape
        sk = k4.shape[1]
        dk, dv = (torch.empty((b, sk, n * d), dtype=torch.float32, device=q4.device)
                  for _ in range(2))
        ptrs = [t.data_ptr() for t in (q4, k4, v4, g4, lse, delta, dk, dv)]
        if self.chunked:
            parts = [torch.empty((chunks, b, sk, n * d), dtype=torch.float32, device=q4.device)
                     for _ in range(2 if chunks > 1 else 0)]
            ptrs += [t.data_ptr() for t in parts] or [None, None]
            ptrs.append(chunks)
        err = self.lib.svi_flash_bwd_f32_dkv(d, *ptrs, b, n, sq, sk, d ** -0.5,
                                             _strides(q4, k4, v4, g4),
                                             torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"{self.name}: dk / dv launch failed with code {err}")
        return dk, dv


def _strides(*views):
    return (ctypes.c_int64 * 12)(*(s for t in views for s in t.stride()[:3]))


def variant_source(spec: str, out_dir: Path) -> tuple:
    """(name, path): a copy of the checkout's csrc/ whose `using NAME = ...;`
    line takes the template arguments of spec = 'NAME=ARGS'."""
    name, args = spec.split("=")
    template = re.sub(r"\d+$", "", name)
    tag = f"{name}_{args.replace(',', '_')}"
    src_dir = out_dir / tag
    shutil.copytree(build.CSRC, src_dir)
    source = src_dir / build.BWD_F32_SOURCE.name
    text, count = re.subn(rf"using {name} = {template}<[^;]*>;",
                          f"using {name} = {template}<{args}>;", source.read_text())
    if count != 1:
        raise ValueError(f"no single `using {name} = ...;` line in {build.BWD_F32_SOURCE}")
    source.write_text(text)
    return tag, source


T2I_STEPS = 10
# run with `python -c SNIPPET FILES STEPS` from the root of a checkout: its
# package's text-to-image train step on chip_smoke.py's written SD files, one
# JSON line
T2I_SNIPPET = """
import json, statistics, sys, time
from pathlib import Path
import torch
sys.path.insert(0, ".")
import chip_smoke as cs
from svi_tpu_torch.models.model_io import ModelManager
from svi_tpu_torch.prompters.sd_prompter import SDPrompter
from svi_tpu_torch.training import text_to_image as t2i
paths, steps = json.loads(Path(sys.argv[1]).read_text()), int(sys.argv[2])
mm = ModelManager(device="cuda")
mm.load_models([paths["sd_unet"], paths["sd_text_encoder"]])
unet, te = mm.fetch_model("sd_unet"), mm.fetch_model("sd_text_encoder")
emb = SDPrompter().encode_prompt(te, cs.SD_PROMPT)
trainer = t2i.T2ILoRATrainer(unet, lora_rank=cs.T2I_RANK, lora_alpha=cs.T2I_ALPHA, seed=0)
lat = torch.randn(cs.T2I_LATENT, generator=torch.Generator(device="cuda").manual_seed(7),
                  device="cuda")
def step():
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.training_step(latents=lat, prompt_emb=emb)
    torch.cuda.synchronize()
    return time.perf_counter() - t0
warm = step()
secs = [step() for _ in range(steps)]
from torch.profiler import ProfilerActivity, profile
with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
    t0 = time.perf_counter()
    for _ in range(3):
        trainer.training_step(latents=lat, prompt_emb=emb)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
kernels = {}
for ev in prof.key_averages():
    dev = getattr(ev, "device_time_total", 0)
    if ev.device_type == torch.autograd.DeviceType.CUDA and dev > 0:
        kernels[ev.key[:90]] = kernels.get(ev.key[:90], 0) + dev / 3e3
bwd = {k: v for k, v in kernels.items() if "flash_bwd_f32" in k or "sum_chunks" in k}
print(json.dumps(dict(warmup_s=warm, step_s=secs, median_s=statistics.median(secs),
                      profiled_wall_ms=1e3 * wall / 3, device_ms=sum(kernels.values()),
                      f32_bwd_ms=sum(bwd.values()), f32_bwd_kernels=bwd)), flush=True)
"""


def t2i_steps(tree: Path, files: Path) -> dict:
    proc = subprocess.run([sys.executable, "-c", T2I_SNIPPET, str(files), str(T2I_STEPS)],
                          cwd=tree, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"the train step in {tree} failed:\n{proc.stderr[-3000:]}")
    return json.loads([line for line in proc.stdout.splitlines() if line.startswith("{")][-1])


def compare_t2i(tree: Path, card: str) -> None:
    import chip_smoke as yardstick

    here = Path(__file__).resolve().parents[2]
    root = Path(tempfile.mkdtemp(prefix="_sd_ckpt_t2i_", dir=here))
    try:
        files = root / "paths.json"
        files.write_text(json.dumps(yardstick.write_sd_checkpoints(root, card)))
        torch.cuda.empty_cache()
        for t in (tree, here, here, tree):
            print(f"[t2i] {json.dumps(dict(tree=str(t), card=card, **t2i_steps(t, files)))}",
                  flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def event_ms(fn) -> float:
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def main(argv=None) -> int:
    import chip_smoke as yardstick  # the bounds, the floor and the peak rates of phase 3

    from ..ops import attention as A

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", action="append", default=[], type=Path,
                    help="another flash_bwd_f32.cu (repeatable)")
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME=ARGS: a build whose `using NAME` line takes ARGS (repeatable)")
    ap.add_argument("--rows", default=",".join(r[0] for r in ROWS))
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--t2i-tree", type=Path, default=None,
                    help="another checkout whose text-to-image train step is timed beside "
                         "this one's")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain backward in f32
    card = yardstick.nvidia_smi_line()
    print(f"[env] {card}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    out_dir = Path(tempfile.mkdtemp(prefix="compare_bwd_f32_"))
    builds = [Build("checkout", build.BWD_F32_SOURCE, out_dir)]
    builds += [Build(*variant_source(spec, out_dir), out_dir) for spec in args.variant]
    builds += [Build(f"other{i}", src, out_dir) for i, src in enumerate(args.other)]
    with ThreadPoolExecutor(max_workers=len(builds)) as pool:
        list(pool.map(Build.compile, builds))
    for bd in builds:
        bd.bind()
        print(f"[build] {bd.name} ({bd.source}, query chunks {bd.chunked}): ptxas: "
              f"{bd.ptxas()}", flush=True)

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(0)
    wanted = set(args.rows.split(","))
    for name, b, sq, sk, n, d in (r for r in ROWS if r[0] in wanted):
        q, g = (torch.randn((b, sq, n * d), generator=gen, device="cuda") for _ in range(2))
        k, v = (torch.randn((b, sk, n * d), generator=gen, device="cuda") for _ in range(2))
        q4, k4, v4, g4 = (t.unflatten(-1, (n, d)) for t in (q, k, v, g))
        out, lse = A.flash_fwd_bnsd(*(t.transpose(1, 2) for t in (q4, k4, v4)))
        out4 = out.transpose(1, 2)
        delta = torch.einsum("bsnd,bsnd->bns", g4, out4).contiguous()
        chunks = A._f32_dkv_chunks(b, n, sq, sk, sms)
        ref = A._flash_bwd_reference(q4, k4, v4, out4, lse, g4, None, None, sk, d ** -0.5)
        ref = [t.flatten(2) for t in ref]
        floor = yardstick.f32_bwd_floor(q, k, v, g, n, d, d ** -0.5)
        bounds = [max(yardstick.F32_BWD_REL_BOUND * r.abs().max().item(), floor) for r in ref]
        ins = (q4, k4, v4, g4, lse, delta)
        for bd in builds:
            got = [bd.dq(*ins), *bd.dkv(*ins, chunks)]
            again = [bd.dq(*ins), *bd.dkv(*ins, chunks)]
            torch.cuda.synchronize()
            errs = [(x - r).abs().max().item() for x, r in zip(got, ref)]
            same = all(torch.equal(x, y) for x, y in zip(got, again))
            ok = all(e <= bnd for e, bnd in zip(errs, bounds)) and all(
                torch.isfinite(x).all().item() for x in got)
            print(f"[check] {name} {bd.name}: dq / dk / dv err "
                  + " / ".join(f"{e:.3e}" for e in errs) + ", bounds "
                  + " / ".join(f"{x:.3e}" for x in bounds)
                  + f", bit-equal to a second run: {same}, ok {ok}", flush=True)
            if not ok:
                raise RuntimeError(f"{name}: {bd.name} disagrees with the plain backward")
        del ref, got, again

        calls = {}
        for bd in builds:
            calls[f"{bd.name}/dq"] = lambda bd=bd: bd.dq(*ins)
            calls[f"{bd.name}/dkv"] = lambda bd=bd: bd.dkv(*ins, chunks)
            calls[f"{bd.name}/both"] = lambda bd=bd: (bd.dq(*ins), bd.dkv(*ins, chunks))
        leaves = [t.transpose(1, 2).detach().requires_grad_() for t in (q4, k4, v4)]
        o_lib = torch.nn.functional.scaled_dot_product_attention(*leaves)
        gh = g4.transpose(1, 2)
        calls["sdpa/bwd"] = lambda: torch.autograd.grad(o_lib, leaves, gh, retain_graph=True)
        times = {key: [] for key in calls}
        order = list(calls)
        for fn in calls.values():  # warm-up
            fn()
        first, rest = order[:3], order[3:]
        for _ in range(args.rounds):
            for key in first + rest + rest[::-1] + first:
                times[key].append(event_ms(calls[key]))
        dev = {key: statistics.median(yardstick.device_ms(fn) for _ in range(args.rounds))
               for key, fn in calls.items()}
        mm = 2 * b * n * sq * sk * d
        io = 4 * (2 * b * sq * n * d + 2 * b * sk * n * d + b * sq * n * d) + 4 * b * n * sq
        bq = yardstick.bound(3 * mm, io + 4 * b * sq * n * d, yardstick.F32_ACCURATE)
        bkv = yardstick.bound(4 * mm, io + 8 * b * sk * n * d, yardstick.F32_ACCURATE)
        row = dict(row=name, shape=[b, sq, sk, n, d], card=card, dkv_chunks=chunks,
                   bound_ms=dict(dq=bq[0], dkv=bkv[0]), bound_by=dict(dq=bq[1], dkv=bkv[1]),
                   ms={key: statistics.median(t) for key, t in times.items()},
                   device_ms=dev, calls_ms=times)
        print(f"[time] {json.dumps(row)}", flush=True)
        del q, k, v, g, q4, k4, v4, g4, out, lse, calls, leaves, o_lib
        torch.cuda.empty_cache()
    if args.t2i_tree is not None:
        compare_t2i(args.t2i_tree.resolve(), card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
