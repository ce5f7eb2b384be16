#!/usr/bin/env python3
"""Smoke run of the PyTorch port (svi_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing what it found; any failure ends the run with a
non-zero exit and no result line:
  1. environment: capability probe, nvidia-smi name and power limit, TF32 choice;
  2. build: nvcc builds every kernel source of svi_tpu_torch/csrc, all at once;
  3. each kernel against its plain PyTorch version at the main paths' shapes
     (max abs error with its bound, median CUDA-event times of the kernel, the
     plain version and the one PyTorch call that computes the same function,
     and the least time the card could take for the work);
  4. the SVI-Shot slice: (a) a tiny pipeline on the card against the same
     pipeline on the CPU, then (b) two clips at the full width of
     Wan2.1-I2V-14B-480P with seeded random weights: 480x832, 9 frames,
     4 steps, CFG 5, motion-frame recycling, TeaCache on clip 2;
  5. the Error-Recycling LoRA training slice: (a) a tiny bf16 trainer on the
     card against the same trainer on the CPU, then (b) 4 training steps of
     rank-128 LoRA on Wan2.1-I2V-14B at full width, 21 frames at 480x832,
     on a batch made by the port's own frozen encoders;
  6. a JSON line of the kernels, the nvidia-smi line, and the result line.
Needs one CUDA card and nvcc; exits non-zero without them.
"""

from __future__ import annotations

import copy
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent

# Tolerances of the kernels against their plain versions, with the reason for each.
# bf16 forward: the kernel rounds P to bf16 for P.V (the plain version keeps
# f32) and both round out to bf16, about 2 bf16 ulps at |out| <= 1.
BF16_OUT_BOUND = 2e-2
# lse comes from f32 scores of the same bf16 inputs in both: order of f32 sums.
BF16_LSE_BOUND = 1e-3
# f32 inputs: the kernel is plain f32 FMA and the plain version runs with TF32
# off, so only the order of f32 sums differs.
F32_BOUND = 1e-4
# bf16 backward, as a share of the gradient's largest magnitude: the kernels
# round P and dS to bf16 before the products that consume them and each
# gradient once to bf16 (2^-8 relative); K4 sums dq with f32 atomics in an
# order that changes from run to run.
BF16_GRAD_REL_BOUND = 2e-2

# The card's published peaks (H100 SXM, dense): bf16 tensor cores, f32 on
# CUDA cores, HBM bandwidth. The f32 kernel path is scalar FMA.
PEAK_BF16, PEAK_F32, HBM_BYTES_PER_S = 989e12, 67e12, 3.35e12

SLICE_H, SLICE_W, SLICE_FRAMES, SLICE_STEPS, MOTION = 480, 832, 9, 4, 1
# training: 21 frames -> 6 latent frames -> 6 x 30 x 52 = 9360 tokens (K4's gate)
TRAIN_FRAMES, TRAIN_STEPS = 21, 4

KERNELS = {  # entry -> (source, the TPU kernel it replaces)
    "flash_fwd_flat": ("svi_tpu_torch/csrc/flash_fwd.cu", "svi_tpu/ops/attention.py:75"),
    "flash_fwd_bnsd": ("svi_tpu_torch/csrc/flash_fwd.cu", "svi_tpu/ops/attention.py:465"),
    "flash_bwd_onepass": ("svi_tpu_torch/csrc/flash_bwd.cu", "svi_tpu/ops/attention.py:721"),
    "flash_bwd_dq": ("svi_tpu_torch/csrc/flash_bwd.cu", "svi_tpu/ops/attention.py:585"),
    "flash_bwd_dkv": ("svi_tpu_torch/csrc/flash_bwd.cu", "svi_tpu/ops/attention.py:646"),
}
# the case whose times stand for each kernel in the JSON line: the shape the
# kernel's main path gives it
TIMED_CASE = {"flash_fwd_flat": "dit_self_attn_rope", "flash_fwd_bnsd": "clip_vit_h",
              "flash_bwd_onepass": "dit_self_attn_bwd_onepass",
              "flash_bwd_dq": "dit_text_cross_attn_bwd",
              "flash_bwd_dkv": "dit_text_cross_attn_bwd"}


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, reps: int) -> float:
    """Median CUDA-event time of fn() after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(flops: float, nbytes: float, peak: float) -> tuple[float, str]:
    """The least time the card could take (ms), and what bounds it."""
    t_ops, t_bytes = flops / peak, nbytes / HBM_BYTES_PER_S
    return (1e3 * t_ops, "operations") if t_ops >= t_bytes else (1e3 * t_bytes, "bytes")


def launch_counters():
    from svi_tpu_torch.ops import attention as A

    return {name: getattr(A, name) for name in KERNELS}


def zero_counts() -> None:
    for fn in launch_counters().values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in launch_counters().items()}


# ---------------------------------------------------------------------------
# phase 3: kernels against plain
# ---------------------------------------------------------------------------


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def kernel_cases():
    """Yields one dict per case: name, the kernel entries it times, `run`
    (returns {entry: max abs err} and the bound of each), the timed callables,
    and the work (FLOP and bytes per entry) for the bound."""
    import torch.nn.functional as F

    from svi_tpu_torch.ops import attention as A
    from svi_tpu_torch.ops.rope import rope_angles_for_grid

    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    def tables(grid, d):
        cos, sin = rope_angles_for_grid(grid, d)
        return torch.from_numpy(cos).cuda(), torch.from_numpy(sin).cuda()

    def heads_first(t, n, d, cos=None, sin=None):
        """(B, S, N*D) -> (B, N, S, D) for SDPA; rotated when tables are given
        (SDPA has no fused RoPE, so its q and k are rotated beforehand)."""
        t4 = t.unflatten(-1, (n, d))
        if cos is not None:
            t4 = A._apply_rope_reference(t4, cos[:t.shape[1]], sin[:t.shape[1]])
        return t4.transpose(1, 2)

    def err(x, ref):
        if not torch.isfinite(x).all():
            raise RuntimeError(f"a kernel output of shape {tuple(x.shape)} is not finite")
        return (x.float() - ref.float()).abs().max().item()

    def worst(*pairs):
        """The (max abs error, bound) pair that comes nearest its bound."""
        return max(pairs, key=lambda p: p[0] / p[1])

    def fwd_case(name, b, sq, sk, n, d, grid=None, kv_len=None):
        q = randn((b, sq, n * d), torch.bfloat16)
        k = randn((b, sk, n * d), torch.bfloat16)
        v = randn((b, sk, n * d), torch.bfloat16)
        cos, sin = tables(grid, d) if grid else (None, None)
        kv = sk if kv_len is None else kv_len
        qh, kh, vh = (heads_first(t, n, d, cos, sin) for t in (q, k, v))
        mask = None if kv == sk else (torch.arange(sk, device="cuda") < kv)[None, None, None]

        def kernel():
            return A.flash_fwd_flat(q, k, v, d, cos=cos, sin=sin, kv_len=kv)

        def plain():
            out, lse = A._flash_fwd_reference(*(t.unflatten(-1, (n, d)) for t in (q, k, v)),
                                              cos, sin, kv, d ** -0.5)
            return out.flatten(2), lse

        def run():
            (out, lse), (ref_out, ref_lse) = kernel(), plain()
            return {"flash_fwd_flat": worst((err(out, ref_out), BF16_OUT_BOUND),
                                            (err(lse, ref_lse), BF16_LSE_BOUND))}

        return dict(case=name, shape=[b, sq, sk, n, d], dtype="bfloat16", run=run,
                    kernels={"flash_fwd_flat": kernel}, plain=plain,
                    library=lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask),
                    work={"flash_fwd_flat": (4 * b * n * sq * kv * d,
                                             _nbytes(q, k, v, q) + 4 * b * n * sq, PEAK_BF16)})

    def bwd_case(name, b, sq, sk, n, d, grid=None):
        """One backward at the route the autograd function picks for it."""
        q = randn((b, sq, n * d), torch.bfloat16)
        k = randn((b, sk, n * d), torch.bfloat16)
        v = randn((b, sk, n * d), torch.bfloat16)
        g = randn((b, sq, n * d), torch.bfloat16)
        cos, sin = tables(grid, d) if grid else (None, None)
        out, lse = A.flash_fwd_flat(q, k, v, d, cos=cos, sin=sin)
        route = A._bwd_route(n, d, sq, sk, sk)
        args = (q, k, v, out, lse, g, d)
        rope = dict(cos=cos, sin=sin)
        if route == "onepass":
            kernels = {"flash_bwd_onepass": lambda: A.flash_bwd_onepass(*args, **rope)}
        else:
            kernels = {"flash_bwd_dq": lambda: A.flash_bwd_dq(*args, **rope),
                       "flash_bwd_dkv": lambda: A.flash_bwd_dkv(*args, **rope)}

        def plain():
            views = [t.unflatten(-1, (n, d)) for t in (q, k, v, out)]
            return [t.flatten(2) for t in A._flash_bwd_reference(
                *views, lse, g.unflatten(-1, (n, d)), cos, sin, sk, d ** -0.5)]

        def run():
            ref = plain()
            got = {}
            if route == "onepass":
                got["flash_bwd_onepass"] = kernels["flash_bwd_onepass"]()
                pairs = {"flash_bwd_onepass": (0, 1, 2)}
            else:
                got["flash_bwd_dq"] = (kernels["flash_bwd_dq"](),)
                got["flash_bwd_dkv"] = kernels["flash_bwd_dkv"]()
                pairs = {"flash_bwd_dq": (0,), "flash_bwd_dkv": (1, 2)}
            res = {}
            for entry, idx in pairs.items():
                res[entry] = worst(*((err(x, ref[i]),
                                      BF16_GRAD_REL_BOUND * ref[i].float().abs().max().item())
                                     for x, i in zip(got[entry], idx)))
            return res

        leaves = [heads_first(q, n, d, cos, sin).detach().requires_grad_(),
                  heads_first(k, n, d, cos, sin).detach().requires_grad_(),
                  heads_first(v, n, d).detach().requires_grad_()]
        gh = heads_first(g, n, d)

        def library():
            o = F.scaled_dot_product_attention(*leaves)
            return torch.autograd.grad(o, leaves, gh)

        mm = 2 * b * n * sq * sk * d  # one matrix product of the backward
        io = _nbytes(q, k, v, out, g) + 4 * b * n * sq  # inputs (lse f32)
        work = {"flash_bwd_onepass": (5 * mm, io + _nbytes(q, k, v), PEAK_BF16),
                "flash_bwd_dq": (3 * mm, io + _nbytes(q), PEAK_BF16),
                "flash_bwd_dkv": (4 * mm, io + _nbytes(k, v), PEAK_BF16)}
        return dict(case=name, shape=[b, sq, sk, n, d], dtype="bfloat16", run=run,
                    kernels=kernels, plain=plain, library=library,
                    work={e: work[e] for e in kernels})

    # the 14B DiT at 480x832x81: 21 x 30 x 52 = 32760 tokens, 40 heads of 128
    yield fwd_case("dit_self_attn_rope", 1, 32760, 32760, 40, 128, grid=(21, 30, 52))
    yield fwd_case("dit_text_cross_attn", 1, 32760, 512, 40, 128)
    yield fwd_case("dit_image_cross_attn", 1, 32760, 257, 40, 128)
    # the inference slice's own clip (3 x 30 x 52 tokens, CFG batch 2) with a masked tail
    yield fwd_case("masked_kv_len", 2, 4680, 4680, 40, 128, grid=(3, 30, 52), kv_len=4100)
    # the training slice's self-attention forward (21 frames: 6 x 30 x 52 tokens)
    yield fwd_case("dit_self_attn_rope_21f", 1, 9360, 9360, 40, 128, grid=(6, 30, 52))

    # CLIP ViT-H/14: 257 tokens, 16 heads of 80, f32, through the (B, N, S, D) entry
    q, k, v = (randn((1, 16, 257, 80), torch.float32) for _ in range(3))

    def clip_plain():
        out, lse = A._flash_fwd_reference(q.transpose(1, 2), k.transpose(1, 2),
                                          v.transpose(1, 2), None, None, 257, 80 ** -0.5)
        return out.transpose(1, 2), lse

    def clip_run():
        (out, lse), (ro, rl) = A.flash_fwd_bnsd(q, k, v), clip_plain()
        return {"flash_fwd_bnsd": worst((err(out, ro), F32_BOUND), (err(lse, rl), F32_BOUND))}

    yield dict(case="clip_vit_h", shape=[1, 257, 257, 16, 80], dtype="float32", run=clip_run,
               kernels={"flash_fwd_bnsd": lambda: A.flash_fwd_bnsd(q, k, v)}, plain=clip_plain,
               library=lambda: F.scaled_dot_product_attention(q, k, v),
               work={"flash_fwd_bnsd": (4 * 16 * 257 * 257 * 80,
                                        _nbytes(q, k, v, q) + 4 * 16 * 257, PEAK_F32)})

    # VAE mid-block at 480x832: 60 x 104 = 6240 tokens, one head of 384, f32,
    # q/k/v as column slices of one qkv tensor as the VAE hands them over
    qkv = randn((2, 6240, 3 * 384), torch.float32)
    vq, vk, vv = qkv[..., :384], qkv[..., 384:768], qkv[..., 768:]

    def vae_plain():
        out, lse = A._flash_fwd_reference(*(t[:, :, None] for t in (vq, vk, vv)), None, None,
                                          6240, 384 ** -0.5)
        return out.flatten(2), lse

    def vae_run():
        (out, lse), (ro, rl) = A.flash_fwd_flat(vq, vk, vv, 384), vae_plain()
        return {"flash_fwd_flat": worst((err(out, ro), F32_BOUND), (err(lse, rl), F32_BOUND))}

    yield dict(case="vae_mid_attn", shape=[2, 6240, 6240, 1, 384], dtype="float32", run=vae_run,
               kernels={"flash_fwd_flat": lambda: A.flash_fwd_flat(vq, vk, vv, 384)},
               plain=vae_plain,
               library=lambda: F.scaled_dot_product_attention(
                   *(t[:, None] for t in (vq, vk, vv))),
               work={"flash_fwd_flat": (4 * 2 * 6240 * 6240 * 384,
                                        _nbytes(vq, vk, vv, vq) + 4 * 2 * 6240, PEAK_F32)})

    # backward: the training slice's self-attention (21 frames, 6 x 30 x 52
    # tokens) through K4, the same at 81 frames, and K5 for cross-attention
    # and for a self-attention too short for K4 (one latent frame)
    yield bwd_case("dit_self_attn_bwd_onepass", 1, 9360, 9360, 40, 128, grid=(6, 30, 52))
    yield bwd_case("dit_self_attn_bwd_onepass_81f", 1, 32760, 32760, 40, 128, grid=(21, 30, 52))
    yield bwd_case("dit_text_cross_attn_bwd", 1, 9360, 512, 40, 128)
    yield bwd_case("dit_image_cross_attn_bwd", 1, 9360, 257, 40, 128)
    yield bwd_case("short_self_attn_bwd_split_rope", 1, 1560, 1560, 40, 128, grid=(1, 30, 52))


def phase_kernels(card: str):
    """Every case's kernels against the plain version; one row per (case, kernel)."""
    rows = []
    for case in kernel_cases():
        results = case["run"]()
        torch.cuda.synchronize()
        plain_ms = median_ms(case["plain"], 2)
        library_ms = median_ms(case["library"], 5)
        for entry, kernel in case["kernels"].items():
            max_err, err_bound = results[entry]
            flops, nbytes, peak = case["work"][entry]
            bound_ms, bound_by = bound(flops, nbytes, peak)
            ms = median_ms(kernel, 5)
            row = dict(case=case["case"], entry=entry, shape_b_sq_sk_n_d=case["shape"],
                       dtype=case["dtype"], max_abs_err=max_err, err_bound=err_bound, ms=ms,
                       plain_ms=plain_ms, library_ms=library_ms, flops=flops, bytes=nbytes,
                       bound_ms=bound_ms, bound_by=bound_by, tflops=flops / ms / 1e9,
                       card=card, ok=max_err <= err_bound)
            log(f"[kernel] {json.dumps(row)}")
            if not row["ok"]:
                raise RuntimeError(f"{case['case']}: {entry} disagrees with the plain version")
            rows.append(row)
        del case
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# phase 4: the inference slice
# ---------------------------------------------------------------------------


def tiny_pipeline(device):
    from svi_tpu_torch.models import clip_vision, wan_dit, wan_vae
    from svi_tpu_torch.pipelines.svi_video import SVIVideoPipeline

    pipe = SVIVideoPipeline(device=device, torch_dtype=torch.float32)
    pipe.vae = wan_vae.init_params(wan_vae.WanVAEConfig(dim=16, z_dim=4), seed=1,
                                   device="cpu").to(device)
    pipe.dit = wan_dit.init_params(wan_dit.WanDiTConfig(
        dim=64, in_dim=12, ffn_dim=128, out_dim=4, text_dim=48, freq_dim=32, num_heads=2,
        num_layers=2, has_image_input=True, clip_feature_dim=64, dtype=torch.float32),
        seed=2, device="cpu").to(device)
    pipe.image_encoder = clip_vision.init_params(clip_vision.ClipVisionConfig(
        image_size=28, patch_size=14, dim=64, mlp_ratio=2, num_heads=2, num_layers=2),
        seed=3, device="cpu").to(device)
    return pipe


def phase_small_reference():
    """The port on the card against the same port on the CPU (plain attention)."""
    from svi_tpu_torch.ops import attention as A

    rng = np.random.default_rng(0)
    img = rng.integers(0, 255, (64, 64, 3), dtype=np.uint8)
    ctx = rng.standard_normal((1, 12, 48)).astype(np.float32)
    kw = dict(input_image=img, random_ref_frame=img, seed=0, height=64, width=64, num_frames=9,
              cfg_scale=5.0, num_inference_steps=3, prompt_emb_posi=ctx,
              prompt_emb_nega=ctx * 0.5, ref_pad_num=-1, return_latents=True)
    launches = A.flash_fwd_flat.launches + A.flash_fwd_bnsd.launches
    frames_gpu, lat_gpu = tiny_pipeline("cuda")(**kw)
    used = A.flash_fwd_flat.launches + A.flash_fwd_bnsd.launches - launches
    frames_cpu, lat_cpu = tiny_pipeline("cpu")(**kw)
    lat_err = (lat_gpu.cpu() - lat_cpu).abs().max().item()
    px_err = int(np.abs(np.stack(frames_gpu).astype(int) - np.stack(frames_cpu).astype(int)).max())
    # f32 through 3 steps of a 2-layer DiT, the VAE and CLIP with TF32 off:
    # only the order of f32 sums differs between card and CPU
    ok = lat_err <= 1e-3 and px_err <= 2 and used > 0
    log(f"[small] card vs CPU on a tiny f32 pipeline: latents max abs err {lat_err:.3e} "
        f"(bound 1e-3), frames max diff {px_err} levels (bound 2), kernel launches {used}")
    if not ok:
        raise RuntimeError("the port on the card disagrees with the port on the CPU")


class PhaseTimer:
    """Wraps a callable: synchronize, time it on the host clock, synchronize."""

    def __init__(self):
        self.seconds: dict[str, list[float]] = {}

    def wrap(self, name, fn):
        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            self.seconds.setdefault(name, []).append(time.perf_counter() - t0)
            return out
        return timed


def prompt_context(seed: int, lengths: list[int], timer: PhaseTimer | None = None):
    """umT5-XXL states of seeded token ids (the tokenizer is not in the
    repository), one row per prompt length; the encoder is freed afterwards."""
    from svi_tpu_torch.models import t5

    t0 = time.perf_counter()
    text = t5.init_params(t5.UMT5_XXL, seed=seed, device="cuda")
    log(f"[t5] init {time.perf_counter() - t0:.2f}s, "
        f"{sum(p.numel() for p in text.parameters()) / 1e9:.2f}B params")
    g = torch.Generator().manual_seed(0)
    ids = torch.randint(0, t5.UMT5_XXL.vocab, (len(lengths), 512), generator=g)
    mask = torch.zeros(len(lengths), 512, dtype=torch.int64)
    for i, n in enumerate(lengths):
        mask[i, :n] = 1
    encode = text.encode_prompt_states if timer is None else timer.wrap(
        "t5", text.encode_prompt_states)
    with torch.inference_mode():
        ctx = encode(ids.cuda(), mask.cuda()).clone()
    del text
    torch.cuda.empty_cache()
    return ctx


def phase_slice():
    """Two clips through the port's pipeline at the full width of
    Wan2.1-I2V-14B-480P, with umT5-XXL, CLIP ViT-H/14 and the Wan VAE."""
    from svi_tpu_torch.models import clip_vision, wan_dit, wan_vae
    from svi_tpu_torch.pipelines.svi_video import SVIVideoPipeline

    timer = PhaseTimer()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    ctx = prompt_context(11, [37, 12], timer)  # positive, negative prompt
    ctx_pos, ctx_neg = ctx[:1].clone(), ctx[1:].clone()
    del ctx

    t0 = time.perf_counter()
    pipe = SVIVideoPipeline(device="cuda", torch_dtype=torch.bfloat16)
    pipe.dit = wan_dit.init_params(wan_dit.WAN_14B_I2V, seed=12, device="cuda")
    pipe.vae = wan_vae.init_params(wan_vae.WAN_VAE, seed=13, device="cuda")
    pipe.image_encoder = clip_vision.init_params(clip_vision.VIT_H_14, seed=14, device="cuda")
    n_dit = sum(p.numel() for p in pipe.dit.parameters())
    log(f"[slice] DiT {wan_dit.WAN_14B_I2V} with {n_dit / 1e9:.2f}B params, VAE and CLIP: init "
        f"{time.perf_counter() - t0:.2f}s")

    pipe.image_encoder.encode_image = timer.wrap("clip", pipe.image_encoder.encode_image)
    pipe.vae.encode = timer.wrap("vae_encode", pipe.vae.encode)
    pipe.vae.decode = timer.wrap("vae_decode", pipe.vae.decode)
    sample = pipe._sample

    def timed_sample(latents, ctx_pos, ctx_neg, image_emb, cfg_scale, tea_cache=None):
        name = "denoise" if tea_cache is None else "denoise_teacache"
        return timer.wrap(name, sample)(latents, ctx_pos, ctx_neg, image_emb, cfg_scale,
                                        tea_cache)

    pipe._sample = timed_sample

    rng = np.random.default_rng(0)
    first = rng.integers(0, 255, (SLICE_H, SLICE_W, 3), dtype=np.uint8)
    anchor = rng.integers(0, 255, (SLICE_H, SLICE_W, 3), dtype=np.uint8)

    # the main path's run: counters from zero, read right after
    zero_counts()
    motion, all_frames, skipped = first, [], 0
    t_run = time.perf_counter()
    for clip in range(2):
        t0 = time.perf_counter()
        frames, latents = pipe(
            input_image=motion, random_ref_frame=anchor, seed=clip,
            height=SLICE_H, width=SLICE_W, num_frames=SLICE_FRAMES, cfg_scale=5.0,
            num_inference_steps=SLICE_STEPS, tiled=False,
            prompt_emb_posi=ctx_pos, prompt_emb_nega=ctx_neg, ref_pad_num=-1,
            tea_cache_l1_thresh=0.3 if clip == 1 else None,
            tea_cache_model_id="Wan2.1-I2V-14B-480P", return_latents=True,
        )
        if not torch.isfinite(latents).all():
            raise RuntimeError(f"clip {clip + 1}: latents are not finite")
        if len(frames) != SLICE_FRAMES:
            raise RuntimeError(f"clip {clip + 1}: {len(frames)} frames, expected {SLICE_FRAMES}")
        if clip == 1:
            skipped = pipe.last_tea_cache.skipped_steps
        all_frames += frames if clip == 0 else frames[MOTION:]
        motion = frames[-MOTION:]
        log(f"[slice] clip {clip + 1}: {len(frames)} frames in {time.perf_counter() - t0:.2f}s")
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t_run
    launches = read_counts()

    video = np.stack(all_frames)
    expect = (SLICE_FRAMES + SLICE_FRAMES - MOTION, SLICE_H, SLICE_W, 3)
    if video.shape != expect or video.dtype != np.uint8:
        raise RuntimeError(f"video {video.shape} {video.dtype}, expected {expect} uint8")
    std = float(video.astype(np.float32).std())
    if not std > 1.0:
        raise RuntimeError(f"pixel std {std} <= 1.0")
    if min(launches["flash_fwd_flat"], launches["flash_fwd_bnsd"]) <= 0:
        raise RuntimeError(f"a kernel was not launched on the main path: {launches}")
    secs = timer.seconds
    per_step = secs["denoise"][0] / SLICE_STEPS
    log(f"[slice] seconds: t5 {secs['t5'][0]:.3f}, clip {secs['clip']}, vae_encode "
        f"{secs['vae_encode']}, denoise step (no TeaCache) {per_step:.3f}, clip-2 denoise "
        f"with TeaCache {secs['denoise_teacache'][0]:.3f} for {SLICE_STEPS} steps, "
        f"vae_decode {secs['vae_decode']}")
    log(f"[slice] two clips {run_s:.2f}s, {video.shape[0]} frames, pixel std {std:.2f}, "
        f"TeaCache skipped {skipped} of {SLICE_STEPS} steps in clip 2, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, launches {launches}")
    return launches


# ---------------------------------------------------------------------------
# phase 5: the training slice
# ---------------------------------------------------------------------------


def _lora_deltas(lora, start):
    return [(p.detach().float().cpu() - p0).flatten() for p, p0 in zip(lora.parameters(), start)]


def phase_small_trainer():
    """A tiny bf16 trainer on the card against the same trainer on the CPU,
    3 steps on one batch. One head of 128 and 4 x 32 x 32 = 4096 tokens, so
    the card's self-attention backward takes K4 and its cross-attention
    (257 image and 512 text tokens) K5a + K5b; the CPU takes the plain
    backward."""
    from svi_tpu_torch.models import wan_dit
    from svi_tpu_torch.training import ErrorRecyclingTrainer, TrainerConfig
    from svi_tpu_torch.training import lora as lora_mod

    cfg = wan_dit.WanDiTConfig(dim=128, in_dim=36, ffn_dim=256, out_dim=16, text_dim=64,
                               freq_dim=32, num_heads=1, num_layers=2, has_image_input=True,
                               clip_feature_dim=64, dtype=torch.bfloat16)
    tcfg = TrainerConfig(lora_rank=16, lora_alpha=16.0, buffer_warmup_iter=2,
                         error_buffer_k=8, num_grids=10, seed=0)
    base = wan_dit.init_params(cfg, seed=31, device="cpu")
    lora = lora_mod.init_lora_params(cfg, rank=16, generator=torch.Generator().manual_seed(32),
                                     device="cpu")
    with torch.no_grad():  # non-zero B, so that step 1 moves A as well
        g = torch.Generator().manual_seed(33)
        for name, p in lora.named_parameters():
            if name.endswith(".b"):
                p.copy_(torch.randn(p.shape, generator=g) * 0.02)
    start = [p.detach().float().clone() for p in lora.parameters()]
    rng = np.random.default_rng(0)
    lat = rng.standard_normal((1, 16, 4, 64, 64)).astype(np.float32)
    ctx = rng.standard_normal((1, 512, 64)).astype(np.float32)
    y = rng.standard_normal((1, 20, 4, 64, 64)).astype(np.float32)
    clip = rng.standard_normal((1, 257, 64)).astype(np.float32)

    runs = {}
    for device in ("cuda", "cpu"):
        trainer = ErrorRecyclingTrainer(copy.deepcopy(base).to(device), tcfg, device=device)
        trainer.lora = copy.deepcopy(lora).to(device)
        zero_counts()
        steps = []
        for _ in range(3):
            m = trainer.training_step(lat, ctx, y=y, clip_feature=clip)
            steps.append((m["loss"], m["grad_norm"], _lora_deltas(trainer.lora, start)))
        runs[device] = (steps, read_counts(), trainer.buffers.stats())
    loss_err = norm_err = 0.0
    min_cos = 1.0
    for i, ((lg, ng, dg), (lc, nc, dc)) in enumerate(zip(runs["cuda"][0], runs["cpu"][0])):
        cos = min(float(torch.nn.functional.cosine_similarity(a, b, dim=0))
                  for a, b in zip(dg, dc))
        loss_err = max(loss_err, abs(lg - lc) / abs(lc))
        norm_err = max(norm_err, abs(ng - nc) / abs(nc))
        min_cos = min(min_cos, cos)
        log(f"[train-small] step {i + 1}: loss card {lg:.6f} cpu {lc:.6f}, grad_norm card "
            f"{ng:.6f} cpu {nc:.6f}, min cosine of the LoRA updates {cos:.5f}")
    counts = runs["cuda"][1]
    # bf16 on both sides, rounded at other places (P and dS in the kernels,
    # bf16 matmul outputs in another order): a few tenths of a percent per
    # step in loss and gradient; Adam's first steps move each parameter by
    # about lr * sign(grad), so the update directions agree up to the few
    # components whose gradient is within that noise of zero
    ok = (loss_err <= 2e-2 and norm_err <= 5e-2 and min_cos >= 0.9
          and runs["cuda"][2] == runs["cpu"][2]
          and min(counts[k] for k in ("flash_fwd_flat", "flash_bwd_onepass", "flash_bwd_dq",
                                      "flash_bwd_dkv")) > 0)
    log(f"[train-small] card vs CPU, 3 steps: loss rel err {loss_err:.2e} (bound 2e-2), "
        f"grad_norm rel err {norm_err:.2e} (bound 5e-2), min cosine {min_cos:.5f} "
        f"(bound 0.9), buffers {runs['cuda'][2]} vs {runs['cpu'][2]}, card launches {counts}")
    if not ok:
        raise RuntimeError("the trainer on the card disagrees with the trainer on the CPU")


def phase_training():
    """Four Error-Recycling LoRA steps on Wan2.1-I2V-14B at full width (seeded
    random weights), rank 128 on q, k, v, o, ffn.0, ffn.2, per-block
    checkpointing, batch 1 of 21 frames at 480x832 (9360 tokens). The batch
    is made as scripts/train_svi.py makes it: umT5-XXL on seeded ids, the VAE
    encode of seeded frames, and encode_images_adaptive for y and the CLIP
    features."""
    from svi_tpu_torch.models import clip_vision, wan_dit, wan_vae
    from svi_tpu_torch.pipelines.svi_video import SVIVideoPipeline
    from svi_tpu_torch.training import ErrorRecyclingTrainer, TrainerConfig
    from svi_tpu_torch.training import lora as lora_mod

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    # the training path's run: counters from zero, read right after
    zero_counts()
    t0 = time.perf_counter()
    ctx = prompt_context(21, [29])
    rng = np.random.default_rng(1)
    frames = rng.integers(0, 255, (TRAIN_FRAMES, SLICE_H, SLICE_W, 3), dtype=np.uint8)
    ref_frame = rng.integers(0, 255, (SLICE_H, SLICE_W, 3), dtype=np.uint8)
    enc = SVIVideoPipeline(device="cuda", torch_dtype=torch.bfloat16)
    enc.vae = wan_vae.init_params(wan_vae.WAN_VAE, seed=23, device="cuda")
    enc.image_encoder = clip_vision.init_params(clip_vision.VIT_H_14, seed=24, device="cuda")
    with torch.no_grad():
        video = torch.from_numpy(frames).cuda().float().div(127.5).sub(1.0)
        latents = enc.vae.encode(video.permute(3, 0, 1, 2)[None])
        emb = enc.encode_images_adaptive([frames[0]], ref_frame, TRAIN_FRAMES, SLICE_H, SLICE_W,
                                         use_first_aug=False, ref_pad_num=-1)
    batch = {"latents": latents.float().cpu().numpy(), "context": ctx.float().cpu().numpy(),
             "y": emb["y"].float().cpu().numpy(),
             "clip_feature": emb["clip_feature"].float().cpu().numpy()}
    del enc, video, latents, emb, ctx
    torch.cuda.empty_cache()
    encode_s = time.perf_counter() - t0
    log(f"[train] batch from the frozen encoders in {encode_s:.2f}s: "
        + ", ".join(f"{k} {tuple(v.shape)}" for k, v in batch.items()))

    t0 = time.perf_counter()
    dit = wan_dit.init_params(wan_dit.WAN_14B_I2V, seed=22, device="cuda")
    trainer = ErrorRecyclingTrainer(dit, TrainerConfig(lora_rank=128, lora_alpha=128.0,
                                                       use_gradient_checkpointing=True,
                                                       remat_granularity=1, seed=0),
                                    device="cuda")
    n_lora = lora_mod.num_lora_params(trainer.lora)
    b_start = [p.detach().clone() for name, p in trainer.lora.named_parameters()
               if name.endswith(".b")]
    torch.cuda.synchronize()
    log(f"[train] DiT {sum(p.numel() for p in dit.parameters()) / 1e9:.2f}B frozen params, "
        f"LoRA {n_lora / 1e6:.1f}M trainable (f32), init {time.perf_counter() - t0:.2f}s")

    step_s, metrics, totals = [], [], []
    for step in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = trainer.training_step(batch["latents"], batch["context"], y=batch["y"],
                                  clip_feature=batch["clip_feature"])
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        metrics.append(m)
        totals.append(m["buffer_latent_total"] + m["buffer_y_total"])
        log(f"[train] step {step + 1}: {step_s[-1]:.3f}s, loss {m['loss']:.6f}, grad_norm "
            f"{m['grad_norm']:.6f}, timestep {m['timestep']:.2f}, grid {m['grid']}, clean "
            f"{m['used_clean_input']}, buffered errors {totals[-1]}")
        if step == 0:
            b_moved = max((p.detach() - p0).abs().max().item() for p, p0 in zip(
                (p for name, p in trainer.lora.named_parameters() if name.endswith(".b")),
                b_start))
    launches = read_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    finite = all(np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"]) for m in metrics)
    log(f"[train] {TRAIN_STEPS} steps: seconds per step {step_s}, steady {step_s[-1]:.3f}s, "
        f"peak memory {peak_gib:.2f} GiB, LoRA B max move after step 1 {b_moved:.3e}, "
        f"launches {launches}")
    if not finite:
        raise RuntimeError("a training loss or grad_norm is not finite")
    if not b_moved > 0:
        raise RuntimeError("the LoRA B matrices did not move after step 1")
    # every step banks its errors, except a clean-input step that loses the
    # clean_buffer_update_prob draw
    if not (totals[-1] > 0 and all(b >= a for a, b in zip(totals, totals[1:]))):
        raise RuntimeError(f"the error buffers did not grow: {totals}")
    if min(launches.values()) <= 0:
        raise RuntimeError(f"a kernel was not launched on the training path: {launches}")
    del trainer, dit
    torch.cuda.empty_cache()
    return launches, step_s, peak_gib


def main() -> int:
    if not (REPO / "svi_tpu_torch" / "__init__.py").is_file():
        raise SystemExit("chip_smoke.py must run from a checkout of the repository "
                         "(svi_tpu_torch/ not found beside it)")
    sys.path.insert(0, str(REPO))
    import svi_tpu_torch
    from svi_tpu_torch.kernels import build

    # 1. environment
    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is False: this smoke run needs a CUDA card")
    log(f"[env] {json.dumps(svi_tpu_torch.capability_probe())}")
    card = nvidia_smi_line()
    log(f"[env] nvidia-smi: {card}")
    # f32 stays f32: the VAE and CLIP run in f32 for fidelity, and the plain
    # attention versions are the reference for the kernels
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[env] TF32: matmul {torch.backends.cuda.matmul.allow_tf32}, "
        f"cudnn {torch.backends.cudnn.allow_tf32} (both off: f32 math stays f32)")

    # 2. build: one nvcc per source, all started together
    t0 = time.perf_counter()
    for name, res in build.build_all().items():
        ptxas = [line for line in res.log.splitlines() if "registers" in line or "spill" in line]
        log(f"[build] {name} -> {res.path.name} in {res.seconds:.2f}s; ptxas: "
            + " | ".join(ptxas))
    build.load_flash_fwd()
    build.load_flash_bwd()
    log(f"[build] all sources in {time.perf_counter() - t0:.2f}s")

    # 3. kernels against plain
    rows = phase_kernels(card)

    # 4. the inference slice
    phase_small_reference()
    infer_launches = phase_slice()

    # 5. the training slice
    phase_small_trainer()
    train_launches, _, _ = phase_training()

    # 6. results: the forward kernels' launches are the inference path's, the
    # backward kernels' the training path's
    kernels = []
    for entry, (src, replaces) in KERNELS.items():
        mine = [r for r in rows if r["entry"] == entry]
        timed = next(r for r in mine if r["case"] == TIMED_CASE[entry])
        launches = (infer_launches if entry.startswith("flash_fwd") else train_launches)[entry]
        kernels.append({"name": entry, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": launches,
                        "max_abs_err": max(r["max_abs_err"] for r in mine),
                        "ms": timed["ms"], "plain_ms": timed["plain_ms"],
                        "bound_ms": timed["bound_ms"], "bound_by": timed["bound_by"],
                        "library_ms": timed["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
