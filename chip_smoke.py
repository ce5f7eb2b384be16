#!/usr/bin/env python3
"""Smoke run of the PyTorch port (svi_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing what it found; any failure ends the run with a
non-zero exit and no result line:
  1. environment: capability probe, nvidia-smi name and power limit, the TF32
     switches (left at PyTorch's defaults, as users run them);
  2. build: nvcc builds every kernel source of svi_tpu_torch/csrc, all at once
     (the two forwards with many head dims, flash_fwd_f32.cu and
     flash_fwd_sm90.cu, and the f32 backward flash_bwd_f32.cu, one library
     per group of head dims);
  3. each kernel against its plain PyTorch version at the main paths' shapes
     (max abs error with its bound, median CUDA-event times of the kernel, the
     plain version and the one PyTorch call that computes the same function,
     the kernel call's device time without host gaps, and the least time
     the card could take for the work); the W4A8 linear at the 14B's
     shapes bit for bit, beside torch._int_mm alone and the chain it
     replaced (K3, `_int8_exec`, the bias), and the fused straight-through
     input gradient `w4a8_dgrad` (`[w4a8-dgrad]` lines; no path takes it)
     beside the chain the backward runs (K3, the bf16 cast, g * s8, cuBLAS)
     and torch.matmul alone; K5a / K5b and K6 at bf16 D=64 (no path takes
     them); the f32 kernel at the SD 1.5
     stack's shapes (head dims 40, 160 and 512, the UNet's 77-key
     cross-attention, AnimateDiff's 16-frame temporal attention over 4096
     batches) and the SDXL stack's at 1024x1024 (heads of 64 over 4096 and
     1024 tokens, AnimateDiff-SDXL's temporal attention at head dims 40, 80
     and 160 over 16384, 4096 and 1024 batches, the VAE's mid-block over
     16384 tokens), phase 11's (Hunyuan-DiT's 16 heads of 88 in f32, B2
     S4096 self and Sk333 cross; CogVideoX-5B's 48 heads of 64 in bf16, B2
     S17776, route sm90 at D = 64, with a ragged S514 kv_len 500 row and
     the exp2 floor; HunyuanVideo's two attention groups at 720x1280x129,
     bf16 D128), and phase 10's at 1024x1024 (FLUX.1-dev's joint and
     single blocks' attention, B1 S4608, 24 heads of 128, bf16; its
     IP-Adapter's attention of 4096 and 4608 queries onto 128 image tokens;
     SD3-medium's joint attention, B2 S4250, 24 heads of 64, f32; the Kolors
     UNet's cross-attention over ChatGLM's 256 tokens at both levels), and
     phase 8e's f32 backward on the (B, N, S, D) route (K5a's and K5b's
     function, csrc/flash_bwd_f32.cu, 3xTF32 on the tensor cores with dk /
     dv over query chunks where the grid is small: SD 1.5's D40 self S4096
     and cross Sk77, D80 S1024 and its cross, D160 S256 and S64; SDXL's D64
     S4096 N10, S1024 N20 and cross Sk77, each kernel beside SDPA's f32
     backward); the
     sm90 route's other bf16 head dims (csrc/flash_fwd_sm90.cu) at the bf16
     paths' shapes (SD 1.5's D40 self B2 S4096 N8 and its 77-key cross, D80
     S1024, D160 S256, AnimateDiff's D40 temporal attention over 4096
     batches of 16 frames on the packed short-sequence kernel; Hunyuan-DiT's
     D88 B2 S4096 N16 self and Sk333 cross; one head of 512 over 4096 and
     16384 tokens on the column-split kernel; and the other head dims, one
     head of 384 and 8 heads of 32) beside bf16 SDPA; K6
     beside K1 at the same shape
     and the exp2 floor; K6's f32 route (qk8 with f32 v and out, P.V in
     3xTF32) at the slice's shape beside SDPA in f32; for context, the int8
     GEMM of a W4A8 linear (torch._int_mm) against the bf16 one;
  4. the SVI-Shot slice: (a) a tiny pipeline on the card against the same
     pipeline on the CPU, then (b) two clips at the full width of
     Wan2.1-I2V-14B-480P with seeded random weights: 480x832, 9 frames,
     4 steps, CFG 5, motion-frame recycling, TeaCache on clip 2; the TF32
     check (the VAE's encode and decode of clip 1 and a full-width pose
     embedding forward, bit-identical with cuDNN TF32 switched on and off
     for the process); then one forward of that DiT at the production token
     count, 480x832x81 (B2 S32760), timed and profiled; (c) a tiny pipeline
     with int4_w4a8 weights and qk8pv8 attention on the card against the
     same on the CPU; the fidelity gate: a tiny f32 int4_w4a8 + qk8 forward
     (K6's f32 route) card against CPU, then clip_psnr of tiny w8a8 and
     int4_w4a8 + qk8 clips against their bf16 clip, card against CPU; the
     two-speaker audio attention, tiny, card against CPU; (d) quantized
     inference at full
     width: (b)'s DiT quantized in place to int4_w4a8, one DiT forward
     against the bf16 one (each also profiled: device time by kind of
     kernel), then two clips with qk8 and qk8pv8 attention, then one
     W4A8 + qk8 forward at 480x832x81; each fails unless every quantized
     linear went through w4a8_linear (no K3, no torch._int_mm) and every
     int8 attention through the sm90 kernel;
  4e. the driver, the way users start SVI: checkpoint files written here in
     the reference's names and formats (Wan2.1-I2V-14B-480P at full width
     cut to 4 of 40 blocks as two bf16 safetensors shards, umT5-XXL cut to 2
     of 24 layers, CLIP ViT-H/14 and the VAE whole, a rank-128 LoRA, the
     tokenizer, a 480x832 reference image as .npy), then the port's driver
     (svi_tpu_torch.scripts.test_svi.main) on them: two clips untiled, one
     with --tiled (and a tiled encode of its frames, whose latents are then
     decoded tiled and untiled), one with --quantize int4_w4a8 and one with
     --quantize w8a8 (each quantized clip's clip_psnr against the bf16
     clip 1 printed); it fails
     unless the LoRA was fused, the loaded tensors are the written ones, the
     stitched frames are right, the tiled decode is within its bound of the
     untiled one (and two wrong assemblies are not), the forward kernels
     ran, and every quantized linear went through w4a8_linear; then the
     gradio demo's core (SVIGradioDemo.initialize_models on these files,
     generate_video for 2 film clips of 9 frames at 2 steps), its streamed
     videos bit-equal to the same pipeline calls made by hand;
  4f. the variants: the tiny dance and talk pipelines on the card against
     the CPU; beside 4e's files a multitalk.safetensors (the 4 blocks'
     audio branches and audio_proj at the published widths), a dance LoRA
     with the pose embedding at dim 5120 and a full-size wav2vec2
     directory; wav2vec2 on data/toy_test/talk/speech.wav, card against
     CPU; the data tools: prepare_video_audio on the card over a seeded .npy
     clip and speech.wav (its embedding against the CPU's), make_toy_data's
     output read by the three datasets; the talk driver (two 9-frame clips
     at 480x832, bf16, then --quantize int4_w4a8) and the dance driver (two
     clips at 368x640 on a seeded .npy pose video), each with per-phase
     seconds and peak memory,
     and two controls (zeroed audio, --remove_pose) that must move the
     clip beyond the card-vs-CPU gap; and, on 4b's bf16 weights, one
     denoise-step forward of the full-depth multitalk 14B at B=3, profiled;
  5b. (run at the end of 4e, on its files and 4f's) the training drivers:
     seeded .npy datasets of 512x928 frames in the JAX package's layouts,
     then svi_tpu_torch.scripts.train_svi at 480x832, 21 frames, 3 steps
     (error recycling from step 2, exports at steps 2 and 3, a torch.profiler
     trace of step 3) and a resume from its checkpoint against the
     uninterrupted run; the same with --quantize int4_w4a8 (every quantized
     linear through w4a8_linear in the forward and the recompute, K3 once
     for each that needs dx in the straight-through backward, no
     torch._int_mm); train_svi_dance from the dance LoRA and its pose convs
     and train_svi_talk with multitalk.safetensors, 2 steps each; then
     extract_lora on the exported LoRA and the inference driver on the
     extracted file, one 9-frame clip; each with its
     per-phase seconds (dataset read, T5, VAE encode, CLIP + y, step,
     export) and peak memory, failing unless every launch took its route
     and K4 ran once a block a step;
  5. the Error-Recycling LoRA training slice: (a) a tiny bf16 trainer on the
     card against the same trainer on the CPU; (a') the same for each
     variant: pose training, customtalk training with audio, LoRA with
     audio, LoRA on an int4_w4a8 base (its K3 and W4A8 launches counted);
     then (b) 4 training steps of rank-128 LoRA on Wan2.1-I2V-14B at full
     width, 21 frames at 480x832, on a batch made by the port's own frozen
     encoders; all fail unless every bf16 D=128 split backward (K5a, K5b)
     took the sm90 kernels; (c) on that 14B, one step each plain, with
     save_attention and with offload_carries (time, peak memory, K1
     launches), then the DiT quantized in place to int4_w4a8 and 2 LoRA
     steps on it (time, peak, K3 and w4a8_linear launches);
  6. the parallel slice, ranks sharing the one card (the card's machine has
     one GPU): (a) a tiny DiT (head dim 128) on 4 gloo ranks: forward_sp
     with all-gather and ring on padded shards, forward_tp, forward_tpsp
     (f32) and sharded bf16 LoRA gradients, each against the card's
     single-device run and the CPU's, and at the same time the same on a
     one-rank NCCL group; (b) Wan2.1-I2V-14B at full width cut to 1 of 40
     blocks on 2 gloo ranks: forward_sp at 480x832x81 (all-gather and ring) against the
     single-device forward, one SP LoRA train step at 21 frames and one at
     81 frames (496x848: an odd token count, so the backward runs K4 on
     masked keys) beside the single-device step with each process's peak
     memory, forward_tp with each rank's weight bytes; (c) (at the end of
     5b, on its files) train_svi under torchrun --nproc_per_node 2 with sp
     and with data_parallel --shard_optimizer_state. Fails unless every
     sharded result is within its bound, every sharded self-attention
     backward took K4 or K5 and every ring step K2's sm90 route; the speed
     of ranks sharing one card is printed and measures no multi-card speed;
  7. (run inside 4e, after 4f, on its files) the pose path: (a) the ONNX
     executor's op families and tiny UniAnimate, long and replace-anyone
     pipelines, card against CPU; (b) DWPose's networks at their published
     widths as seeded ONNX graphs (YOLOX-L at 640x640, the detector steered
     to 1-4 people; DWPose-l at 384x288), card against CPU, with op counts,
     FLOPs and ms a frame and a person; (c) prepare_video_pose and
     run_align_pose on them over a seeded 16-frame 480x640 .npy video; (d)
     UniAnimate at the 14B's width on 4e's 4-block files and a side-module
     file through ModelManager: the plain pipeline (and a no-pose control),
     the long pipeline (33 frames, 3 windows) and replace-anyone, failing
     unless every K1 / K2 launch took its ported route;
  8. the SD 1.5 video stack: (a) the narrow SD models of the CPU tests
     (one head a block) through SDVideoPipeline (tile ControlNet, Contrast
     smoother) on the card against the CPU; (b) seeded files at the
     published widths in the reference's diffsynth naming (the SD 1.5 UNet,
     CLIP ViT-L/14's text tower, the VAE encoder and decoder, AnimateDiff
     v2's 21 motion modules, one ControlNet); (c) one UNet + ControlNet +
     motion forward on them at 4 frames of 128x128, card against CPU; (d)
     SDVideoPipelineRunner.run on a seeded 4-frame 512x512 video (one
     4-frame window; 8a runs several), 3 steps at strength 0.9, the tile ControlNet at
     scale 0.5, a Contrast smoother, with per-model seconds, peak memory
     and the f32 attention launches per head dim, which must be the plans'
     count; the smoother chain is FastBlend (its default ebsynth config, as
     a Diffutoon config names it) then Contrast; (e) text-to-image LoRA
     training (T2ILoRATrainer): a half-width UNet with 4 heads of 40, 80
     and 160, 3 steps card against CPU, then the full-width UNet of (b) in
     f32 at 512x512 (rank 4, 3 steps and one through vae_encode_fn on a
     TextImageDataset row), its attention backward on the f32 kernels, 32
     launches of each a step, and the save_lora round trip; (f) the bf16
     paths on the sm90 route (csrc/flash_fwd_sm90.cu) at the head dims that
     are not 64 or 128: the narrow bf16
     SDImagePipeline (a half-width UNet, 4 heads of 40 / 80 / 160, the VAE
     decoder at full width), FluxImagePipeline at its default bf16 (its VAE
     too) and HunyuanDiTImagePipeline(dtype=bf16) (2 heads of 88), card
     against CPU; AnimateDiff's motion modules in bf16 at the SD UNet's three
     widths on 16 frames (the packed short-sequence kernel), card against
     CPU; then SDImagePipeline(dtype=bf16) on (b)'s files at
     512x512, 2 steps, CFG 7.5, with seconds a step, peak memory and the
     launches per route, which must be the plan's count;
  9. the extensions and the SDXL family: (a) the narrow SDXL models (one
     head a block) through SDXLImagePipeline and SDXLVideoPipeline (a tile
     ControlNet Union unit, an IP-Adapter image), RIFE, FastBlend, ESRGAN
     and the Aesthetic and HPSv2 scores on small inputs, card against CPU;
     (b) seeded files at the published widths (SDXL base 1.0, AnimateDiff-
     SDXL, ControlNet Union SDXL, IP-Adapter SDXL with its ViT-H image
     encoder, RRDBNet x4, IFNet, CLIP ViT-L/14 with the aesthetic MLP,
     open_clip ViT-H/14); (c) one UNet + ControlNet + motion forward on them
     at 2 frames of 128x128, card against CPU; (d) SDXLVideoPipeline at
     1024x1024, 8 frames, 2 steps with ControlNet and IP-Adapter, then RIFE
     over its frames, FastBlend over its first 3, ESRGAN on 2 and the two
     scores on 2, with per-part seconds, peak memory and the f32 attention
     launches per head dim, which must be the plans' count;
 10. Kolors, SD3 and FLUX: (a) the CPU tests' tiny models (one head a
     block) through Kolors' SDXLImagePipeline and SDXLVideoPipeline with
     AnimateDiff-SDXL, SD3ImagePipeline with CFG and T5, FluxImagePipeline
     with a ControlNet unit, an IP-Adapter embedding, TeaCache and one EliGen
     entity, card against CPU; then one family at a time, its files freed
     before the next: (b) seeded files at the published widths (ChatGLM3-6B
     at 2 of 28 layers, the Kolors UNet, SDXL's VAE; SD3-medium's MMDiT at
     2 of 24 blocks, CLIP-L, OpenCLIP bigG at 2 of 32 layers, its VAE;
     FLUX.1-dev's DiT at 2 + 2 of 19 + 38
     blocks, CLIP-L, its VAE; T5-XXL at 2 of 24 layers; a cut file's
     parameter count at the published depth is computed from its blocks and
     held to the published count), (c) one forward at a cut depth card
     against CPU (FLUX in f32 and in bf16), (d) the pipeline on those files
     at 1024x1024, 2 steps (Kolors: the 256-token prompt, CFG 7.5; SD3:
     batched CFG 7.5, T5 on; FLUX: embedded guidance 3.5, its VAE in its
     bf16: K1's sm90 route at one head of 512), with per-part
     seconds, peak memory and the attention launches, which must be the
     loaded models' count;
 11. SVD, Hunyuan-DiT, HunyuanVideo and CogVideoX: (a) the narrow models of
     tests/torch_video_fixtures.py through SVDVideoPipeline (a mask frame),
     HunyuanDiTImagePipeline (2 heads of 88: the D88 route), HunyuanVideoPipeline
     (true CFG, the prompter with a seeded LLM table) and CogVideoPipeline
     (video-to-video, batched CFG), f32, card against CPU; then one family
     at a time, its files freed before the next: (b) seeded files at the
     published widths (SVD-XT's UNet, its temporal VAE decoder, SD's VAE
     encoder, CLIP ViT-H's image tower; Hunyuan-DiT with the SDXL VAE
     decoder; HunyuanVideo's 13B DiT at 2 + 2 of 20 + 40 blocks, its causal
     VAE decoder, CLIP-L; CogVideoX-5B's DiT at 2 of 42 blocks and VAE
     decoder with T5-XXL at 2 of 24 layers), (c) one forward at a cut depth
     card against CPU (HunyuanVideo and CogVideoX also in bf16, and
     Hunyuan-DiT in bf16 on the sm90 route at D88, its launches counted),
     (d) the
     pipeline on those files at full width, 2 steps (SVD 576x1024x25,
     Hunyuan-DiT 1024x1024, HunyuanVideo 544x960x33, CogVideoX 480x720x49),
     with per-part seconds, peak memory and the attention launches, which
     must be the loaded models' count (K2 f32 D88, K2 bf16 sm90 D64 among
     them); phase 3's rows at their shapes include HunyuanVideo's attention
     groups at its default 720x1280x129 (B1 S118871 and S185);
 12. StepVideo, OmniGen and the flow-matching solvers: (a) the narrow
     StepVideo (2 heads of 128, its chunked decode) and OmniGen (text only;
     a reference image: 3 branches and the KV cache) pipelines in f32, card
     against CPU, and UniPC / DPM-Solver++ card against CPU; then through
     phase 11's tables, (b) seeded files (StepVideo's DiT at 2 of 48 blocks
     and its VAE; OmniGen's Phi-3 transformer and the SDXL VAE), (c)
     forwards at a cut depth card against CPU (Step1 at 2 of 48 layers and
     StepVideo also in bf16), (d) StepVideoPipeline at 544x992x17 in bf16
     with all 48 blocks seeded on the card (K1 sm90 twice a block a step)
     and OmnigenImagePipeline at 1024x1024 with a reference image (K1 f32
     D512 in its SDXL VAE), launches against the models' count; phase 3's
     row at StepVideo's default 544x992x204 (B1 S75888 N48 D128);
 13. a JSON line of the kernels (K3's launches from 5b's quantized run;
     each entry's launches on phase 6's sharded runs as
     `launches_parallel`, on phase 7's UniAnimate runs as `launches_pose`,
     on phase 8's runner as `launches_sd`, on phase 9's SDXL video pipeline
     as `launches_sdxl`, on phase 10's pipelines as `launches_kolors`,
     `launches_sd3` and `launches_flux`, on phase 11's as `launches_svd`,
     `launches_hunyuan_dit`, `launches_hunyuan_video` and `launches_cog`,
     on phase 12's as `launches_stepvideo` and `launches_omnigen`, on phase
     8e's full-width trainer as `launches_t2i`, on each bf16 path as
     `launches_bf16_paths`; K2's D88 and bf16 D64 entries count phase 11's,
     the f32 backward's phase 8e's, the sm90 route's other bf16 head dims'
     the bf16 paths' (8f's SD 1.5 image pipeline and motion modules, 10d's
     FLUX, 11c's Hunyuan-DiT forward)), the
     nvidia-smi line, and the result line.
Needs one CUDA card and nvcc; exits non-zero without them.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import gc
import json
import math
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent

# Tolerances of the kernels against their plain versions, with the reason for each.
# bf16 forward: the kernel rounds P to bf16 for P.V (the plain version keeps
# f32) and both round out to bf16, about 2 bf16 ulps at |out| <= 1. The out
# bound is also held to a share of the plain version's largest |out| (printed
# beside the mean |out|): at the long DiT shapes a typical |out| is ~0.01,
# under the absolute bound, while a wrong V operand or a P.V dropped or
# repeated for some key tiles moves out by a share of its own size.
BF16_OUT_BOUND, BF16_OUT_REL = 2e-2, 2e-2
# lse comes from f32 scores of the same bf16 inputs in both: order of f32 sums.
BF16_LSE_BOUND = 1e-3
# f32 inputs: the kernel takes every product in 3xTF32 (about 2^-21 relative
# per product, f32-level) and the plain version runs in f32 with TF32 off:
# f32 rounding and the order of f32 sums differ.
F32_BOUND = 1e-4
# bf16 backward, as a share of the gradient's largest magnitude: the kernels
# round P and dS to bf16 before the products that consume them and each
# gradient once to bf16 (2^-8 relative); K4 sums dq in f32 (TMA reduce-adds)
# in an order that changes from run to run.
BF16_GRAD_REL_BOUND = 2e-2
# f32 backward on the (B, N, S, D) route (csrc/flash_bwd_f32.cu, every
# product in 3xTF32 on the tensor cores, about 2^-21 relative, f32-level)
# against the plain f32 backward (TF32 off) on the same inputs: f32 rounding
# and the order of the f32 sums over up to 4096 keys or queries (in dk / dv
# also over query chunks) differ. Bound: each gradient within 1e-4 of its
# own largest magnitude, or within `f32_bwd_floor` where that is larger (one
# key: dS = P (dP - delta) cancels to rounding); a wrong tile, mask or scale
# moves a gradient by its own size, and the plain backward with TF32 on
# (about 1e-3 relative) fails the bound (checked at one cross row).
F32_BWD_REL_BOUND = 1e-4


def f32_bwd_floor(q, k, v, g, n: int, d: int, scale: float) -> float:
    """What f32 rounding alone can leave in dq or dk where they are 0 but for
    it (one key: p = 1, so ds = p (dO.v - delta) subtracts two equal values):
    one ulp (2^-23) of |dO| |v| (the largest per-head rows; a bound on each
    of the two), times the scale and the largest |q| or |k|, and times
    sqrt(ceil(Sq / Sk)), for the queries whose rounding a key's dk sums at
    random signs. q, k, v, g flat (B, S, N*D)."""
    def row(t):
        return t.unflatten(-1, (n, d)).norm(dim=-1).max().item()

    share = -(-q.shape[1] // k.shape[1])
    largest = max(q.abs().max().item(), k.abs().max().item())
    return 2.0 ** -23 * scale * row(g) * row(v) * largest * share ** 0.5


def dgrad_err_bound(gs, w8, exact) -> float:
    """How far two computations of bf16(gs @ W8) with f32 sums can lie apart
    (the W4A8 input gradient against its plain version, cuBLAS; gs and W8
    exact in bf16, so every product is exact in f32): each rounds its f32
    sum once to bf16, so the two can land on neighbouring bf16 values, one
    ulp of |dx| <= 2^-7 of the largest |dx| (exact: the f64 product); and
    each sums in f32 in its own order: a tensor-core k16 step adds 16 exact
    products to the f32 accumulator with one rounding, at most an ulp
    (2^-23) of the running sum, itself at most sum_n |gs W8|, so each side is
    within (N/16 + 1) such roundings of the exact sum, the two within twice
    that. A wrong scale, nibble or tile moves dx by a share of its own size.
    tests/test_torch_kernels_cuda.py holds the card tests to the same."""
    n = gs.shape[-1]
    terms = (gs.double().abs() @ w8.double().abs()).max().item()
    return 2.0 ** -7 * exact.abs().max().item() + 2 * (n / 16 + 1) * 2.0 ** -23 * terms


# int4 unpack + requantization (K3) is held bit for bit (torch.equal): one f32
# product and one round-half-to-even per weight on both sides. So are the
# W4A8 linear (its activation pre-pass: the same IEEE divisions and
# roundings; the GEMM: K3's arithmetic in shared memory, an exact int32
# product, the same f32 epilogue in the same order) and its pre-pass.
# int8 attention forward (K6) against its plain version at the kernel's
# 128-key tiles: the same integer scores, row max and f32 steps, and both
# round out to bf16 the same way (qk8pv8: in v8 units, then again after the
# vss product). What remains is exp2 (a few f32 ulps) and the order of sums,
# which can put the two on neighbouring bf16 values (one ulp, at most 2^-7
# of the value), and for qk8pv8 a P that rounds to the other int8 level (one
# level of 127 in one of thousands of terms). The out bound is a share of the
# plain version's largest |out| (printed beside the typical |out|, a few
# 0.01 at the DiT shapes): 2.5 to 5 bf16 ulps there, while a wrong scale or
# V channel moves out by a share of its own size.
Q8_OUT_REL, Q8_LSE_BOUND = 2e-2, 1e-3
# K6 with f32 v and out (its own kernel, route "sm90_f32"): P.V in 3xTF32
# (about 2^-21 relative a product) against the plain version's f32 P.V; the
# same integer scores and row max, so what remains is exp2 (a few f32 ulps)
# and the order of the sums: out within 1e-4 of the plain version's largest
# |out|, lse within 1e-4
Q8_F32_OUT_REL, Q8_F32_LSE_BOUND = 1e-4, 1e-4
# The tiny W4A8 + qk8pv8 DiT (f32, TF32 off), card against CPU. The
# correctness gate is one forward on the same inputs: it agrees to f32 sums
# in another order (the W4A8 linears are bit-equal: w4a8_linear is bit-exact
# against its plain version; 1.7e-7 of the output's scale was measured with
# the K3 chain it replaced): bound 1e-3,
# ten times below the jump of one int8 level (~1% of a row's largest
# value). The pipeline after it is a smoke check: the DiT's inputs come from
# the VAE and CLIP, which differ by ~1e-6 between card and CPU; that moves
# some activation across an int8 rounding boundary, the first DiT output
# jumps by ~1e-2 and CFG 5 carries it through the steps. The card drifts
# that far at both seeds, and a witness on the CPU alone (the prompt
# embeddings moved by 1e-6) drifts as far at seed 0 (at seed 1 that move
# crosses no boundary). The pipeline's bounds are about four times the
# largest of those readings (PERF.md, PR 3), so they catch only an error of
# the latents' own size (~1): a wrong scale, packing or rounding mode.
SMALL_Q_FWD_REL = 1e-3
SMALL_Q_LAT_MAX, SMALL_Q_LAT_MEAN, SMALL_Q_FRAME_LEVELS = 0.5, 0.1, 32
SMALL_Q_SEEDS = (0, 1)
# The 14B forward, int4_w4a8 + qk8 against bf16 on the same inputs: a sanity
# bound, not a fidelity gate. int4 with 8 levels a side costs a few percent
# per linear on random weights (measured 0.114 mean relative difference over
# the 40 blocks); a wrong scale or packing at the 14B shapes moves the output
# by its own size.
QUANT_FWD_REL = 0.3

# The card's published peaks (H100 SXM, dense): bf16, int8 and TF32 tensor
# cores, f32 on CUDA cores, HBM bandwidth.
# Bounds: K1, K2, K4, K5 and K6 are bound by tensor-core (or f32) operations
# at the DiT shapes: K6 runs Q.K^T at the int8 rate and P.V at the bf16 rate
# (qk8) or the int8 rate (qk8pv8). K3 is bound by bytes: it reads half a byte
# and writes one per weight, plus the ratio table. An f32 product at f32
# accuracy can be taken on the CUDA cores (one FMA per multiply-add, 67
# TFLOP/s) or on the tensor cores in 3xTF32 (three TF32 products per f32
# product, 495 / 3 = 165 TFLOP/s of f32 work); the f32 rows (K1's f32 route,
# K2) are bound by the faster of the two, and `bound_rate` names it.
PEAK_BF16, PEAK_INT8, PEAK_F32, PEAK_TF32, HBM_BYTES_PER_S = (989e12, 1979e12, 67e12, 495e12,
                                                              3.35e12)
# K6's exp2 floor, which the tensor-core bound does not show: one exp2 per
# score on the special-function units, 16 a clock on each of the 132 SMs at
# the 1.98 GHz boost clock (printed beside the bound, not part of it)
EXP2_PER_S = 16 * 132 * 1.98e9
F32_ACCURATE = "f32"  # the peak of an f32 product at f32 accuracy: the better of the two above

SLICE_H, SLICE_W, SLICE_FRAMES, SLICE_STEPS, MOTION = 480, 832, 9, 4, 1
FORWARD_FRAMES = 81  # the reference's clip length: one forward at its token count
# training: 21 frames -> 6 latent frames -> 6 x 30 x 52 = 9360 tokens (K4's gate)
TRAIN_FRAMES, TRAIN_STEPS = 21, 4

# entry or "entry/route" -> (source, the TPU kernel it replaces); an entry
# whose routes launch different kernels has one name per route, counted from
# its per-route counter
KERNELS = {
    # the sm90 kernel's entries name their head dim, so that the D = 64
    # launches (phase 11's CogVideoX) and the D = 128 ones count apart
    "flash_fwd_flat/sm90/128": ("svi_tpu_torch/csrc/flash_fwd_sm90.cu",
                            "svi_tpu/ops/attention.py:75"),
    "flash_fwd_flat/f32": ("svi_tpu_torch/csrc/flash_fwd_f32.cu",
                           "svi_tpu/ops/attention.py:75"),
    "rope_rotate_flat": ("svi_tpu_torch/csrc/flash_fwd_sm90.cu",
                         "svi_tpu/ops/attention.py:60"),
    "flash_fwd_bnsd/f32": ("svi_tpu_torch/csrc/flash_fwd_f32.cu",
                           "svi_tpu/ops/attention.py:465"),
    # K2 at bf16 D=128: the ring's steps (phase 6), the sm90 kernel on
    # (B, N, S, D) views
    "flash_fwd_bnsd/sm90/128": ("svi_tpu_torch/csrc/flash_fwd_sm90.cu",
                            "svi_tpu/ops/attention.py:465"),
    "flash_bwd_onepass": ("svi_tpu_torch/csrc/flash_bwd_sm90.cu",
                          "svi_tpu/ops/attention.py:721"),
    "flash_bwd_dq/sm90": ("svi_tpu_torch/csrc/flash_bwd_split_sm90.cu",
                          "svi_tpu/ops/attention.py:585"),
    "flash_bwd_dkv/sm90": ("svi_tpu_torch/csrc/flash_bwd_split_sm90.cu",
                           "svi_tpu/ops/attention.py:646"),
    # K5a's and K5b's function in f32 on the (B, N, S, D) route: the SD 1.5
    # (D = 40, 80, 160) and SDXL (D = 64) UNets' attention backward, which
    # the TPU computes in XLA (svi_tpu/ops/attention.py:963, _flash_bwd_xla);
    # launched by phase 8e's text-to-image LoRA trainer
    "flash_bwd_dq/f32": ("svi_tpu_torch/csrc/flash_bwd_f32.cu", "svi_tpu/ops/attention.py:585"),
    "flash_bwd_dkv/f32": ("svi_tpu_torch/csrc/flash_bwd_f32.cu", "svi_tpu/ops/attention.py:646"),
    # the W4A8 linear replaces K3 on the inference path (K3 itself runs only
    # in the straight-through backward, off the main paths; phase 3 still
    # holds it bit for bit)
    "quantize_rows_int8": ("svi_tpu_torch/csrc/w4a8_gemm_sm90.cu",
                           "svi_tpu/ops/quant_matmul.py:33"),
    "w4a8_linear": ("svi_tpu_torch/csrc/w4a8_gemm_sm90.cu", "svi_tpu/ops/quant_matmul.py:33"),
    "flash_fwd_flat_q8/sm90": ("svi_tpu_torch/csrc/flash_fwd_q8_sm90.cu",
                               "svi_tpu/ops/attention.py:289"),
    # K6 with f32 v and out (an f32 DiT's qk8 attention): the kernel of its
    # own in the same source, P.V in 3xTF32; launched by the fidelity gate's
    # one-forward check
    "flash_fwd_flat_q8/sm90_f32": ("svi_tpu_torch/csrc/flash_fwd_q8_sm90.cu",
                                   "svi_tpu/ops/attention.py:289"),
    # K2 f32 at Hunyuan-DiT's D = 88 (a name of its own for the route's
    # head dim, counted from flash_fwd_bnsd.routes) and K2 bf16 at D = 64
    # (route sm90: CogVideoX's joint attention)
    "flash_fwd_bnsd/f32/88": ("svi_tpu_torch/csrc/flash_fwd_f32.cu",
                              "svi_tpu/ops/attention.py:465"),
    "flash_fwd_bnsd/sm90/64": ("svi_tpu_torch/csrc/flash_fwd_sm90.cu",
                               "svi_tpu/ops/attention.py:465"),
    # K2 and K1 at one head in bf16 at the head dims other than 64 and 128
    # (route sm90, csrc/flash_fwd_sm90.cu; a name's last part lists its head
    # dims): the SD 1.5 UNet's 8 heads of 40 / 80 / 160 and Hunyuan-DiT's 16
    # heads of 88 (K2; the D64 / D128 kernel over zero-filled head-dim boxes,
    # and the packed kernel at Sq and Sk <= 16), the VAE mid-blocks' one head
    # of 512 (K1; the column-split kernel); launched by the bf16 paths (phase
    # 8f's SD 1.5 image pipeline and motion modules, 10d's FLUX decode, 11c's
    # Hunyuan-DiT)
    "flash_fwd_bnsd/sm90/32+40+80+88+160": ("svi_tpu_torch/csrc/flash_fwd_sm90.cu",
                                            "svi_tpu/ops/attention.py:465"),
    "flash_fwd_flat/sm90/384+512": ("svi_tpu_torch/csrc/flash_fwd_sm90.cu",
                                    "svi_tpu/ops/attention.py:75"),
    # K3 standalone: the straight-through backward of every W4A8 linear that
    # needs dx, when LoRA trains on an int4_w4a8 base (phases 5a', 5b, 5c)
    "unpack_requant_int4": ("svi_tpu_torch/csrc/quant_unpack.cu",
                            "svi_tpu/ops/quant_matmul.py:33"),
}
QUANT_KERNELS = ("quantize_rows_int8", "w4a8_linear", "flash_fwd_flat_q8/sm90")
QUANT_TRAIN = ("unpack_requant_int4",)  # launched only by training on a quantized base
QUANT_F32 = ("flash_fwd_flat_q8/sm90_f32",)  # launched only by an f32 DiT's qk8 attention
QUANT_MODULE_ENTRIES = ("unpack_requant_int4", "quantize_rows_int8", "w4a8_linear")
PARALLEL_KERNELS = ("flash_fwd_bnsd/sm90/128",)  # launched only by the ring (phase 6)
ZOO_KERNELS = ("flash_fwd_bnsd/f32/88", "flash_fwd_bnsd/sm90/64")  # launched by phase 11's pipelines
T2I_KERNELS = ("flash_bwd_dq/f32", "flash_bwd_dkv/f32")  # launched by phase 8e's trainer
# launched by the bf16 paths
BF16_KERNELS = ("flash_fwd_bnsd/sm90/32+40+80+88+160", "flash_fwd_flat/sm90/384+512")
# each bf16 path's launches per KERNELS name, read just after its run (the
# counts zeroed just before it): 8f's SD 1.5 image pipeline and motion
# modules, 10d's FLUX pipeline (its VAE decode), 11c's Hunyuan-DiT forward
BF16_PATH_LAUNCHES: dict = {}
# the case whose times stand for each kernel in the JSON line: the shape the
# kernel's main path gives it
TIMED_CASE = {"flash_fwd_flat/sm90/128": "dit_self_attn_rope", "flash_fwd_flat/f32": "vae_mid_attn",
              "rope_rotate_flat": "rope_prepass",
              "flash_fwd_bnsd/f32": "clip_vit_h", "flash_fwd_bnsd/sm90/128": "ring_block",
              "flash_bwd_onepass": "dit_self_attn_bwd_onepass",
              "flash_bwd_dq/sm90": "dit_text_cross_attn_bwd",
              "flash_bwd_dkv/sm90": "dit_text_cross_attn_bwd",
              "quantize_rows_int8": "w4a8_prepass_ffn_0", "w4a8_linear": "w4a8_ffn_0",
              "flash_fwd_flat_q8/sm90": "dit_self_attn_q8_qk8",
              "flash_fwd_flat_q8/sm90_f32": "slice_self_attn_q8_qk8_f32",
              "unpack_requant_int4": "ffn_0", "flash_fwd_bnsd/f32/88": "hunyuan_dit_self_attn_d88",
              "flash_fwd_bnsd/sm90/64": "cogvideox_joint_attn_d64",
              "flash_bwd_dq/f32": "sd_unet_self_attn_d40_bwd",
              "flash_bwd_dkv/f32": "sd_unet_self_attn_d40_bwd",
              "flash_fwd_bnsd/sm90/32+40+80+88+160": "sd_unet_self_attn_d40_bf16",
              "flash_fwd_flat/sm90/384+512": "vae_mid_attn_d512_s16384_bf16"}


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


def timed_calls(fn):
    """fn, keeping the CUDA-event ms of each call in `.times`, each timed from
    an idle device as median_ms times it. Phase 3 wraps every plain version:
    the call that gives a case's comparison its reference is its warm-up
    (its time is printed, not used), and the calls after it give plain_ms."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*args, **kwargs)
        end.record()
        end.synchronize()
        wrapper.times.append(start.elapsed_time(end))
        return out

    wrapper.times = []
    return wrapper


def device_ms(fn, reps: int = 5) -> float | None:
    """Device time of one fn() call, ms: reps calls queued behind a device
    sleep that outlasts the host's work of queueing them, between two CUDA
    events, so that no host gap is counted (median_ms counts the host's
    wrapper work where the device waits on it). None where torch has no
    device sleep."""
    if not hasattr(torch.cuda, "_sleep"):
        return None
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    per_call = time.perf_counter() - t0  # host and device time of one call
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2e9 * (reps * per_call + 2e-3)))  # cycles at <= 2 GHz
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(flops: float, nbytes: float, peak) -> tuple[float, str, str]:
    """The least time the card could take (ms), what bounds it (bytes or
    operations) and the rate of the bound. peak: FLOP/s, or F32_ACCURATE
    for f32 products at f32 accuracy (the faster of f32 FMA and 3xTF32)."""
    if peak == F32_ACCURATE:
        t_ops, rate = min((flops / PEAK_F32, "f32 FMA 67 TFLOP/s"),
                          (3 * flops / PEAK_TF32, "3xTF32 at 495 TFLOP/s"))
    else:
        t_ops, rate = flops / peak, f"{peak / 1e12:g} TFLOP/s"
    t_bytes = nbytes / HBM_BYTES_PER_S
    if t_ops >= t_bytes:
        return 1e3 * t_ops, "operations", rate
    return 1e3 * t_bytes, "bytes", "3.35 TB/s"


def launch_counters():
    """KERNELS name -> (the wrapper that counts its launches, its route or '',
    its head dims ('a+b+c' in the name) or None)."""
    from svi_tpu_torch.ops import attention as A
    from svi_tpu_torch.ops import quant_matmul as Q

    out = {}
    for name in KERNELS:
        entry, _, route = name.partition("/")
        route, _, dims = route.partition("/")
        out[name] = (getattr(Q if entry in QUANT_MODULE_ENTRIES else A, entry), route,
                     tuple(map(int, dims.split("+"))) if dims else None)
    return out


def kernel_name(entry: str, route: str, head_dim: int) -> str:
    """The KERNELS name that counts `entry`'s launches on `route` at head_dim."""
    for name, (fn, r, dims) in launch_counters().items():
        if fn.__name__ == entry and r == route and (dims is None or head_dim in dims):
            return name
    raise KeyError(f"no KERNELS name counts {entry} on route {route} at D={head_dim}")


def zero_counts() -> None:
    """Every KERNELS counter to 0 (K3's too: the quantized inference paths
    check that it stays at 0)."""
    for fn, _, _ in launch_counters().values():
        if hasattr(fn, "launches"):
            fn.launches = 0
        if hasattr(fn, "routes"):
            fn.routes.clear()


def read_counts() -> dict:
    return {name: sum(n for key, n in fn.routes.items()
                      if key[0] == route and (dims is None or key[2] in dims)) if route
            else fn.launches for name, (fn, route, dims) in launch_counters().items()}


def per_kernel(launches: dict) -> dict:
    """Forward launches as `sd_launches` gives them ({entry: {"route/dtype/
    head_dim": n}}) per KERNELS name of those entries."""
    counts = {}
    for name, (_, route, dims) in launch_counters().items():
        entry = name.partition("/")[0]
        if entry in launches and route:
            counts[name] = sum(n for key, n in launches[entry].items()
                               if key.split("/")[0] == route
                               and (dims is None or int(key.split("/")[2]) in dims))
    return counts


def check_fwd_routes(path: str, need_f32: bool = False, need_d128: bool = True,
                     need_d64: bool = False) -> dict:
    """The forward launches per (route, dtype, head_dim) since the counts were
    zeroed; fails unless every bf16 launch (D = 128 and D = 64) took the sm90
    route (with need_d128 / need_d64, at least one at that head dim), and
    every f32 launch the 3xTF32 kernel (route f32; with need_f32, at least
    one)."""
    from svi_tpu_torch.ops import attention as A

    routes = {}
    for entry in (A.flash_fwd_flat, A.flash_fwd_bnsd):
        for key, n in entry.routes.items():
            routes["/".join(map(str, key))] = routes.get("/".join(map(str, key)), 0) + n
    for d, need in ((128, need_d128), (64, need_d64)):
        bf16 = {k: n for k, n in routes.items() if k.endswith(f"/bfloat16/{d}")}
        if set(bf16) - {f"sm90/bfloat16/{d}"} or (need and not bf16):
            raise RuntimeError(f"{path}: a bf16 D={d} forward took a route other than sm90, or "
                               f"none ran: {routes}")
    f32 = {k: n for k, n in routes.items() if "/float32/" in k}
    if any(not k.startswith("f32/") for k in f32) or (need_f32 and not f32):
        raise RuntimeError(f"{path}: an f32 forward took a route other than f32, or none ran: "
                           f"{routes}")
    return routes


def check_split_routes(path: str) -> dict:
    """The split backward's launches per (route, dtype, head_dim) since the
    counts were zeroed; fails unless every bf16 D=128 launch of K5a and K5b
    took the sm90 kernels and at least one of each did."""
    from svi_tpu_torch.ops import attention as A

    routes = {}
    for entry in (A.flash_bwd_dq, A.flash_bwd_dkv):
        name = entry.__name__
        for key, n in entry.routes.items():
            routes[f"{name}/" + "/".join(map(str, key))] = n
        d128 = {k[0] for k in entry.routes if k[1:] == ("bfloat16", 128)}
        if d128 != {"sm90"}:
            raise RuntimeError(f"{path}: a bf16 D=128 {name} launch took a route other than "
                               f"sm90, or none ran: {routes}")
    return routes


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

    from svi_tpu_torch.models import wan_dit
    from svi_tpu_torch.ops import attention as A
    from svi_tpu_torch.ops import quant_matmul as Q
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

        @timed_calls
        def plain():
            out, lse = A._flash_fwd_reference(*(t.unflatten(-1, (n, d)) for t in (q, k, v)),
                                              cos, sin, kv, d ** -0.5)
            return out.flatten(2), lse

        def run():
            (out, lse), (ref_out, ref_lse) = kernel(), plain()
            size = ref_out.float().abs()
            out_max, out_mean = size.max().item(), size.mean().item()
            del size
            out_err = err(out, ref_out)
            out_bound = min(BF16_OUT_BOUND, BF16_OUT_REL * out_max)
            log(f"[fwd] {name}: out max abs err {out_err:.3e}, bound {out_bound:.3e} (the "
                f"smaller of {BF16_OUT_BOUND} and {BF16_OUT_REL} of the largest |out| "
                f"{out_max:.3e}; mean |out| {out_mean:.3e})")
            return {"flash_fwd_flat/sm90/128": worst((out_err, out_bound),
                                                 (err(lse, ref_lse), BF16_LSE_BOUND))}

        return dict(case=name, shape=[b, sq, sk, n, d], dtype="bfloat16", run=run,
                    kernels={"flash_fwd_flat/sm90/128": kernel}, plain=plain,
                    library=lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask),
                    work={"flash_fwd_flat/sm90/128": (4 * b * n * sq * kv * d,
                                                  _nbytes(q, k, v, q) + 4 * b * n * sq,
                                                  PEAK_BF16)})

    def f32_case(name, b, sq, sk, n, d, entry=None):
        """An f32 forward as the SD stack runs it: q, k, v from their own
        projections, (B, S, N*D); N = 1 through K1's flat entry, else K2's
        (B, N, S, D) entry on transposed views. entry: the KERNELS name the
        row stands for (default the entry's f32 route)."""
        q = randn((b, sq, n * d), torch.float32)
        k = randn((b, sk, n * d), torch.float32)
        v = randn((b, sk, n * d), torch.float32)
        qh, kh, vh = (heads_first(t, n, d) for t in (q, k, v))
        entry = entry or ("flash_fwd_flat/f32" if n == 1 else "flash_fwd_bnsd/f32")

        def kernel():
            if n == 1:
                return A.flash_fwd_flat(q, k, v, d)
            out, lse = A.flash_fwd_bnsd(qh, kh, vh)
            return out.transpose(1, 2).flatten(2), lse

        @timed_calls
        def plain():
            out, lse = A._flash_fwd_reference(*(t.unflatten(-1, (n, d)) for t in (q, k, v)),
                                              None, None, sk, d ** -0.5)
            return out.flatten(2), lse

        def run():
            (out, lse), (ref_out, ref_lse) = kernel(), plain()
            return {entry: worst((err(out, ref_out), F32_BOUND), (err(lse, ref_lse), F32_BOUND))}

        return dict(case=name, shape=[b, sq, sk, n, d], dtype="float32", run=run,
                    kernels={entry: kernel}, plain=plain,
                    library=lambda: F.scaled_dot_product_attention(qh, kh, vh),
                    work={entry: (4 * b * n * sq * sk * d, _nbytes(q, k, v, q) + 4 * b * n * sq,
                                  F32_ACCURATE)})

    def bnsd_bf16_case(name, b, sq, sk, n, d, kv_len=None, flat=False):
        """K2 in bf16 (route sm90, csrc/flash_fwd_sm90.cu: CogVideoX's joint
        attention at D = 64; the other head dims over zero-filled head-dim
        boxes, or packed four (batch, head) items a tile at Sq and Sk <= 16),
        or with flat K1 at one head (the flat entry on column slices of one
        qkv tensor, as the VAE mid-blocks hand them over; the column-split
        kernel at D = 384 and 512): q, k, v from their own projections,
        (B, S, N*D), as (B, N, S, D) views for K2; keys at or past kv_len
        masked. The bound is at the true head dim (the kernel pads D40 to 64
        columns, D88 to 128, D160 to 192); the exp2 floor (one exp2 a score)
        is printed beside it."""
        if flat:
            qkv = randn((b, sq, 3 * d), torch.bfloat16)
            q, k, v = qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:]
        else:
            q = randn((b, sq, n * d), torch.bfloat16)
            k, v = (randn((b, sk, n * d), torch.bfloat16) for _ in range(2))
        qh, kh, vh = (heads_first(t, n, d) for t in (q, k, v))
        entry = kernel_name("flash_fwd_flat" if flat else "flash_fwd_bnsd",
                            A._fwd_route(torch.bfloat16, d), d)
        kv = sk if kv_len is None else kv_len
        mask = None if kv == sk else (torch.arange(sk, device="cuda") < kv)[None, None, None]

        def kernel():
            if flat:
                return A.flash_fwd_flat(q, k, v, d, kv_len=kv)
            out, lse = A.flash_fwd_bnsd(qh, kh, vh, kv_len=kv)
            return out.transpose(1, 2).flatten(2), lse

        @timed_calls
        def plain():
            out, lse = A._flash_fwd_reference(*(t.unflatten(-1, (n, d)) for t in (q, k, v)),
                                              None, None, kv, d ** -0.5)
            return out.flatten(2), lse

        def run():
            (out, lse), (ref_out, ref_lse) = kernel(), plain()
            out_max = ref_out.float().abs().max().item()
            out_err, lse_err = err(out, ref_out), err(lse, ref_lse)
            out_bound = min(BF16_OUT_BOUND, BF16_OUT_REL * out_max)
            log(f"[fwd] {name}: out max abs err {out_err:.3e}, bound {out_bound:.3e} (the "
                f"smaller of {BF16_OUT_BOUND} and {BF16_OUT_REL} of the largest |out| "
                f"{out_max:.3e}); lse max abs err {lse_err:.3e}, bound {BF16_LSE_BOUND}")
            return {entry: worst((out_err, out_bound), (lse_err, BF16_LSE_BOUND))}

        return dict(case=name, shape=[b, sq, sk, n, d], dtype="bfloat16", run=run,
                    kernels={entry: kernel}, plain=plain,
                    library=lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask),
                    work={entry: (4 * b * n * sq * kv * d, _nbytes(q, k, v, q) + 4 * b * n * sq,
                                  PEAK_BF16)},
                    exp2_floor_ms=1e3 * b * n * sq * kv / EXP2_PER_S)

    def bwd_case(name, b, sq, sk, n, d, grid=None, kv_len=None):
        """One backward at the route the autograd function picks for it. With
        kv_len < Sk (a padded sequence-parallel shard's gathered keys) the
        kernels run on the first kv_len keys, routed by that cut, as
        flash_bwd_flat runs them; the plain version masks the full keys, and
        its dk and dv past kv_len must be exactly 0."""
        kv = sk if kv_len is None else kv_len
        q = randn((b, sq, n * d), torch.bfloat16)
        k_full = randn((b, sk, n * d), torch.bfloat16)
        v_full = randn((b, sk, n * d), torch.bfloat16)
        g = randn((b, sq, n * d), torch.bfloat16)
        cos, sin = tables(grid, d) if grid else (None, None)
        out, lse = A.flash_fwd_flat(q, k_full, v_full, d, cos=cos, sin=sin, kv_len=kv)
        k, v = k_full[:, :kv], v_full[:, :kv]  # the keys the kernels see
        route = A._bwd_route(n, d, sq, kv, kv)
        split = A._split_bwd_route(torch.bfloat16, d)  # sm90 at D = 128, mma at D = 64
        dq_name, dkv_name = f"flash_bwd_dq/{split}", f"flash_bwd_dkv/{split}"
        args = (q, k, v, out, lse, g, d)
        rope = dict(cos=cos, sin=sin)
        if route == "onepass":
            kernels = {"flash_bwd_onepass": lambda: A.flash_bwd_onepass(*args, **rope)}
        else:
            kernels = {dq_name: lambda: A.flash_bwd_dq(*args, **rope),
                       dkv_name: lambda: A.flash_bwd_dkv(*args, **rope)}

        @timed_calls
        def plain():
            views = [t.unflatten(-1, (n, d)) for t in (q, k_full, v_full, out)]
            return [t.flatten(2) for t in A._flash_bwd_reference(
                *views, lse, g.unflatten(-1, (n, d)), cos, sin, kv, d ** -0.5)]

        def run():
            ref = plain()
            if kv < sk:
                if any((t[:, kv:] != 0).any() for t in ref[1:]):
                    raise RuntimeError(f"{name}: the plain dk, dv of masked keys are not 0")
                ref = [ref[0], ref[1][:, :kv], ref[2][:, :kv]]
            got = {}
            if route == "onepass":
                got["flash_bwd_onepass"] = kernels["flash_bwd_onepass"]()
                pairs = {"flash_bwd_onepass": (0, 1, 2)}
            else:
                got[dq_name] = (kernels[dq_name](),)
                got[dkv_name] = kernels[dkv_name]()
                pairs = {dq_name: (0,), dkv_name: (1, 2)}
            res = {}
            for entry, idx in pairs.items():
                res[entry] = worst(*((err(x, ref[i]),
                                      BF16_GRAD_REL_BOUND * ref[i].float().abs().max().item())
                                     for x, i in zip(got[entry], idx)))
            if route == "split" and split == "sm90":
                # the prep both kernels read: lse * log2(e) bit for bit, delta
                # an f32 sum of 128 products in another order
                o4, g4 = out.unflatten(-1, (n, d)), g.unflatten(-1, (n, d))
                lse2, delta = A._bwd_prep(o4, g4, lse, A._SPLIT_ROWS)
                want = A._bwd_prep_reference(o4, g4, lse, lse2.shape[-1])
                prep_err = max(0.0 if torch.equal(lse2, want[0]) else float("inf"),
                               err(delta, want[1]) / want[1].abs().max().item())
                log(f"[bwd-prep] {name}: lse2 {'bit-exact' if prep_err < float('inf') else 'DIFFERS'}, "
                    f"delta max err {prep_err:.3e} of the largest |delta| (bound 1e-5)")
                res[dq_name] = worst(res[dq_name], (prep_err, 1e-5))
            return res

        leaves = [heads_first(q, n, d, cos, sin).detach().requires_grad_(),
                  heads_first(k, n, d, cos, sin).detach().requires_grad_(),
                  heads_first(v, n, d).detach().requires_grad_()]
        gh = heads_first(g, n, d)
        o_lib = F.scaled_dot_product_attention(*leaves)  # SDPA's forward, once

        def library():
            """SDPA's backward alone, on its saved forward."""
            return torch.autograd.grad(o_lib, leaves, gh, retain_graph=True)

        def library_fwd_bwd():
            o = F.scaled_dot_product_attention(*leaves)
            return torch.autograd.grad(o, leaves, gh)

        mm = 2 * b * n * sq * kv * d  # one matrix product of the backward
        io = _nbytes(q, k, v, out, g) + 4 * b * n * sq  # inputs (lse f32)
        work = {"flash_bwd_onepass": (5 * mm, io + _nbytes(q, k, v), PEAK_BF16),
                dq_name: (3 * mm, io + _nbytes(q), PEAK_BF16),
                dkv_name: (4 * mm, io + _nbytes(k, v), PEAK_BF16)}
        # flash_bwd_flat beside the split kernels (it routes bf16 D = 64 at 80
        # heads to the (B, N, S, D) route, which takes f32 only)
        extra = dict(split=lambda: A.flash_bwd_flat(q, k, v, out, lse, g, d, **rope)) \
            if route == "split" else {}
        return dict(case=name, shape=[b, sq, sk, n, d], dtype="bfloat16", run=run,
                    kernels=kernels, plain=plain, library=library,
                    library_fwd_bwd=library_fwd_bwd, work={e: work[e] for e in kernels},
                    **extra)

    def f32_bwd_case(name, b, sq, sk, n, d, tf32_control=False):
        """The f32 backward of the (B, N, S, D) route (csrc/flash_bwd_f32.cu),
        as the SD and SDXL UNets' attention hands it over: q, k, v, out, dO
        flat (B, S, N*D) f32, lse from K2's f32 forward; each kernel alone
        against the plain backward, SDPA's f32 backward alone as the library
        call, and flash_bwd_flat (delta computed once for both) beside them.
        tf32_control: the plain backward with TF32 on must fail the bound on
        every gradient (the bound tells f32 from TF32 products)."""
        q = randn((b, sq, n * d), torch.float32)
        k = randn((b, sk, n * d), torch.float32)
        v = randn((b, sk, n * d), torch.float32)
        g = randn((b, sq, n * d), torch.float32)
        qh, kh, vh = (heads_first(t, n, d) for t in (q, k, v))
        out, lse = A.flash_fwd_bnsd(qh, kh, vh)
        out = out.transpose(1, 2).flatten(2)
        if A._bwd_route(n, d, sq, sk, sk) != "xla":
            raise RuntimeError(f"{name}: not the (B, N, S, D) route")
        args = (q, k, v, out, lse, g, d)
        kernels = {"flash_bwd_dq/f32": lambda: A.flash_bwd_dq(*args),
                   "flash_bwd_dkv/f32": lambda: A.flash_bwd_dkv(*args)}

        def plain_backward():
            views = [t.unflatten(-1, (n, d)) for t in (q, k, v, out)]
            return [t.flatten(2) for t in A._flash_bwd_reference(
                *views, lse, g.unflatten(-1, (n, d)), None, None, sk, d ** -0.5)]

        plain = timed_calls(plain_backward)

        def run():
            ref = plain()
            got = (kernels["flash_bwd_dq/f32"](),) + tuple(kernels["flash_bwd_dkv/f32"]())
            floor = f32_bwd_floor(q, k, v, g, n, d, d ** -0.5)
            bounds = [max(F32_BWD_REL_BOUND * r.abs().max().item(), floor) for r in ref]
            errs = [err(x, r) for x, r in zip(got, ref)]
            log(f"[bwd-f32] {name}: dq / dk / dv max abs err " + " / ".join(
                f"{e:.3e}" for e in errs) + ", bounds " + " / ".join(
                f"{b_:.3e}" for b_ in bounds) + f" ({F32_BWD_REL_BOUND} of each gradient's "
                f"largest |value|, or the rounding floor {floor:.3e})")
            if tf32_control:
                saved = torch.backends.cuda.matmul.allow_tf32
                torch.backends.cuda.matmul.allow_tf32 = True
                try:
                    control = plain_backward()
                finally:
                    torch.backends.cuda.matmul.allow_tf32 = saved
                ratios = [err(x, r) / b_ for x, r, b_ in zip(control, ref, bounds)]
                log(f"[bwd-f32] {name}: the plain backward with TF32 on, dq / dk / dv max abs "
                    "err over the bound " + " / ".join(f"{x:.2f}" for x in ratios))
                if min(ratios) <= 1:
                    raise RuntimeError(f"{name}: the f32 backward's bound passes TF32 products")
            return {"flash_bwd_dq/f32": (errs[0], bounds[0]),
                    "flash_bwd_dkv/f32": worst((errs[1], bounds[1]), (errs[2], bounds[2]))}

        leaves = [t.detach().requires_grad_() for t in (qh, kh, vh)]
        gh = heads_first(g, n, d)
        o_lib = F.scaled_dot_product_attention(*leaves)

        def library():
            """SDPA's f32 backward alone, on its saved forward."""
            return torch.autograd.grad(o_lib, leaves, gh, retain_graph=True)

        def library_fwd_bwd():
            o = F.scaled_dot_product_attention(*leaves)
            return torch.autograd.grad(o, leaves, gh)

        mm = 2 * b * n * sq * sk * d  # one matrix product of the backward
        io = _nbytes(q, k, v, out, g) + 4 * b * n * sq  # inputs (lse f32)
        work = {"flash_bwd_dq/f32": (3 * mm, io + _nbytes(q), F32_ACCURATE),
                "flash_bwd_dkv/f32": (4 * mm, io + _nbytes(k, v), F32_ACCURATE)}
        return dict(case=name, shape=[b, sq, sk, n, d], dtype="float32", run=run,
                    kernels=kernels, plain=plain, library=library,
                    library_fwd_bwd=library_fwd_bwd, work=work,
                    split=lambda: A.flash_bwd_flat(*args))

    def ring_case(name, b, s, n, d, kv_len):
        """K2 (`flash_fwd_bnsd`, route sm90) at a ring step's shapes: q, k, v
        as (B, N, S, D) views of (B, S, N, D) shards, the block's valid keys
        kv_len; a block of padding only (kv_len 0) gives out 0 and lse <=
        -1e30 (the merge weighs it 0), where the plain version's -1e30 mask
        averages v instead, and has no library call."""
        q, k, v = (randn((b, s, n, d), torch.bfloat16).transpose(1, 2) for _ in range(3))
        mask = None if kv_len in (0, s) else (torch.arange(s, device="cuda") < kv_len)[
            None, None, None]

        def kernel():
            return A.flash_fwd_bnsd(q, k, v, kv_len=kv_len)

        @timed_calls
        def plain():
            out, lse = A._flash_fwd_reference(*(t.transpose(1, 2) for t in (q, k, v)), None,
                                              None, kv_len, d ** -0.5)
            return out.transpose(1, 2), lse

        def run():
            (out, lse), (ref_out, ref_lse) = kernel(), plain()
            if kv_len == 0:
                ok = bool((out == 0).all() and (lse <= -1e30).all() and torch.isfinite(lse).all())
                return {"flash_fwd_bnsd/sm90/128": (0.0 if ok else float("inf"), 0.0)}
            out_bound = min(BF16_OUT_BOUND, BF16_OUT_REL * ref_out.float().abs().max().item())
            return {"flash_fwd_bnsd/sm90/128": worst((err(out, ref_out), out_bound),
                                                 (err(lse, ref_lse), BF16_LSE_BOUND))}

        library = None if kv_len == 0 else (
            lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask))
        return dict(case=name, shape=[b, s, s, n, d], dtype="bfloat16", run=run,
                    kernels={"flash_fwd_bnsd/sm90/128": kernel}, plain=plain, library=library,
                    work={"flash_fwd_bnsd/sm90/128": (4 * b * n * s * kv_len * d,
                                                  4 * b * s * n * d * 2 + 4 * b * n * s,
                                                  PEAK_BF16)})

    def rope_case(name, b, s, n, d, grid):
        """The sm90 route's RoPE pre-pass on q and k, held bit for bit against
        the plain rotation on the same card tensors."""
        q = randn((b, s, n * d), torch.bfloat16)
        k = randn((b, s, n * d), torch.bfloat16)
        cos, sin = tables(grid, d)

        def kernel():
            return A.rope_rotate_flat(q, cos, sin, d), A.rope_rotate_flat(k, cos, sin, d)

        @timed_calls
        def plain():
            return tuple(A._apply_rope_reference(t.unflatten(-1, (n, d)), cos[:s],
                                                 sin[:s]).flatten(2) for t in (q, k))

        def run():
            got, ref = kernel(), plain()
            diff = 0.0 if all(torch.equal(a, r) for a, r in zip(got, ref)) else max(
                2.0 ** -126, *(err(a, r) for a, r in zip(got, ref)))
            return {"rope_rotate_flat": (diff, 0.0)}

        # 6 f32 operations per pair; each of q, k read once and written once,
        # the tables read once
        return dict(case=name, shape=[b, s, s, n, d], dtype="bfloat16", run=run,
                    kernels={"rope_rotate_flat": kernel}, plain=plain, library=None,
                    work={"rope_rotate_flat": (2 * 3 * q.numel(),
                                               2 * _nbytes(q, k) + _nbytes(cos[:s], sin[:s]),
                                               PEAK_F32)})

    # the 14B DiT at 480x832x81: 21 x 30 x 52 = 32760 tokens, 40 heads of 128
    yield fwd_case("dit_self_attn_rope", 1, 32760, 32760, 40, 128, grid=(21, 30, 52))
    yield rope_case("rope_prepass", 1, 32760, 40, 128, grid=(21, 30, 52))
    yield fwd_case("dit_text_cross_attn", 1, 32760, 512, 40, 128)
    yield fwd_case("dit_image_cross_attn", 1, 32760, 257, 40, 128)
    # the inference slice's own clip (3 x 30 x 52 tokens, CFG batch 2) with a masked tail
    yield fwd_case("masked_kv_len", 2, 4680, 4680, 40, 128, grid=(3, 30, 52), kv_len=4100)
    # the training slice's self-attention forward (21 frames: 6 x 30 x 52 tokens)
    yield fwd_case("dit_self_attn_rope_21f", 1, 9360, 9360, 40, 128, grid=(6, 30, 52))
    # the talk variant's step: its three CFG branches as batch 3 (self and text cross)
    yield fwd_case("talk_self_attn_rope_b3", 3, 4680, 4680, 40, 128, grid=(3, 30, 52))
    yield fwd_case("talk_text_cross_attn_b3", 3, 4680, 512, 40, 128)
    # the UniAnimate long pipeline's window step: 5 x 30 x 52 tokens, CFG batch 2
    # (self, text and image cross-attention)
    yield fwd_case("unianimate_long_window", 2, 7800, 7800, 40, 128, grid=(5, 30, 52))
    yield fwd_case("unianimate_long_text_cross_attn", 2, 7800, 512, 40, 128)
    yield fwd_case("unianimate_long_image_cross_attn", 2, 7800, 257, 40, 128)
    # replace-anyone's two batch-1 forwards a step at 9 frames (3 x 30 x 52 tokens)
    yield fwd_case("replace_anyone_self_attn_b1", 1, 4680, 4680, 40, 128, grid=(3, 30, 52))

    # CLIP ViT-H/14: 257 tokens, 16 heads of 80, f32, through the (B, N, S, D) entry
    q, k, v = (randn((1, 16, 257, 80), torch.float32) for _ in range(3))

    @timed_calls
    def clip_plain():
        out, lse = A._flash_fwd_reference(q.transpose(1, 2), k.transpose(1, 2),
                                          v.transpose(1, 2), None, None, 257, 80 ** -0.5)
        return out.transpose(1, 2), lse

    def clip_run():
        (out, lse), (ro, rl) = A.flash_fwd_bnsd(q, k, v), clip_plain()
        return {"flash_fwd_bnsd/f32": worst((err(out, ro), F32_BOUND),
                                           (err(lse, rl), F32_BOUND))}

    yield dict(case="clip_vit_h", shape=[1, 257, 257, 16, 80], dtype="float32", run=clip_run,
               kernels={"flash_fwd_bnsd/f32": lambda: A.flash_fwd_bnsd(q, k, v)},
               plain=clip_plain, library=lambda: F.scaled_dot_product_attention(q, k, v),
               work={"flash_fwd_bnsd/f32": (4 * 16 * 257 * 257 * 80,
                                        _nbytes(q, k, v, q) + 4 * 16 * 257, F32_ACCURATE)})

    # VAE mid-block at 480x832: 60 x 104 = 6240 tokens, one head of 384, f32,
    # q/k/v as column slices of one qkv tensor as the VAE hands them over
    qkv = randn((2, 6240, 3 * 384), torch.float32)
    vq, vk, vv = qkv[..., :384], qkv[..., 384:768], qkv[..., 768:]

    @timed_calls
    def vae_plain():
        out, lse = A._flash_fwd_reference(*(t[:, :, None] for t in (vq, vk, vv)), None, None,
                                          6240, 384 ** -0.5)
        return out.flatten(2), lse

    def vae_run():
        (out, lse), (ro, rl) = A.flash_fwd_flat(vq, vk, vv, 384), vae_plain()
        return {"flash_fwd_flat/f32": worst((err(out, ro), F32_BOUND),
                                           (err(lse, rl), F32_BOUND))}

    yield dict(case="vae_mid_attn", shape=[2, 6240, 6240, 1, 384], dtype="float32", run=vae_run,
               kernels={"flash_fwd_flat/f32": lambda: A.flash_fwd_flat(vq, vk, vv, 384)},
               plain=vae_plain,
               library=lambda: F.scaled_dot_product_attention(
                   *(t[:, None] for t in (vq, vk, vv))),
               work={"flash_fwd_flat/f32": (4 * 2 * 6240 * 6240 * 384,
                                            _nbytes(vq, vk, vv, vq) + 4 * 2 * 6240,
                                            F32_ACCURATE)})

    # the SD 1.5 video stack at 512x512 (64 x 64 latents, a 16-frame window,
    # one CFG branch a pass), f32 through the 3xTF32 kernel: the UNet's first
    # level (8 heads of 40) self- and cross-attention (77 text keys: one
    # full 64-key tile and a ragged one), its second and third (8 heads of
    # 80 over 32 x 32 tokens, of 160 over 16 x 16), AnimateDiff's temporal attention at the first level (16 frames
    # over 64 x 64 pixels, the short-query tiles), and the VAE's mid-block
    # (one head of 512 over 64 x 64 tokens, K1 through the flat entry)
    yield f32_case("sd_unet_self_attn_d40", 16, 4096, 4096, 8, 40)
    yield f32_case("sd_unet_cross_attn_d40", 16, 4096, 77, 8, 40)
    yield f32_case("sd_unet_self_attn_d80", 16, 1024, 1024, 8, 80)
    yield f32_case("sd_unet_self_attn_d160", 16, 256, 256, 8, 160)
    yield f32_case("sd_motion_attn_d40", 4096, 16, 16, 8, 40)
    yield f32_case("sd_vae_mid_attn_d512", 1, 4096, 4096, 1, 512)
    # the SDXL video stack at 1024x1024 (128 x 128 latents, 16 frames a pass):
    # the UNet's 64 x 64 level (10 heads of 64) self- and text
    # cross-attention, its 32 x 32 level (20 heads of 64), and the VAE's
    # mid-block (one head of 512 over 128 x 128 tokens, K1); AnimateDiff-SDXL's
    # temporal attention runs SD's head dims on the short-query tiles (16
    # frames over 128 x 128, 64 x 64 and 32 x 32 pixels, 8 heads)
    yield f32_case("sdxl_unet_self_attn_d64", 16, 4096, 4096, 10, 64)
    yield f32_case("sdxl_unet_cross_attn_d64", 16, 4096, 77, 10, 64)
    yield f32_case("sdxl_unet_self_attn_d64_n20", 16, 1024, 1024, 20, 64)
    yield f32_case("sdxl_unet_cross_attn_d64_n20", 16, 1024, 77, 20, 64)
    yield f32_case("sdxl_motion_attn_d40", 16384, 16, 16, 8, 40)
    yield f32_case("sdxl_motion_attn_d80", 4096, 16, 16, 8, 80)
    yield f32_case("sdxl_motion_attn_d160", 1024, 16, 16, 8, 160)
    yield f32_case("sdxl_vae_mid_attn_d512", 1, 16384, 16384, 1, 512)
    # phase 10's shapes at 1024x1024: FLUX.1-dev's joint and single blocks
    # (B1 at the default cfg_scale 1: 512 T5 + 4096 image tokens, 24 heads of
    # 128, bf16; RoPE applied before the kernel, as svi_tpu does) and its
    # IP-Adapter's attention onto 128 image tokens (the joint blocks' image
    # queries, the single blocks' whole sequence); SD3-medium's joint
    # attention (batched CFG B2: 4096 image + 77 CLIP + 77 T5 tokens, 24
    # heads of 64, f32, K2); the Kolors UNet's cross-attention over ChatGLM's
    # 256 tokens at its two levels (CFG as one batch of two); the SD3 and
    # FLUX VAEs' mid-block is sdxl_vae_mid_attn_d512's shape
    yield fwd_case("flux_joint_attn", 1, 4608, 4608, 24, 128)
    yield fwd_case("flux_ipadapter_joint_cross_attn", 1, 4096, 128, 24, 128)
    yield fwd_case("flux_ipadapter_single_cross_attn", 1, 4608, 128, 24, 128)
    yield f32_case("sd3_joint_attn_d64", 2, 4250, 4250, 24, 64)
    yield f32_case("kolors_unet_cross_attn_d64", 2, 4096, 256, 10, 64)
    yield f32_case("kolors_unet_cross_attn_d64_n20", 2, 1024, 256, 20, 64)
    # phase 11's shapes: Hunyuan-DiT at 1024 x 1024 (16 heads of 88, f32,
    # K2's entry, route f32 at D = 88: self-attention over 64 x 64 tokens and
    # cross-attention over 77 + 256 text tokens, B2); CogVideoX-5B at 480 x
    # 720 x 49 (226 text + 13 x 30 x 45 video tokens, 48 heads of 64, bf16,
    # batched CFG B2: K2's route sm90 at D = 64; and a ragged sequence of 514
    # with masked keys past 500, a last tile of 2 live keys); HunyuanVideo's two attention groups
    # at its default 720 x 1280 x 129 (33 x 45 x 80 image tokens + 71 text,
    # and the last 185 text tokens; 24 heads of 128, bf16, K1 sm90)
    yield f32_case("hunyuan_dit_self_attn_d88", 2, 4096, 4096, 16, 88,
                   entry="flash_fwd_bnsd/f32/88")
    yield f32_case("hunyuan_dit_cross_attn_d88", 2, 4096, 333, 16, 88,
                   entry="flash_fwd_bnsd/f32/88")
    yield bnsd_bf16_case("cogvideox_joint_attn_d64", 2, 17776, 17776, 48, 64)
    yield bnsd_bf16_case("cogvideox_ragged_d64_kv500", 2, 514, 514, 48, 64, kv_len=500)
    yield fwd_case("hunyuan_video_group_a", 1, 118871, 118871, 24, 128)
    yield fwd_case("hunyuan_video_group_b", 1, 185, 185, 24, 128)
    # phase 12's shape: StepVideo's self-attention at its default 544 x 992 x
    # 204 (36 latent frames x 34 x 62 = 75888 tokens; 48 heads of 128, bf16,
    # K1 sm90; q and k are rotated in torch before the kernel, so the kernel,
    # SDPA and the plain version take the same rotated q and k)
    yield fwd_case("stepvideo_self_attn_s75888", 1, 75888, 75888, 48, 128)
    # the bf16 paths' shapes (route sm90, csrc/flash_fwd_sm90.cu): the SD 1.5
    # UNet at 512 x 512 with batched CFG (B2; 8 heads of 40 over 64 x 64
    # tokens and the 77-token text, 80 over 32 x 32, 160 over 16 x 16),
    # Hunyuan-DiT at 1024 x 1024 (B2, 16 heads of 88, self and the 77 + 256
    # text tokens), the VAE mid-block's one head of 512 over the SD VAE's
    # 64 x 64 and the SDXL / SD3 / FLUX VAE's 128 x 128 tokens
    yield bnsd_bf16_case("sd_unet_self_attn_d40_bf16", 2, 4096, 4096, 8, 40)
    yield bnsd_bf16_case("sd_unet_cross_attn_d40_bf16", 2, 4096, 77, 8, 40)
    yield bnsd_bf16_case("sd_unet_self_attn_d80_bf16", 2, 1024, 1024, 8, 80)
    yield bnsd_bf16_case("sd_unet_self_attn_d160_bf16", 2, 256, 256, 8, 160)
    # AnimateDiff's temporal attention in bf16 (an SD video pipeline run in
    # bf16): 16 frames over the 64 x 64 pixels of the first level, 8 heads of
    # 40, the f32 row sd_motion_attn_d40's shape; the packed kernel
    yield bnsd_bf16_case("animatediff_motion_d40_bf16", 4096, 16, 16, 8, 40)
    yield bnsd_bf16_case("hunyuan_dit_self_attn_d88_bf16", 2, 4096, 4096, 16, 88)
    yield bnsd_bf16_case("hunyuan_dit_cross_attn_d88_bf16", 2, 4096, 333, 16, 88)
    yield bnsd_bf16_case("sd_vae_mid_attn_d512_bf16", 1, 4096, 4096, 1, 512, flat=True)
    yield bnsd_bf16_case("vae_mid_attn_d512_s16384_bf16", 1, 16384, 16384, 1, 512, flat=True)
    # the route's other two head dims, which no bf16 pipeline of the
    # repository reaches: one head of 384 through K1's flat entry at the Wan
    # VAE's mid-block shape (B2 S6240; the VAE runs f32) and, through K2's, 8
    # heads of 32 at the tiny DiTs' 9-frame token count (S4680)
    yield bnsd_bf16_case("wan_vae_mid_attn_d384_bf16", 2, 6240, 6240, 1, 384, flat=True)
    yield bnsd_bf16_case("tiny_dit_self_attn_d32_bf16", 1, 4680, 4680, 8, 32)

    # backward: the training slice's self-attention (21 frames, 6 x 30 x 52
    # tokens) through K4, the same at 81 frames, and K5 for cross-attention
    # and for a self-attention too short for K4 (one latent frame)
    yield bwd_case("dit_self_attn_bwd_onepass", 1, 9360, 9360, 40, 128, grid=(6, 30, 52))
    yield bwd_case("dit_self_attn_bwd_onepass_81f", 1, 32760, 32760, 40, 128, grid=(21, 30, 52))
    yield bwd_case("dit_text_cross_attn_bwd", 1, 9360, 512, 40, 128)
    yield bwd_case("dit_image_cross_attn_bwd", 1, 9360, 257, 40, 128)
    yield bwd_case("short_self_attn_bwd_split_rope", 1, 1560, 1560, 40, 128, grid=(1, 30, 52))
    # the sequence-parallel path (phase 6): a rank's self-attention backward
    # on its padded shard against the gathered keys, kv_len < Sk. Phase 6b's
    # 81-frame step at 496x848 (21 x 31 x 53 = 34503 tokens over 2 ranks:
    # shards of 17252, keys gathered to 34504) through K4, and a shard under
    # K4's gate through K5a + K5b
    yield bwd_case("sp_self_attn_bwd_kvlen_onepass", 1, 17252, 34504, 40, 128, kv_len=34503)
    yield bwd_case("sp_self_attn_bwd_kvlen_split", 1, 2100, 4200, 40, 128, kv_len=4199)
    # K5a / K5b at bf16 D = 64 (route mma, csrc/flash_bwd.cu; no path takes it:
    # the DiTs train at D = 128) at the 14B's width in 64-wide heads (no RoPE:
    # the DiT's 3-axis tables are laid out for D = 128)
    yield bwd_case("dit_self_attn_bwd_d64", 1, 9360, 9360, 80, 64)
    # the text-to-image LoRA trainer's backward (phase 8e), f32 on the
    # (B, N, S, D) route: SD 1.5 at 512x512 (64 x 64 latents, B1): 8 heads of
    # 40 over 64 x 64 tokens, self and onto the 77 text keys, of 80 over
    # 32 x 32, of 160 over 16 x 16 and the mid-block's 8 x 8; SDXL at
    # 1024x1024: 10 heads of 64 over 64 x 64 (self and text), 20 over 32 x 32
    yield f32_bwd_case("sd_unet_self_attn_d40_bwd", 1, 4096, 4096, 8, 40)
    yield f32_bwd_case("sd_unet_cross_attn_d40_bwd", 1, 4096, 77, 8, 40, tf32_control=True)
    yield f32_bwd_case("sd_unet_self_attn_d80_bwd", 1, 1024, 1024, 8, 80)
    yield f32_bwd_case("sd_unet_cross_attn_d80_bwd", 1, 1024, 77, 8, 80)
    yield f32_bwd_case("sd_unet_self_attn_d160_bwd", 1, 256, 256, 8, 160)
    yield f32_bwd_case("sd_unet_mid_attn_d160_bwd", 1, 64, 64, 8, 160)
    yield f32_bwd_case("sdxl_unet_self_attn_d64_bwd", 1, 4096, 4096, 10, 64)
    yield f32_bwd_case("sdxl_unet_self_attn_d64_n20_bwd", 1, 1024, 1024, 20, 64)
    yield f32_bwd_case("sdxl_unet_cross_attn_d64_bwd", 1, 4096, 77, 10, 64)
    # K2 at the ring's shapes: phase 6b's 81-frame forward over 2 ranks
    # (32760 tokens, blocks of 16380), a block with a padded tail, and one
    # of padding only
    yield ring_case("ring_block", 1, 16380, 40, 128, 16380)
    yield ring_case("ring_block_partial", 1, 16380, 40, 128, 9000)
    yield ring_case("ring_block_padding", 1, 16380, 40, 128, 0)

    def unpack_case(name, n, k):
        """K3 on a weight of the 14B DiT's shape (out n, in k), quantized by
        the port's own quantizer."""
        packed, scale = wan_dit._quantize_leaf_int4(randn((n, k), torch.bfloat16) * 0.02)
        r, _ = wan_dit._w4a8_leaves(scale)
        del scale

        def kernel():
            return Q.unpack_requant_int4(packed, r)

        @timed_calls
        def plain():
            return Q._unpack_requant_reference(packed, r)

        def run():
            got, ref = kernel(), plain()
            diff = 0.0 if torch.equal(got, ref) else max(
                1.0, (got.int() - ref.int()).abs().max().item())
            return {"unpack_requant_int4": (diff, 0.0)}

        return dict(case=name, shape=[n, k], dtype="int4->int8", run=run,
                    kernels={"unpack_requant_int4": kernel}, plain=plain, library=None,
                    work={"unpack_requant_int4": (n * k, _nbytes(packed, r) + n * k, PEAK_F32)})

    # W4A8 linears of the 14B DiT: ffn.0, ffn.2, a 5120 x 5120 projection and
    # the time embedding's first linear (K = 256). K3 runs in the
    # straight-through backward now; the inference path fuses it below.
    yield unpack_case("ffn_0", 13824, 5120)
    yield unpack_case("ffn_2", 5120, 13824)
    yield unpack_case("self_attn_q", 5120, 5120)
    yield unpack_case("time_embedding_0", 5120, 256)

    def ms_pair(fn):
        return median_ms(fn, 5), device_ms(fn)

    def w4a8_case(name, m, n, k):
        """The W4A8 linear (pre-pass + GEMM) on a weight of the 14B DiT's shape
        (out n, in k) quantized by the port's own quantizer, with a bias, at m
        tokens; bit for bit against the plain version. Beside it: torch._int_mm
        alone on int8 operands made beforehand (`_int8_matmul`, which pads M
        <= 16 to 17 rows) and the chain it replaced, K3 + `_int8_exec` + the
        bias, both timed in this run."""
        packed, scale = wan_dit._quantize_leaf_int4(randn((n, k), torch.bfloat16) * 0.02)
        r, s8 = wan_dit._w4a8_leaves(scale)
        del scale
        x = randn((m, k), torch.bfloat16)
        b = randn((n,), torch.bfloat16) * 0.1
        x8, _ = Q.quantize_rows_int8(x)
        w8 = Q.unpack_requant_int4(packed, r)

        def kernel():
            return Q.w4a8_linear(x, packed, r, s8, b)

        @timed_calls
        def plain():
            return Q._w4a8_linear_reference(x, packed, r, s8, b)

        def old_chain():
            return wan_dit._plus_bias({"b": b}, wan_dit._int8_exec(
                x, Q.unpack_requant_int4(packed, r), s8))

        def run():
            got, ref = kernel(), plain()
            diff = 0.0 if torch.equal(got, ref) else max(
                1.0, (got.float() - ref.float()).abs().max().item())
            old_ms, old_dev = ms_pair(old_chain)
            new_ms, new_dev = ms_pair(kernel)
            log(f"[w4a8] {name} M{m} N{n} K{k}: torch.equal {diff == 0.0}; w4a8_linear "
                f"{new_ms:.4f} ms (device {new_dev}); the chain it replaced (K3, _int8_exec, "
                f"bias) {old_ms:.4f} ms (device {old_dev}); faster than that chain: "
                f"{new_ms < old_ms}")
            return {"w4a8_linear": (diff, 0.0)}

        io = _nbytes(x, packed, r, s8, b) + 2 * m * n
        return dict(case=name, shape=[m, n, k], dtype="bf16 x int4 (W4A8)", run=run,
                    kernels={"w4a8_linear": kernel}, plain=plain,
                    library=lambda: wan_dit._int8_matmul(x8, w8),
                    work={"w4a8_linear": (2 * m * n * k, io, PEAK_INT8)})

    def prepass_case(name, m, k):
        """The W4A8 activation pre-pass alone, bit for bit (x8 and xs)."""
        x = randn((m, k), torch.bfloat16)

        def kernel():
            return Q.quantize_rows_int8(x)

        @timed_calls
        def plain():
            return Q._quantize_rows_reference(x)

        def run():
            (x8, xs), (rx8, rxs) = kernel(), plain()
            same = torch.equal(x8, rx8) and torch.equal(xs, rxs)
            return {"quantize_rows_int8": (0.0 if same else 1.0, 0.0)}

        return dict(case=name, shape=[m, k], dtype="bf16->int8", run=run,
                    kernels={"quantize_rows_int8": kernel}, plain=plain, library=None,
                    work={"quantize_rows_int8": (3 * m * k, 3 * m * k + 4 * m, PEAK_F32)})

    # the W4A8 linears at the slice's 9360 tokens (B2 S4680): ffn.0, ffn.2,
    # self_attn.q; the cross-attention's k on the text (B2 x 512 tokens); the
    # time embedding's first linear at M = batch
    yield prepass_case("w4a8_prepass_ffn_0", 9360, 5120)
    yield prepass_case("w4a8_prepass_ffn_2", 9360, 13824)
    yield w4a8_case("w4a8_ffn_0", 9360, 13824, 5120)
    yield w4a8_case("w4a8_ffn_2", 9360, 5120, 13824)
    yield w4a8_case("w4a8_self_attn_q", 9360, 5120, 5120)
    yield w4a8_case("w4a8_cross_attn_k_text", 1024, 5120, 5120)
    yield w4a8_case("w4a8_time_embedding_0", 2, 5120, 256)

    def ratio(a, b):
        return "not measured" if a is None or b is None else f"{a / b:.2f}"

    def dgrad_case(name, m, n, k):
        """The fused W4A8 input gradient `w4a8_dgrad` (no path takes it: the
        training backward runs the chain, faster on this card) on a weight of
        the 14B DiT's shape (out n, in k) quantized by the port's own
        quantizer, with a cotangent of m tokens, against the plain version
        (K3's plain unpack, g * bf16(s8), cuBLAS) within `dgrad_err_bound`;
        as the control, the plain version against the exact (f64) product of
        the same bf16 operands, rounded to bf16, within the same bound.
        Beside it: the chain the backward runs (the standalone K3, then
        `_straight_through_dx`: the bf16 cast, g * s8 and cuBLAS) and
        torch.matmul(gs, W8 in bf16) alone on operands made beforehand (the
        product without the transforms: the library call)."""
        packed, scale = wan_dit._quantize_leaf_int4(randn((n, k), torch.bfloat16) * 0.02)
        r, s8 = wan_dit._w4a8_leaves(scale)
        del scale
        g = randn((m, n), torch.bfloat16) * 1e-3
        gs = g * s8.reshape(-1).to(torch.bfloat16)
        wb = Q.unpack_requant_int4(packed, r).to(torch.bfloat16)

        def kernel():
            return Q.w4a8_dgrad(g, packed, r, s8)

        @timed_calls
        def plain():
            return Q._w4a8_dgrad_reference(g, packed, r, s8)

        def chain():
            return Q._straight_through_dx(g, Q.unpack_requant_int4(packed, r), s8)

        def library():
            return torch.matmul(gs, wb)

        io = _nbytes(g, packed, r, s8) + 2 * m * k

        def run():
            got, ref = kernel(), plain()
            exact = gs.double() @ wb.double()
            err_bound = dgrad_err_bound(gs, wb, exact)
            exact = exact.to(torch.bfloat16)
            got_err, control = err(got, ref), err(ref, exact)
            del exact, got, ref
            chain_ms, chain_dev = ms_pair(chain)
            lib_ms, lib_dev = ms_pair(library)
            new_ms, new_dev = ms_pair(kernel)
            bound_ms = bound(2 * m * n * k, io, PEAK_BF16)[0]
            log(f"[w4a8-dgrad] {name} M{m} N{n} K{k}: max abs err {got_err:.3e} against the "
                f"plain version, the plain version {control:.3e} against the exact product, "
                f"bound {err_bound:.3e}; w4a8_dgrad {new_ms:.4f} ms (device {new_dev}); the "
                f"chain the backward runs (K3, the bf16 cast, g * s8, cuBLAS) {chain_ms:.4f} ms "
                f"(device {chain_dev}); torch.matmul alone {lib_ms:.4f} ms (device {lib_dev}); "
                f"bound {bound_ms:.4f} ms; device time over the bound {ratio(new_dev, bound_ms)}, "
                f"over torch.matmul {ratio(new_dev, lib_dev)}, over the chain "
                f"{ratio(new_dev, chain_dev)}")
            if control > err_bound:
                raise RuntimeError(f"{name}: the plain version (cuBLAS) is {control:.3e} from the "
                                   f"exact product, past the bound {err_bound:.3e}")
            return {"w4a8_dgrad": (got_err, err_bound)}

        return dict(case=name, shape=[m, n, k], dtype="bf16 x int4 (W4A8 input gradient)",
                    run=run, kernels={"w4a8_dgrad": kernel}, plain=plain, library=library,
                    work={"w4a8_dgrad": (2 * m * n * k, io, PEAK_BF16)})

    # the fused input gradient at the training slice's 9360 tokens
    # (21 frames): ffn.0's and ffn.2's weights, a 5120 x 5120 projection and
    # the head (64 outputs)
    yield dgrad_case("w4a8_dgrad_ffn_0", 9360, 13824, 5120)
    yield dgrad_case("w4a8_dgrad_ffn_2", 9360, 5120, 13824)
    yield dgrad_case("w4a8_dgrad_self_attn_q", 9360, 5120, 5120)
    yield dgrad_case("w4a8_dgrad_head", 9360, 64, 5120)

    def q8_case(name, quant, b, sq, sk, n, d, grid=None, kv_len=None, dtype=torch.bfloat16):
        """K6 on `_quant_prep`'s operands (the prep is torch code, outside the
        kernel, as the JAX package keeps it in XLA); dtype f32: q, k, v and
        out in f32, the qk8 kernel of route sm90_f32."""
        pv8 = quant == "qk8pv8"
        f32 = dtype == torch.float32
        # sm90 at D = 128, mma at D = 64 (bf16)
        entry = "flash_fwd_flat_q8/sm90_f32" if f32 else f"flash_fwd_flat_q8/{A._q8_route(d)}"
        out_rel, lse_bound = (Q8_F32_OUT_REL, Q8_F32_LSE_BOUND) if f32 else (Q8_OUT_REL,
                                                                          Q8_LSE_BOUND)
        q = randn((b, sq, n * d), dtype)
        k = randn((b, sk, n * d), dtype) + 0.5  # biased channels, for the centring
        v = randn((b, sk, n * d), dtype)
        cos, sin = tables(grid, d) if grid else (None, None)
        kv = sk if kv_len is None else kv_len
        q8, qs, k8, kscale, v8, vss = A._quant_prep(q, k, v, cos, sin, d, pv8)
        v_in = v8 if pv8 else v
        qh, kh = (heads_first(t, n, d, cos, sin) for t in (q, k))
        vh = heads_first(v, n, d)
        mask = None if kv == sk else (torch.arange(sk, device="cuda") < kv)[None, None, None]

        def kernel():
            return A.flash_fwd_flat_q8(q8, qs, k8, kscale, v_in, vss, d, kv_len=kv,
                                       out_dtype=dtype)

        @timed_calls
        def plain():
            return A._flash_fwd_q8_reference(q8, qs, k8, kscale, v_in, vss, kv, d ** -0.5,
                                             dtype, block_k=A.Q8_BLOCK_K[d])

        def run():
            (out, lse), (ref_out, ref_lse) = kernel(), plain()
            size = ref_out.float().abs()
            out_max, out_mean = size.max().item(), size.mean().item()
            del size
            out_err, out_bound = err(out, ref_out), out_rel * out_max
            log(f"[q8] {name}: out max abs err {out_err:.3e}, bound {out_bound:.3e} "
                f"({out_rel} of the largest |out| {out_max:.3e}; mean |out| {out_mean:.3e})")
            if b * sq * sk >= 32760 * 32760:
                # K1 on the same bf16 q, k, v (no RoPE: K6's operands come rotated),
                # in turns with K6, and the exp2 floor
                k1_dev, k6_dev = device_ms(k1), device_ms(kernel)
                k1_dev2, k6_dev2 = device_ms(k1), device_ms(kernel)
                floor_ms = 1e3 * b * n * sq * sk / EXP2_PER_S
                log(f"[q8-vs-k1] {name}: device ms K6 {k6_dev:.3f} / {k6_dev2:.3f}, K1 sm90 "
                    f"{k1_dev:.3f} / {k1_dev2:.3f}; K6 <= K1: "
                    f"{max(k6_dev, k6_dev2) <= min(k1_dev, k1_dev2)}; exp2 floor "
                    f"{floor_ms:.2f} ms")
            return {entry: worst((out_err, out_bound), (err(lse, ref_lse), lse_bound))}

        def k1():
            return A.flash_fwd_flat(q, k, v, d)

        io = _nbytes(q8, qs, k8, kscale, v_in, *([vss] if pv8 else [])) \
            + q8.numel() * torch.tensor([], dtype=dtype).element_size() + 4 * b * n * sq
        # Q.K^T at the int8 rate, P.V at the int8 (qk8pv8), bf16 (qk8) or
        # f32-accurate rate (f32 qk8: 3xTF32, three TF32 products a product)
        pv_rate = PEAK_INT8 if pv8 else PEAK_TF32 / 3 if f32 else PEAK_BF16
        peak = 2 / (1 / PEAK_INT8 + 1 / pv_rate)
        return dict(case=name, shape=[b, sq, sk, n, d],
                    dtype=f"int8 {quant}" + (", f32 v and out" if f32 else ""), run=run,
                    kernels={entry: kernel}, plain=plain,
                    library=lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask),
                    work={entry: (4 * b * n * sq * kv * d, io, peak)})

    for quant in ("qk8", "qk8pv8"):
        # the 14B self-attention at 81 frames (production), at the slice's 9
        # frames (CFG batch 2), and the slice's shape with a masked tail
        yield q8_case(f"dit_self_attn_q8_{quant}", quant, 1, 32760, 32760, 40, 128,
                      grid=(21, 30, 52))
        yield q8_case(f"slice_self_attn_q8_{quant}", quant, 2, 4680, 4680, 40, 128,
                      grid=(3, 30, 52))
        yield q8_case(f"masked_kv_len_q8_{quant}", quant, 2, 4680, 4680, 40, 128,
                      grid=(3, 30, 52), kv_len=4100)
    # qk8 with f32 v and out at the slice's shape, and with a masked tail
    # (SDPA in f32 beside it: a yardstick)
    yield q8_case("slice_self_attn_q8_qk8_f32", "qk8", 2, 4680, 4680, 40, 128,
                  grid=(3, 30, 52), dtype=torch.float32)
    yield q8_case("masked_kv_len_q8_qk8_f32", "qk8", 2, 4680, 4680, 40, 128,
                  grid=(3, 30, 52), kv_len=4100, dtype=torch.float32)
    # K6 at D = 64 (route mma, csrc/flash_fwd_q8.cu; no path takes it: the
    # DiTs attend at D = 128) at the 14B's width in 64-wide heads, no RoPE
    yield q8_case("dit_self_attn_q8_qk8_d64", "qk8", 1, 9360, 9360, 80, 64)


PLAIN_ONE_CALL_MS = 1000.0
# a comparison call this long is its own time: what a first call costs more
# (allocations, library setup; up to 13x a short call's time) is a few
# milliseconds against seconds (HunyuanVideo's group A at S118871, ~9 s)
PLAIN_TIMED_ONCE_MS = 5000.0


def phase_kernels(card: str):
    """Every case's kernels against the plain version; one row per (case, kernel)."""
    rows = []
    for case in kernel_cases():
        results = case["run"]()
        plain = case["plain"]
        if len(plain.times) != 1:
            raise RuntimeError(f"{case['case']}: the comparison ran the plain version "
                               f"{len(plain.times)} times, not once")
        # after that warm-up call, the median of 2 calls, or one call where
        # the warm-up took over PLAIN_ONE_CALL_MS (the 81-frame shapes), or
        # the comparison's own call where it took over PLAIN_TIMED_ONCE_MS
        first = plain.times[0]
        extra = 0 if first > PLAIN_TIMED_ONCE_MS else 1 if first > PLAIN_ONE_CALL_MS else 2
        for _ in range(extra):
            plain()
        plain_ms = statistics.median(plain.times[1:] if extra else plain.times)
        library_ms = None if case["library"] is None else median_ms(case["library"], 5)
        # the backward cases' library call is SDPA's backward alone; its
        # forward + backward is printed beside it, as earlier runs timed it
        fwd_bwd_ms = median_ms(case["library_fwd_bwd"], 5) if "library_fwd_bwd" in case \
            else None
        for entry, kernel in case["kernels"].items():
            max_err, err_bound = results[entry]
            flops, nbytes, peak = case["work"][entry]
            bound_ms, bound_by, bound_rate = bound(flops, nbytes, peak)
            ms = median_ms(kernel, 5)
            dev_ms = device_ms(kernel)
            row = dict(case=case["case"], entry=entry, shape=case["shape"],
                       dtype=case["dtype"], max_abs_err=max_err, err_bound=err_bound, ms=ms,
                       device_ms=dev_ms,
                       plain_ms=plain_ms, plain_calls_ms=plain.times,
                       library_ms=library_ms,
                       library_fwd_bwd_ms=fwd_bwd_ms, flops=flops, bytes=nbytes,
                       bound_ms=bound_ms, bound_by=bound_by, bound_rate=bound_rate,
                       exp2_floor_ms=case.get("exp2_floor_ms"), tflops=flops / ms / 1e9,
                       card=card, ok=max_err <= err_bound)
            log(f"[kernel] {json.dumps(row)}")
            if not row["ok"]:
                raise RuntimeError(f"{case['case']}: {entry} disagrees with the plain version")
            rows.append(row)
        if "split" in case:
            split_summary(case, rows[-2:], card)
        del case
        torch.cuda.empty_cache()
    return rows


def split_summary(case: dict, pair: list, card: str) -> None:
    """K5a and K5b of one split-backward case side by side: each call's
    CUDA-event and device time (each computes its own delta), their sum, the
    whole backward as flash_bwd_flat runs it (one prep for both), SDPA's
    backward alone and the bounds."""
    def fmt(x):
        return "not measured" if x is None else f"{x:.4f}"

    dq, dkv = pair
    flat_ms, flat_dev = median_ms(case["split"], 5), device_ms(case["split"])
    both = None if dq["device_ms"] is None else dq["device_ms"] + dkv["device_ms"]
    log(f"[bwd-split] {case['case']} {case['shape']}: K5a {dq['ms']:.4f} ms (device "
        f"{fmt(dq['device_ms'])}), K5b {dkv['ms']:.4f} ms (device {fmt(dkv['device_ms'])}); "
        f"the two calls' device time {fmt(both)} ms; flash_bwd_flat (one prep) {flat_ms:.4f} "
        f"ms (device {fmt(flat_dev)}); SDPA bwd {dq['library_ms']:.4f} ms; bounds "
        f"{dq['bound_ms']:.4f} / {dkv['bound_ms']:.4f} ms; {card}")


def int8_gemm_context(card: str) -> None:
    """For context only (no kernel of the port): the int8 product of a W4A8
    linear, torch._int_mm (cuBLASLt) on w8.t(), against F.linear in bf16, at
    ffn.0's shape with the slice's 9360 tokens; and a check that w8.t() is
    taken as it is, with no copy of the weight."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(1)
    m, k, n = 9360, 5120, 13824

    def int8(shape):
        return torch.randint(-127, 128, shape, generator=gen, device="cuda",
                             dtype=torch.int32).to(torch.int8)

    a, w = int8((m, k)), int8((n, k))
    y = torch._int_mm(a, w.t())
    exact = torch.equal(y[:64, :256].double(), a[:64].double() @ w[:256].double().t())
    del y
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    y = torch._int_mm(a, w.t())
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base - y.numel() * y.element_size()
    del y
    int8_ms = median_ms(lambda: torch._int_mm(a, w.t()), 5)
    ab, wb = torch.randn((m, k), device="cuda", dtype=torch.bfloat16), w.to(torch.bfloat16)
    bf16_ms = median_ms(lambda: F.linear(ab, wb), 5)
    flops = 2 * m * k * n
    log(f"[int8-gemm] context only: torch._int_mm ({m}x{k} int8) x ({k}x{n} int8, w8.t()) "
        f"{int8_ms:.3f} ms ({flops / int8_ms / 1e9:.1f} TOP/s), F.linear bf16 {bf16_ms:.3f} ms "
        f"({flops / bf16_ms / 1e9:.1f} TFLOP/s); exact int32 {exact}; bytes allocated beyond "
        f"the output {extra} (a copy of w8 would be {w.numel()}); {card}")
    if not exact or extra >= w.numel():
        raise RuntimeError("torch._int_mm on w8.t() is not exact or copied the weight")
    del a, w, ab, wb
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 4: the inference slice
# ---------------------------------------------------------------------------


def tiny_pipeline(device, quantized: bool = False):
    """A tiny f32 pipeline; quantized=True gives its DiT one head of 128 (the
    int8 attention takes the flat layout), qk8pv8 attention (the mode the
    kernel takes in f32) and int4_w4a8 weights quantized on `device` (groups
    of 16, every linear of 1024 weights or more)."""
    from svi_tpu_torch.models import clip_vision, wan_dit, wan_vae
    from svi_tpu_torch.pipelines.svi_video import SVIVideoPipeline

    pipe = SVIVideoPipeline(device=device, torch_dtype=torch.float32)
    pipe.vae = wan_vae.init_params(wan_vae.WanVAEConfig(dim=16, z_dim=4), seed=1,
                                   device="cpu").to(device)
    width = dict(dim=128, ffn_dim=256, num_heads=1, attention_quant="qk8pv8") if quantized \
        else dict(dim=64, ffn_dim=128, num_heads=2)
    pipe.dit = wan_dit.init_params(wan_dit.WanDiTConfig(
        in_dim=12, out_dim=4, text_dim=48, freq_dim=32, num_layers=2, has_image_input=True,
        clip_feature_dim=64, dtype=torch.float32, **width), seed=2, device="cpu").to(device)
    if quantized:
        pipe.dit = wan_dit.quantize_params_for_inference(pipe.dit, "int4_w4a8", min_size=1024,
                                                         group=16, consume=True)
    pipe.image_encoder = clip_vision.init_params(clip_vision.ClipVisionConfig(
        image_size=28, patch_size=14, dim=64, mlp_ratio=2, num_heads=2, num_layers=2),
        seed=3, device="cpu").to(device)
    return pipe


def tiny_call_kwargs() -> dict:
    rng = np.random.default_rng(0)
    img = rng.integers(0, 255, (64, 64, 3), dtype=np.uint8)
    ctx = rng.standard_normal((1, 12, 48)).astype(np.float32)
    return dict(input_image=img, random_ref_frame=img, seed=0, height=64, width=64, num_frames=9,
                cfg_scale=5.0, num_inference_steps=3, tiled=False, prompt_emb_posi=ctx,
                prompt_emb_nega=ctx * 0.5, ref_pad_num=-1, return_latents=True)


def phase_small_reference():
    """The port on the card against the same port on the CPU (plain attention)."""
    from svi_tpu_torch.ops import attention as A

    kw = tiny_call_kwargs()
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


def phase_small_quantized():
    """The tiny pipeline with int4_w4a8 weights and qk8pv8 attention on the
    card (the W4A8 linear, K6) against the same on the CPU (the plain
    versions); the quantizers are bit-exact on both, so
    both start from the same int4 weights. First one DiT forward on the same
    inputs, then the pipeline."""
    pipes = {dev: tiny_pipeline(dev, quantized=True) for dev in ("cuda", "cpu")}
    rng = np.random.default_rng(3)
    inputs = [rng.standard_normal(shape).astype(np.float32) for shape in
              ((2, 4, 3, 8, 8), (2, 12, 48), (2, 5, 64), (2, 8, 3, 8, 8))]
    outs = {}
    with torch.inference_mode():
        for dev, pipe in pipes.items():
            x, ctx, clip, y = (torch.from_numpy(a).to(dev) for a in inputs)
            outs[dev] = pipe.dit(x, torch.tensor([731.0], device=dev), ctx, clip_feature=clip,
                                 y=y).cpu()
    fwd_rel = ((outs["cuda"] - outs["cpu"]).abs().max() / outs["cpu"].abs().max()).item()

    ok = fwd_rel <= SMALL_Q_FWD_REL
    log(f"[small-quant] card vs CPU, tiny int4_w4a8 + qk8pv8 DiT: one forward on the same "
        f"inputs, max abs err {fwd_rel:.3e} of the output's scale (bound {SMALL_Q_FWD_REL})")

    def drift(a, b):
        (frames_a, lat_a), (frames_b, lat_b) = a, b
        d = (lat_a.cpu() - lat_b).abs()
        px = int(np.abs(np.stack(frames_a).astype(int) - np.stack(frames_b).astype(int)).max())
        return d.max().item(), d.mean().item(), px

    for seed in SMALL_Q_SEEDS:
        kw = dict(tiny_call_kwargs(), seed=seed)
        zero_counts()
        got = pipes["cuda"](**kw)
        counts = read_counts()
        ref = pipes["cpu"](**kw)
        # the witness, on the CPU alone: the prompt embeddings moved by 1e-6
        # of their size, as the VAE and CLIP move the DiT's inputs on the card
        nudge = np.float32(1 + 1e-6)
        moved = pipes["cpu"](**dict(kw, prompt_emb_posi=kw["prompt_emb_posi"] * nudge,
                                    prompt_emb_nega=kw["prompt_emb_nega"] * nudge))
        (lat_max, lat_mean, px_err), witness = drift(got, ref), drift(moved, ref)
        ok = (ok and lat_max <= SMALL_Q_LAT_MAX and lat_mean <= SMALL_Q_LAT_MEAN
              and px_err <= SMALL_Q_FRAME_LEVELS and bool(torch.isfinite(got[1]).all())
              and min(counts[k] for k in QUANT_KERNELS) > 0)
        log(f"[small-quant] seed {seed}, the pipeline (smoke check): card vs CPU latents max "
            f"abs err {lat_max:.3e} (bound {SMALL_Q_LAT_MAX}), mean {lat_mean:.3e} (bound "
            f"{SMALL_Q_LAT_MEAN}), frames max diff {px_err} levels (bound "
            f"{SMALL_Q_FRAME_LEVELS}); witness, CPU vs CPU with the prompt embeddings moved by "
            f"1e-6: max {witness[0]:.3e}, mean {witness[1]:.3e}, {witness[2]} levels; card "
            f"launches {counts}")
    if not ok:
        raise RuntimeError("the quantized port on the card disagrees with the port on the CPU")


# The clip-level fidelity gate (tests/test_torch_fidelity.py runs it on the
# CPU against the JAX package, within 0.5 dB): the tiny pipeline with a bf16
# DiT (one head of 128), then that DiT quantized to w8a8 and to int4_w4a8 with
# qk8 attention; each device scores its quantized clip against its own bf16
# clip with clip_psnr, and the card's score must be within FIDELITY_CARD_DB of
# the CPU port's. Written before the first card run: bf16 and f32 sums in
# another order and an activation that lands on the other side of an int8
# rounding boundary move a score by a fraction of a dB; a wrong scale,
# packing or rounding mode moves it by tens. On seeded weights the scores
# only catch regressions (PERF.md); a threshold on the score itself waits
# for trained checkpoints.
FIDELITY_CARD_DB = 1.0
FIDELITY_MODES = ("w8a8", "int4_w4a8")
# The first card run broke FIDELITY_CARD_DB for w8a8 (card 46.817 dB, CPU
# 48.036 dB: a 1.219 dB gap; int4_w4a8 0.293 dB), while the CPU port on
# another machine read 45.783 dB for the same clips: near 47 dB a clip is
# within about one level of its bf16 clip, and bf16 sums in another order
# move the score by a dB or two (PERF.md, section 6). As phase 4c does for
# its int8 pipeline, the check of the quantized path is then one DiT forward
# on the same inputs, card against CPU, for the bf16 DiT and each quantized one:
# bf16 rounding through 2 blocks and an int8 level that flips (~1% of a
# row's largest value) stay within FIDELITY_FWD_REL of the output's scale,
# a wrong scale, packing or rounding mode moves the output by its own size.
# A clip gap over FIDELITY_CARD_DB is printed as broken and fails the run
# unless those forwards hold. (This bound was written after the first run.)
FIDELITY_FWD_REL = 5e-2
# the tiny multi-speaker audio attention (two speakers, 1-D RoPE class
# labels, f32 softmax in plain torch), card against CPU: f32 sums in another
# order, relative to the largest |output|
MULTITALK_CARD_REL = 1e-5


def fidelity_pipeline(device, mode):
    """The gate's tiny pipeline on `device`: phase 4a's VAE and CLIP (f32)
    with a bf16 DiT of one head of 128, quantized on `device` when mode is
    given (groups of 16, every linear of 1024 weights or more) with qk8
    attention."""
    from svi_tpu_torch.models import wan_dit

    pipe = tiny_pipeline(device)
    pipe.dit = wan_dit.init_params(wan_dit.WanDiTConfig(
        dim=128, in_dim=12, ffn_dim=256, out_dim=4, text_dim=48, freq_dim=32, num_heads=1,
        num_layers=2, has_image_input=True, clip_feature_dim=64, dtype=torch.bfloat16),
        seed=2, device="cpu").to(device)
    if mode is not None:
        pipe.dit = wan_dit.quantize_params_for_inference(pipe.dit, mode, min_size=1024,
                                                         group=16, consume=True)
        pipe.dit.cfg = dataclasses.replace(pipe.dit.cfg, attention_quant="qk8")
    return pipe


def phase_fidelity_gate(card: str) -> dict:
    """(a) The one-forward check of K6's f32 route: the tiny f32 DiT of phase
    4c with int4_w4a8 weights and qk8 attention (f32 v and out: route
    sm90_f32), card against CPU on the same inputs, within SMALL_Q_FWD_REL of
    the output's scale; its launches are the f32 route's on this path. (b)
    The clip-level gate: clip_psnr of the w8a8 and int4_w4a8 clips against
    the bf16 clip, on the card and on the CPU, within FIDELITY_CARD_DB.
    Returns (a)'s launches."""
    from svi_tpu_torch.ops import attention as A
    from svi_tpu_torch.utils.fidelity import clip_psnr

    pipes = {dev: tiny_pipeline(dev, quantized=True) for dev in ("cuda", "cpu")}
    for pipe in pipes.values():
        pipe.dit.cfg = dataclasses.replace(pipe.dit.cfg, attention_quant="qk8")
    rng = np.random.default_rng(5)
    inputs = [rng.standard_normal(shape).astype(np.float32) for shape in
              ((2, 4, 3, 8, 8), (2, 12, 48), (2, 5, 64), (2, 8, 3, 8, 8))]
    outs = {}
    with torch.inference_mode():
        for dev, pipe in pipes.items():
            x, ctx, clip, y = (torch.from_numpy(a).to(dev) for a in inputs)
            if dev == "cuda":
                zero_counts()
            outs[dev] = pipe.dit(x, torch.tensor([731.0], device=dev), ctx, clip_feature=clip,
                                 y=y).cpu()
            if dev == "cuda":
                torch.cuda.synchronize()
                launches = read_counts()
                routes = dict(A.flash_fwd_flat_q8.routes)
    del pipes
    fwd_rel = ((outs["cuda"] - outs["cpu"]).abs().max() / outs["cpu"].abs().max()).item()
    log(f"[fidelity] card vs CPU, tiny f32 int4_w4a8 + qk8 DiT (K6 route sm90_f32): one "
        f"forward on the same inputs, max abs err {fwd_rel:.3e} of the output's scale (bound "
        f"{SMALL_Q_FWD_REL}); int8 attention routes {routes}; {card}")
    if not (fwd_rel <= SMALL_Q_FWD_REL and launches["flash_fwd_flat_q8/sm90_f32"] > 0
            and set(k[0] for k in routes) == {"sm90_f32"}):
        raise RuntimeError("the f32 qk8 forward on the card disagrees with the CPU, or did not "
                           "take K6's f32 route")

    kw = tiny_call_kwargs()
    clips, fwd_rel = {}, {}
    for mode in (None,) + FIDELITY_MODES:
        outs = {}
        for dev in ("cuda", "cpu"):
            pipe = fidelity_pipeline(dev, mode)
            x, ctx, clip, y = (torch.from_numpy(a).to(dev) for a in inputs)
            with torch.inference_mode():
                outs[dev] = pipe.dit(x, torch.tensor([731.0], device=dev), ctx,
                                     clip_feature=clip, y=y).float().cpu()
            frames, _ = pipe(**kw)
            clips[dev, mode] = np.stack([np.asarray(fr) for fr in frames])
            del pipe
        fwd_rel[mode] = ((outs["cuda"] - outs["cpu"]).abs().max()
                         / outs["cpu"].abs().max()).item()
        log(f"[fidelity] one forward of the gate's {mode or 'bf16'} DiT on the same inputs, "
            f"card vs CPU: max abs err {fwd_rel[mode]:.3e} of the output's scale (bound "
            f"{FIDELITY_FWD_REL}); {card}")
    forwards_hold = all(v <= FIDELITY_FWD_REL for v in fwd_rel.values())
    ok = forwards_hold
    for mode in FIDELITY_MODES:
        scores = {dev: clip_psnr(clips[dev, mode], clips[dev, None]) for dev in ("cuda", "cpu")}
        gap = abs(scores["cuda"] - scores["cpu"])
        held = gap <= FIDELITY_CARD_DB
        ok = ok and all(np.isfinite(v) for v in scores.values())
        log(f"[fidelity] tiny pipeline, {mode} + qk8 against bf16: clip_psnr card "
            f"{scores['cuda']:.3f} dB, CPU {scores['cpu']:.3f} dB, gap {gap:.3f} dB (bound "
            f"{FIDELITY_CARD_DB}: {'held' if held else 'BROKEN, the one-forward checks decide'}"
            f"); {card}")
    if not ok:
        raise RuntimeError("the fidelity gate: a gate DiT's forward on the card disagrees with "
                           "the CPU port's, or a score is not finite")
    return launches


def phase_small_multitalk(card: str) -> None:
    """The multi-speaker audio attention (WanDiT.single_stream_multi_attention,
    two speakers with a reference map) of a tiny f32 multitalk DiT, card
    against CPU on the same inputs, within MULTITALK_CARD_REL."""
    from svi_tpu_torch.models import wan_dit
    from svi_tpu_torch.utils import multitalk

    cfg = wan_dit.WanDiTConfig(dim=64, in_dim=12, ffn_dim=128, out_dim=4, text_dim=48,
                               freq_dim=32, num_heads=2, num_layers=1, has_image_input=True,
                               clip_feature_dim=64, dtype=torch.float32, enable_multitalk=True,
                               audio_hidden_dim=32)
    rng = np.random.default_rng(6)
    f, s, na = 3, 8, 6
    x = rng.standard_normal((2, f * s, 64)).astype(np.float32)
    audio = rng.standard_normal((2, f, na, 32)).astype(np.float32)
    q = rng.standard_normal((1, f * s, 2, 32)).astype(np.float32)
    masks = np.zeros((2, s), np.float32)
    masks[0, :s // 2], masks[1, s // 2:] = 1, 1
    outs = {}
    for dev in ("cuda", "cpu"):
        dit = wan_dit.init_params(cfg, seed=7, device="cpu").to(dev)
        t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
        with torch.inference_mode():
            ref_map = multitalk.get_attn_map_with_target(t(q), t(q), (f, 2, s // 2), t(masks))
            outs[dev] = dit.single_stream_multi_attention(
                dit["blocks"][0]["audio_cross_attn"], t(x), t(audio), f, x_ref_attn_map=ref_map,
                human_num=2).cpu()
    rel = ((outs["cuda"] - outs["cpu"]).abs().max() / outs["cpu"].abs().max()).item()
    log(f"[multitalk] two-speaker audio attention of a tiny f32 DiT, card vs CPU: max abs err "
        f"{rel:.3e} of the output's scale (bound {MULTITALK_CARD_REL}); {card}")
    if not (torch.isfinite(outs["cuda"]).all() and rel <= MULTITALK_CARD_REL):
        raise RuntimeError("the multi-speaker audio attention on the card disagrees with the CPU")


class PhaseTimer:
    """Wraps a callable: synchronize, time it on the host clock, synchronize;
    also keeps the peak device memory (GiB since the last reset) at the end
    of each call."""

    def __init__(self):
        self.seconds: dict[str, list[float]] = {}
        self.peak_gib: dict[str, float] = {}

    def wrap(self, name, fn):
        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            self.seconds.setdefault(name, []).append(time.perf_counter() - t0)
            self.peak_gib[name] = torch.cuda.max_memory_allocated() / 2**30
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

    def timed_sample(latents, ctx_pos, ctx_neg, image_emb, cfg_scale, tea_cache=None, *rest):
        name = "denoise" if tea_cache is None else "denoise_teacache"
        return timer.wrap(name, sample)(latents, ctx_pos, ctx_neg, image_emb, cfg_scale,
                                        tea_cache, *rest)

    pipe._sample = timed_sample

    rng = np.random.default_rng(0)
    first = rng.integers(0, 255, (SLICE_H, SLICE_W, 3), dtype=np.uint8)
    anchor = rng.integers(0, 255, (SLICE_H, SLICE_W, 3), dtype=np.uint8)

    # the main path's run: counters from zero, read right after
    zero_counts()
    t_run = time.perf_counter()
    video, skipped = two_clips(pipe, first, anchor, ctx_pos, ctx_neg, "slice",
                               tea_cache_clip2=True)
    run_s = time.perf_counter() - t_run
    launches = read_counts()
    routes = check_fwd_routes("the bf16 inference path", need_f32=True)
    std = float(video.astype(np.float32).std())
    if min(launches[k] for k in ("flash_fwd_flat/sm90/128", "flash_fwd_flat/f32", "rope_rotate_flat",
                                 "flash_fwd_bnsd/f32")) <= 0:
        raise RuntimeError(f"a kernel was not launched on the main path: {launches}")
    secs = timer.seconds
    per_step = secs["denoise"][0] / SLICE_STEPS
    log(f"[slice] seconds: t5 {secs['t5'][0]:.3f}, clip {secs['clip']}, vae_encode "
        f"{secs['vae_encode']}, denoise step (no TeaCache) {per_step:.3f}, clip-2 denoise "
        f"with TeaCache {secs['denoise_teacache'][0]:.3f} for {SLICE_STEPS} steps, "
        f"vae_decode {secs['vae_decode']}")
    log(f"[slice] two clips {run_s:.2f}s, {video.shape[0]} frames, pixel std {std:.2f}, "
        f"TeaCache skipped {skipped} of {SLICE_STEPS} steps in clip 2, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, launches {launches}, forward "
        f"routes {routes}")
    return launches, dict(pipe=pipe, ctx_pos=ctx_pos, ctx_neg=ctx_neg, first=first,
                          anchor=anchor, clip1=video[:SLICE_FRAMES])


def check_tf32_invariance(state: dict, card: str) -> None:
    """The f32 policy (ops.conv.conv_f32): the VAE's encode and decode of
    the slice's first clip (480x832, 9 frames) and one forward of the pose
    embedding at the 14B's width (9 frames of 480x832) run twice, with cuDNN
    TF32 switched on for the process and off; the outputs must be the same
    bits, since the package runs every f32 convolution with TF32 off
    whatever the process sets."""
    from svi_tpu_torch.models import pose_embedding, wan_dit

    vae = state["pipe"].vae
    video = torch.from_numpy(state["clip1"]).cuda().permute(3, 0, 1, 2)[None].float() / 127.5 - 1
    pose = pose_embedding.init_params(wan_dit.WAN_14B_I2V.dim, seed=15, device="cuda")
    pose_video = torch.rand((1, 3, SLICE_FRAMES, SLICE_H, SLICE_W),
                            generator=torch.Generator(device="cuda").manual_seed(16),
                            device="cuda") * 255
    outs, secs = {}, {}
    saved = torch.backends.cudnn.allow_tf32
    try:
        for tf32 in (True, False):
            torch.backends.cudnn.allow_tf32 = tf32
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.inference_mode():
                lat = vae.encode(video)
                outs[tf32] = (lat, vae.decode(lat), pose(pose_video))
            torch.cuda.synchronize()
            secs[tf32] = time.perf_counter() - t0
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    same = [torch.equal(a, b) for a, b in zip(outs[True], outs[False])]
    finite = all(bool(torch.isfinite(t).all()) for t in outs[True])
    log(f"[tf32] VAE encode + decode of the slice's clip 1 {tuple(video.shape)} and the pose "
        f"embedding at dim {wan_dit.WAN_14B_I2V.dim} on {tuple(pose_video.shape)}: cuDNN TF32 "
        f"on {secs[True]:.3f}s, off {secs[False]:.3f}s; bit-identical (latents, frames, pose "
        f"tokens) {same}; {card}")
    if not (all(same) and finite):
        raise RuntimeError("an f32 convolution's result depends on the process's cuDNN TF32 "
                           "switch")


def two_clips(pipe, first, anchor, ctx_pos, ctx_neg, tag: str, tea_cache_clip2: bool = False,
              attention=None):
    """Two clips as the clip loop drives them: clip 2 is conditioned on clip
    1's last frame. attention: the DiT's attention_quant for each clip (None:
    leave it). Checks finite latents, the frame count, a uint8 video and
    pixel std > 1; returns the video and TeaCache's skipped steps in clip 2."""
    motion, all_frames, skipped = first, [], 0
    for clip in range(2):
        if attention is not None:
            pipe.dit.cfg = dataclasses.replace(pipe.dit.cfg, attention_quant=attention[clip])
        t0 = time.perf_counter()
        frames, latents = pipe(
            input_image=motion, random_ref_frame=anchor, seed=clip,
            height=SLICE_H, width=SLICE_W, num_frames=SLICE_FRAMES, cfg_scale=5.0,
            num_inference_steps=SLICE_STEPS, tiled=False,
            prompt_emb_posi=ctx_pos, prompt_emb_nega=ctx_neg, ref_pad_num=-1,
            tea_cache_l1_thresh=0.3 if clip == 1 and tea_cache_clip2 else None,
            tea_cache_model_id="Wan2.1-I2V-14B-480P", return_latents=True,
        )
        if not torch.isfinite(latents).all():
            raise RuntimeError(f"{tag} clip {clip + 1}: latents are not finite")
        if len(frames) != SLICE_FRAMES:
            raise RuntimeError(f"{tag} clip {clip + 1}: {len(frames)} frames, expected "
                               f"{SLICE_FRAMES}")
        if clip == 1 and tea_cache_clip2:
            skipped = pipe.last_tea_cache.skipped_steps
        all_frames += frames if clip == 0 else frames[MOTION:]
        motion = frames[-MOTION:]
        quant = f" ({pipe.dit.cfg.attention_quant} attention)" if attention is not None else ""
        log(f"[{tag}] clip {clip + 1}{quant}: {len(frames)} frames in "
            f"{time.perf_counter() - t0:.2f}s")
    torch.cuda.synchronize()
    video = np.stack(all_frames)
    expect = (SLICE_FRAMES + SLICE_FRAMES - MOTION, SLICE_H, SLICE_W, 3)
    if video.shape != expect or video.dtype != np.uint8:
        raise RuntimeError(f"{tag}: video {video.shape} {video.dtype}, expected {expect} uint8")
    std = float(video.astype(np.float32).std())
    if not std > 1.0:
        raise RuntimeError(f"{tag}: pixel std {std} <= 1.0")
    return video, skipped


def timed_forward(fn):
    """fn as a callable that keeps its output in `.out` and its synchronized
    wall seconds in `.seconds`, so that one run is both timed and profiled."""
    def run():
        t0 = time.perf_counter()
        run.out = fn()
        torch.cuda.synchronize()
        run.seconds = time.perf_counter() - t0

    return run


def device_time_breakdown(fn) -> str:
    """Runs fn() once under torch.profiler (CUDA activity) and returns its
    device time by kind of kernel, the device-busy share of the wall time
    (which the profiler slows a little) and the largest kernels; or 'not
    measured' when the profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    groups, kernels = {}, []
    for evt in prof.key_averages():
        sec = getattr(evt, "self_device_time_total", 0.0) / 1e6
        if sec <= 0:
            continue
        name = evt.key
        low = name.lower()
        if "unpack_requant" in name:
            group = "K3"
        elif "w4a8_gemm" in name:
            group = "W4A8 GEMM"
        elif "w4a8_quantize_rows" in name:
            group = "W4A8 pre-pass"
        elif "flash_fwd_q8" in name:
            group = "K6"
        elif "flash_fwd" in name:  # flash_fwd_sm90.cu with its RoPE pre-pass, flash_fwd_f32.cu
            group = "K1/K2"
        elif "flash_bwd" in name or "finalize_grad" in name:
            group = "K4/K5"
        elif any(w in low for w in ("fprop", "dgrad", "wgrad", "conv")):  # cuDNN convolutions
            group = "convs"
        elif any(w in low for w in ("gemm", "cutlass", "xmma", "nvjet")):
            group = "GEMMs"
        else:
            group = "elementwise and other"
        groups[group] = groups.get(group, 0.0) + sec
        kernels.append((sec, evt.count, name[:70]))
    total = sum(groups.values())
    if total == 0:
        return "not measured (the profiler recorded no device time)"
    parts = ", ".join(f"{g} {t:.3f}s ({100 * t / total:.1f}%)"
                      for g, t in sorted(groups.items(), key=lambda kv: -kv[1]))
    top = "; ".join(f"{name} x{n} {t:.3f}s" for t, n, name in sorted(kernels, reverse=True)[:8])
    return (f"wall {wall:.3f}s, device busy {total:.3f}s ({100 * total / wall:.1f}%): {parts}; "
            f"largest: {top}")


def phase_forward_81f(state: dict) -> None:
    """One 14B bf16 DiT forward at the production token count, 480x832x81
    (21 x 60 x 104 latents, 32760 tokens, batched CFG: B=2), on phase 4b's
    DiT with seeded inputs, under the profiler: its seconds (the profiler's
    cost at this size is within the run-to-run spread: 7.020 s profiled
    against 7.035 s alone on the H100), peak memory and device time by kind
    of kernel."""
    pipe = state["pipe"]
    lt, lh, lw = (FORWARD_FRAMES - 1) // 4 + 1, SLICE_H // 8, SLICE_W // 8
    gen = torch.Generator(device="cuda").manual_seed(7)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    cfg = pipe.dit.cfg
    args = (randn(2, 16, lt, lh, lw), pipe.scheduler.timesteps[:1].cuda(),
            torch.cat([state["ctx_pos"], state["ctx_neg"]]),
            randn(2, 257, cfg.clip_feature_dim), randn(2, cfg.in_dim - 16, lt, lh, lw))
    tokens = lt * lh * lw // 4
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    with torch.inference_mode():
        run = timed_forward(lambda: pipe.dit(*args))
        profile = device_time_breakdown(run)
        out, seconds = run.out, run.seconds
        peak = torch.cuda.max_memory_allocated() / 2**30
        routes = check_fwd_routes("the 81-frame forward")
        if out.shape != args[0].shape or not torch.isfinite(out).all():
            raise RuntimeError(f"the 81-frame forward gave {tuple(out.shape)}, or non-finite "
                               "values")
        del out, run
        log(f"[forward-81f] 14B bf16 DiT, one forward at {SLICE_H}x{SLICE_W}x{FORWARD_FRAMES} "
            f"(B2 S{tokens}, under the profiler): {seconds:.3f}s, peak memory {peak:.2f} GiB, "
            f"forward routes {routes}")
        log(f"[forward-81f] profile: {profile}")
    del args
    torch.cuda.empty_cache()


def phase_quantized_slice(state: dict):
    """Quantized inference at full width on phase 4b's pipeline: one DiT
    forward (480x832x9, batched CFG) in bf16, then the DiT quantized in place
    to int4_w4a8 (consume=True frees each bf16 weight as its int4 leaves are
    made) and the same forward with qk8 attention; then two clips, clip 1
    with qk8 and clip 2 with qk8pv8 attention, no TeaCache. The forward and
    the clips fail unless every quantized linear took w4a8_linear and every
    int8 attention the sm90 kernel (`check_quant_path`)."""
    from svi_tpu_torch.models import wan_dit
    from svi_tpu_torch.ops import attention as A

    pipe, ctx_pos, ctx_neg = state["pipe"], state["ctx_pos"], state["ctx_neg"]
    timer = PhaseTimer()
    lt, lh, lw = (SLICE_FRAMES - 1) // 4 + 1, SLICE_H // 8, SLICE_W // 8
    with torch.inference_mode():
        emb = pipe.encode_images_adaptive(state["first"], state["anchor"], SLICE_FRAMES,
                                          SLICE_H, SLICE_W, ref_pad_num=-1)
        gen = torch.Generator(device="cuda").manual_seed(5)
        lat = torch.randn((1, 16, lt, lh, lw), generator=gen, device="cuda").to(torch.bfloat16)
        args = (torch.cat([lat, lat]), pipe.scheduler.timesteps[:1].cuda(),
                torch.cat([ctx_pos, ctx_neg]), torch.cat([emb["clip_feature"]] * 2),
                torch.cat([emb["y"]] * 2))
        out_bf16 = timer.wrap("forward_bf16", pipe.dit)(*args)
        log(f"[quant] profile of the bf16 forward: {device_time_breakdown(lambda: pipe.dit(*args))}")
    dit_bytes_bf16 = sum(p.numel() * p.element_size() for p in pipe.dit.parameters())

    t0 = time.perf_counter()
    with torch.no_grad():
        pipe.dit = wan_dit.quantize_params_for_inference(pipe.dit, "int4_w4a8", consume=True)
    pipe.dit.cfg = dataclasses.replace(pipe.dit.cfg, attention_quant="qk8")
    torch.cuda.synchronize()
    quantize_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    dit_bytes = sum(p.numel() * p.element_size() for p in pipe.dit.parameters())
    n_q4 = sum(1 for name, _ in pipe.dit.named_parameters() if name.endswith("w_q4"))
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode(), count_int_mm() as int_mm:
        zero_counts()
        out_q = timer.wrap("forward_w4a8_qk8", pipe.dit)(*args)
        check_quant_path("the W4A8 + qk8 forward", read_counts(), int_mm, n_q4, forwards=1)
        log("[quant] profile of the W4A8 + qk8 forward: "
            f"{device_time_breakdown(lambda: pipe.dit(*args))}")
    if not torch.isfinite(out_q).all():
        raise RuntimeError("the quantized DiT forward is not finite")
    rel = ((out_q.float() - out_bf16.float()).abs().mean()
           / out_bf16.float().abs().mean()).item()
    log(f"[quant] DiT int4_w4a8: {n_q4} linears packed in {quantize_s:.2f}s, DiT bytes "
        f"{dit_bytes / 2**30:.2f} GiB (bf16 {dit_bytes_bf16 / 2**30:.2f} GiB); one forward "
        f"(B2 S{lt * lh * lw // 4}) bf16 {timer.seconds['forward_bf16'][0]:.3f}s, W4A8 + qk8 "
        f"{timer.seconds['forward_w4a8_qk8'][0]:.3f}s; mean relative difference of the "
        f"outputs {rel:.4f} (bound {QUANT_FWD_REL})")
    if not rel <= QUANT_FWD_REL:
        raise RuntimeError("the quantized DiT forward is as far from the bf16 one as its size")

    pipe.image_encoder.encode_image = timer.wrap("clip", pipe.image_encoder.encode_image)
    pipe.vae.encode = timer.wrap("vae_encode", pipe.vae.encode)
    pipe.vae.decode = timer.wrap("vae_decode", pipe.vae.decode)
    pipe._sample = timer.wrap("denoise", pipe._sample)
    # the quantized path's run: counters from zero, read right after
    with count_int_mm() as int_mm:
        zero_counts()
        t_run = time.perf_counter()
        video, _ = two_clips(pipe, state["first"], state["anchor"], ctx_pos, ctx_neg, "quant",
                             attention=("qk8", "qk8pv8"))
        run_s = time.perf_counter() - t_run
        launches = read_counts()
    std = float(video.astype(np.float32).std())
    check_quant_path("the quantized clips", launches, int_mm, n_q4)
    secs = timer.seconds
    per_step = [s / SLICE_STEPS for s in secs["denoise"]]
    log(f"[quant] seconds: clip {secs['clip']}, vae_encode {secs['vae_encode']}, denoise step "
        f"qk8 {per_step[0]:.3f}, qk8pv8 {per_step[1]:.3f}, vae_decode {secs['vae_decode']}")
    log(f"[quant] two clips {run_s:.2f}s, {video.shape[0]} frames, pixel std {std:.2f}, peak "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, DiT "
        f"{dit_bytes / 2**30:.2f} GiB, launches {launches}, int8 attention routes "
        f"{dict(A.flash_fwd_flat_q8.routes)}")
    state["n_q4"] = n_q4
    return launches


class count_int_mm:
    """Counts torch._int_mm calls inside the block (the int8 GEMM the W4A8
    path used before w4a8_linear; W8A8 still calls it)."""

    def __enter__(self):
        self.calls, self._orig = 0, torch._int_mm

        def counted(*args, **kwargs):
            self.calls += 1
            return self._orig(*args, **kwargs)

        torch._int_mm = counted
        return self

    def __exit__(self, *exc):
        torch._int_mm = self._orig


def check_quant_path(path: str, launches: dict, int_mm: count_int_mm, n_q4: int,
                     forwards: int | None = None, int8_attention: bool = True) -> None:
    """Fails unless every quantized linear of the path went through
    w4a8_linear (n_q4 launches a forward, as many of its pre-pass; `forwards`
    forwards when given), with no K3 and no torch._int_mm launch, and every
    int8 attention launch took the sm90 kernel (int8_attention=False: the
    path quantizes weights only, and no int8 attention ran)."""
    from svi_tpu_torch.ops import attention as A
    from svi_tpu_torch.ops import quant_matmul as Q

    n = launches["w4a8_linear"]
    per_forward = n == launches["quantize_rows_int8"] and n > 0 and n % n_q4 == 0 and (
        forwards is None or n == forwards * n_q4)
    routes = dict(A.flash_fwd_flat_q8.routes)
    if not per_forward or Q.unpack_requant_int4.launches or int_mm.calls:
        raise RuntimeError(f"{path}: {n} w4a8_linear launches for {n_q4} quantized linears a "
                           f"forward, {Q.unpack_requant_int4.launches} K3 launches, "
                           f"{int_mm.calls} torch._int_mm calls: {launches}")
    if not int8_attention:
        if routes:
            raise RuntimeError(f"{path}: int8 attention ran on a weights-only path: {routes}")
    elif not routes or any(key[0] != "sm90" for key in routes):
        raise RuntimeError(f"{path}: an int8 attention launch took a route other than sm90, "
                           f"or none ran: {routes}")
    log(f"[quant] {path}: {n} w4a8_linear launches ({n // n_q4} forwards x {n_q4} linears), "
        f"0 K3, 0 torch._int_mm; int8 attention routes {routes}")


def phase_quantized_81f(state: dict) -> None:
    """One W4A8 + qk8 forward of the quantized 14B DiT at 480x832x81 (B2
    S32760, seeded inputs as in the bf16 81-frame forward), under the
    profiler: its seconds, peak memory and device time by kind of kernel."""
    pipe = state["pipe"]
    pipe.dit.cfg = dataclasses.replace(pipe.dit.cfg, attention_quant="qk8")
    lt, lh, lw = (FORWARD_FRAMES - 1) // 4 + 1, SLICE_H // 8, SLICE_W // 8
    gen = torch.Generator(device="cuda").manual_seed(7)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    cfg = pipe.dit.cfg
    args = (randn(2, 16, lt, lh, lw), pipe.scheduler.timesteps[:1].cuda(),
            torch.cat([state["ctx_pos"], state["ctx_neg"]]),
            randn(2, 257, cfg.clip_feature_dim), randn(2, cfg.in_dim - 16, lt, lh, lw))
    tokens = lt * lh * lw // 4
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode(), count_int_mm() as int_mm:
        zero_counts()
        run = timed_forward(lambda: pipe.dit(*args))
        profile = device_time_breakdown(run)
        out, seconds = run.out, run.seconds
        peak = torch.cuda.max_memory_allocated() / 2**30
        check_quant_path("the 81-frame W4A8 + qk8 forward", read_counts(), int_mm,
                         state["n_q4"], forwards=1)
        if out.shape != args[0].shape or not torch.isfinite(out).all():
            raise RuntimeError(f"the 81-frame quantized forward gave {tuple(out.shape)}, or "
                               "non-finite values")
        del out, run
        log(f"[forward-81f-quant] 14B W4A8 + qk8 DiT, one forward at {SLICE_H}x{SLICE_W}x"
            f"{FORWARD_FRAMES} (B2 S{tokens}, under the profiler): {seconds:.3f}s, peak memory "
            f"{peak:.2f} GiB")
        log(f"[forward-81f-quant] profile: {profile}")
    del args
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the driver phase: checkpoint files -> the user's entry point -> frames
# ---------------------------------------------------------------------------

# Wan2.1-I2V-14B-480P at full width, cut in depth only because about 10 GB
# are written and read back inside the run (the full-depth DiT runs in 4b)
DRIVER_DIT_BLOCKS, DRIVER_T5_LAYERS, DRIVER_LORA_RANK = 4, 2, 128
DRIVER_LORA_TARGETS = tuple(f"{a}.{m}" for a in ("self_attn", "cross_attn") for m in "qkvo") + (
    "ffn.0", "ffn.2")
DRIVER_LORA_CHECKED = "blocks.1.self_attn.q.weight"
# mean |tiled - untiled decode| of the same latents, [-1, 1] units, at the
# driver's tiles (PERF.md, PR 8 findings: the sound reading and those of two
# wrong assemblies)
DECODE_TILED_GAP = 0.02
# tensors held bit for bit after the load (untouched by the LoRA), per file
DRIVER_SAMPLES = {
    "wan_video_dit": ("patch_embedding.weight", "blocks.3.cross_attn.k_img.weight",
                      "blocks.0.modulation", "head.modulation", "img_emb.proj.1.weight"),
    "wan_video_text_encoder": ("blocks.1.ffn.fc2.weight", "blocks.0.pos_embedding.embedding.weight",
                               "norm.weight"),
    "wan_video_image_encoder": ("visual.transformer.31.mlp.2.weight", "visual.pos_embedding",
                                "visual.patch_embedding.weight"),
    "wan_video_vae": ("decoder.head.2.weight", "encoder.middle.1.to_qkv.weight",
                      "decoder.upsamples.3.resample.1.weight"),
}
DRIVER_FILES = {"wan_video_text_encoder": "models_t5_umt5-xxl-enc-bf16.pth",
                "wan_video_vae": "Wan2.1_VAE.pth",
                "wan_video_image_encoder":
                    "models_clip_open-clip-xlm-roberta-large-vit-huge-14.pth"}


def write_driver_checkpoints(root: Path) -> dict:
    """(a) The files a user points the driver at, in the reference's names
    and formats, with seeded weights made on the card: the DiT in bf16 as two
    safetensors shards, umT5-XXL bf16 .pth, CLIP ViT-H/14 and the VAE f32
    .pth, a rank-128 peft LoRA, the tokenizer (the vendored T5 model stands
    in for umT5's) and a 480x832 reference image as .npy. Returns the host
    copies of the tensors checked after the load."""
    import shutil

    from svi_tpu_torch.models import clip_vision, t5, wan_dit, wan_vae
    from svi_tpu_torch.utils.safetensors_io import save_file

    kept, sizes, seconds = {}, {}, {}
    t0 = time.perf_counter()
    dit = wan_dit.init_params(dataclasses.replace(wan_dit.WAN_14B_I2V,
                                                  num_layers=DRIVER_DIT_BLOCKS), seed=21,
                              device="cuda")
    sd = wan_dit.torch_state_dict_from_params(dit)
    first = {k: v for k, v in sd.items() if not k.startswith(("blocks.2.", "blocks.3."))}
    shard = "diffusion_pytorch_model-0000{}-of-00002.safetensors"
    sizes["dit"] = save_file(first, str(root / shard.format(1)))
    sizes["dit"] += save_file({k: v for k, v in sd.items() if k not in first},
                              str(root / shard.format(2)))
    kept["wan_video_dit"] = {k: sd[k].cpu() for k in DRIVER_SAMPLES["wan_video_dit"]
                             + (DRIVER_LORA_CHECKED,)}
    del dit, sd, first
    torch.cuda.empty_cache()
    seconds["dit"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(22)
    lora, d, f = {}, wan_dit.WAN_14B_I2V.dim, wan_dit.WAN_14B_I2V.ffn_dim
    for i in range(DRIVER_DIT_BLOCKS):
        for target in DRIVER_LORA_TARGETS:
            fo, fi = {"ffn.0": (f, d), "ffn.2": (d, f)}.get(target, (d, d))
            key = f"diffusion_model.blocks.{i}.{target}"
            a = torch.randn((DRIVER_LORA_RANK, fi), generator=gen, device="cuda") / fi ** 0.5
            b = torch.randn((fo, DRIVER_LORA_RANK), generator=gen, device="cuda") * 1e-2
            lora[f"{key}.lora_A.default.weight"] = a.to(torch.bfloat16)
            lora[f"{key}.lora_B.default.weight"] = b.to(torch.bfloat16)
    sizes["lora"] = save_file(lora, str(root / "svi-shot.safetensors"))
    prefix = "diffusion_model." + DRIVER_LORA_CHECKED.removesuffix(".weight")
    kept["lora"] = {k: lora[f"{prefix}.lora_{k}.default.weight"].cpu() for k in "AB"}
    del lora
    seconds["lora"] = time.perf_counter() - t0

    for kind, make in (
            ("wan_video_text_encoder", lambda: t5.torch_state_dict_from_params(t5.init_params(
                dataclasses.replace(t5.UMT5_XXL, num_layers=DRIVER_T5_LAYERS), seed=23,
                device="cuda"))),
            ("wan_video_image_encoder", lambda: clip_vision.torch_state_dict_from_params(
                clip_vision.init_params(clip_vision.VIT_H_14, seed=24, device="cuda"))),
            ("wan_video_vae", lambda: wan_vae.torch_state_dict_from_params(
                wan_vae.init_params(wan_vae.WAN_VAE, seed=25, device="cuda")))):
        t0 = time.perf_counter()
        sd = make()
        if kind == "wan_video_text_encoder":  # the reference's file is bf16 throughout
            sd = {k: v.to(torch.bfloat16) for k, v in sd.items()}
        sd = {k: v.cpu() for k, v in sd.items()}
        torch.save(sd, root / DRIVER_FILES[kind])
        sizes[kind] = (root / DRIVER_FILES[kind]).stat().st_size
        kept[kind] = {k: sd[k] for k in DRIVER_SAMPLES[kind]}
        del sd
        torch.cuda.empty_cache()
        seconds[kind] = time.perf_counter() - t0

    tok = root / "google" / "umt5-xxl"
    tok.mkdir(parents=True)
    shutil.copy(REPO / "svi_tpu_torch" / "tokenizer_configs" / "t5" / "spiece.model", tok)
    rng = np.random.default_rng(26)
    np.save(root / "frame.npy", rng.integers(0, 255, (SLICE_H, SLICE_W, 3), dtype=np.uint8))
    log(f"[driver] wrote {sum(sizes.values()) / 1e9:.3f} GB: "
        + ", ".join(f"{k} {sizes[k] / 1e9:.3f} GB in {seconds[k]:.2f}s" for k in sizes))
    return kept


class timed_methods:
    """Wraps methods of classes with a PhaseTimer inside the block: the driver
    makes its objects itself, so they are timed through their classes."""

    def __init__(self, timer: PhaseTimer, targets: list):
        self.timer, self.targets = timer, targets

    def __enter__(self):
        self.saved = []
        for cls, name, label in self.targets:
            raw = cls.__dict__[name]
            self.saved.append((cls, name, raw))
            fn = raw.__func__ if isinstance(raw, staticmethod) else raw
            wrapped = self.timer.wrap(label, fn)
            setattr(cls, name, staticmethod(wrapped) if isinstance(raw, staticmethod) else wrapped)
        return self

    def __exit__(self, *exc):
        for cls, name, raw in self.saved:
            setattr(cls, name, raw)


def run_driver(root: Path, tag: str, extra: list[str], card: str):
    """(b), (c) One in-process run of the port's driver on the files under
    `root`: launch counts zeroed just before and read just after, per-phase
    seconds and peak memory, beside the card's name and power limit. Returns
    (record, launches, timer)."""
    from svi_tpu_torch.models.clip_vision import ClipVision
    from svi_tpu_torch.models.model_io import ModelManager
    from svi_tpu_torch.models.wan_vae import WanVAE
    from svi_tpu_torch.pipelines.svi_video import SVIVideoPipeline
    from svi_tpu_torch.scripts import test_svi

    argv = ["--dit_root", str(root), "--extra_module_root", str(root / "svi-shot.safetensors"),
            "--output", str(root / f"videos_{tag}"),
            "--ref_image_path", str(root / "frame.npy"),
            "--prompt_path", str(REPO / "data" / "toy_test" / "shot" / "prompt.txt"),
            "--num_frames", str(SLICE_FRAMES), "--num_steps", str(SLICE_STEPS),
            "--num_motion_frames", str(MOTION), "--ref_pad_num", "-1", "--cfg_scale_text", "5.0",
            "--save_format", "npy", *extra]
    timer = PhaseTimer()
    targets = [(ModelManager, "load_models", "load"), (ModelManager, "load_lora_v2", "lora_fuse"),
               (SVIVideoPipeline, "from_model_manager", "pipeline_ready"),
               (SVIVideoPipeline, "encode_prompt", "tokenize_t5"),
               (ClipVision, "encode_image", "clip"), (WanVAE, "encode", "vae_encode"),
               (WanVAE, "decode", "vae_decode"), (WanVAE, "tiled_decode", "vae_tiled_decode"),
               (SVIVideoPipeline, "_sample", "denoise")]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with timed_methods(timer, targets):
        zero_counts()
        t0 = time.perf_counter()
        record = test_svi.main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = read_counts()
    sec = timer.seconds
    (sample,) = record["samples"]
    log(f"[driver {tag}] {' '.join(extra)}: {seconds:.2f}s in all; load {sec['load'][0]:.2f}s "
        f"(peak {timer.peak_gib['load']:.2f} GiB), LoRA fuse {max(sec['lora_fuse']):.2f}s "
        f"{record['manager'].lora_log}, pipeline ready {sec['pipeline_ready'][0]:.2f}s (peak of "
        f"the load {timer.peak_gib['pipeline_ready']:.2f} GiB); tokenize + T5 "
        f"{[round(x, 3) for x in sec['tokenize_t5']]}, CLIP {[round(x, 3) for x in sec['clip']]}, "
        f"VAE encode {[round(x, 3) for x in sec['vae_encode']]}, VAE decode "
        f"{[round(x, 3) for x in sec.get('vae_decode', [])]} (per tile when tiled), tiled decode "
        f"{[round(x, 3) for x in sec.get('vae_tiled_decode', [])]}, denoise per step "
        f"{[round(x / SLICE_STEPS, 3) for x in sec['denoise']]}, clip seconds "
        f"{[round(c['seconds'], 2) for c in sample['clips']]}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches {launches}; {card}")
    return record, launches, timer


GRADIO_CLIPS, GRADIO_STEPS, GRADIO_SEED = 2, 2, 3
GRADIO_PROMPTS = "A lone explorer walks across rolling green hills.\nThe explorer pauses at the top."


def phase_gradio_core(root: Path, card: str) -> None:
    """(e') The gradio demo's core without gradio: `SVIGradioDemo.initialize_models`
    on the driver's files (film mode, its LoRA pointed at the driver's LoRA
    file), `generate_video` for GRADIO_CLIPS clips of SLICE_FRAMES frames at
    GRADIO_STEPS steps from the driver's reference image (.npy), then the
    same SVIVideoPipeline calls made by hand on the demo's pipeline: every
    streamed cumulative video must equal the hand-made one bit for bit, and
    both runs must launch K1 sm90 alike (counted, more than 0)."""
    from svi_tpu_torch.scripts import gradio_demo as gd
    from svi_tpu_torch.utils.image_process import calculate_dimensions, resize_uint8

    modes = {**gd.MODEL_MODES, "film": {**gd.MODEL_MODES["film"],
                                        "lora_path": str(root / "svi-shot.safetensors")}}
    frame = np.load(root / "frame.npy")
    with patched([(gd, "MODEL_MODES", modes)]):
        demo = gd.SVIGradioDemo(str(root), output_dir=str(root / "gradio"), mode="film",
                                save_format="npy")
        t0 = time.perf_counter()
        status = demo.initialize_models()
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        zero_counts()
        t0 = time.perf_counter()
        streamed = list(demo.generate_video(
            frame, GRADIO_PROMPTS, num_clips=GRADIO_CLIPS, num_steps=GRADIO_STEPS,
            seed=GRADIO_SEED, num_frames=SLICE_FRAMES, max_width=SLICE_W))
        torch.cuda.synchronize()
        demo_s = time.perf_counter() - t0
        demo_launches = read_counts()
        cfg = gd.MODEL_MODES["film"]
    pipe = demo.pipe
    height, width = calculate_dimensions(frame, max_width=SLICE_W)
    ref = resize_uint8(frame, width, height)
    nmf = cfg["num_motion_frames"]
    prompts = gd.SVIGradioDemo.parse_prompts(GRADIO_PROMPTS)
    motion, by_hand, stages = [ref] * nmf, [], []
    zero_counts()
    t0 = time.perf_counter()
    for clip in range(GRADIO_CLIPS):
        video = pipe(prompt=prompts[clip % len(prompts)], negative_prompt=gd.NEGATIVE,
                     input_image=motion, num_frames=SLICE_FRAMES,
                     num_inference_steps=GRADIO_STEPS, cfg_scale=dict(text=5.0),
                     seed=clip * GRADIO_SEED, tiled=False, random_ref_frame=ref,
                     height=height, width=width, ref_pad_num=cfg["ref_pad_num"])
        motion = video[-nmf:]
        by_hand += video[:-nmf] if clip < GRADIO_CLIPS - 1 else video
        stages.append(np.stack(by_hand))
    torch.cuda.synchronize()
    hand_s = time.perf_counter() - t0
    hand_launches = read_counts()
    got = [np.load(path) for _, path in streamed[:-1]]
    equal = [bool(a.shape == b.shape and np.array_equal(a, b)) for a, b in zip(got, stages)]
    k1 = (demo_launches["flash_fwd_flat/sm90/128"], hand_launches["flash_fwd_flat/sm90/128"])
    info = json.loads((Path(streamed[-1][1]).parent / "generation_info.json").read_text())
    log(f"[gradio] {status}: load {load_s:.2f}s; generate_video {GRADIO_CLIPS} clips of "
        f"{SLICE_FRAMES} frames, {GRADIO_STEPS} steps at {width}x{height}: {demo_s:.2f}s, "
        f"streamed {[s for s, _ in streamed]}; cumulative videos {[g.shape for g in got]} "
        f"bit-equal to the hand-made calls ({hand_s:.2f}s): {equal}; K1 sm90 launches demo / "
        f"by hand {k1}; generation_info {info['video_dimensions']} "
        f"{info['cumulative_videos']}; {card}")
    if len(got) != GRADIO_CLIPS or not all(equal) or float(got[-1].std()) <= 1.0:
        raise RuntimeError("the gradio core's streamed videos are not the hand-made calls' "
                           "frames, bit for bit, or are flat")
    if not (k1[0] > 0 and k1[0] == k1[1]):
        raise RuntimeError(f"the gradio core launched K1 sm90 {k1[0]} times, by hand {k1[1]}")
    check_fwd_routes("the gradio core", need_f32=True)
    del demo, pipe


def check_driver_video(tag: str, sample: dict, clips: int) -> None:
    video = np.load(sample["path"])
    expect = (clips * SLICE_FRAMES - (clips - 1) * MOTION, SLICE_H, SLICE_W, 3)
    std = float(video.astype(np.float32).std())
    if video.shape != expect or video.dtype != np.uint8 or not std > 1.0:
        raise RuntimeError(f"[driver {tag}] stitched video {video.shape} {video.dtype} with pixel "
                           f"std {std}, expected {expect} uint8 with std > 1")
    log(f"[driver {tag}] stitched {video.shape} uint8, pixel std {std:.2f}; seeds and prompts "
        f"{[(c['seed'], c['prompt'][:30]) for c in sample['clips']]}")


def check_tiled_decode(pipe, lat, card: str) -> None:
    """The driver's tiled decode on the card against the untiled decode of
    the same latents: mean |tiled - untiled| in [-1, 1] units within
    DECODE_TILED_GAP. Two wrong assemblies are read beside it and must
    exceed the bound: the same tiles blended without their feathered masks
    (a plain mean where they overlap), and the tiled frames one latent unit
    (8 px) off."""
    from svi_tpu_torch.models import wan_vae
    from svi_tpu_torch.scripts import test_svi

    flags = test_svi.parse_args([])
    tiles = dict(tiled=True, tile_size=tuple(flags.tile_size), tile_stride=tuple(flags.tile_stride))
    feathered = wan_vae.build_mask
    with torch.inference_mode():
        whole = pipe.decode_video(lat, tiled=False)
        tiled = pipe.decode_video(lat, **tiles)
        wan_vae.build_mask = lambda shape, is_bound, border, device=None: feathered(
            shape, (True,) * 4, border, device)
        try:
            unfeathered = pipe.decode_video(lat, **tiles)
        finally:
            wan_vae.build_mask = feathered
        gaps = {name: (v - whole).abs() for name, v in
                (("tiled", tiled), ("unfeathered", unfeathered),
                 ("misplaced", tiled.roll(8, dims=-1)))}
    read = {k: (g.mean().item(), g.max().item()) for k, g in gaps.items()}
    log(f"[driver b-tiled] tiled decode {tuple(tiled.shape)} against the untiled decode of the "
        f"same latents, mean / max |difference| in [-1, 1] units: "
        + ", ".join(f"{k} {m:.5f} / {x:.4f}" for k, (m, x) in read.items())
        + f"; bound on the mean {DECODE_TILED_GAP}; {card}")
    if not torch.isfinite(tiled).all() or tiled.shape != whole.shape:
        raise RuntimeError(f"tiled decode gave {tuple(tiled.shape)} or non-finite values")
    if not read["tiled"][0] <= DECODE_TILED_GAP:
        raise RuntimeError(f"the tiled decode is {read['tiled'][0]:.5f} from the untiled one, "
                           f"over {DECODE_TILED_GAP}")
    missed = [k for k in ("unfeathered", "misplaced") if not read[k][0] > DECODE_TILED_GAP]
    if missed:
        raise RuntimeError(f"the bound {DECODE_TILED_GAP} does not tell {missed} from the sound "
                           f"tiled decode: {read}")


def check_loaded_tensors(mm, kept: dict) -> None:
    """The sampled tensors of each loaded model, under the reference's names,
    equal the written ones bit for bit (umT5's f32 position tables as the
    bf16 written)."""
    from svi_tpu_torch.models import clip_vision, t5, wan_dit, wan_vae

    modules = {"wan_video_dit": wan_dit, "wan_video_text_encoder": t5, "wan_video_vae": wan_vae,
               "wan_video_image_encoder": clip_vision}
    for kind, module in modules.items():
        loaded = module.torch_state_dict_from_params(mm.models[kind])
        for key in DRIVER_SAMPLES[kind]:
            want = kept[kind][key]
            if not torch.equal(loaded[key].cpu().to(want.dtype).reshape(want.shape), want):
                raise RuntimeError(f"{kind} {key}: the loaded tensor differs from the written one")


def phase_driver(card: str) -> dict:
    """The way users start SVI, at the full width of Wan2.1-I2V-14B-480P: (a)
    checkpoint files written here; (b) the port's driver (`main`, in-process)
    on them, two clips untiled (stitched 2 x 9 - 1 frames), then one clip
    with --tiled, then a tiled encode of its frames and a tiled decode of
    their latents; (c) one clip with --quantize int4_w4a8. Fails unless the
    LoRA was fused (its count, and one weight against W + alpha·B@A in f32),
    the loaded tensors are the written ones bit for bit, the frames are
    right, the tiled decode is within its bound of the untiled one, the
    forward kernels ran in (b) and every quantized linear of (c) went
    through w4a8_linear. Then phases 4f, 7 and 5b on these files; returns
    5b's quantized training run's launches and phase 7's (UniAnimate's)."""
    import shutil
    import tempfile

    from svi_tpu_torch.models import model_io

    root = Path(tempfile.mkdtemp(prefix="_driver_ckpt_", dir=REPO))
    try:
        free = shutil.disk_usage(root).free
        log(f"[driver] checkpoints under {root.name} ({free / 1e9:.1f} GB free); {card}")
        kept = write_driver_checkpoints(root)

        # (b) two clips, untiled
        record, launches, _ = run_driver(root, "b", ["--num_clips", "2"], card)
        routes = check_fwd_routes("the driver", need_f32=True)
        if min(launches[k] for k in ("flash_fwd_flat/sm90/128", "flash_fwd_flat/f32",
                                     "rope_rotate_flat", "flash_fwd_bnsd/f32")) <= 0:
            raise RuntimeError(f"a kernel was not launched on the driver's path: {launches}")
        log(f"[driver b] forward routes {routes}")
        check_driver_video("b", record["samples"][0], clips=2)
        bf16_clip1 = np.load(record["samples"][0]["path"])[:SLICE_FRAMES]
        mm = record["manager"]
        expect_n = DRIVER_DIT_BLOCKS * len(DRIVER_LORA_TARGETS)
        if [n for _, n in mm.lora_log] != [expect_n]:
            raise RuntimeError(f"LoRA fused {mm.lora_log}, expected one file of {expect_n}")
        check_loaded_tensors(mm, kept)
        w = kept["wan_video_dit"][DRIVER_LORA_CHECKED].cuda().float()
        delta = kept["lora"]["B"].cuda().float() @ kept["lora"]["A"].cuda().float()
        fused = model_io.dit_param(mm.models["wan_video_dit"], DRIVER_LORA_CHECKED).float()
        # bf16 rounds the delta and then the sum, each by at most 2^-8 relative
        err = ((fused - (w + delta)).abs() - 2.0 ** -8 * (w.abs() + 2 * delta.abs()) * 1.01).max()
        moved = (fused - w).abs().mean().item()
        log(f"[driver b] LoRA {DRIVER_LORA_CHECKED}: mean |fused - W| {moved:.3e} (mean |B@A| "
            f"{delta.abs().mean().item():.3e}), excess over the bf16 bound {err.item():.3e}; "
            f"{sum(len(v) for k, v in kept.items() if k != 'lora')} sampled tensors bit-equal")
        if err.item() > 0 or not moved > 0:
            raise RuntimeError("the fused LoRA weight is not W + alpha * B @ A")
        del record, mm, w, delta, fused

        # (b) again with --tiled, then a tiled encode of its frames
        record, tiled_launches, _ = run_driver(root, "b-tiled", ["--num_clips", "1", "--tiled"],
                                                card)
        check_driver_video("b-tiled", record["samples"][0], clips=1)
        pipe = record["pipe"]
        frames = np.load(record["samples"][0]["path"])
        video = torch.from_numpy(frames).cuda().permute(3, 0, 1, 2)[None].float() / 127.5 - 1
        with torch.inference_mode():
            zero_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lat = pipe.encode_video(video, tiled=True)
            torch.cuda.synchronize()
            enc_s = time.perf_counter() - t0
            f32 = read_counts()["flash_fwd_flat/f32"]
            t0 = time.perf_counter()
            lat_whole = pipe.encode_video(video, tiled=False)
            torch.cuda.synchronize()
            whole_s = time.perf_counter() - t0
        lt = (SLICE_FRAMES - 1) // 4 + 1
        if lat.shape != (1, 16, lt, SLICE_H // 8, SLICE_W // 8) or not torch.isfinite(lat).all():
            raise RuntimeError(f"tiled encode gave {tuple(lat.shape)} or non-finite values")
        rel = ((lat.float() - lat_whole.float()).abs().mean()
               / lat_whole.float().abs().mean()).item()
        log(f"[driver b-tiled] tiled encode of the clip {enc_s:.3f}s ({f32} K1 f32 launches: "
            f"the mid-block attention of each tile and time chunk), untiled {whole_s:.3f}s, "
            f"mean relative difference {rel:.4f}; the run's launches {tiled_launches}; {card}")
        if f32 <= 0:
            raise RuntimeError("the tiled encode launched no f32 attention")
        check_tiled_decode(pipe, lat_whole, card)
        del record, pipe, video, lat, lat_whole

        # (c) one clip with the DiT quantized on load
        with count_int_mm() as int_mm:
            record, q_launches, _ = run_driver(root, "c", ["--num_clips", "1", "--quantize",
                                                           "int4_w4a8"], card)
        dit = record["pipe"].dit
        n_q4 = sum(1 for name, _ in dit.named_parameters() if name.endswith("w_q4"))
        check_quant_path("the driver with --quantize int4_w4a8", q_launches, int_mm, n_q4,
                         int8_attention=False)
        check_driver_video("c", record["samples"][0], clips=1)
        quant_clips = {"int4_w4a8": np.load(record["samples"][0]["path"])}
        del record, dit

        # (c') the same clip with W8A8 (int8 weights, int8 activations on
        # torch._int_mm), then each quantized clip against (b)'s bf16 clip 1
        # (the same files, seed and prompt): full-width numbers on seeded
        # weights, printed for regressions, with no bound drawn from them
        with count_int_mm() as int_mm:
            record, _, _ = run_driver(root, "c-w8a8", ["--num_clips", "1", "--quantize", "w8a8"],
                                      card)
        check_driver_video("c-w8a8", record["samples"][0], clips=1)
        n_q8 = sum(1 for name, _ in record["pipe"].dit.named_parameters()
                   if name.endswith("w_q8"))
        quant_clips["w8a8"] = np.load(record["samples"][0]["path"])
        del record
        if not (n_q8 > 0 and int_mm.calls > 0):
            raise RuntimeError(f"--quantize w8a8 loaded {n_q8} int8 linears and made "
                               f"{int_mm.calls} int8 GEMM calls")
        from svi_tpu_torch.utils.fidelity import clip_psnr

        scores = {mode: round(clip_psnr(v, bf16_clip1), 3) for mode, v in quant_clips.items()}
        log(f"[driver fidelity] clip_psnr against the bf16 clip 1 (dB), 4-block 14B-width "
            f"driver on seeded weights: {scores}; w8a8: {n_q8} int8 linears, "
            f"{int_mm.calls} torch._int_mm calls; {card}")
        if not all(np.isfinite(v) for v in scores.values()):
            raise RuntimeError("a quantized clip's PSNR against bf16 is not finite")

        # (e') the gradio demo's core on these files
        phase_gradio_core(root, card)

        # 4f: the variants' drivers on these files and the ones they add
        phase_variants(root, card)
        # 7: the pose path, UniAnimate on these files
        pose_launches = phase_pose(root, card)
        # 5b: the training drivers on the same files
        return phase_train_drivers(root, card), pose_launches
    finally:
        gc.collect()
        torch.cuda.empty_cache()
        shutil.rmtree(root, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 4f: the variants (SVI-Dance, SVI-Talk) through their drivers
# ---------------------------------------------------------------------------

# the talk and dance runs: two clips of 9 frames, 4 steps, as phase 4e's
VARIANT_CLIPS = 2
# wav2vec2's 12 hidden states of speech.wav, card against CPU, f32 with TF32
# off: sums in another order through 7 convs, the 128-tap grouped
# positional conv and 12 layers. Relative to the largest |state|; the first
# reading on an H100 was 2.05e-6 (PERF.md, section 6), the bound ten times
# that: a wrong tap, stride or weight-norm fold moves the states by their
# own size
W2V_CARD_REL = 2e-5
# prepare_video_audio on the card against the CPU port's states of the same
# file: the bound an earlier wav2vec2 card check held (2.051e-6 read)
PREPARE_CARD_REL = 2.1e-6
# the tiny dance and talk pipelines, card against CPU (as phase 4a's)
VARIANT_LAT_TOL, VARIANT_FRAME_LEVELS = 1e-3, 2
# the dance driver caps the width at 640: a 480x832 image becomes 368x640
DANCE_H, DANCE_W = 368, 640
SPEECH = REPO / "data" / "toy_test" / "talk" / "speech.wav"


def tiny_variant_pipeline(device, variant: str):
    """Phase 4a's tiny f32 pipeline as the dance variant (a pose embedding of
    the DiT's width) or the talk variant (a 3-block multitalk DiT, audio
    windows 32 wide)."""
    from svi_tpu_torch.models import clip_vision, pose_embedding, wan_dit, wan_vae
    from svi_tpu_torch.pipelines.svi_video_dance import SVIDanceVideoPipeline
    from svi_tpu_torch.pipelines.svi_video_talk import SVITalkVideoPipeline

    cls = SVIDanceVideoPipeline if variant == "dance" else SVITalkVideoPipeline
    pipe = cls(device=device, torch_dtype=torch.float32)
    pipe.vae = wan_vae.init_params(wan_vae.WanVAEConfig(dim=16, z_dim=4), seed=1,
                                   device="cpu").to(device)
    audio = dict(enable_multitalk=True, audio_hidden_dim=32, audio_context_tokens=4) \
        if variant == "talk" else {}
    pipe.dit = wan_dit.init_params(wan_dit.WanDiTConfig(
        dim=64, in_dim=12, ffn_dim=128, out_dim=4, text_dim=48, freq_dim=32, num_heads=2,
        num_layers=3, has_image_input=True, clip_feature_dim=64, dtype=torch.float32, **audio),
        seed=2, device="cpu").to(device)
    pipe.image_encoder = clip_vision.init_params(clip_vision.ClipVisionConfig(
        image_size=28, patch_size=14, dim=64, mlp_ratio=2, num_heads=2, num_layers=2),
        seed=3, device="cpu").to(device)
    if variant == "dance":
        pipe.dwpose_embedding = pose_embedding.init_params(64, seed=4, device="cpu").to(device)
    return pipe


def phase_small_variants(card: str) -> int:
    """(a) The tiny dance and talk pipelines on the card against the same on
    the CPU; returns the largest frame difference (levels), the card-vs-CPU
    gap that the controls must exceed."""
    from svi_tpu_torch.ops import attention as A

    rng = np.random.default_rng(40)
    extra = {"dance": dict(humanpose_data=rng.integers(0, 255, (3, 9, 64, 64)).astype(np.float32),
                           cond_wo_pose=True, cfg_scale=dict(text=5.0, audio=2.0)),
             "talk": dict(audio_embed=rng.standard_normal((1, 9, 5, 12, 32)).astype(np.float32),
                          cfg_scale=dict(text=5.0, audio=2.0))}
    gap = 0
    for variant, kw in extra.items():
        kw = dict(tiny_call_kwargs(), **kw)
        launches = A.flash_fwd_flat.launches + A.flash_fwd_bnsd.launches
        frames_gpu, lat_gpu = tiny_variant_pipeline("cuda", variant)(**kw)
        used = A.flash_fwd_flat.launches + A.flash_fwd_bnsd.launches - launches
        frames_cpu, lat_cpu = tiny_variant_pipeline("cpu", variant)(**kw)
        lat_err = (lat_gpu.cpu() - lat_cpu).abs().max().item()
        px = int(np.abs(np.stack(frames_gpu).astype(int) - np.stack(frames_cpu).astype(int)).max())
        gap = max(gap, px)
        log(f"[variants-small] {variant}: card vs CPU on a tiny f32 pipeline, latents max abs "
            f"err {lat_err:.3e} (bound {VARIANT_LAT_TOL}), frames max diff {px} levels (bound "
            f"{VARIANT_FRAME_LEVELS}), kernel launches {used}; {card}")
        if not (lat_err <= VARIANT_LAT_TOL and px <= VARIANT_FRAME_LEVELS and used > 0):
            raise RuntimeError(f"the tiny {variant} pipeline on the card disagrees with the CPU")
    return gap


def write_variant_checkpoints(root: Path, card: str) -> None:
    """(b) Beside phase 4e's files: multitalk.safetensors (the 4 blocks' audio
    cross-attention and norm, and audio_proj, bf16, at the published widths),
    svi-dance.safetensors (4e's LoRA plus the pose embedding at dim 5120,
    f32), a full-size chinese-wav2vec2-base directory in transformers'
    naming (f32), a 368x640 reference image and a seeded pose video
    (12 frames of 448x256, as data/toy_test/dance/pose.mp4's) as .npy."""
    from svi_tpu_torch.models import pose_embedding, wan_dit, wav2vec2
    from svi_tpu_torch.utils.safetensors_io import load_file, save_file

    t0 = time.perf_counter()
    sizes = {}
    cfg = dataclasses.replace(wan_dit.WAN_14B_I2V_MULTITALK, num_layers=DRIVER_DIT_BLOCKS)
    dit = wan_dit.init_params(cfg, seed=41, device="cuda")
    audio = {k: v for k, v in wan_dit.torch_state_dict_from_params(dit).items()
             if "audio" in k or ".norm_x." in k}
    sizes["multitalk"] = save_file(audio, str(root / "multitalk.safetensors"))
    del dit, audio
    torch.cuda.empty_cache()
    lora = load_file(str(root / "svi-shot.safetensors"))
    lora.update(pose_embedding.torch_state_dict_from_params(
        pose_embedding.init_params(cfg.dim, seed=42, device="cuda")))
    sizes["dance_lora"] = save_file(lora, str(root / "svi-dance.safetensors"))
    w2v = root / "chinese-wav2vec2-base"
    w2v.mkdir()
    sizes["wav2vec2"] = save_file(wav2vec2.torch_state_dict_from_params(
        wav2vec2.init_params(seed=43, device="cuda")), str(w2v / "model.safetensors"))
    rng = np.random.default_rng(44)
    np.save(root / "dance_frame.npy", rng.integers(0, 255, (DANCE_H, DANCE_W, 3), dtype=np.uint8))
    np.save(root / "pose.npy", rng.integers(0, 255, (12, 448, 256, 3), dtype=np.uint8))
    log(f"[variants] wrote {sum(sizes.values()) / 1e9:.3f} GB ("
        + ", ".join(f"{k} {v / 1e9:.3f} GB" for k, v in sizes.items())
        + f") in {time.perf_counter() - t0:.2f}s; {card}")


def phase_wav2vec2_card(root: Path, card: str) -> None:
    """(c) The tower from the written directory, on the card and on the CPU,
    over data/toy_test/talk/speech.wav: the 12 hidden states within
    W2V_CARD_REL of the largest |state|."""
    from svi_tpu_torch.models import wav2vec2
    from svi_tpu_torch.utils import audio

    speech = audio.load_audio(str(SPEECH))
    embs, secs = {}, {}
    for where, dev in (("card", "cuda"), ("host", "cpu")):
        model = wav2vec2.load_params(str(root / "chinese-wav2vec2-base"), device=dev)
        audio.wav2vec_embedding(speech[:16000], None, model)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        embs[where] = audio.wav2vec_embedding(speech, None, model)
        secs[where] = time.perf_counter() - t0
        del model
    err = float(np.abs(embs["card"] - embs["host"]).max())
    scale = float(np.abs(embs["host"]).max())
    log(f"[variants] wav2vec2 of speech.wav ({speech.size / 16000:.2f} s -> "
        f"{embs['card'].shape}): card {secs['card']:.3f}s, CPU {secs['host']:.3f}s; card vs CPU "
        f"max abs err {err:.3e} of max |state| {scale:.3f} = {err / scale:.3e} (bound "
        f"{W2V_CARD_REL}); {card}")
    if not (np.isfinite(embs["card"]).all() and err <= W2V_CARD_REL * scale):
        raise RuntimeError("the wav2vec2 states on the card disagree with the CPU port")
    return embs["host"]


def phase_tools(root: Path, host_emb: np.ndarray, card: str) -> None:
    """The data tools on the card's machine: (a) prepare_video_audio, on the
    card by default, over a seeded .npy clip and speech.wav with (c)'s
    full-size wav2vec2: its audio_embedding.pkl within PREPARE_CARD_REL of the
    CPU port's states of the same file (c), its frames in video.npy where
    Pillow is missing; (b) make_toy_data (host only) into a directory of its
    own, its .npy output read by the three training datasets."""
    import pickle
    import shutil

    from svi_tpu_torch.scripts import make_toy_data, prepare_video_audio
    from svi_tpu_torch.training.dataset import (DanceVideoDataset, TalkVideoDataset,
                                                TextVideoDataset)

    src, wavs, out = root / "talk_clips", root / "talk_wavs", root / "talk_data"
    src.mkdir()
    wavs.mkdir()
    clip = np.random.default_rng(45).integers(0, 255, (12, 96, 160, 3), dtype=np.uint8)
    np.save(src / "speech.npy", clip)
    shutil.copy(SPEECH, wavs / "speech.wav")
    t0 = time.perf_counter()
    done = prepare_video_audio.main(["--video_dir", str(src), "--audio_dir", str(wavs),
                                     "--out_dir", str(out),
                                     "--wav2vec_path", str(root / "chinese-wav2vec2-base")])
    secs = time.perf_counter() - t0
    with open(out / "speech" / "audio_embedding.pkl", "rb") as fh:
        emb = pickle.load(fh)
    want = np.transpose(host_emb, (1, 0, 2))
    err = float(np.abs(emb - want).max()) if emb.shape == want.shape else float("inf")
    scale = float(np.abs(want).max())
    frames = sorted(p.name for p in (out / "speech").iterdir())
    log(f"[tools] prepare_video_audio on the card ({secs:.2f}s): {done}, files {frames}; "
        f"embedding vs the CPU port's max abs err {err:.3e} of max |state| {scale:.3f} = "
        f"{err / scale:.3e} (bound {PREPARE_CARD_REL}); {card}")
    if not (err <= PREPARE_CARD_REL * scale and emb.dtype == np.float32):
        raise RuntimeError("prepare_video_audio's embedding on the card disagrees with the CPU")
    if "video.npy" in frames and not np.array_equal(np.load(out / "speech" / "video.npy"), clip):
        raise RuntimeError("prepare_video_audio's video.npy is not the clip's frames")
    ds = TalkVideoDataset(str(out), max_num_frames=9, num_frames=9, height=96, width=160,
                          seed=0)
    if len(ds.video_list) != 1 or not np.isfinite(ds[0]["video"]).all():
        raise RuntimeError("TalkVideoDataset did not read prepare_video_audio's sample")

    t0 = time.perf_counter()
    toy = make_toy_data.main(["--root", str(root / "toy_data")])
    secs = time.perf_counter() - t0
    kw = dict(max_num_frames=9, num_frames=9, height=96, width=160, seed=0)
    read = {}
    for cls, rel in ((TextVideoDataset, "svi-film-shot"), (DanceVideoDataset, "svi-dance"),
                     (TalkVideoDataset, "svi-talk")):
        ds = cls(str(Path(toy) / "toy_train" / rel), **kw)
        sample = ds[0]
        read[rel] = (len(ds.video_list), tuple(np.shape(sample["video"])))
        if not np.isfinite(sample["video"]).all():
            raise RuntimeError(f"make_toy_data's {rel} sample is not finite")
    files = sorted(p.name for p in (Path(toy) / "toy_test" / "dance").iterdir())
    log(f"[tools] make_toy_data {secs:.2f}s (toy_test/dance holds {files}); read by the "
        f"datasets (samples, video shape): {read}; {card}")


def run_variant_driver(module, argv: list[str], tag: str, card: str):
    """One in-process run of a variant's driver: launch counts zeroed just
    before and read just after, per-phase seconds and peak memory. Returns
    (record, launches, timer)."""
    from svi_tpu_torch.models.clip_vision import ClipVision
    from svi_tpu_torch.models.model_io import ModelManager
    from svi_tpu_torch.models.pose_embedding import PoseEmbedding
    from svi_tpu_torch.models.wan_vae import WanVAE
    from svi_tpu_torch.models.wav2vec2 import Wav2Vec2
    from svi_tpu_torch.pipelines.svi_video import SVIVideoPipeline
    from svi_tpu_torch.pipelines.svi_video_talk import SVITalkVideoPipeline

    timer = PhaseTimer()
    targets = [(ModelManager, "load_models", "load"), (ModelManager, "load_lora_v2", "lora_fuse"),
               (SVIVideoPipeline, "encode_prompt", "tokenize_t5"),
               (ClipVision, "encode_image", "clip"), (WanVAE, "encode", "vae_encode"),
               (WanVAE, "decode", "vae_decode"), (Wav2Vec2, "forward", "wav2vec2"),
               (PoseEmbedding, "forward", "pose_embedding"),
               (SVIVideoPipeline, "_sample", "denoise_b2"),
               (SVITalkVideoPipeline, "_sample_talk", "denoise_b3")]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with timed_methods(timer, targets):
        zero_counts()
        t0 = time.perf_counter()
        record = module.main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = read_counts()
    sec = timer.seconds

    def r(name, per=1):
        return [round(x / per, 3) for x in sec.get(name, [])]

    log(f"[variants {tag}] {seconds:.2f}s in all; load {sec['load'][0]:.2f}s, LoRA fuse "
        f"{sec['lora_fuse'][0]:.2f}s; wav2vec2 {r('wav2vec2')}, pose embedding "
        f"{r('pose_embedding')}, tokenize + T5 {r('tokenize_t5')}, CLIP {r('clip')}, VAE "
        f"encode {r('vae_encode')}, denoise step B=3 {r('denoise_b3', SLICE_STEPS)}, B=2 "
        f"{r('denoise_b2', SLICE_STEPS)}, VAE decode {r('vae_decode')}; clip seconds "
        f"{[round(c['seconds'], 2) for c in record['clips']]}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches {launches}; {card}")
    return record, launches, timer


def check_variant_video(tag: str, frames: np.ndarray, expect: tuple) -> None:
    std = float(frames.astype(np.float32).std())
    if frames.shape != expect or frames.dtype != np.uint8 or not std > 1.0:
        raise RuntimeError(f"[variants {tag}] stitched video {frames.shape} {frames.dtype} with "
                           f"pixel std {std}, expected {expect} uint8 with std > 1")


def control_gap(tag: str, run: np.ndarray, control: np.ndarray, gap: int, card: str) -> None:
    """A control clip must differ from the clip it shadows by more than the
    card-vs-CPU gap of the tiny pipelines (mean levels over the frames)."""
    d = float(np.abs(run.astype(np.float32) - control.astype(np.float32)).mean())
    log(f"[variants {tag}] control: mean |run - control| {d:.2f} levels (must exceed the "
        f"card-vs-CPU gap {gap}); {card}")
    if not d > gap:
        raise RuntimeError(f"the {tag} control does not move the clip beyond the card-vs-CPU gap")


def phase_variants(root: Path, card: str) -> dict:
    """Phase 4f, the SVI-Talk and SVI-Dance drivers on phase 4e's 14B-width
    files (4 of 40 blocks) and the files (b) adds: (a) the tiny pipelines,
    card against CPU; (c) wav2vec2, card against CPU; (d) talk on
    speech.wav, two clips of 9 frames at 480x832, 4 steps, bf16, and a
    control with a zeroed audio embedding; (e) the same with --quantize
    int4_w4a8; (f) dance on the seeded pose video, two clips at 368x640, and
    a control with --remove_pose. Fails unless every bf16 D=128 forward took
    sm90 and every f32 one f32, every quantized linear (the audio ones
    included) went through w4a8_linear, the stitched videos are right and
    the controls differ."""
    from svi_tpu_torch.scripts import test_svi_dance, test_svi_talk
    from svi_tpu_torch.utils import audio

    t_phase = time.perf_counter()
    gap = phase_small_variants(card)
    write_variant_checkpoints(root, card)
    phase_tools(root, phase_wav2vec2_card(root, card), card)
    common = ["--dit_root", str(root), "--num_frames", str(SLICE_FRAMES), "--num_steps",
              str(SLICE_STEPS), "--save_format", "npy"]
    talk = [*common, "--extra_module_root", str(root / "svi-shot.safetensors"),
            "--multitalk_path", str(root / "multitalk.safetensors"),
            "--wav2vec_path", str(root / "chinese-wav2vec2-base"),
            "--ref_image_path", str(root / "frame.npy"), "--audio_path", str(SPEECH)]
    launches = {}

    # (d) talk, bf16
    record, launches["talk"], _ = run_variant_driver(
        test_svi_talk, [*talk, "--num_clips", str(VARIANT_CLIPS), "--output",
                        str(root / "videos_talk")], "talk", card)
    routes = check_fwd_routes("the talk driver", need_f32=True)
    if not record["pipe"].dit.cfg.enable_multitalk:
        raise RuntimeError("the talk driver's DiT did not load as multitalk")
    if min(launches["talk"][k] for k in ("flash_fwd_flat/sm90/128", "flash_fwd_flat/f32",
                                         "rope_rotate_flat", "flash_fwd_bnsd/f32")) <= 0:
        raise RuntimeError(f"a kernel was not launched on the talk driver's path: "
                           f"{launches['talk']}")
    frames = np.load(record["paths"][-1])
    check_variant_video("talk", frames, (VARIANT_CLIPS * SLICE_FRAMES, SLICE_H, SLICE_W, 3))
    log(f"[variants talk] forward routes {routes}; stitched {frames.shape}, pixel std "
        f"{frames.astype(np.float32).std():.2f}, audio starts "
        f"{[c['audio_start'] for c in record['clips']]}")
    del record
    real_embedding = audio.wav2vec_embedding
    audio.wav2vec_embedding = lambda speech, extractor, model: np.zeros_like(
        real_embedding(speech, extractor, model))
    try:
        record, _, _ = run_variant_driver(
            test_svi_talk, [*talk, "--num_clips", "1", "--output", str(root / "videos_talk0")],
            "talk-zero-audio", card)
    finally:
        audio.wav2vec_embedding = real_embedding
    control_gap("talk", frames[:SLICE_FRAMES], np.load(record["paths"][-1]), gap, card)
    del record

    # (e) talk, int4_w4a8
    with count_int_mm() as int_mm:
        record, launches["talk_q"], _ = run_variant_driver(
            test_svi_talk, [*talk, "--num_clips", str(VARIANT_CLIPS), "--quantize", "int4_w4a8",
                            "--output", str(root / "videos_talk_q")], "talk-int4_w4a8", card)
    names = [name for name, _ in record["pipe"].dit.named_parameters() if name.endswith("w_q4")]
    n_audio = sum(1 for name in names if "audio" in name)
    check_quant_path("the talk driver with --quantize int4_w4a8", launches["talk_q"], int_mm,
                     len(names), forwards=VARIANT_CLIPS * SLICE_STEPS, int8_attention=False)
    check_fwd_routes("the quantized talk driver", need_f32=True)
    log(f"[variants talk-int4_w4a8] {len(names)} quantized linears a forward, {n_audio} of them "
        f"audio (4 audio_proj + 3 a block)")
    if n_audio != 4 + 3 * DRIVER_DIT_BLOCKS:
        raise RuntimeError(f"{n_audio} audio linears quantized, expected "
                           f"{4 + 3 * DRIVER_DIT_BLOCKS}")
    check_variant_video("talk-int4_w4a8", np.load(record["paths"][-1]),
                        (VARIANT_CLIPS * SLICE_FRAMES, SLICE_H, SLICE_W, 3))
    del record

    # (f) dance
    dance = [*common, "--extra_module_root", str(root / "svi-dance.safetensors"),
             "--image_path", str(root / "dance_frame.npy"),
             "--pose_path", str(root / "pose.npy")]
    motion = test_svi_dance.parse_args(["--image_path", "x", "--pose_path", "x"]).num_motion_frames
    record, launches["dance"], _ = run_variant_driver(
        test_svi_dance, [*dance, "--num_clips", str(VARIANT_CLIPS), "--output",
                         str(root / "videos_dance")], "dance", card)
    routes = check_fwd_routes("the dance driver", need_f32=True)
    if record["pipe"].dwpose_embedding is None or launches["dance"]["flash_fwd_flat/sm90/128"] <= 0:
        raise RuntimeError("the dance driver ran without its pose embedding or K1")
    frames = np.load(record["path"])
    check_variant_video("dance", frames, (VARIANT_CLIPS * SLICE_FRAMES - (VARIANT_CLIPS - 1)
                                          * motion, DANCE_H, DANCE_W, 3))
    log(f"[variants dance] forward routes {routes}; stitched {frames.shape}, pixel std "
        f"{frames.astype(np.float32).std():.2f}")
    del record
    record, _, _ = run_variant_driver(
        test_svi_dance, [*dance, "--num_clips", "1", "--remove_pose", "--output",
                         str(root / "videos_dance0")], "dance-remove-pose", card)
    control_gap("dance", frames[:SLICE_FRAMES - motion],
                np.load(record["path"])[:SLICE_FRAMES - motion], gap, card)
    del record
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[variants] phase 4f passed in {time.perf_counter() - t_phase:.1f}s; {card}")
    return launches


def phase_multitalk_step(state: dict, card: str) -> None:
    """Phase 4f's full-depth step: one denoise-step forward (batch 3: cond,
    drop-text, null audio) of the multitalk 14B at 480x832x9, 40 blocks:
    phase 4b's bf16 base weights with seeded audio branches and audio_proj
    added (a second DiT of the same tensors), timed, then profiled."""
    from svi_tpu_torch.models import wan_dit
    from svi_tpu_torch.models.params import Init

    pipe = state["pipe"]
    cfg = dataclasses.replace(pipe.dit.cfg, enable_multitalk=True)
    t0 = time.perf_counter()
    r = Init(45, "cuda", cfg.dtype)  # init_params's distributions
    d, ad = cfg.dim, cfg.audio_hidden_dim
    tree = pipe.dit.tree()  # the same tensors: nothing of the base DiT is copied
    for blk in tree["blocks"]:
        blk["audio_cross_attn"] = {"q_linear": r.linear(d, d), "kv_linear": r.linear(ad, 2 * d),
                                   "proj": r.linear(d, d)}
        blk["norm_x"] = {"w": r.ones((d,)), "b": r.zeros((d,))}
    tree["audio_proj"] = {"proj1": r.linear(5 * 12 * ad, 512),
                          "proj1_vf": r.linear(8 * 12 * ad, 512), "proj2": r.linear(512, 512),
                          "proj3": r.linear(512, cfg.audio_context_tokens * ad),
                          "norm": {"w": r.ones((ad,)), "b": r.zeros((ad,))}}
    dit = wan_dit.WanDiT(cfg, tree)
    n_params = sum(p.numel() for p in dit.parameters())
    init_s = time.perf_counter() - t0
    lt, lh, lw = (SLICE_FRAMES - 1) // 4 + 1, SLICE_H // 8, SLICE_W // 8
    g = torch.Generator(device="cuda").manual_seed(47)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)

    ctx = torch.cat([state["ctx_pos"], state["ctx_neg"], state["ctx_neg"]])
    args = (randn(3, 16, lt, lh, lw), pipe.scheduler.timesteps[:1].cuda(), ctx,
            randn(3, 257, cfg.clip_feature_dim), randn(3, cfg.in_dim - 16, lt, lh, lw))
    first, vf = randn(1, 1, 5, 12, 768), randn(1, lt - 1, 8, 12, 768)
    audio3 = (torch.cat([first, first, torch.zeros_like(first)]),
              torch.cat([vf, vf, torch.zeros_like(vf)]))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        dit(*args, audio_embed_tuple=audio3)  # warm-up
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = dit(*args, audio_embed_tuple=audio3)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        routes = check_fwd_routes("the full-depth multitalk step")
        launches = read_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        if out.shape != args[0].shape or not torch.isfinite(out).all():
            raise RuntimeError("the full-depth multitalk forward gave the wrong shape or "
                               "non-finite values")
        del out
        log(f"[variants-14b] multitalk 14B, {cfg.num_layers} blocks, {n_params / 1e9:.2f}B "
            f"params (audio branches added in {init_s:.2f}s), one denoise step at {SLICE_H}x"
            f"{SLICE_W}x{SLICE_FRAMES} (B3 S{lt * lh * lw // 4}): {seconds:.3f}s, peak memory "
            f"{peak:.2f} GiB, launches {launches}, forward routes {routes}; {card}")
        log(f"[variants-14b] profile: "
            f"{device_time_breakdown(lambda: dit(*args, audio_embed_tuple=audio3))}; {card}")
    del dit, tree, args, audio3
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 7: the pose path (the ONNX executor, DWPose, the pose scripts,
# UniAnimate)
# ---------------------------------------------------------------------------

# The executor's op families, card against CPU: f32 convs with TF32 off,
# f32 matmuls, sums in another order: within 1e-5 of the largest |output|;
# shape outputs exactly equal.
POSE_OP_REL = 1e-5
# The full-width YOLOX-L and DWPose-l graphs, card against CPU: a few hundred
# f32 ops deep, each summing in another order on the card: within 1e-3 of
# the largest |output|.
POSE_GRAPH_REL = 1e-3
POSE_PEOPLE = (1, 4)  # the steered detector's people on the seeded frame
POSE_H, POSE_W, POSE_FRAMES = 480, 640, 16  # (c)'s seeded video
# (d): UniAnimate at the 14B's width on 4e's 4-block files, 480x832
UNI_FRAMES, UNI_LONG_FRAMES, UNI_CONTEXT, UNI_OVERLAP = 9, 33, 5, 2
UNI_PROMPT = "a person dancing in a bright studio, full body"


def _pose_graphs():
    """tests/torch_dwpose_graphs.py (the seeded ONNX graphs; no JAX)."""
    if str(REPO / "tests") not in sys.path:
        sys.path.insert(0, str(REPO / "tests"))
    import torch_dwpose_graphs

    return torch_dwpose_graphs


def capture_decode(pipe) -> dict:
    """Keep the pipeline's decoded frames (before the uint8 cast) under
    ["v"]."""
    seen = {}
    decode = pipe.decode_video

    def spy(*a, **kw):
        seen["v"] = decode(*a, **kw)
        return seen["v"]

    pipe.decode_video = spy
    return seen


def _host_rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def tiny_uni_pipeline(device, name: str):
    """Phase 4a's tiny f32 pipeline as one of wan_video's UniAnimate
    pipelines, its side stacks cut to the tiny DiT's widths (y has 4 + 4
    channels, the latents 4)."""
    from svi_tpu_torch.models import pose_embedding, unianimate
    from svi_tpu_torch.pipelines import wan_video

    base = tiny_pipeline(device)
    pipe = getattr(wan_video, name)(device=device, torch_dtype=torch.float32)
    pipe.vae, pipe.dit, pipe.image_encoder = base.vae, base.dit, base.image_encoder
    pipe.dwpose_embedding = pose_embedding.init_params(64, seed=4, device="cpu").to(device)
    pipe.randomref_embedding_pose = unianimate.init_params(
        "randomref", seed=5, device="cpu", channels=(3, 16, 16, 16, 16, 16, 8)).to(device)
    if name == "WanRepalceAnyoneVideoPipeline":
        pipe.learn_in_embedding = unianimate.init_params(
            "learn_in", seed=6, device="cpu", channels=(4, 16, 16, 16, 4)).to(device)
        pipe.inpaint_embedding = unianimate.init_params(
            "inpaint", seed=7, device="cpu", channels=(4, 16, 16, 4)).to(device)
    return pipe


def phase_pose_small(card: str) -> int:
    """(a) The executor's op families and the tiny UniAnimate, long and
    replace-anyone pipelines on the card against the same on the CPU.
    Returns the largest frame difference (levels): the card-vs-CPU gap the
    pose control must exceed."""
    from svi_tpu_torch.ops import attention as A
    from svi_tpu_torch.utils import onnx_torch

    for name, data, feeds in _pose_graphs().op_family_graphs():
        card_out = onnx_torch.InferenceSession(data, device="cuda").run(None, feeds)
        cpu_out = onnx_torch.InferenceSession(data, device="cpu").run(None, feeds)
        errs = []
        for got, want in zip(card_out, cpu_out):
            if got.shape != want.shape or got.dtype != want.dtype:
                raise RuntimeError(f"[pose-small] {name}: {got.shape} {got.dtype} on the card, "
                                   f"{want.shape} {want.dtype} on the CPU")
            if np.issubdtype(want.dtype, np.floating):
                errs.append(_host_rel(got, want))
            elif not np.array_equal(got, want):
                raise RuntimeError(f"[pose-small] {name}: integer outputs differ")
        log(f"[pose-small] ONNX {name}: card vs CPU max err {max(errs, default=0.0):.3e} of the "
            f"largest |output| (bound {POSE_OP_REL}); shape outputs equal; {card}")
        if max(errs, default=0.0) > POSE_OP_REL:
            raise RuntimeError(f"the executor's {name} on the card disagrees with the CPU")

    rng = np.random.default_rng(60)
    gap = 0
    base_kw = tiny_call_kwargs()
    common = {k: base_kw[k] for k in ("input_image", "seed", "height", "width", "cfg_scale",
                                      "num_inference_steps", "tiled", "prompt_emb_posi",
                                      "prompt_emb_nega")}
    runs = {"WanUniAnimateVideoPipeline": dict(num_frames=9),
            "WanUniAnimateLongVideoPipeline": dict(num_frames=17, context_size=3,
                                                   context_overlap=2),
            "WanRepalceAnyoneVideoPipeline": dict(num_frames=9, batch={
                "video": rng.uniform(-1, 1, (3, 9, 64, 64)).astype(np.float32),
                "segmentation_data": (rng.random((9, 64, 64)) > 0.7).astype(np.float32) * 255})}
    for name, extra in runs.items():
        kw = dict(common, **extra, random_ref_dwpose=rng.integers(0, 255, (64, 64, 3)).astype(
            np.float32), dwpose_data=rng.integers(0, 255, (3, extra["num_frames"], 64, 64)).astype(
            np.float32))
        outs = {}
        for where, dev in (("card", "cuda"), ("host", "cpu")):
            pipe = tiny_uni_pipeline(dev, name)
            seen = capture_decode(pipe)
            launches = A.flash_fwd_flat.launches + A.flash_fwd_bnsd.launches
            frames = np.stack(pipe(**kw))
            used = A.flash_fwd_flat.launches + A.flash_fwd_bnsd.launches - launches
            outs[where] = (frames, seen["v"].float().cpu(), used)
        err = (outs["card"][1] - outs["host"][1]).abs().max().item()
        px = int(np.abs(outs["card"][0].astype(int) - outs["host"][0].astype(int)).max())
        gap = max(gap, px)
        finite = bool(torch.isfinite(outs["card"][1]).all())
        log(f"[pose-small] {name}: card vs CPU on a tiny f32 pipeline, decoded frames max abs "
            f"err {err:.3e} (bound 1e-3), frames max diff {px} levels (bound 2), finite "
            f"{finite}, kernel launches {outs['card'][2]}; {card}")
        if not (err <= 1e-3 and px <= 2 and finite and outs["card"][2] > 0):
            raise RuntimeError(f"the tiny {name} on the card disagrees with the CPU")
    return gap


def phase_dwpose_full(root: Path, card: str) -> dict:
    """(b) DWPose's two networks at their published widths (YOLOX-L at
    640x640, DWPose-l at 384x288) as ONNX graphs from seeded weights, the
    detector's objectness bias steered so that the seeded frame shows
    1-4 people: each graph on the card against the CPU, its op count and
    FLOPs, its median ms a frame / a person (one run under sync debug mode
    'error': it fails if the executor waits for the card), and Wholebody a
    frame. Writes the two graphs under root; returns their paths."""
    from svi_tpu_torch.dwpose import Wholebody, onnx_infer
    from svi_tpu_torch.utils import onnx_torch

    graphs = _pose_graphs()
    frame = np.random.default_rng(61).integers(0, 256, (POSE_H, POSE_W, 3), dtype=np.uint8)
    det_in, _ = onnx_infer._preprocess_det(frame, device=torch.device("cuda"))
    t0 = time.perf_counter()
    det_bytes, det_stats = graphs.steered_yolox(
        lambda data: onnx_torch.InferenceSession(data, device="cuda").run(
            None, {"images": det_in})[0], people=3)
    pose_bytes, pose_stats = graphs.rtmpose()
    build_s = time.perf_counter() - t0
    paths = {"det": root / "yolox_l.onnx", "pose": root / "dw-ll_ucoco_384.onnx"}
    paths["det"].write_bytes(det_bytes)
    paths["pose"].write_bytes(pose_bytes)

    sess = {(k, dev): onnx_torch.InferenceSession(str(paths[k]), device=dev)
            for k in ("det", "pose") for dev in ("cuda", "cpu")}
    boxes = onnx_infer.inference_detector(sess["det", "cuda"], frame)
    if not POSE_PEOPLE[0] <= len(boxes) <= POSE_PEOPLE[1]:
        raise RuntimeError(f"the steered detector found {len(boxes)} people, expected "
                           f"{POSE_PEOPLE}")
    img = torch.from_numpy(frame).cuda()
    center, scale = onnx_infer._bbox_to_center_scale(boxes[0])
    crop, _ = onnx_infer._crop(img, center, scale)
    mean = torch.tensor(onnx_infer._POSE_MEAN, device="cuda")
    std = torch.tensor(onnx_infer._POSE_STD, device="cuda")
    pose_in = ((crop.float() - mean) / std).permute(2, 0, 1)[None].contiguous()
    feeds = {"det": {"images": det_in}, "pose": {"input": pose_in}}
    stats = {"det": det_stats, "pose": pose_stats}
    wb = Wholebody(str(paths["det"]), str(paths["pose"]), device="cuda")
    for k in ("det", "pose"):
        t0 = time.perf_counter()
        card_out = sess[k, "cuda"].run(None, feeds[k])
        cpu_feed = {n: v.cpu() for n, v in feeds[k].items()}
        t1 = time.perf_counter()
        cpu_out = sess[k, "cpu"].run(None, cpu_feed)
        cpu_s = time.perf_counter() - t1
        rel = max(_host_rel(a, b) for a, b in zip(card_out, cpu_out))
        run = lambda k=k: sess[k, "cuda"].run_tensors(None, feeds[k])  # noqa: E731
        ms = median_ms(run, reps=10)
        torch.cuda.synchronize()
        # the executor's enqueue, the device behind: a run that waited for
        # the card (a read-back, a blocking upload) raises here
        torch.cuda.set_sync_debug_mode("error")
        try:
            t1 = time.perf_counter()
            run()
            host_ms = 1e3 * (time.perf_counter() - t1)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        st = stats[k]
        nbytes = 4 * (st["params"] + sum(v.numel() for v in feeds[k].values())
                      + sum(int(np.prod(o.shape)) for o in card_out))
        b_ms, b_by, b_rate = bound(st["flops"], nbytes, F32_ACCURATE)
        log(f"[dwpose] {'YOLOX-L 640x640' if k == 'det' else 'DWPose-l 384x288'}: {st['ops']} "
            f"ops, {st['flops'] / 1e9:.2f} GFLOP counted from its shapes, "
            f"{st['params'] / 1e6:.2f}M params; card {ms:.3f} ms a "
            f"{'frame' if k == 'det' else 'person'} (median of 10 CUDA-event runs after one "
            f"warm-up), host enqueue {host_ms:.3f} ms ({1e3 * host_ms / st['ops']:.1f} us an "
            f"op, no host sync under sync debug mode 'error'), bound {b_ms:.4f} ms ({b_by}, "
            f"{b_rate}); CPU run {cpu_s:.2f}s; card vs CPU "
            f"max err {rel:.3e} of the largest |output| (bound {POSE_GRAPH_REL}); {card}")
        if not rel <= POSE_GRAPH_REL:
            raise RuntimeError(f"the full-width {k} graph on the card disagrees with the CPU")
    wb(frame)
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        kpts, scores = wb(frame)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    log(f"[dwpose] graphs built in {build_s:.2f}s (objectness bias "
        f"{det_stats['obj_bias']:.4f}): {len(boxes)} people on the seeded {POSE_H}x{POSE_W} "
        f"frame; Wholebody a frame (detect, {len(boxes)} crops and poses, decode) "
        f"{1e3 * statistics.median(times):.2f} ms median of 5, keypoints {kpts.shape}, "
        f"finite {bool(np.isfinite(kpts).all())}; {card}")
    if not np.isfinite(kpts).all():
        raise RuntimeError("Wholebody's keypoints are not finite")
    return {k: str(v) for k, v in paths.items()}


def _load_frames(paths: list) -> np.ndarray:
    """Frames written by run_align_pose: .npy, or .jpg through Pillow."""
    if paths[0].endswith(".npy"):
        return np.stack([np.load(p) for p in paths])
    from PIL import Image

    return np.stack([np.asarray(Image.open(p).convert("RGB")) for p in paths])


def phase_pose_scripts(root: Path, graph_paths: dict, card: str) -> dict:
    """(c) The two pose scripts as users run them, on the full-width graphs:
    prepare_video_pose over a seeded 16-frame 480x640 .npy video (the sample
    directory must load in DanceVideoDataset), then run_align_pose of that
    video to a seeded 480x832 .npy reference image, rendered at 480x832.
    Returns the aligned skeleton frames and the reference's."""
    from svi_tpu_torch.scripts import prepare_video_pose, run_align_pose
    from svi_tpu_torch.training.dataset import DanceVideoDataset

    rng = np.random.default_rng(62)
    vids = root / "pose_videos"
    vids.mkdir()
    np.save(vids / "dance_a.npy", rng.integers(0, 256, (POSE_FRAMES, POSE_H, POSE_W, 3),
                                                dtype=np.uint8))
    graphs = ["--det_onnx", graph_paths["det"], "--pose_onnx", graph_paths["pose"]]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = prepare_video_pose.main(["--video_dir", str(vids), "--out_dir",
                                    str(root / "pose_samples"), *graphs], device="cuda")
    prep_s = time.perf_counter() - t0
    ds = DanceVideoDataset(str(root / "pose_samples"), max_num_frames=9, num_frames=9,
                           height=256, width=320)
    item = ds[0]
    ok = (len(ds) == 1 and item["dwpose_data"].shape[0] == 3
          and item["dwpose_data"].shape[1:] == item["video"].shape[1:])
    log(f"[pose-scripts] prepare_video_pose: {done} in {prep_s:.2f}s "
        f"({POSE_FRAMES / prep_s:.2f} frames/s); DanceVideoDataset reads it: video "
        f"{item['video'].shape}, dwpose {item['dwpose_data'].shape}; {card}")
    if not ok:
        raise RuntimeError("the prepared sample directory does not load as a dance sample")

    ref = rng.integers(0, 256, (SLICE_H, SLICE_W, 3), dtype=np.uint8)
    np.save(root / "pose_ref.npy", ref)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run_align_pose.main(["--ref_name", str(root / "pose_ref.npy"), "--source_video_paths",
                               str(vids / "dance_a.npy"), "--saved_pose_dir",
                               str(root / "aligned"), *graphs, "--height", str(SLICE_H),
                               "--width", str(SLICE_W)], device="cuda")
    align_s = time.perf_counter() - t0
    frames = _load_frames([str(root / "aligned" / f) for f in out["files"]])
    painted = float((frames.max(-1) > 0).mean())
    log(f"[pose-scripts] run_align_pose: {len(out['aligned'])} aligned frames "
        f"({POSE_FRAMES} + the reference's pose) in {align_s:.2f}s "
        f"({(POSE_FRAMES + 1) / align_s:.2f} frames/s), {out['files'][0]}..{out['files'][-1]} "
        f"{frames.shape}, {100 * painted:.2f}% of the pixels painted; {card}")
    if frames.shape != (POSE_FRAMES + 1, SLICE_H, SLICE_W, 3) or not painted > 0:
        raise RuntimeError("run_align_pose wrote no skeleton")
    return {"poses": frames[:-1], "ref_pose": frames[-1], "ref": ref}


def write_uni_side_modules(root: Path) -> Path:
    """4e's LoRA plus UniAnimate's side stacks at the 14B's widths (seeded,
    f32, the reference's key names): the file a UniAnimate user passes."""
    from svi_tpu_torch.models import pose_embedding, unianimate, wan_dit
    from svi_tpu_torch.utils.safetensors_io import load_file, save_file

    side = load_file(str(root / "svi-shot.safetensors"))
    side.update(pose_embedding.torch_state_dict_from_params(
        pose_embedding.init_params(wan_dit.WAN_14B_I2V.dim, seed=63, device="cuda")))
    for i, kind in enumerate(("randomref", "learn_in", "inpaint")):
        side.update(unianimate.torch_state_dict_from_params(
            kind, unianimate.init_params(kind, seed=64 + i, device="cuda")))
    path = root / "unianimate.safetensors"
    save_file(side, str(path))
    return path


def phase_unianimate(root: Path, scripts: dict, gap: int, card: str) -> dict:
    """(d) The UniAnimate pipelines at the width of Wan2.1-I2V-14B on 4e's
    4-block files and a side-module file, through ModelManager and
    from_model_manager: the plain pipeline (480x832, 9 frames, 4 steps,
    (c)'s aligned skeletons) and the same without the pose (a control that
    must move the clip beyond the card-vs-CPU gap), the long pipeline (33
    frames in windows of 5 latent frames, overlap 2: 3 windows, every
    latent frame kept) and replace-anyone (9 frames, a seeded mask). Fails
    unless the frames are finite and shaped and every K1 / K2 launch took
    its ported route. Returns the summed launches."""
    from svi_tpu_torch.models.clip_vision import ClipVision
    from svi_tpu_torch.models.pose_embedding import PoseEmbedding
    from svi_tpu_torch.models.unianimate import ConvStack
    from svi_tpu_torch.models.wan_vae import WanVAE
    from svi_tpu_torch.pipelines import wan_video
    from svi_tpu_torch.pipelines.svi_video import SVIVideoPipeline
    from svi_tpu_torch.scripts import test_svi

    side = write_uni_side_modules(root)
    args = test_svi.parse_args(["--dit_root", str(root), "--extra_module_root", str(side)])
    gc.collect()
    torch.cuda.empty_cache()
    mm, load_s, fuse_s = test_svi.load_manager(args, torch.device("cuda"))
    log(f"[unianimate] {side.name} written; ModelManager load {load_s:.2f}s, LoRA fuse "
        f"{fuse_s:.2f}s {mm.lora_log}, side modules {len(mm.state_dict_new_module)} tensors; "
        f"{card}")
    poses = np.transpose(scripts["poses"], (3, 0, 1, 2)).astype(np.float32)  # (3, 16, H, W)
    cycled = lambda n: poses[:, np.arange(n) % poses.shape[1]]  # noqa: E731 (16, cycled)
    rng = np.random.default_rng(65)
    common = dict(prompt=UNI_PROMPT, negative_prompt="", input_image=scripts["ref"], seed=3,
                  height=SLICE_H, width=SLICE_W, cfg_scale=5.0, num_inference_steps=SLICE_STEPS,
                  tiled=False, random_ref_dwpose=scripts["ref_pose"].astype(np.float32))
    runs = [("plain", "WanUniAnimateVideoPipeline",
             dict(num_frames=UNI_FRAMES, dwpose_data=cycled(UNI_FRAMES))),
            ("plain-no-pose", "WanUniAnimateVideoPipeline", dict(num_frames=UNI_FRAMES)),
            ("long", "WanUniAnimateLongVideoPipeline",
             dict(num_frames=UNI_LONG_FRAMES, dwpose_data=cycled(UNI_LONG_FRAMES),
                  context_size=UNI_CONTEXT,
                  context_overlap=UNI_OVERLAP)),
            ("replace-anyone", "WanRepalceAnyoneVideoPipeline",
             dict(num_frames=UNI_FRAMES, dwpose_data=cycled(UNI_FRAMES), batch={
                 "video": rng.uniform(-1, 1, (3, UNI_FRAMES, SLICE_H, SLICE_W)).astype(
                     np.float32),
                 "segmentation_data": (rng.random((UNI_FRAMES, SLICE_H, SLICE_W)) > 0.6).astype(
                     np.float32) * 255}))]
    total, clips = {}, {}
    targets = [(SVIVideoPipeline, "encode_prompt", "tokenize_t5"),
               (ClipVision, "encode_image", "clip"), (WanVAE, "encode", "vae_encode"),
               (WanVAE, "decode", "vae_decode"), (PoseEmbedding, "forward", "pose_embedding"),
               (ConvStack, "run", "side_stacks"), (SVIVideoPipeline, "_denoise_step", "step"),
               (SVIVideoPipeline, "_dit_forward", "forward")]
    for tag, name, extra in runs:
        pipe = getattr(wan_video, name).from_model_manager(mm, device="cuda")
        seen = capture_decode(pipe)
        timer = PhaseTimer()
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with timed_methods(timer, targets):
            zero_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            frames = np.stack(pipe(**common, **extra))
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
            launches = read_counts()
        routes = check_fwd_routes(f"UniAnimate {tag}", need_f32=True)
        decoded = seen["v"]
        n_frames = UNI_LONG_FRAMES if tag == "long" else UNI_FRAMES
        finite = bool(torch.isfinite(decoded).all())
        sec = timer.seconds
        # replace-anyone steps by its own two batch-1 forwards and an Euler update
        forwards = sec.get("forward", [])
        steps = sec.get("step") or [a + b for a, b in zip(forwards[::2], forwards[1::2])]
        log(f"[unianimate {tag}] {name}: {run_s:.2f}s in all (T5 {[round(x, 3) for x in sec.get('tokenize_t5', [])]}, CLIP "
            f"{[round(x, 3) for x in sec.get('clip', [])]}, VAE encode "
            f"{[round(x, 3) for x in sec.get('vae_encode', [])]}, pose embedding "
            f"{[round(x, 3) for x in sec.get('pose_embedding', [])]}, side stacks "
            f"{[round(x, 3) for x in sec.get('side_stacks', [])]}, {len(steps)} denoise "
            f"steps{' (window steps)' if tag == 'long' else ''} at "
            f"{statistics.median(steps) if steps else 0:.3f}s each (median), VAE decode "
            f"{[round(x, 3) for x in sec.get('vae_decode', [])]}); frames {frames.shape}, "
            f"decoded finite {finite}; peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
            f"{ {k: v for k, v in launches.items() if v} }; forward routes {routes}; {card}")
        if frames.shape != (n_frames, SLICE_H, SLICE_W, 3) or not finite:
            raise RuntimeError(f"UniAnimate {tag}: frames {frames.shape}, finite {finite}")
        if min(launches[k] for k in ("flash_fwd_flat/sm90/128", "flash_fwd_flat/f32",
                                     "flash_fwd_bnsd/f32")) <= 0:
            raise RuntimeError(f"a kernel was not launched on UniAnimate {tag}: {launches}")
        clips[tag] = frames
        total = {k: total.get(k, 0) + v for k, v in launches.items()}
        del pipe, decoded, seen
    control_gap("unianimate pose", clips["plain"], clips["plain-no-pose"], gap, card)
    del mm
    gc.collect()
    torch.cuda.empty_cache()
    return total


def phase_pose(root: Path, card: str) -> dict:
    """Phase 7, the pose path: (a) tiny, card against CPU; (b) the full-width
    DWPose graphs; (c) the pose scripts on them; (d) UniAnimate at the 14B's
    width on phase 4e's files under root. Returns (d)'s launches."""
    t0 = time.perf_counter()
    gap = phase_pose_small(card)
    paths = phase_dwpose_full(root, card)
    scripts = phase_pose_scripts(root, paths, card)
    launches = phase_unianimate(root, scripts, gap, card)
    log(f"[pose] phase 7 passed in {time.perf_counter() - t0:.1f}s; {card}")
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
    (257 image and 512 text tokens) K5a + K5b on their sm90 route (the run
    fails otherwise); the CPU takes the plain backward."""
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
        if device == "cuda":
            check_split_routes("the tiny trainer")
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
          and min(counts[k] for k in ("flash_fwd_flat/sm90/128", "flash_bwd_onepass",
                                      "flash_bwd_dq/sm90", "flash_bwd_dkv/sm90")) > 0)
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
    features. Then phase 5c on the same trainer (`phase_full_depth_variants`)."""
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
    routes = check_fwd_routes("the training path", need_f32=True)
    split_routes = check_split_routes("the training path")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    finite = all(np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"]) for m in metrics)
    log(f"[train] {TRAIN_STEPS} steps: seconds per step {step_s}, steady {step_s[-1]:.3f}s, "
        f"peak memory {peak_gib:.2f} GiB, LoRA B max move after step 1 {b_moved:.3e}, "
        f"launches {launches}, forward routes {routes}, split backward routes {split_routes}")
    if not finite:
        raise RuntimeError("a training loss or grad_norm is not finite")
    if not b_moved > 0:
        raise RuntimeError("the LoRA B matrices did not move after step 1")
    # every step banks its errors, except a clean-input step that loses the
    # clean_buffer_update_prob draw
    if not (totals[-1] > 0 and all(b >= a for a, b in zip(totals, totals[1:]))):
        raise RuntimeError(f"the error buffers did not grow: {totals}")
    if min(n for k, n in launches.items()
           if k not in QUANT_KERNELS + QUANT_TRAIN + QUANT_F32 + PARALLEL_KERNELS
           + ZOO_KERNELS + T2I_KERNELS + BF16_KERNELS) <= 0:
        raise RuntimeError(f"a kernel was not launched on the training path: {launches}")
    # every block's self-attention backward in every step takes K4
    k4_expected = TRAIN_STEPS * wan_dit.WAN_14B_I2V.num_layers
    if launches["flash_bwd_onepass"] != k4_expected:
        raise RuntimeError(f"{launches['flash_bwd_onepass']} one-pass backward launches on the "
                           f"training path, expected {k4_expected}")
    # and its text and image cross-attention backward K5a + K5b on the sm90 route
    for entry in ("flash_bwd_dq/sm90", "flash_bwd_dkv/sm90"):
        if launches[entry] != 2 * k4_expected:
            raise RuntimeError(f"{launches[entry]} {entry} launches on the training path, "
                               f"expected {2 * k4_expected}")
    held = {"trainer": trainer}
    del trainer, dit, b_start
    phase_full_depth_variants(held, batch)
    return launches, step_s, peak_gib


def one_train_step(trainer, batch: dict, tag: str) -> dict:
    """One training step: seconds (synchronized), peak memory from a reset
    just before, the step's launches."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m = trainer.training_step(batch["latents"], batch["context"], y=batch["y"],
                              clip_feature=batch["clip_feature"])
    torch.cuda.synchronize()
    out = dict(seconds=time.perf_counter() - t0, peak=torch.cuda.max_memory_allocated() / 2**30,
               launches=read_counts(), loss=m["loss"], grad_norm=m["grad_norm"])
    log(f"[train-14b {tag}] step {out['seconds']:.3f}s, peak {out['peak']:.2f} GiB, loss "
        f"{m['loss']:.6f}, grad_norm {m['grad_norm']:.6f}, K1 sm90 "
        f"{out['launches']['flash_fwd_flat/sm90/128']}, K4 {out['launches']['flash_bwd_onepass']}, "
        f"K3 {out['launches']['unpack_requant_int4']}, w4a8_linear "
        f"{out['launches']['w4a8_linear']}")
    if not (np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])):
        raise RuntimeError(f"[train-14b {tag}] a loss or grad norm is not finite")
    return out


def phase_full_depth_variants(held: dict, batch: dict) -> None:
    """Phase 5c, on phase 5's 14B trainer (40 blocks, 21 frames at 480x832):
    one plain step, one with save_attention (each block's self-attention out
    / lse kept: the recompute skips its K1, 40 launches fewer), one with
    offload_carries (the checkpoints' carries in pinned host memory); then
    the DiT quantized in place to int4_w4a8 and 2 LoRA steps on it. Fails
    unless the K1 counts differ as they should, the quantized steps' linears
    all took w4a8_linear (forward and recompute) and K3 ran once for each
    that needs dx, with no torch._int_mm. `held` holds the only reference to
    the trainer, so that its adapters and optimizer state are freed before
    the quantized trainer's."""
    from svi_tpu_torch.models import wan_dit
    from svi_tpu_torch.training import ErrorRecyclingTrainer

    trainer = held.pop("trainer")
    layers = trainer.dit_cfg.num_layers
    log(f"[train-14b] profile of one plain step: "
        f"{device_time_breakdown(lambda: trainer.training_step(**batch))}")
    modes = {"plain": {}, "save_attention": dict(save_attention_activations=True),
             "offload_carries": dict(use_gradient_checkpointing_offload=True)}
    runs = {name: [] for name in modes}
    for rnd in range(FULL_DEPTH_ROUNDS):  # in turns, so that a drift of the card hits each
        for name, flags in modes.items():
            for key, value in flags.items():
                setattr(trainer.cfg, key, value)
            runs[name].append(one_train_step(trainer, batch, f"{name} round {rnd + 1}"))
            for key in flags:
                setattr(trainer.cfg, key, False)
    k1 = {name: {r["launches"]["flash_fwd_flat/sm90/128"] for r in rs} for name, rs in runs.items()}
    log("[train-14b] " + ", ".join(
        f"{name} {[round(r['seconds'], 3) for r in rs]}s / {max(r['peak'] for r in rs):.2f} GiB"
        for name, rs in runs.items()) + f"; K1 launches a step {k1}")
    plain_k1 = layers * 6  # self, text and image cross-attention, forward and recompute
    if k1 != {"plain": {plain_k1}, "save_attention": {plain_k1 - layers},
              "offload_carries": {plain_k1}}:
        raise RuntimeError(f"save_attention should skip one K1 a block in the recompute: {k1}")

    t0 = time.perf_counter()
    dit, cfg = trainer.dit, trainer.cfg
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    qdit = wan_dit.quantize_params_for_inference(dit, "int4_w4a8", consume=True)
    del dit
    gc.collect()
    torch.cuda.empty_cache()
    qtrainer = ErrorRecyclingTrainer(qdit, cfg, device="cuda")
    torch.cuda.synchronize()
    log(f"[train-14b-int4_w4a8] quantized in place and a fresh trainer in "
        f"{time.perf_counter() - t0:.2f}s; {torch.cuda.memory_allocated() / 2**30:.2f} GiB held")
    expect = {"w4a8_linear": w4a8_per_step(qdit), "quantize_rows_int8": w4a8_per_step(qdit),
              "unpack_requant_int4": k3_per_step(qdit)}
    with count_int_mm() as int_mm:
        steps = [one_train_step(qtrainer, batch, f"int4_w4a8 step {i + 1}") for i in range(2)]
    log(f"[train-14b-int4_w4a8] profile of one more step: "
        f"{device_time_breakdown(lambda: qtrainer.training_step(**batch))}")
    got = [{k: r["launches"][k] for k in expect} for r in steps]
    log(f"[train-14b-int4_w4a8] 2 LoRA steps on the int4_w4a8 base: "
        f"{[round(r['seconds'], 3) for r in steps]}s, peak {max(r['peak'] for r in steps):.2f} "
        f"GiB; launches a step {got} (expected {expect}), torch._int_mm {int_mm.calls}")
    if any(g != expect for g in got) or int_mm.calls:
        raise RuntimeError("the 14B int4_w4a8 LoRA step's linears did not all take w4a8_linear "
                           "and K3 as counted")
    del qtrainer, qdit
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 5a': the trainer variants, card against CPU
# ---------------------------------------------------------------------------

# The tiny bf16 trainer of phase 5a as each variant: pose training, customtalk
# training with audio, LoRA with audio (multitalk), LoRA on an int4_w4a8
# base (groups of 16, every linear of 1024 weights or more, as phase 4c's
# tiny DiT). One head of 128 on a 2 x 8 x 8 latent grid, 512 text and 257
# image tokens: every backward takes the sm90 split kernels on the card.
VARIANT_TRAINERS = {
    "pose": (dict(), dict(train_pose=True, pose_drop_prob1=0.3, cond_drop_prob=0.3), None),
    "customtalk": (dict(enable_customtalk=True, audio_hidden_dim=32, audio_context_tokens=4),
                   dict(train_architecture="customtalk", audio_drop_prob=0.3), None),
    "audio": (dict(enable_multitalk=True, audio_hidden_dim=32, audio_context_tokens=4),
              dict(audio_drop_prob=0.3), None),
    "int4_w4a8": (dict(), dict(), "int4_w4a8"),
}
# bf16 on both sides, as phase 5a's bounds: a few tenths of a percent per
# step in loss and gradient norm from bf16 roundings in other places; the
# int4_w4a8 base also rounds activations to int8 on both sides (one level
# apart where a value lands near a boundary), within the same bounds; Adam's
# first steps move each parameter by about lr * sign(grad), so the update
# directions agree up to the components whose gradient is within that noise
# of zero. The smallest trainable, the first pose conv (1296 weights, six
# convs and the DiT away from the loss), has the most such components: its
# update read a cosine of 0.896 on the first card run (NVIDIA H100 80GB
# HBM3, 700 W) while the loss agreed to 6e-5; a wrong gradient (sign, scale,
# a dropped term) gives a cosine of 0.5 or less
SMALL_TRAIN_LOSS_REL, SMALL_TRAIN_NORM_REL, SMALL_TRAIN_MIN_COS = 2e-2, 5e-2, 0.8
# phase 5c's full-depth steps: rounds of (plain, save_attention, offload_carries);
# one round since phase 8 joined the script (two before), to keep it under 720 s
FULL_DEPTH_ROUNDS = 1


def k3_per_step(dit) -> int:
    """The standalone K3 launches one training step gives on an int4_w4a8
    base: one for each quantized linear whose input needs a gradient (a
    linear whose input comes from no trainable leaf has no backward node):
    the blocks' and the head's, except block 0's self-attention q, k, v
    (they read the patch tokens) and each block's cross-attention k, v,
    k_img, v_img and audio kv_linear (they read the text, image and audio
    context). Held against a count on the CPU in
    tests/test_torch_training_variants.py."""
    count = 0
    for name, _ in dit.named_parameters():
        if not name.endswith("w_q4"):
            continue
        parts = name.split(".")
        if parts[0] == "head":
            count += 1
        elif parts[0] == "blocks":
            block, module, linear = int(parts[1]), parts[2], parts[3]
            context = (module == "cross_attn" and linear in ("k", "v", "k_img", "v_img")) or (
                module == "audio_cross_attn" and linear == "kv_linear")
            if not context and not (block == 0 and module == "self_attn"
                                    and linear in ("q", "k", "v")):
                count += 1
    return count


def w4a8_per_step(dit) -> int:
    """w4a8_linear launches of one training step with per-block remat: every
    quantized linear in the forward, the blocks' again in the recompute."""
    names = [n for n, _ in dit.named_parameters() if n.endswith("w_q4")]
    return len(names) + sum(1 for n in names if n.startswith("blocks."))


def _trainable_deltas(trainer, start):
    return {k: (p.detach().float().cpu() - start[k]).flatten()
            for k, p in trainer.named_trainables().items()}


def phase_small_variant_trainers(card: str) -> dict:
    """(5a') Each variant's tiny bf16 trainer on the card against the same
    trainer on the CPU, 3 steps on one batch: the same host draws
    (timestep, grid, clean input, buffer counts), losses and gradient norms
    within SMALL_TRAIN_*_REL, the trainables' updates in the same
    directions; the quantized base's K3 and W4A8 launches as counted.
    Returns the card's launches per variant."""
    import copy

    from svi_tpu_torch.models import wan_dit
    from svi_tpu_torch.training import ErrorRecyclingTrainer, TrainerConfig

    rng = np.random.default_rng(60)
    batch = dict(latents=rng.standard_normal((1, 16, 2, 16, 16)).astype(np.float32),
                 context=rng.standard_normal((1, 512, 64)).astype(np.float32),
                 y=rng.standard_normal((1, 20, 2, 16, 16)).astype(np.float32),
                 clip_feature=rng.standard_normal((1, 257, 64)).astype(np.float32))
    pose = rng.uniform(0, 255, (1, 3, 5, 128, 128)).astype(np.float32)
    audio = (rng.standard_normal((1, 1, 5, 12, 32)).astype(np.float32),
             rng.standard_normal((1, 1, 8, 12, 32)).astype(np.float32))
    out = {}
    for variant, (dit_kw, train_kw, quant) in VARIANT_TRAINERS.items():
        cfg = wan_dit.WanDiTConfig(dim=128, in_dim=36, ffn_dim=256, out_dim=16, text_dim=64,
                                   freq_dim=32, num_heads=1, num_layers=2,
                                   has_image_input=True, clip_feature_dim=64,
                                   dtype=torch.bfloat16, **dit_kw)
        base = wan_dit.init_params(cfg, seed=61, device="cpu")
        if quant:
            base = wan_dit.quantize_params_for_inference(base, quant, min_size=1024, group=16)
        tcfg = TrainerConfig(lora_rank=16, lora_alpha=16.0, buffer_warmup_iter=2,
                             error_buffer_k=8, num_grids=10, seed=0, **train_kw)
        kw = dict(batch)
        if "pose" in variant:
            kw["pose"] = pose
        if dit_kw:
            kw["audio_tuple"] = audio
        cpu = ErrorRecyclingTrainer(copy.deepcopy(base), tcfg, device="cpu")
        if cpu.lora is not None:
            with torch.no_grad():  # non-zero B, so that step 1 moves A as well
                g = torch.Generator().manual_seed(62)
                for name, p in cpu.lora.named_parameters():
                    if name.endswith(".b"):
                        p.copy_(torch.randn(p.shape, generator=g) * 0.02)
        card_t = ErrorRecyclingTrainer(copy.deepcopy(base).to("cuda"), tcfg, device="cuda")
        if cpu.lora is not None:
            card_t.lora = copy.deepcopy(cpu.lora).to("cuda")
        if cpu.pose_params is not None:
            card_t.pose_params = copy.deepcopy(cpu.pose_params).to("cuda")
        start = {k: p.detach().float().cpu().clone() for k, p in cpu.named_trainables().items()}
        runs = {}
        for where, trainer in (("card", card_t), ("cpu", cpu)):
            zero_counts()
            steps = []
            for _ in range(3):
                m = trainer.training_step(**kw)
                steps.append((m, _trainable_deltas(trainer, start)))
            runs[where] = (steps, read_counts(), trainer.buffers.stats())
            if where == "card":
                check_split_routes(f"the tiny {variant} trainer")
        worst = {"loss": 0.0, "norm": 0.0, "cos": 1.0, "at": None}
        draws_equal = True
        for (mg, dg), (mc, dc) in zip(runs["card"][0], runs["cpu"][0]):
            draws_equal &= all(mg[k] == mc[k] for k in ("timestep", "grid", "used_clean_input",
                                                        "buffer_latent_total",
                                                        "buffer_y_total"))
            worst["loss"] = max(worst["loss"], abs(mg["loss"] - mc["loss"]) / abs(mc["loss"]))
            worst["norm"] = max(worst["norm"],
                                abs(mg["grad_norm"] - mc["grad_norm"]) / abs(mc["grad_norm"]))
            for k, b in dc.items():
                cos = float(torch.nn.functional.cosine_similarity(dg[k], b, dim=0))
                if b.abs().max() > 0 and cos < worst["cos"]:
                    worst["cos"], worst["at"] = cos, k
        counts = runs["card"][1]
        expect = {}
        if quant:
            expect = {"unpack_requant_int4": 3 * k3_per_step(card_t.dit),
                      "w4a8_linear": 3 * w4a8_per_step(card_t.dit)}
        got = {k: counts[k] for k in expect}
        log(f"[train-small-{variant}] card vs CPU, 3 steps: loss rel err {worst['loss']:.2e} "
            f"(bound {SMALL_TRAIN_LOSS_REL}), grad_norm rel err {worst['norm']:.2e} (bound "
            f"{SMALL_TRAIN_NORM_REL}), min cosine of the updates {worst['cos']:.5f} at "
            f"{worst['at']} (bound {SMALL_TRAIN_MIN_COS}), host draws equal {draws_equal}, buffers "
            f"{runs['card'][2]} vs {runs['cpu'][2]}, losses "
            f"{[round(m['loss'], 6) for m, _ in runs['card'][0]]} (card) "
            f"{[round(m['loss'], 6) for m, _ in runs['cpu'][0]]} (CPU); K3 / W4A8 launches "
            f"{got} (expected {expect}); card launches {counts}; {card}")
        if not (draws_equal and runs["card"][2] == runs["cpu"][2]
                and worst["loss"] <= SMALL_TRAIN_LOSS_REL
                and worst["norm"] <= SMALL_TRAIN_NORM_REL and worst["cos"] >= SMALL_TRAIN_MIN_COS
                and got == expect and counts["flash_fwd_flat/sm90/128"] > 0):
            raise RuntimeError(f"the tiny {variant} trainer on the card disagrees with the CPU")
        out[variant] = counts
        del cpu, card_t, base
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 5b: the training drivers on files
# ---------------------------------------------------------------------------

# frames larger than 480x832, so that the random crop and the resize run
TRAIN_VIDEO_FRAMES, TRAIN_VIDEO_H, TRAIN_VIDEO_W = 30, 512, 928
TRAIN_DRIVER_STEPS, VARIANT_DRIVER_STEPS = 3, 2
# the resumed step against the uninterrupted one (same trainables, same
# batch, same host draws): the forward is the same computation on the same
# values (the loss is expected bit-equal; the bound leaves room for cuBLAS
# picking another algorithm); the backward sums dq (K4) and dk / dv (K5b)
# by TMA reduce-adds in an order that changes from run to run, a few bf16
# roundings of the gradient; Adam then moves a parameter by at most about
# lr = 1e-4 either way
RESUME_LOSS_REL, RESUME_NORM_REL, RESUME_PARAM_ABS = 1e-3, 2e-2, 2.5e-4


def write_train_datasets(root: Path, card: str) -> dict:
    """Seeded datasets in the JAX package's layouts, as .npy videos (the card
    has neither OpenCV nor Pillow) of TRAIN_VIDEO_FRAMES frames at
    TRAIN_VIDEO_H x TRAIN_VIDEO_W: shot (one category dir with two videos
    and its captions csv), dance (video.npy + dwpose.npy), talk (video.npy +
    audio_embedding.pkl, a numpy (12, 40, 768) array)."""
    import pickle

    t0 = time.perf_counter()
    rng = np.random.default_rng(50)
    shape = (TRAIN_VIDEO_FRAMES, TRAIN_VIDEO_H, TRAIN_VIDEO_W, 3)

    def video():
        return rng.integers(0, 255, shape, dtype=np.uint8)

    paths = {k: root / f"train_{k}" for k in ("shot", "dance", "talk")}
    cat = paths["shot"] / "seeded"
    cat.mkdir(parents=True)
    lines = ["Filename,Video Description"]
    for i in range(2):
        np.save(cat / f"clip_{i:02d}.npy", video())
        lines.append(f'clip_{i:02d}.npy,"A seeded training clip, number {i}."')
    (cat / "seeded.csv").write_text("\n".join(lines) + "\n")
    for name in ("dance", "talk"):
        (paths[name] / "00001").mkdir(parents=True)
        np.save(paths[name] / "00001" / "video.npy", video())
    np.save(paths["dance"] / "00001" / "dwpose.npy", video())
    with open(paths["talk"] / "00001" / "audio_embedding.pkl", "wb") as f:
        pickle.dump(rng.standard_normal((12, 40, 768)).astype(np.float32), f)
    log(f"[train-drivers] wrote the seeded .npy datasets ({TRAIN_VIDEO_FRAMES} frames of "
        f"{TRAIN_VIDEO_H}x{TRAIN_VIDEO_W} a video, 5 videos) in "
        f"{time.perf_counter() - t0:.2f}s; {card}")
    return {k: str(v) for k, v in paths.items()}


def run_train_driver(module, argv: list[str], tag: str, card: str):
    """One in-process run of a training driver: launch counts zeroed just
    before and read just after, per-phase seconds, peak memory. Returns
    (record, launches, int_mm calls)."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with count_int_mm() as int_mm:
        zero_counts()
        t0 = time.perf_counter()
        record = module.main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = read_counts()
    sec = record["seconds"]

    def r(name):
        return [round(x, 3) for x in sec.get(name, [])]

    metrics = record["metrics"]
    log(f"[train-driver {tag}] {seconds:.2f}s in all; per sample: dataset read (wait) "
        f"{r('data')}, T5 {r('t5')}, VAE encode {r('vae_encode')}, CLIP + y {r('clip_and_y')}; "
        f"step {r('step')}; export {r('export')}; losses {[round(m['loss'], 5) for m in metrics]}, "
        f"grad norms {[round(m['grad_norm'], 5) for m in metrics]}, timesteps "
        f"{[m['timestep'] for m in metrics]}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches {launches}; "
        f"torch._int_mm {int_mm.calls}; {card}")
    if not all(np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"]) for m in metrics):
        raise RuntimeError(f"[train-driver {tag}] a loss or grad norm is not finite")
    return record, launches, int_mm.calls


def check_train_driver(tag: str, record: dict, launches: dict, steps: int, out: Path,
                       blocks: int) -> None:
    """The files a run leaves and the kernels it took: args.json, one
    metrics line a step, the exports, every forward and split-backward
    launch on its route, one K4 launch a block a step."""
    lines = (out / "metrics.jsonl").read_text().splitlines()
    if not (out / "args.json").is_file() or len(lines) != steps or not record["exports"]:
        raise RuntimeError(f"[train-driver {tag}] args.json, {len(lines)} metrics lines or the "
                           f"exports {record['exports']} missing")
    check_fwd_routes(f"the {tag} training driver", need_f32=True)
    check_split_routes(f"the {tag} training driver")
    if launches["flash_bwd_onepass"] != steps * blocks:
        raise RuntimeError(f"[train-driver {tag}] {launches['flash_bwd_onepass']} K4 launches, "
                           f"expected {steps} steps x {blocks} blocks")


def profile_train_step(tag: str, trainer, batch: dict, card: str) -> None:
    """One more step of a driver's trainer on its last batch, profiled:
    device time by kind of kernel (the encoders are not in it)."""
    log(f"[train-driver {tag}] profile of one step: "
        f"{device_time_breakdown(lambda: trainer.training_step(**batch))}; {card}")


def check_resume(trainer, batch: dict, ckpt: Path, card: str) -> None:
    """save_checkpoint after the driver's run, restore_checkpoint into a
    fresh trainer on the same DiT, then one step of each on the driver's
    last batch: the same host draws, the loss and gradient norm and the
    trainables within the RESUME_* bounds."""
    from svi_tpu_torch.training import ErrorRecyclingTrainer

    trainer.save_checkpoint(str(ckpt))
    fresh = ErrorRecyclingTrainer(trainer.dit, trainer.cfg, device="cuda")
    fresh.restore_checkpoint(str(ckpt))
    got, want = fresh.training_step(**batch), trainer.training_step(**batch)
    draws = all(got[k] == want[k] for k in ("timestep", "grid", "used_clean_input",
                                            "buffer_latent_total", "buffer_y_total"))
    loss_rel = abs(got["loss"] - want["loss"]) / abs(want["loss"])
    norm_rel = abs(got["grad_norm"] - want["grad_norm"]) / abs(want["grad_norm"])
    mine = trainer.named_trainables()
    param = max((p - mine[k]).abs().max().item() for k, p in fresh.named_trainables().items())
    log(f"[train-driver b-resume] step {trainer.iteration_count} resumed from "
        f"{sum(f.stat().st_size for f in ckpt.iterdir()) / 1e6:.1f} MB of checkpoint: host "
        f"draws equal {draws} (timestep {got['timestep']}, grid {got['grid']}), loss "
        f"{got['loss']:.6f} vs {want['loss']:.6f} (rel {loss_rel:.2e}, bound {RESUME_LOSS_REL}), "
        f"grad norm rel {norm_rel:.2e} (bound {RESUME_NORM_REL}), trainables max |diff| "
        f"{param:.2e} (bound {RESUME_PARAM_ABS}); {card}")
    if not (draws and loss_rel <= RESUME_LOSS_REL and norm_rel <= RESUME_NORM_REL
            and param <= RESUME_PARAM_ABS):
        raise RuntimeError("the resumed run disagrees with the uninterrupted one")
    del fresh


def phase_train_drivers(root: Path, card: str) -> dict:
    """Phase 5b, the training drivers on phase 4e / 4f's files (the 14B at
    full width, 4 of 40 blocks; umT5 2 of 24 layers; CLIP and the VAE
    whole) and seeded .npy datasets: (a) train_svi at 480x832, 21 frames,
    3 steps with error recycling from step 2 and an export at step 2, then
    a resume from its checkpoint; (b) the same with --quantize int4_w4a8;
    (c) train_svi_dance and (d) train_svi_talk, 2 steps each; (e) the
    inference driver on (a)'s exported LoRA, one 9-frame clip. Fails unless
    the files are written, every launch took its route, K4 ran once a block
    a step, the quantized run's linears went through w4a8_linear (forward
    and recompute) and K3 ran once for each that needs dx, with no
    torch._int_mm, the dance run loaded and trained the pose convs, and the
    clip fused the export (B non-zero) into finite frames. Returns the
    quantized run's launches."""
    from svi_tpu_torch.scripts import test_svi, train_svi, train_svi_dance, train_svi_talk
    from svi_tpu_torch.utils.safetensors_io import load_file

    t_phase = time.perf_counter()
    data = write_train_datasets(root, card)
    shards = ",".join(str(p) for p in sorted(root.glob("diffusion_pytorch_model*.safetensors")))
    common = ["--dit_path", shards, "--vae_path", str(root / DRIVER_FILES["wan_video_vae"]),
              "--text_encoder_path", str(root / DRIVER_FILES["wan_video_text_encoder"]),
              "--image_encoder_path", str(root / DRIVER_FILES["wan_video_image_encoder"]),
              "--height", str(SLICE_H), "--width", str(SLICE_W),
              "--num_frames", str(TRAIN_FRAMES), "--use_error_recycling",
              "--buffer_warmup_iter", "1", "--save_every_n_steps", "2"]

    # (a) shot, bf16, then the resume
    out = root / "train_out_shot"
    record, launches, _ = run_train_driver(train_svi, [
        *common, "--dataset_path", data["shot"], "--output_path", str(out),
        "--max_steps", str(TRAIN_DRIVER_STEPS), "--profile_dir", str(root / "train_trace")],
        "a-shot", card)
    check_train_driver("a-shot", record, launches, TRAIN_DRIVER_STEPS, out, DRIVER_DIT_BLOCKS)
    trace = root / "train_trace" / "trace.json"
    log(f"[train-driver a-shot] exports {[Path(p).name for p in record['exports']]}; step-3 "
        f"trace {trace.stat().st_size / 1e6:.1f} MB")
    check_resume(record["trainer"], record["last_batch"], root / "train_ckpt", card)
    profile_train_step("a-shot", record["trainer"], record["last_batch"], card)
    export = record["exports"][-1]
    del record
    gc.collect()

    # (b) the same on an int4_w4a8 base
    out = root / "train_out_shot_q"
    record, q_launches, int_mm = run_train_driver(train_svi, [
        *common, "--dataset_path", data["shot"], "--output_path", str(out),
        "--max_steps", str(TRAIN_DRIVER_STEPS), "--quantize", "int4_w4a8"], "b-int4_w4a8", card)
    check_train_driver("b-int4_w4a8", record, q_launches, TRAIN_DRIVER_STEPS, out,
                       DRIVER_DIT_BLOCKS)
    dit = record["trainer"].dit
    expect = {"w4a8_linear": TRAIN_DRIVER_STEPS * w4a8_per_step(dit),
              "quantize_rows_int8": TRAIN_DRIVER_STEPS * w4a8_per_step(dit),
              "unpack_requant_int4": TRAIN_DRIVER_STEPS * k3_per_step(dit)}
    got = {k: q_launches[k] for k in expect}
    log(f"[train-driver b-int4_w4a8] {sum(1 for n, _ in dit.named_parameters() if n.endswith('w_q4'))}"
        f" quantized linears; launches {got} (expected {expect}), torch._int_mm {int_mm}; {card}")
    if got != expect or int_mm:
        raise RuntimeError("the quantized training run's linears did not all take w4a8_linear "
                           "and K3 as counted")
    profile_train_step("b-int4_w4a8", record["trainer"], record["last_batch"], card)
    del record, dit
    gc.collect()

    # (c) dance, from the dance LoRA with its pose convs
    out = root / "train_out_dance"
    lora_sd = load_file(str(root / "svi-dance.safetensors"))
    record, launches, _ = run_train_driver(train_svi_dance, [
        *common, "--dataset_path", data["dance"], "--output_path", str(out),
        "--max_steps", str(VARIANT_DRIVER_STEPS),
        "--pretrained_lora_path", str(root / "svi-dance.safetensors")], "c-dance", card)
    check_train_driver("c-dance", record, launches, VARIANT_DRIVER_STEPS, out, DRIVER_DIT_BLOCKS)
    pose = record["trainer"].pose_params["layers"][0]["w"].detach().float().cpu()
    moved = (pose - lora_sd["dwpose_embedding.0.weight"].float()).abs().max().item()
    log(f"[train-driver c-dance] pose conv 0 moved by {moved:.2e} from the file's after "
        f"{VARIANT_DRIVER_STEPS} steps (Adam: at most about {VARIANT_DRIVER_STEPS} x lr)")
    if not 0 < moved <= 1.5 * VARIANT_DRIVER_STEPS * 1e-4:
        raise RuntimeError("the dance driver did not start from the file's pose convs, or did "
                           "not train them")
    profile_train_step("c-dance", record["trainer"], record["last_batch"], card)
    del record, lora_sd
    gc.collect()

    # (d) talk, with the multitalk branches
    out = root / "train_out_talk"
    record, launches, _ = run_train_driver(train_svi_talk, [
        *common, "--dataset_path", data["talk"], "--output_path", str(out),
        "--max_steps", str(VARIANT_DRIVER_STEPS),
        "--multitalk_path", str(root / "multitalk.safetensors")], "d-talk", card)
    check_train_driver("d-talk", record, launches, VARIANT_DRIVER_STEPS, out, DRIVER_DIT_BLOCKS)
    if not record["trainer"].dit.cfg.enable_multitalk:
        raise RuntimeError("the talk training driver's DiT did not load as multitalk")
    profile_train_step("d-talk", record["trainer"], record["last_batch"], card)
    del record
    gc.collect()
    torch.cuda.empty_cache()

    # 6c: train_svi under torchrun on these files, the ranks sharing the card
    phase_parallel_drivers(root, common, data, card)

    # (e) extract_lora on the exported shot LoRA, then the extracted file
    # through the inference driver
    from svi_tpu_torch.scripts import extract_lora

    extracted = str(root / "svi-shot-extracted.safetensors")
    n_extracted = extract_lora.main(["--input", export, "--output", extracted])
    sd = load_file(extracted)
    exported = load_file(export)
    log(f"[train-driver e-infer] extract_lora: {n_extracted} of the export's {len(exported)} "
        f"tensors, f32: {all(v.dtype == torch.float32 for v in sd.values())}")
    if sorted(sd) != sorted(k for k in exported if "lora_" in k) or any(
            not torch.equal(sd[k], exported[k].float()) for k in sd):
        raise RuntimeError("extract_lora did not keep the export's LoRA tensors as they are")
    del exported
    b_max = max(v.abs().max().item() for k, v in sd.items() if ".lora_B." in k)
    argv = ["--dit_root", str(root), "--extra_module_root", extracted,
            "--output", str(root / "videos_trained"), "--ref_image_path", str(root / "frame.npy"),
            "--prompt_path", str(REPO / "data" / "toy_test" / "shot" / "prompt.txt"),
            "--num_frames", str(SLICE_FRAMES), "--num_steps", str(SLICE_STEPS),
            "--num_motion_frames", str(MOTION), "--ref_pad_num", "-1", "--cfg_scale_text", "5.0",
            "--num_clips", "1", "--save_format", "npy"]
    t0 = time.perf_counter()
    rec = test_svi.main(argv)
    (sample,) = rec["samples"]
    fused = rec["manager"].lora_log
    log(f"[train-driver e-infer] the extracted LoRA ({len(sd)} tensors, max |B| {b_max:.3e}) "
        f"fused {fused} in the inference driver; one clip in {time.perf_counter() - t0:.2f}s; "
        f"{card}")
    if not (b_max > 0 and fused and fused[0][1] == len(sd) // 2):
        raise RuntimeError("the exported LoRA was not fused, or its B matrices are zero")
    check_driver_video("e-infer", sample, clips=1)
    del rec, sd
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[train-drivers] phase 5b passed in {time.perf_counter() - t_phase:.1f}s; {card}")
    return q_launches



# ---------------------------------------------------------------------------
# phase 6: the parallel slice
# ---------------------------------------------------------------------------

# The card's machine has one GPU, so the ranks share it over gloo (NCCL cannot
# put two ranks on one GPU); a one-rank NCCL group runs the NCCL code. Speeds
# of ranks sharing one card measure no multi-card speed: printed, not claimed.
PARALLEL_DEPTH = 1  # blocks of the 14B in 6b: two ranks and their references on one card
PARALLEL_SEED = 31
# 6a's tiny DiT: head dim 128, so that every attention takes the kernels of
# the 14B's routes (f32: 3xTF32; bf16: sm90); 3 x 3 x 5 = 45 tokens, padded
# over 2 and 4 ranks
PAR_TINY = dict(dim=256, in_dim=36, ffn_dim=512, out_dim=16, text_dim=64, freq_dim=32,
                num_heads=2, num_layers=2, has_image_input=True, clip_feature_dim=64)
PAR_TINY_LATENT = (3, 6, 10)
# f32 sharded forwards against the card's single-device forward and the
# CPU's: f32 rounding (3xTF32 in the attention kernels) summed in other
# orders, as a share of the output's largest value
PAR_F32_REL = 1e-4
# bf16 LoRA gradients (sum over the ranks, as the trainer sums them) against
# the single-device gradients: bf16 activations rounded where the sharded
# path rounds them (other GEMM shapes, the gathered keys), 2^-8 relative a
# rounding through two blocks forward and back, as a share of the largest
# gradient; a missing or doubled rank's share moves them by their own size
PAR_BF16_GRAD_REL = 5e-2
# the 14B at full width, bf16, sharded against single-device on the same
# card: the mean |difference| over the mean |output| (bf16 roundings in
# other GEMM tilings and the ring's f32 merge of per-block bf16 results),
# and the loss and gradient norm of a train step as the training drivers'
# sharded-against-one-process bounds (tests/test_torch_parallel_training.py)
PAR_14B_MEAN_REL = 1e-2
PAR_14B_LOSS_REL, PAR_14B_NORM_REL = 1e-2, 2e-2
RANK_TIMEOUT = 900  # seconds for a phase-6 rank's result; a hang fails the phase


def _rank_entry(fn, rank, world, backend, store, results, args):
    import datetime
    import traceback

    import torch.distributed as dist

    sys.path.insert(0, str(REPO))
    torch.cuda.set_device(0)
    try:
        dist.init_process_group(backend, init_method=f"file://{store}", rank=rank,
                                world_size=world, timeout=datetime.timedelta(seconds=300))
        results.put((rank, None, fn(rank, world, *args)))
    except BaseException:  # noqa: BLE001 -- sent to the parent, which raises it
        results.put((rank, traceback.format_exc(), None))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn, world: int, backend: str, *args) -> list:
    """fn(rank, world, *args) in `world` spawned processes on the card, joined
    over `backend` through a FileStore in the checkout; their results in rank
    order, or the first failure's traceback. Every process is ended."""
    import multiprocessing
    import queue

    store = REPO / f"_parallel_store_{fn.__name__}_{world}_{backend}"
    store.unlink(missing_ok=True)
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_entry, args=(fn, r, world, backend, str(store), results,
                                                   args), daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    out, errors = {}, []
    try:
        for _ in range(world):
            rank, err_text, res = results.get(timeout=RANK_TIMEOUT)
            if err_text:
                errors.append(f"rank {rank}:\n{err_text}")
            out[rank] = res
    except queue.Empty:
        errors.append(f"ranks {sorted(set(range(world)) - set(out))} gave no result in "
                      f"{RANK_TIMEOUT} s")
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
        store.unlink(missing_ok=True)
    if errors:
        raise RuntimeError(f"{fn.__name__} over {world} {backend} ranks failed:\n"
                           + "\n".join(errors))
    return [out[r] for r in range(world)]


def _add_counts(total: dict, counts: dict) -> dict:
    for k, n in counts.items():
        total[k] = total.get(k, 0) + n
    return total


def _routes(entry) -> dict:
    return {"/".join(map(str, k)): n for k, n in entry.routes.items()}


def _bwd_routes() -> dict:
    from svi_tpu_torch.ops import attention as A

    return {"onepass": A.flash_bwd_onepass.launches, "dq": _routes(A.flash_bwd_dq),
            "dkv": _routes(A.flash_bwd_dkv)}


def _rel(x, ref) -> float:
    x, ref = x.float().cpu(), ref.float().cpu()
    if not torch.isfinite(x).all():
        return float("inf")
    return (x - ref).abs().max().item() / ref.abs().max().item()


def _par_tiny(rank, world, meshes):
    """6a on one rank: the tiny DiT's sharded forwards in f32 (all-gather,
    ring, TP, TP x SP) and its sharded bf16 LoRA gradients, each against the
    card's single-device run and the CPU's. Returns the relative errors, the
    launches of the sharded runs and their routes."""
    from svi_tpu_torch.models import wan_dit
    from svi_tpu_torch.ops import attention as A
    from svi_tpu_torch.parallel import collectives, make_mesh
    from svi_tpu_torch.parallel.sequence_parallel import forward_sp
    from svi_tpu_torch.parallel.tensor_parallel import forward_tp, shard_dit_params_tp
    from svi_tpu_torch.parallel.tp_sp import forward_tpsp, make_mesh3, shard_dit_params_tpsp
    from svi_tpu_torch.training import lora as lora_mod

    rng = np.random.default_rng(43)
    f, h, w = PAR_TINY_LATENT
    host_in = [torch.from_numpy(a) for a in (
        rng.standard_normal((2, 16, f, h, w)).astype(np.float32),
        np.array([300.0, 700.0], np.float32),
        rng.standard_normal((2, 9, PAR_TINY["text_dim"])).astype(np.float32),
        rng.standard_normal((2, 257, PAR_TINY["clip_feature_dim"])).astype(np.float32),
        rng.standard_normal((2, 20, f, h, w)).astype(np.float32))]
    card_in = [t.cuda() for t in host_in]
    errors, counts, routes = {}, {}, {}

    def sharded(fn):
        zero_counts()
        with torch.no_grad():
            out = fn()
        torch.cuda.synchronize()
        _add_counts(counts, read_counts())
        return out

    for dtype in (torch.float32, torch.bfloat16):
        cfg = wan_dit.WanDiTConfig(dtype=dtype, **PAR_TINY)
        host = wan_dit.init_params(cfg, seed=41, device="cpu")
        card = wan_dit.WanDiT(cfg, _tree_to(host.tree(), "cuda"))
        if dtype == torch.float32:
            with torch.no_grad():
                refs = (card(*card_in), host(*host_in))
            for mesh_shape in meshes["sp"]:
                mesh = make_mesh(*mesh_shape)
                for ring in (False, True):
                    out = sharded(lambda: forward_sp(card, *card_in, mesh=mesh, ring=ring))
                    errors[f"sp_{mesh_shape}_{'ring' if ring else 'gather'}"] = [
                        _rel(out, r) for r in refs]
            mesh = make_mesh(*meshes["tp"])
            tp = shard_dit_params_tp(host, mesh, device="cuda")
            errors[f"tp_{meshes['tp']}"] = [_rel(sharded(
                lambda: forward_tp(tp, *card_in, mesh=mesh)), r) for r in refs]
            mesh = make_mesh3(*meshes["tpsp"])
            tpsp = shard_dit_params_tpsp(host, mesh, device="cuda")
            for ring in (False, True):
                errors[f"tpsp_{meshes['tpsp']}_{'ring' if ring else 'gather'}"] = [
                    _rel(sharded(lambda: forward_tpsp(tpsp, *card_in, mesh=mesh, ring=ring)), r)
                    for r in refs]
            routes["forward"] = {e: _routes(getattr(A, e))
                                 for e in ("flash_fwd_flat", "flash_fwd_bnsd")}
            continue
        # bf16 LoRA gradients of sum(out * g): sharded (summed over the ranks),
        # single-device on the card and on the CPU
        lora_host = lora_mod.init_lora_params(cfg, rank=4, device="cpu",
                                              generator=torch.Generator().manual_seed(44))
        with torch.no_grad():
            for p in lora_host.parameters():
                p.add_(0.02)
        g = torch.from_numpy(rng.standard_normal((2, 16, f, h, w)).astype(np.float32))

        def grads(model, lora, inputs, mesh=None):
            kw = dict(lora=lora, lora_scale=0.5, use_remat=True)
            out = (forward_sp(model, *inputs, mesh=mesh, **kw) if mesh is not None
                   else model(*inputs, **kw))
            (out.float() * g.to(out.device)).sum().backward()
            gs = [p.grad.detach().clone() for p in lora.parameters()]
            for p in lora.parameters():
                p.grad = None
            return gs

        lora_card = lora_mod.from_peft_state_dict(lora_mod.to_peft_state_dict(lora_host), cfg,
                                                  device="cuda")
        want = (grads(card, lora_card, card_in), grads(host, lora_host, host_in))
        mesh = make_mesh(*meshes["grads"])
        zero_counts()
        got = grads(card, lora_card, card_in, mesh)
        torch.cuda.synchronize()
        _add_counts(counts, read_counts())
        routes["backward"] = _bwd_routes()
        for gr in got:
            collectives.all_reduce_(gr, mesh.world)
        scale = [max(t.abs().max().item() for t in ws) for ws in want]
        errors[f"grads_{meshes['grads']}"] = [
            max((a.float().cpu() - b.float().cpu()).abs().max().item() for a, b in zip(got, ws))
            / sc for ws, sc in zip(want, scale)]
    return {"errors": errors, "counts": counts, "routes": routes}


def _par_14b(rank, world):
    """6b on one rank: the 14B at full width cut to PARALLEL_DEPTH blocks
    (the same seeded weights on every rank): forward_sp at 480x832x81
    (all-gather and ring) against rank 0's single-device forward; one SP
    LoRA train step at 21 frames (480x832) and one at 81 frames (496x848,
    an odd token count, so every rank's keys carry a padded position) beside
    rank 0's single-device step, with each process's peak memory; then the
    blocks sliced for forward_tp from a host copy, its weight bytes."""
    import torch.distributed as dist

    from svi_tpu_torch.models import wan_dit
    from svi_tpu_torch.ops import attention as A
    from svi_tpu_torch.parallel import make_mesh, make_training_mesh
    from svi_tpu_torch.parallel.sequence_parallel import forward_sp
    from svi_tpu_torch.parallel.tensor_parallel import (forward_tp, param_bytes,
                                                        shard_dit_params_tp)
    from svi_tpu_torch.training import ErrorRecyclingTrainer, TrainerConfig

    cfg = dataclasses.replace(wan_dit.WAN_14B_I2V, num_layers=PARALLEL_DEPTH)
    dit = wan_dit.init_params(cfg, seed=PARALLEL_SEED, device="cuda")
    mesh = make_mesh(1, world)
    out = {"rank": rank, "counts": {}, "routes": {}, "seconds": {}, "peak_gib": {}, "rel": {}}
    rng = np.random.default_rng(32)

    def inputs(frames, h, w):
        lt = (frames - 1) // 4 + 1
        return dict(latents=rng.standard_normal((1, 16, lt, h // 8, w // 8)).astype(np.float32),
                    context=rng.standard_normal((1, 512, 4096)).astype(np.float32),
                    y=rng.standard_normal((1, 20, lt, h // 8, w // 8)).astype(np.float32),
                    clip_feature=rng.standard_normal((1, 257, 1280)).astype(np.float32))

    b81 = inputs(FORWARD_FRAMES, SLICE_H, SLICE_W)
    args = [torch.from_numpy(b81[k]).cuda() for k in ("latents",)] + [
        torch.tensor([500.0], device="cuda"), torch.from_numpy(b81["context"]).cuda(),
        torch.from_numpy(b81["clip_feature"]).cuda(), torch.from_numpy(b81["y"]).cuda()]
    ref = None
    if rank == 0:
        with torch.no_grad():
            ref = dit(*args)
        torch.cuda.synchronize()
    dist.barrier()

    def timed(tag, fn):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        out["seconds"][tag] = time.perf_counter() - t0
        out["peak_gib"][tag] = torch.cuda.max_memory_allocated() / 2**30
        out["counts"][tag] = read_counts()
        out["routes"][tag] = dict(_bwd_routes(), bnsd=_routes(A.flash_fwd_bnsd))
        return res

    for ring in (False, True):
        tag = f"forward_sp_81f_{'ring' if ring else 'gather'}"
        with torch.no_grad():
            got = timed(tag, lambda: forward_sp(dit, *args, mesh=mesh, ring=ring))
        out["rel"][tag] = None if ref is None else (
            (got.float() - ref.float()).abs().mean() / ref.float().abs().mean()).item()
        out.setdefault("checksum", {})[tag] = got.double().sum().item()
        del got

    train_cfg = TrainerConfig(lora_rank=128, lora_alpha=128.0, use_gradient_checkpointing=True,
                              remat_granularity=1, seed=0)
    for tag, frames, h, w in (("21f", TRAIN_FRAMES, SLICE_H, SLICE_W), ("81f", 81, 496, 848)):
        batch = inputs(frames, h, w)
        trainer = ErrorRecyclingTrainer(dit, train_cfg, mesh=make_training_mesh("sp"),
                                        device="cuda")
        m = timed(f"train_sp_{tag}", lambda: trainer.training_step(**batch))
        out[f"train_sp_{tag}"] = {k: m[k] for k in ("loss", "grad_norm", "timestep")}
        del trainer
        if rank == 0:
            single = ErrorRecyclingTrainer(dit, train_cfg, device="cuda")
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            m1 = single.training_step(**batch)
            torch.cuda.synchronize()
            out["seconds"][f"train_single_{tag}"] = time.perf_counter() - t0
            out["peak_gib"][f"train_single_{tag}"] = torch.cuda.max_memory_allocated() / 2**30
            out[f"train_single_{tag}"] = {k: m1[k] for k in ("loss", "grad_norm", "timestep")}
            del single
        dist.barrier()

    # TP: the blocks sliced from a host copy, so the card never holds a
    # second full tree
    host = wan_dit.WanDiT(cfg, _tree_to(dit.tree(), "cpu"))
    del dit
    gc.collect()
    torch.cuda.empty_cache()
    tp = shard_dit_params_tp(host, mesh, device="cuda")
    out["weight_bytes"] = {"tp_rank": param_bytes(tp), "unsharded": param_bytes(host),
                           "tp_rank_blocks": param_bytes(tp["blocks"]),
                           "unsharded_blocks": param_bytes(host["blocks"])}
    del host
    with torch.no_grad():
        got = timed("forward_tp_81f", lambda: forward_tp(tp, *args, mesh=mesh))
    out["rel"]["forward_tp_81f"] = None if ref is None else (
        (got.float() - ref.float()).abs().mean() / ref.float().abs().mean()).item()
    out["checksum"]["forward_tp_81f"] = got.double().sum().item()
    out["finite"] = bool(torch.isfinite(got).all())
    return out


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device) for v in tree]
    return tree.to(device)


def phase_parallel(card: str) -> dict:
    """Phase 6, the parallel slice through its entry points, every rank a
    process on the one card: (a) the tiny DiT on 4 gloo ranks (forward_sp
    padded with all-gather and ring on (2, 2) and (1, 4), forward_tp on
    (2, 2), forward_tpsp on (1, 2, 2), sharded bf16 LoRA gradients on
    (1, 4)), each against the card's single-device run and the CPU's, and
    at the same time the same on a one-rank NCCL group; (b) the 14B at full
    width cut to
    PARALLEL_DEPTH blocks on 2 gloo ranks (`_par_14b`). Fails unless every
    result is within its bound, every sharded self-attention backward took
    K4 or K5 and every ring step K2's sm90 route. Returns the launches of
    the sharded runs, summed over the ranks. (6c, the training driver under
    torchrun, runs at the end of phase 5b on its files:
    `phase_parallel_drivers`.)"""
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    total: dict = {}
    meshes4 = {"sp": [(2, 2), (1, 4)], "tp": (2, 2), "tpsp": (1, 2, 2), "grads": (1, 4)}
    meshes1 = {"sp": [(1, 1)], "tp": (1, 1), "tpsp": (1, 1, 1), "grads": (1, 1)}
    groups = ((4, "gloo", meshes4), (1, "nccl", meshes1))
    # the two groups are independent processes on the card, each with a
    # tiny model: they run at once, and each is checked as on its own
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(groups)) as pool:
        runs = [pool.submit(run_ranks, _par_tiny, world, backend, meshes)
                for world, backend, meshes in groups]
        group_results = [run.result() for run in runs]
    seconds = time.perf_counter() - t0
    for (world, backend, _), per_rank in zip(groups, group_results):
        for res in per_rank:
            _add_counts(total, res["counts"])
        worst_err = {name: max(max(r["errors"][name]) for r in per_rank)
                     for name in per_rank[0]["errors"]}
        log(f"[parallel a] tiny DiT on {world} {backend} rank(s) ({seconds:.1f}s for both "
            f"groups at once): max relative error (card single-device, CPU) "
            f"per case {json.dumps({n: r['errors'][n] for r in per_rank[:1] for n in r['errors']})}"
            f"; worst over ranks {worst_err}; forward routes {per_rank[0]['routes']['forward']}; "
            f"backward routes {per_rank[0]['routes']['backward']}; {card}")
        for name, e in worst_err.items():
            bound = PAR_BF16_GRAD_REL if name.startswith("grads") else PAR_F32_REL
            if not e <= bound:
                raise RuntimeError(f"[parallel a] {name} on {world} {backend} ranks: {e:.3e} > "
                                   f"{bound}")
        for res in per_rank:
            bwd = res["routes"]["backward"]
            if bwd["onepass"] or set(bwd["dq"]) != {"sm90/bfloat16/128"} or set(
                    bwd["dkv"]) != {"sm90/bfloat16/128"}:
                raise RuntimeError(f"[parallel a] a sharded backward took another route: {bwd}")

    t0 = time.perf_counter()
    per_rank = run_ranks(_par_14b, 2, "gloo")
    r0 = per_rank[0]
    for res in per_rank:
        for tag, counts in res["counts"].items():
            _add_counts(total, counts)
        log(f"[parallel b] rank {res['rank']}: seconds {json.dumps(res['seconds'])}; peak GiB "
            f"{json.dumps(res['peak_gib'])}; weight bytes {json.dumps(res['weight_bytes'])}; "
            f"routes {json.dumps(res['routes'])}; {card}")
    log(f"[parallel b] Wan2.1-I2V-14B at full width, {PARALLEL_DEPTH} of 40 blocks, 2 gloo ranks "
        f"on one card ({time.perf_counter() - t0:.1f}s): mean relative difference against the "
        f"single-device run {json.dumps(r0['rel'])} (bound {PAR_14B_MEAN_REL}); train steps "
        f"sp {r0['train_sp_21f']} / {r0['train_sp_81f']}, single {r0['train_single_21f']} / "
        f"{r0['train_single_81f']}; {card}")
    for tag, rel in r0["rel"].items():
        if not rel <= PAR_14B_MEAN_REL:
            raise RuntimeError(f"[parallel b] {tag}: {rel:.3e} > {PAR_14B_MEAN_REL}")
    if per_rank[0]["checksum"] != per_rank[1]["checksum"] or not r0["finite"]:
        raise RuntimeError("[parallel b] the ranks' outputs differ, or are not finite")
    for tag in ("21f", "81f"):
        sp, one = r0[f"train_sp_{tag}"], r0[f"train_single_{tag}"]
        if not (sp["timestep"] == one["timestep"]
                and abs(sp["loss"] - one["loss"]) <= PAR_14B_LOSS_REL * abs(one["loss"])
                and abs(sp["grad_norm"] - one["grad_norm"])
                <= PAR_14B_NORM_REL * abs(one["grad_norm"])):
            raise RuntimeError(f"[parallel b] the {tag} SP train step disagrees with the "
                               f"single-device one: {sp} vs {one}")
    for res in per_rank:
        for tag in ("train_sp_21f", "train_sp_81f"):
            r = res["routes"][tag]
            if (r["onepass"] != PARALLEL_DEPTH or set(r["dq"]) != {"sm90/bfloat16/128"}
                    or r["dq"]["sm90/bfloat16/128"] != 2 * PARALLEL_DEPTH
                    or r["dkv"] != r["dq"]):
                raise RuntimeError(f"[parallel b] {tag}: the self-attention backward did not "
                                   f"take K4 once a block (and K5 twice): {r}")
        ring = res["routes"]["forward_sp_81f_ring"]["bnsd"]
        if ring != {"sm90/bfloat16/128": 2 * PARALLEL_DEPTH}:
            raise RuntimeError(f"[parallel b] the ring steps took another route: {ring}")
    log(f"[parallel] phase 6 (a, b) passed in {time.perf_counter() - t_phase:.1f}s; launches of "
        f"the sharded runs over the ranks {total}; {card}")
    return total


def phase_parallel_drivers(root: Path, common: list, data: dict, card: str) -> None:
    """6c: train_svi as users launch it on several GPUs, `torchrun
    --nproc_per_node 2 -m svi_tpu_torch.scripts.train_svi`, on phase 5b's
    files; the two ranks share the card, so the launch picks gloo. Once with
    --training_strategy sp, once data_parallel --shard_optimizer_state; 2
    steps of 9 frames each, the export at step 2. Fails unless the run exits
    0 and rank 0 wrote args.json, a finite metrics line a step and the
    export."""
    import socket

    for tag, flags in (("sp", ["--training_strategy", "sp"]),
                       ("zero1", ["--training_strategy", "data_parallel",
                                  "--shard_optimizer_state"])):
        out = root / f"train_out_torchrun_{tag}"
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        cmd = [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1",
               "--nproc_per_node", "2", "--master_addr", "127.0.0.1", "--master_port", str(port),
               "-m", "svi_tpu_torch.scripts.train_svi", *common, "--num_frames", "9",
               "--dataset_path", data["shot"], "--output_path", str(out), "--max_steps", "2",
               *flags]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=600)
        seconds = time.perf_counter() - t0
        lines = (out / "metrics.jsonl").read_text().splitlines() if (
            out / "metrics.jsonl").is_file() else []
        metrics = [json.loads(x) for x in lines]
        tail = "\n".join((proc.stdout + proc.stderr).splitlines()[-30:])
        log(f"[parallel c] torchrun train_svi {tag}: exit {proc.returncode} in {seconds:.1f}s; "
            f"losses {[round(m['loss'], 5) for m in metrics]}, grad norms "
            f"{[round(m['grad_norm'], 5) for m in metrics]}; files "
            f"{sorted(p.name for p in out.iterdir()) if out.is_dir() else []}; {card}")
        if proc.returncode != 0 or len(metrics) != 2 or not (out / "args.json").is_file() \
                or [p.name.split("-")[1] for p in out.glob("*.safetensors")] != [
                    "step=2.safetensors"] or not all(
                    np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"]) for m in metrics):
            raise RuntimeError(f"[parallel c] torchrun train_svi {tag} failed:\n{tail}")
        log(f"[parallel c] {tag} log: " + " | ".join(
            x for x in (proc.stdout + proc.stderr).splitlines()
            if "torch.distributed" in x or "training mesh" in x))


# ---------------------------------------------------------------------------
# phase 8: the SD 1.5 video stack (UNet, ControlNet, AnimateDiff, VAE, CLIP
# text) and SDVideoPipelineRunner
# ---------------------------------------------------------------------------

# (d)'s 4 frames in one window: cut from 8 to make room for (e) (the runner's
# FastBlend pass took 10.7 of its 20.3 s at 8 frames)
SD_H, SD_W, SD_FRAMES, SD_STEPS, SD_STRENGTH = 512, 512, 4, 3, 0.9
SD_WINDOW, SD_STRIDE, SD_CN_SCALE, SD_CONTRAST, SD_SMOOTH_AT = 4, 4, 0.5, 1.3, 1
SD_PROMPT = "a watercolor painting of a city street at dusk, soft light"
SD_FILES = {"sd_unet": "sd15_unet.safetensors", "sd_text_encoder": "sd15_text_encoder.safetensors",
            "sd_vae_encoder": "sd15_vae_encoder.safetensors",
            "sd_vae_decoder": "sd15_vae_decoder.safetensors",
            "sd_motion_modules": "animatediff_v2_motion.safetensors",
            "sd_controlnet": "sd15_controlnet_tile.safetensors"}
# Card against CPU, f32 on both. Before any uint8 cast (the small pipeline's
# render at the smoother's step, the full-width forward): the card's
# attention is 3xTF32 (about 2^-21 relative a product), its convolutions
# cuDNN's f32 algorithms and its GEMMs cuBLAS's, each summing in another
# order than the CPU's, through 60-odd layers: 1e-4 of the output's scale
# for the small models, 1e-3 at full width (its sums are 10-40x longer).
# After the smoother has cast frames to uint8 and encoded them again, an
# f32 difference can move a value across a rounding boundary: the final
# latents within 1e-3, the frames within one level.
SD_SMALL_REL, SD_FULL_REL, SD_SMOOTHED_REL, SD_LEVELS = 1e-4, 1e-3, 1e-3, 1


def _sd_fixtures():
    """tests/torch_sd_fixtures.py (narrow plans, seeded state dicts; no JAX)."""
    if str(REPO / "tests") not in sys.path:
        sys.path.insert(0, str(REPO / "tests"))
    import torch_sd_fixtures

    return torch_sd_fixtures


class patched:
    """Module attributes replaced inside the block: [(module, name, value)]."""

    def __init__(self, sets):
        self.sets = sets

    def __enter__(self):
        self.saved = [getattr(m, k) for m, k, _ in self.sets]
        for m, k, v in self.sets:
            setattr(m, k, v)

    def __exit__(self, *exc):
        for (m, k, _), v in zip(self.sets, self.saved):
            setattr(m, k, v)


def sd_plans(unet, vae_encoder, vae_decoder, controlnet) -> patched:
    """The SD plans of the port's modules set to others inside the block."""
    from svi_tpu_torch.models import controlnets as cn
    from svi_tpu_torch.models import sd

    return patched([(sd, "SD_UNET_PLAN", unet), (sd, "SD_VAE_ENCODER_PLAN", vae_encoder),
                    (sd, "SD_VAE_DECODER_PLAN", vae_decoder),
                    (cn, "SD_CONTROLNET_PLAN", controlnet)])


def sd_frames(n: int, h: int, w: int, seed: int) -> np.ndarray:
    """(n, h, w, 3) uint8: moving gradients plus seeded noise."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    out = np.empty((n, h, w, 3), np.uint8)
    for i in range(n):
        base = np.stack([x * 256 // w + 6 * i, y * 256 // h, (x + y) * 128 // (h + w) + 40], -1)
        out[i] = np.clip(base % 256 + rng.integers(-24, 25, (h, w, 3)), 0, 255)
    return out


def sd_expected_launches(windows: int, branches: int, steps: int, vae_calls: int,
                         with_controlnet=True, with_motion=True) -> dict:
    """K2 (flash_fwd_bnsd) launches per (route, dtype, head dim) from the
    plans: each spatial transformer block runs self- and cross-attention,
    each motion module two temporal attentions; K1 (flash_fwd_flat) once a
    VAE call (its mid-block)."""
    from svi_tpu_torch.models import controlnets as cn
    from svi_tpu_torch.models import motion as mo
    from svi_tpu_torch.models import sd

    per = {}

    def add(d, n):
        key = f"f32/float32/{d}"
        per[key] = per.get(key, 0) + n

    plans = [sd.SD_UNET_PLAN] + ([cn.SD_CONTROLNET_PLAN] if with_controlnet else [])
    for plan in plans:
        for desc in plan:
            if desc[0] == "attn":
                add(desc[2], 2)
    if with_motion:
        chans = mo.plan_channels(sd.SD_UNET_PLAN)
        for bid in mo.SD_MOTION_CALL_MAP:
            add(chans[bid] // mo.NUM_HEADS, 2)
    passes = windows * branches * steps
    bnsd = {k: n * passes for k, n in per.items()}
    flat = {f"f32/float32/{sd.SD_VAE_DECODER_PLAN[1][1]}": vae_calls} if vae_calls else {}
    return {"flash_fwd_bnsd": bnsd, "flash_fwd_flat": flat}


def sd_launches() -> dict:
    from svi_tpu_torch.ops import attention as A

    return {"flash_fwd_bnsd": _routes(A.flash_fwd_bnsd), "flash_fwd_flat": _routes(A.flash_fwd_flat)}


def sd_small_pipeline(device, sds: dict, fx):
    """The SD video pipeline on the narrow models (no motion modules: their
    8 heads would be 4 wide there, a head dim the kernel has no route for),
    one tile ControlNet unit."""
    from svi_tpu_torch.models import controlnets as cn
    from svi_tpu_torch.models import sd
    from svi_tpu_torch.pipelines.sd_video import SDVideoPipeline

    unet = sd.sd_unet_params_from_torch(sds["sd_unet"], device=device)
    te = sd.sd_text_encoder_params_from_torch(sds["sd_text_encoder"], device=device)
    enc = sd.sd_vae_encoder_params_from_torch(sds["sd_vae_encoder"], device=device)
    dec = sd.sd_vae_decoder_params_from_torch(sds["sd_vae_decoder"], device=device)
    cnp = cn.sd_controlnet_params_from_torch(sds["sd_controlnet"], device=device)
    manager = cn.MultiControlNetManager([(cn.sd_controlnet_forward, cnp, SD_CN_SCALE)],
                                        [cn.Annotator("tile")])
    return SDVideoPipeline(unet, None, te, enc, dec, controlnet=manager)


def phase_sd_small(card: str) -> None:
    """(a) The narrow SD models (the CPU tests' widths, one attention head a
    block so that every head dim has a kernel route: 32, 64, 128) through
    SDVideoPipeline on the card and on the CPU: 3 frames at 64x64 in windows
    of 2, a tile ControlNet, video-to-video at 0.9 over 3 steps, a Contrast
    smoother after step 1."""
    from svi_tpu_torch.models import controlnets as cn
    from svi_tpu_torch.models import sd
    from svi_tpu_torch.processors import ContrastEditor

    fx = _sd_fixtures()
    plans = dict(unet=fx.narrow_plan(sd.SD_UNET_PLAN, 10, heads=1),
                 vae_encoder=fx.VAE_ENCODER_PLAN, vae_decoder=fx.VAE_DECODER_PLAN,
                 controlnet=fx.narrow_plan(cn.SD_CONTROLNET_PLAN, 10, heads=1))
    frames = list(sd_frames(3, 64, 64, seed=5))
    out = {}
    with sd_plans(**plans):
        sds = {k: v for k, v in fx.state_dicts(seed=11).items() if k != "sd_motion_modules"}
        for device in ("cuda", "cpu"):
            pipe = sd_small_pipeline(device, sds, fx)
            renders = []
            decode = pipe.decode_video

            def spy(latents, *a, _d=decode, _r=renders, **kw):
                _r.append(latents.float().cpu())
                return _d(latents, *a, **kw)

            pipe.decode_video = spy
            zero_counts()
            got = pipe(SD_PROMPT, negative_prompt="blurry", cfg_scale=7.5, num_frames=3,
                       input_frames=frames, denoising_strength=SD_STRENGTH, height=64, width=64,
                       num_inference_steps=SD_STEPS, animatediff_batch_size=2,
                       animatediff_stride=1, controlnet_frames=[frames],
                       smoother=ContrastEditor(SD_CONTRAST),
                       smoother_progress_ids=[SD_SMOOTH_AT], seed=1)
            if device == "cuda":
                torch.cuda.synchronize()
                launches = sd_launches()
            out[device] = (renders, got)
            del pipe
    (rc, fc), (rh, fh) = out["cuda"], out["cpu"]
    render_rel, final_rel = _rel(rc[0], rh[0]), _rel(rc[1], rh[1])
    gap = int(max(np.abs(a.astype(int) - b.astype(int)).max() for a, b in zip(fc, fh)))
    want = sd_expected_launches(windows=2, branches=2, steps=SD_STEPS, vae_calls=0,
                                with_motion=False)["flash_fwd_bnsd"]
    flat_f32 = sum(n for k, n in launches["flash_fwd_flat"].items() if k.startswith("f32/"))
    log(f"[sd-small] render at step {SD_SMOOTH_AT} card vs CPU {render_rel:.3e} (bound "
        f"{SD_SMALL_REL}), final latents {final_rel:.3e} (bound {SD_SMOOTHED_REL}), frames "
        f"{gap} levels (bound {SD_LEVELS}); launches {launches}; {card}")
    if not (render_rel <= SD_SMALL_REL and final_rel <= SD_SMOOTHED_REL and gap <= SD_LEVELS):
        raise RuntimeError("the small SD video pipeline on the card disagrees with the CPU")
    # one head a block: every attention through K1's flat entry, 12 VAE calls
    # (3 encodes, 3 renders, 3 encodes, 3 decodes)
    n_attn = sum(want.values())
    if flat_f32 != n_attn + 12 or any(not k.startswith("f32/") for k in launches["flash_fwd_flat"]):
        raise RuntimeError(f"the small SD pipeline launched {launches}, expected {n_attn} + 12 "
                           "f32 flat forwards")


def write_sd_checkpoints(root: Path, card: str) -> dict:
    """(b) Seeded SD 1.5 family files at their published widths in the
    reference's diffsynth naming, f16 as SD 1.5 checkpoints ship: the UNet,
    CLIP ViT-L/14's text tower (12 layers of 768), the VAE encoder and
    decoder, AnimateDiff v2's 21 motion modules and one ControlNet."""
    from svi_tpu_torch.models import controlnets as cn
    from svi_tpu_torch.models import motion as mo
    from svi_tpu_torch.models import sd
    from svi_tpu_torch.utils.safetensors_io import save_file

    makers = {"sd_unet": sd.sd_unet_state_dict, "sd_text_encoder": sd.sd_text_encoder_state_dict,
              "sd_vae_encoder": sd.sd_vae_encoder_state_dict,
              "sd_vae_decoder": sd.sd_vae_decoder_state_dict,
              "sd_motion_modules": mo.sd_motion_state_dict,
              "sd_controlnet": cn.sd_controlnet_state_dict}
    t0 = time.perf_counter()
    paths, sizes, params = {}, {}, {}
    for i, (kind, make) in enumerate(makers.items()):
        state = make(seed=61 + i, device="cuda", dtype=torch.float16)
        params[kind] = sum(t.numel() for t in state.values())
        paths[kind] = str(root / SD_FILES[kind])
        sizes[kind] = save_file(state, paths[kind])
        del state
    torch.cuda.empty_cache()
    log(f"[sd-files] {', '.join(f'{k} {params[k] / 1e6:.1f}M' for k in makers)} parameters; "
        f"{sum(sizes.values()) / 1e9:.3f} GB written in {time.perf_counter() - t0:.2f}s; {card}")
    return paths


def phase_sd_full_forward(paths: dict, card: str) -> None:
    """(c) One UNet + ControlNet + motion forward at full width on 4 frames
    at 128x128, the models loaded from (b)'s files by ModelManager on the
    card and on the CPU."""
    from svi_tpu_torch.models import controlnets as cn
    from svi_tpu_torch.models import motion as mo
    from svi_tpu_torch.models import sd
    from svi_tpu_torch.models.model_io import ModelManager

    g = torch.Generator().manual_seed(3)
    lat = torch.randn((4, 4, 16, 16), generator=g)
    ctx = torch.randn((1, 77, 768), generator=g)
    cond = torch.rand((4, 3, 128, 128), generator=g)
    t = torch.tensor([601.0])
    outs, secs = {}, {}
    for device in ("cuda", "cpu"):
        mm = ModelManager(device=device)
        t0 = time.perf_counter()
        mm.load_models([paths[k] for k in ("sd_unet", "sd_motion_modules", "sd_controlnet")])
        load_s = time.perf_counter() - t0
        unet, motion, cnp = (mm.fetch_model(k) for k in ("sd_unet", "sd_motion_modules",
                                                         "sd_controlnet"))
        args = [x.to(device) for x in (lat, t, ctx)]
        with torch.inference_mode():
            if device == "cuda":
                zero_counts()
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = [r * SD_CN_SCALE for r in cn.sd_controlnet_forward(cnp, *args,
                                                                      cond.to(device))]
            out = sd.sd_unet_forward(unet, *args, controlnet_res=res,
                                     motion=mo.motion_hooks(motion))
            if device == "cuda":
                torch.cuda.synchronize()
                launches = sd_launches()
            secs[device] = (load_s, time.perf_counter() - t0)
        outs[device] = out.float().cpu()
        del mm, unet, motion, cnp, res, out
        gc.collect()
        torch.cuda.empty_cache()
    rel = _rel(outs["cuda"], outs["cpu"])
    want = sd_expected_launches(windows=1, branches=1, steps=1, vae_calls=0)
    (card_load, card_fwd), (cpu_load, cpu_fwd) = secs["cuda"], secs["cpu"]
    log(f"[sd-forward] UNet + ControlNet + motion at full width, 4x4x16x16: card vs CPU "
        f"{rel:.3e} of the output's scale (bound {SD_FULL_REL}); load s / forward s card "
        f"{card_load:.2f} / {card_fwd:.3f}, CPU {cpu_load:.2f} / {cpu_fwd:.2f}; launches "
        f"{launches}; {card}")
    if not rel <= SD_FULL_REL:
        raise RuntimeError("the full-width SD forward on the card disagrees with the CPU")
    if launches["flash_fwd_bnsd"] != want["flash_fwd_bnsd"]:
        raise RuntimeError(f"the SD forward launched {launches}, expected {want}")


def phase_sd_runner(root: Path, paths: dict, card: str) -> dict:
    """(d) SDVideoPipelineRunner.run, the way users start a Diffutoon-style
    render: a seeded 4-frame 512x512 .npy video (one 4-frame window, cut
    from 16 to 8 to make room for phase 11 and to 4 for (e); 8a blends
    windows of 2), the tile ControlNet on the same frames at
    scale 0.5, 3 steps at strength 0.9, CFG 7.5, a Contrast smoother after
    step 1; frames,
    video.npy and config.json written. Returns the launches per entry."""
    from svi_tpu_torch.extensions import FastBlendSmoother
    from svi_tpu_torch.models import controlnets as cn
    from svi_tpu_torch.models import motion as mo
    from svi_tpu_torch.models import sd
    from svi_tpu_torch.pipelines.pipeline_runner import SDVideoPipelineRunner
    from svi_tpu_torch.prompters.sd_prompter import SDPrompter
    from svi_tpu_torch.schedulers.ddim import EnhancedDDIMScheduler

    video = sd_frames(SD_FRAMES, SD_H, SD_W, seed=9)
    np.save(root / "input.npy", video)
    src = {"video_file": str(root / "input.npy"), "height": SD_H, "width": SD_W,
           "start_frame_id": 0, "end_frame_id": SD_FRAMES}
    out_dir = root / "render"
    config = {
        "models": {"model_list": [paths[k] for k in ("sd_unet", "sd_text_encoder",
                                                     "sd_vae_encoder", "sd_vae_decoder",
                                                     "sd_motion_modules")],
                   "textual_inversion_folder": None, "device": "cuda", "lora_alphas": [],
                   "controlnet_units": [{"processor_id": "tile",
                                         "model_path": paths["sd_controlnet"],
                                         "scale": SD_CN_SCALE}]},
        "data": {"input_frames": dict(src), "controlnet_frames": [dict(src)],
                 "output_folder": str(out_dir), "fps": 8, "save_format": "npy"},
        "pipeline": {"seed": 0, "pipeline_inputs": {
            "prompt": SD_PROMPT, "negative_prompt": "blurry, low quality", "cfg_scale": 7.5,
            "clip_skip": 1, "denoising_strength": SD_STRENGTH,
            "num_inference_steps": SD_STEPS, "animatediff_batch_size": SD_WINDOW,
            "animatediff_stride": SD_STRIDE, "smoother_progress_ids": [SD_SMOOTH_AT]}},
        "smoother_configs": [{"processor_type": "FastBlend", "config": {}},
                             {"processor_type": "Contrast", "config": {"rate": SD_CONTRAST}}],
    }
    timer = PhaseTimer()
    step_marks = []
    step = EnhancedDDIMScheduler.step

    def timed_step(self, *a, **kw):
        out = step(self, *a, **kw)
        if not kw.get("to_final"):
            torch.cuda.synchronize()
            step_marks.append(time.perf_counter())
        return out

    sets = [(sd, "sd_unet_forward", timer.wrap("unet (with motion)", sd.sd_unet_forward)),
            (sd, "sd_vae_decode", timer.wrap("vae_decode", sd.sd_vae_decode)),
            (sd, "sd_vae_encode", timer.wrap("vae_encode", sd.sd_vae_encode)),
            (mo, "temporal_block", timer.wrap("motion", mo.temporal_block)),
            (cn, "sd_controlnet_forward", timer.wrap("controlnet", cn.sd_controlnet_forward)),
            (SDPrompter, "encode_prompt", timer.wrap("text_encoder", SDPrompter.encode_prompt)),
            (FastBlendSmoother, "__call__", timer.wrap("fastblend", FastBlendSmoother.__call__)),
            (EnhancedDDIMScheduler, "step", timed_step)]
    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with patched(sets):
        runner = SDVideoPipelineRunner(device="cuda")
        frames = runner.run(config)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launches = sd_launches()
    peak = torch.cuda.max_memory_allocated() / 2**30
    secs = {k: sum(v) for k, v in timer.seconds.items()}
    calls = {k: len(v) for k, v in timer.seconds.items()}
    windows = len(range(0, SD_FRAMES - SD_WINDOW + SD_STRIDE, SD_STRIDE))
    step_s = [b - a for a, b in zip(step_marks, step_marks[1:])]
    per_step = (secs["unet (with motion)"] + secs["controlnet"]) / SD_STEPS
    log(f"[sd-runner] {SD_FRAMES} frames {SD_H}x{SD_W}, {windows} windows of {SD_WINDOW}, "
        f"{SD_STEPS} steps, CFG 7.5 (two passes): {total:.2f}s in all; UNet + ControlNet "
        f"seconds per step {per_step:.3f} (wall between steps 1-2 with the smoother, 2-3: "
        f"{[round(x, 3) for x in step_s]}); seconds (calls): "
        + ", ".join(f"{k} {secs[k]:.3f} ({calls[k]})" for k in secs)
        + f"; peak memory {peak:.2f} GiB; launches {launches}; {card}")
    want = sd_expected_launches(windows=windows, branches=2, steps=SD_STEPS,
                                vae_calls=4 * SD_FRAMES)
    if launches != want:
        raise RuntimeError(f"the runner launched {launches}, expected {want}")
    saved = np.load(out_dir / "video.npy")
    if len(frames) != SD_FRAMES or saved.shape != (SD_FRAMES, SD_H, SD_W, 3) \
            or not np.array_equal(saved, np.stack(frames)) or saved.std() == 0:
        raise RuntimeError(f"the runner's video is {saved.shape}, or not its frames, or flat")
    pngs = sorted(p.name for p in (out_dir / "frames").iterdir())
    if len(pngs) != SD_FRAMES or not (out_dir / "config.json").is_file():
        raise RuntimeError(f"the runner wrote {len(pngs)} frames or no config.json")
    return {"flash_fwd_bnsd/f32": sum(launches["flash_fwd_bnsd"].values()),
            "flash_fwd_flat/f32": sum(launches["flash_fwd_flat"].values())}


# phase 8e: text-to-image LoRA training (training.text_to_image.T2ILoRATrainer)
# on the SD 1.5 UNet, f32; its attention backward is csrc/flash_bwd_f32.cu
T2I_RANK, T2I_ALPHA, T2I_STEPS = 4, 4.0, 3
T2I_LATENT = (1, 4, 64, 64)  # 512 x 512
T2I_SMALL_LATENT = (1, 4, 16, 16)
# The tiny trainer, card against CPU, f32 on both (written before the first
# card run): the losses and the adapters after its steps within 1e-4
# relative (f32 through some 60 layers forward and back, sums in another
# order: SD_SMALL_REL). Its loss is weighted by T2I_SMALL_WEIGHT on both
# devices (a scheduler whose training_weight says so, lr 1.0), so that every
# gradient stays far below AdamW's eps and the step is linear in the
# gradient: at weight 1 AdamW's first steps are lr * sign(g), and a few
# gradient entries that cancel flip between two f32 summation orders
# (tests/test_torch_text_to_image.py).
T2I_SMALL_REL, T2I_SMALL_WEIGHT = 1e-4, 1e-9


def t2i_expected_launches(plan, steps: int) -> dict:
    """The f32 backward kernels' launches per head dim in `steps` training
    steps, from the plan: each spatial transformer block runs self- and
    cross-attention, each with one dq and one dk/dv launch. For SD 1.5's plan
    a step is 32 of each: 10 at D = 40, 10 at D = 80, 12 at D = 160."""
    per = {}
    for desc in plan:
        if desc[0] == "attn":
            per[desc[2]] = per.get(desc[2], 0) + 2 * steps
    return per


def t2i_bwd_launches(path: str) -> dict:
    """The f32 backward kernels' launches per head dim since the counts were
    zeroed, the same for dq and dk/dv; fails if either kernel ran another
    route or the two counts differ."""
    from svi_tpu_torch.ops import attention as A

    got = {}
    for entry in (A.flash_bwd_dq, A.flash_bwd_dkv):
        if any(k[:2] != ("f32", "float32") for k in entry.routes):
            raise RuntimeError(f"{path}: a split backward launch took another route: "
                               f"{dict(entry.routes)}")
        got[entry.__name__] = {k[2]: n for k, n in sorted(entry.routes.items())}
    if got["flash_bwd_dq"] != got["flash_bwd_dkv"]:
        raise RuntimeError(f"{path}: dq and dk/dv launches differ: {got}")
    return got["flash_bwd_dq"]


def _weighted_ddim(weight: float):
    from svi_tpu_torch.schedulers.ddim import EnhancedDDIMScheduler

    class Weighted(EnhancedDDIMScheduler):
        def training_weight(self, timestep):
            return weight

    return Weighted()


def phase_t2i_small(root: Path, card: str) -> None:
    """(e, i) The tiny trainer card against CPU: a narrow SD UNet (the
    published plan at half width, 4 heads a block: head dims 40, 80 and 160,
    so that every attention backward takes the f32 kernels; one head would
    take the flat layout, which has no f32 split kernel), rank 4, 3 steps on
    the same latents and context, from the card trainer's adapters (saved,
    then loaded by the CPU trainer)."""
    from svi_tpu_torch.models import sd
    from svi_tpu_torch.training import text_to_image as t2i

    fx = _sd_fixtures()
    plan = fx.narrow_plan(sd.SD_UNET_PLAN, 2, heads=4)
    rng = np.random.default_rng(21)
    lat = rng.standard_normal(T2I_SMALL_LATENT).astype(np.float32)
    emb = rng.standard_normal((1, 77, fx.TEXT_DIM)).astype(np.float32)
    start = root / "t2i_small_start.safetensors"
    kw = dict(learning_rate=1.0, lora_rank=T2I_RANK, lora_alpha=T2I_ALPHA, seed=5)
    out, secs = {}, {}
    with patched([(sd, "SD_UNET_PLAN", plan)]):
        state = sd.sd_unet_state_dict(23, device="cuda", text_dim=fx.TEXT_DIM)
        for device in ("cuda", "cpu"):
            unet = sd.sd_unet_params_from_torch(state, device=device)
            trainer = t2i.T2ILoRATrainer(unet, scheduler=_weighted_ddim(T2I_SMALL_WEIGHT),
                                         pretrained_lora_path=None if device == "cuda"
                                         else str(start), **kw)
            if device == "cuda":
                trainer.save_lora(str(start))
                zero_counts()
            t0 = time.perf_counter()
            losses = [trainer.training_step(latents=lat, prompt_emb=emb)
                      for _ in range(T2I_STEPS)]
            if device == "cuda":
                torch.cuda.synchronize()
                launches = t2i_bwd_launches("the tiny trainer")
            secs[device] = time.perf_counter() - t0
            out[device] = (np.array(losses), {k: [t.detach().cpu() for t in ab.values()]
                                              for k, ab in trainer.lora.items()})
            del trainer, unet
    (lc, ac), (lh, ah) = out["cuda"], out["cpu"]
    loss_rel = float(np.abs(lc - lh).max() / np.abs(lh).max())
    ad_rel = {name: _rel(torch.cat([ac[k][i].ravel() for k in ah]),
                         torch.cat([ah[k][i].ravel() for k in ah]))
              for i, name in enumerate(("A", "B"))}
    want = t2i_expected_launches(plan, T2I_STEPS)
    log(f"[t2i-small] 4 heads of 40 / 80 / 160, rank {T2I_RANK}, {T2I_STEPS} steps, card vs "
        f"CPU: losses {loss_rel:.3e} ({lc.tolist()}), adapters A {ad_rel['A']:.3e} B "
        f"{ad_rel['B']:.3e} (bound {T2I_SMALL_REL}); seconds card {secs['cuda']:.2f}, CPU "
        f"{secs['cpu']:.2f}; f32 backward launches per head dim {launches} (expected {want}, "
        f"each of dq and dk/dv); {card}")
    if not (np.isfinite(lc).all() and loss_rel <= T2I_SMALL_REL
            and max(ad_rel.values()) <= T2I_SMALL_REL):
        raise RuntimeError("the tiny text-to-image trainer on the card disagrees with the CPU")
    if launches != want:
        raise RuntimeError(f"the tiny trainer launched {launches}, expected {want}")


def phase_t2i_full(root: Path, paths: dict, card: str) -> dict:
    """(e, ii) The SD 1.5 UNet at full width from (b)'s file, in f32, trained
    as users start it: rank 4, alpha 4, the default targets (to_q, to_k,
    to_v, to_out), the context from (b)'s text encoder, 3 steps on seeded
    (1, 4, 64, 64) latents, then one step on a TextImageDataset row written
    here (a 576x640 .npy image, resized and centre-cropped to 512x512) through
    vae_encode_fn with (b)'s VAE encoder; then save_lora and its round trip.
    Returns the run's launches per KERNELS entry."""
    from svi_tpu_torch.models import sd
    from svi_tpu_torch.models.model_io import ModelManager, load_state_dict
    from svi_tpu_torch.prompters.sd_prompter import SDPrompter
    from svi_tpu_torch.training import text_to_image as t2i

    kinds = ("sd_unet", "sd_text_encoder", "sd_vae_encoder")
    mm = ModelManager(device="cuda")
    t0 = time.perf_counter()
    mm.load_models([paths[k] for k in kinds])
    unet, te, enc = (mm.fetch_model(k) for k in kinds)
    emb = SDPrompter().encode_prompt(te, SD_PROMPT)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    data, side = root / "t2i_data", 8 * T2I_LATENT[-1]
    (data / "train").mkdir(parents=True)
    np.save(data / "train" / "img0.npy", sd_frames(1, side + 64, side + 128, seed=33)[0])
    (data / "train" / "metadata.csv").write_text("file_name,text\nimg0.npy,a city street\n")
    item = t2i.TextImageDataset(str(data), steps_per_epoch=1, height=side, width=side)[0]
    image = torch.from_numpy(item["image"])[None].cuda()
    trainer = t2i.T2ILoRATrainer(unet, lora_rank=T2I_RANK, lora_alpha=T2I_ALPHA, seed=0)
    lat = torch.randn(T2I_LATENT, generator=torch.Generator(device="cuda").manual_seed(7),
                      device="cuda")
    losses, secs = [], []
    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    for i in range(T2I_STEPS + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if i < T2I_STEPS:
            losses.append(trainer.training_step(latents=lat, prompt_emb=emb))
        else:
            losses.append(trainer.training_step(
                batch_image=image, prompt_emb=emb,
                vae_encode_fn=lambda x: sd.sd_vae_encode(enc, x)))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    launches = read_counts()
    bwd = t2i_bwd_launches("the text-to-image trainer")
    fwd = sd_launches()
    peak = torch.cuda.max_memory_allocated() / 2**30
    frozen = all(p.grad is None for p in unet.parameters())
    moved = max(ab["B"].detach().abs().max().item() for ab in trainer.lora.values())
    path = root / "t2i_lora.safetensors"
    t0 = time.perf_counter()
    trainer.save_lora(str(path))
    back = t2i.lora_from_state_dict(load_state_dict(str(path)), device="cuda")
    save_s = time.perf_counter() - t0
    same = sorted(back) == sorted(trainer.lora) and all(
        torch.equal(back[k][n], ab[n].detach()) for k, ab in trainer.lora.items() for n in "AB")
    steps = T2I_STEPS + 1
    want = t2i_expected_launches(sd.SD_UNET_PLAN, steps)
    want_fwd = {"flash_fwd_bnsd": {f"f32/float32/{d}": n for d, n in sorted(want.items())},
                "flash_fwd_flat": {f"f32/float32/{sd.SD_VAE_ENCODER_PLAN[-2][1]}": 1}}
    log(f"[t2i] SD 1.5 UNet f32 at 512x512, rank {T2I_RANK}, {len(trainer.lora)} sites: load "
        f"{load_s:.2f}s; seconds per step {[round(x, 3) for x in secs]} (the last through "
        f"vae_encode_fn on a TextImageDataset row); losses {[round(x, 6) for x in losses]}; "
        f"peak memory {peak:.2f} GiB; save_lora + load {save_s:.2f}s ({path.stat().st_size} "
        f"bytes, round trip {'bit-equal' if same else 'DIFFERS'}); max |B| {moved:.3e}; frozen "
        f"weights without grads {frozen}; f32 backward launches per head dim {bwd} (expected "
        f"{want}, each of dq and dk/dv), forwards {fwd}; {card}")
    if not (np.isfinite(losses).all() and frozen and same and moved > 0):
        raise RuntimeError("the text-to-image trainer's steps are not finite, moved a frozen "
                           "weight, did not move B, or its LoRA file does not round-trip")
    if bwd != want or fwd != want_fwd:
        raise RuntimeError(f"the trainer launched {bwd} backward and {fwd} forward kernels, "
                           f"expected {want} and {want_fwd}")
    del trainer, mm, unet, te, enc
    return launches


# phase 8f: the bf16 paths (route sm90, csrc/flash_fwd_sm90.cu). Card against
# CPU, bf16 on both (written before the first card run): the two round to
# bf16 in other places (the kernel rounds P for P.V where the plain version
# keeps f32; cuBLAS and the CPU's GEMMs sum in other orders), which moves a
# bf16 model by bf16 roundings (2^-9 relative) through every layer, and
# CFG amplifies each step's difference: the decoded images within 0.15 of
# their scale, the bound tests/test_torch_bf16_paths.py holds the port's
# bf16 SD pipeline to against svi_tpu's on the CPU for the same reason.
BF16_SMALL_REL = 0.15
SD_BF16_H, SD_BF16_W, SD_BF16_STEPS = 512, 512, 2


def bf16_expected_launches(plan_attn: dict, passes: int, vae_calls: int,
                           vae_d: int = 512) -> dict:
    """The bf16 paths' forward launches per (route, dtype, head dim):
    plan_attn {(n_heads, head_dim): attentions a pass}, routed as
    `flash_attention` routes them (the flat entry for one head or D % 128 ==
    0, else (B, N, S, D)), and the VAE decoder's mid-block (one head of
    vae_d) once a call."""
    from svi_tpu_torch.ops import attention as A

    want = {"flash_fwd_bnsd": {}, "flash_fwd_flat": {}}

    def add(n, d, count):
        entry = "flash_fwd_flat" if A._flat_ok(n, d) else "flash_fwd_bnsd"
        key = f"{A._fwd_route(torch.bfloat16, d)}/bfloat16/{d}"
        want[entry][key] = want[entry].get(key, 0) + count

    for (n, d), count in plan_attn.items():
        add(n, d, count * passes)
    if vae_calls:
        add(1, vae_d, vae_calls)
    return want


def sd_plan_attn(plan) -> dict:
    """{(heads, head dim): attentions a UNet pass}: self and cross a block."""
    out = {}
    for desc in plan:
        if desc[0] == "attn":
            out[(desc[1], desc[2])] = out.get((desc[1], desc[2]), 0) + 2
    return out


def bf16_small_pipelines(device):
    """Phase 8f's narrow bf16 pipelines on `device`, each in bf16 through its
    normal entry point, with the decoded image captured: SDImagePipeline on
    a half-width SD 1.5 UNet (4 heads of 40 / 80 / 160, the card's route
    sm90) and the SD VAE decoder at full width (one head of 512), 64 x 64, 2
    steps, CFG 7.5 (one batch of two); FluxImagePipeline at its default
    dtype (bf16, the VAE too) on the CPU tests' DiT (one head of 128, route
    sm90) and FLUX's VAE decoder at full width, 64 x 64, 2 steps;
    HunyuanDiTImagePipeline(dtype=bf16) on a DiT of 2 heads of 88 (route
    sm90) with the SD VAE decoder at full width, 64 x 64, 2 steps, CFG 5.
    {name: (pipeline, kwargs, captured list, expected launches)}."""
    from svi_tpu_torch.models import flux, hunyuan_dit, sd, t5
    from svi_tpu_torch.pipelines import hunyuan_image
    from svi_tpu_torch.pipelines.flux_image import FluxImagePipeline
    from svi_tpu_torch.pipelines.sd_image import SDImagePipeline
    from svi_tpu_torch.prompters.hunyuan_dit_prompter import HunyuanDiTPrompter
    from svi_tpu_torch.prompters.sp_tokenizer import default_t5_tokenizer

    vfx, fx = _video_fixtures(), _sd_fixtures()
    kw, bf16 = dict(device=device), torch.bfloat16
    out = {}
    plan = fx.narrow_plan(sd.SD_UNET_PLAN, 2, heads=4)
    with patched([(sd, "SD_UNET_PLAN", plan)]):
        unet = sd.sd_unet_params_from_torch(sd.sd_unet_state_dict(71, text_dim=fx.TEXT_DIM), **kw)
    te = sd.sd_text_encoder_params_from_torch(sd.sd_text_encoder_state_dict(
        72, dim=fx.TEXT_DIM, num_layers=fx.TEXT_LAYERS), **kw)
    dec = sd.sd_vae_decoder_params_from_torch(sd.sd_vae_decoder_state_dict(73), **kw)
    pipe = SDImagePipeline(unet, te, vae_decoder=dec, dtype=bf16)
    out["sd_image"] = (pipe, dict(prompt=SD_PROMPT, negative_prompt="blurry", cfg_scale=7.5,
                                  height=64, width=64, num_inference_steps=2, seed=1),
                       [(sd, "SD_UNET_PLAN", plan)],
                       bf16_expected_launches(sd_plan_attn(plan), 2, 1))
    fl = fx.flux_state_dicts(74)  # its VAE at the published SD3 / FLUX plans
    flt5 = t5.params_from_torch_state_dict(fl["t5"], fl["t5_cfg"], **kw)
    pipe = FluxImagePipeline(
        flux.flux_dit_params_from_torch(fl["dit"], **kw),
        sd.sd_text_encoder_params_from_torch(fl["te1"], **kw), (flt5, flt5.cfg, None),
        vae_decoder_params=flux.flux_vae_decoder_params_from_torch(fl["vae_decoder"], **kw))
    blocks = len(pipe.dit_params["blocks"]) + len(pipe.dit_params["single_blocks"])
    out["flux"] = (pipe, dict(prompt=FLUX_PROMPT, height=64, width=64, num_inference_steps=2,
                              t5_sequence_length=16, seed=2), [],
                   bf16_expected_launches({(1, fx.FLUX_DIM): blocks}, 2, 1))
    d = vfx.HY_DIT
    prompter = HunyuanDiTPrompter(TableEncoder(50000, d["text_dim"], 1), None,
                                  TableEncoder(32128, d["t5_dim"], 2), default_t5_tokenizer())
    with patched([(hunyuan_dit, "NUM_HEADS", 2)]):
        pipe = hunyuan_image.HunyuanDiTImagePipeline(
            hunyuan_dit.hunyuan_dit_params_from_torch(hunyuan_dit.hunyuan_dit_state_dict(
                76, **(d | dict(dim=2 * 88))), **kw), prompter,
            vae_decoder_params=sd.sd_vae_decoder_params_from_torch(
                sd.sd_vae_decoder_state_dict(77), **kw), dtype=bf16, num_layers_down=vfx.HY_DOWN)
    n_blocks = len(pipe.dit_params["blocks"])
    out["hunyuan_dit"] = (pipe, dict(prompt=ZOO_PROMPT_ZH, negative_prompt="模糊", cfg_scale=5.0,
                                     height=64, width=64, num_inference_steps=2, seed=3),
                          [(hunyuan_dit, "NUM_HEADS", 2)],
                          bf16_expected_launches({(2, 88): 2 * n_blocks}, 2 * 2, 1))
    return out


def phase_bf16_small(card: str) -> dict:
    """(f, i) The narrow bf16 pipelines of `bf16_small_pipelines` on the card
    and on the CPU: the decoded images (before the uint8 cast) within
    BF16_SMALL_REL of their scale, each card run's launches equal to its
    models' count (the sm90 route at D40 / D80 / D160 / D88 / D512). Returns
    the card's launches per KERNELS name."""
    got, launches, secs = {}, {}, {}
    for device in ("cuda", "cpu"):
        for name, (pipe, kw, sets, want) in bf16_small_pipelines(device).items():
            store = got.setdefault((name, device), [])
            _capture(pipe, store)
            zero_counts()
            t0 = time.perf_counter()
            with patched(sets), torch.inference_mode():
                image = pipe(**kw)
            if device == "cuda":
                torch.cuda.synchronize()
                launches[name] = sd_launches()
                if launches[name] != want:
                    raise RuntimeError(f"the small bf16 {name} pipeline launched "
                                       f"{launches[name]}, expected {want}")
            secs[(name, device)] = round(time.perf_counter() - t0, 2)
            if image.shape != (64, 64, 3) or not torch.isfinite(store[0]).all():
                raise RuntimeError(f"the small bf16 {name} pipeline gave {image.shape}, or a "
                                   f"decode that is not finite")
            del pipe
    names = sorted({n for n, _ in got})
    rels = {n: _rel(got[(n, "cuda")][0], got[(n, "cpu")][0]) for n in names}
    log(f"[bf16-small] bf16 pipelines card vs CPU, decoded images "
        f"{ {k: f'{v:.3e}' for k, v in rels.items()} } (bound {BF16_SMALL_REL}); seconds "
        f"{secs}; launches {launches}; {card}")
    if max(rels.values()) > BF16_SMALL_REL:
        raise RuntimeError("the small bf16 pipelines on the card disagree with the CPU")
    total = {}
    for counts in launches.values():
        _add_counts(total, per_kernel(counts))
    return total


def phase_sd_bf16(paths: dict, card: str) -> dict:
    """(f, ii) SDImagePipeline(dtype=bf16), the SD 1.5 image pipeline as its
    notes recommend it, on (b)'s files at full width (the converters' f32
    weights cast to bf16 by the pipeline): text-to-image at 512 x 512, 2
    steps, CFG 7.5 (one UNet batch of two), the VAE decode. Per-part
    seconds, seconds a step, peak memory, and the sm90 route's launches
    against the plan's count. Returns the launches per KERNELS name."""
    from svi_tpu_torch.models import sd
    from svi_tpu_torch.models.model_io import load_state_dict
    from svi_tpu_torch.pipelines.sd_image import SDImagePipeline
    from svi_tpu_torch.prompters.sd_prompter import SDPrompter
    from svi_tpu_torch.schedulers.ddim import EnhancedDDIMScheduler

    t0 = time.perf_counter()
    pipe = SDImagePipeline(
        sd.sd_unet_params_from_torch(load_state_dict(paths["sd_unet"]), device="cuda"),
        sd.sd_text_encoder_params_from_torch(load_state_dict(paths["sd_text_encoder"]),
                                             device="cuda"),
        vae_decoder=sd.sd_vae_decoder_params_from_torch(load_state_dict(paths["sd_vae_decoder"]),
                                                        device="cuda"), dtype=torch.bfloat16)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    if any(p.dtype != torch.bfloat16 for m in (pipe.unet, pipe.text_encoder, pipe.vae_decoder)
           for p in m.parameters()):
        raise RuntimeError("SDImagePipeline(dtype=bf16) kept a weight in another dtype")
    timer, step_marks = PhaseTimer(), []
    step = EnhancedDDIMScheduler.step

    def timed_step(self, *a, **kw):
        out = step(self, *a, **kw)
        torch.cuda.synchronize()
        step_marks.append(time.perf_counter())
        return out

    sets = [(sd, "sd_unet_forward", timer.wrap("unet", sd.sd_unet_forward)),
            (sd, "sd_vae_decode", timer.wrap("vae_decode", sd.sd_vae_decode)),
            (SDPrompter, "encode_prompt", timer.wrap("text_encoder", SDPrompter.encode_prompt)),
            (EnhancedDDIMScheduler, "step", timed_step)]
    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with patched(sets):
        image = pipe(SD_PROMPT, negative_prompt="blurry, low quality", cfg_scale=7.5,
                     height=SD_BF16_H, width=SD_BF16_W, num_inference_steps=SD_BF16_STEPS,
                     seed=0)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launches = sd_launches()
    peak = torch.cuda.max_memory_allocated() / 2**30
    secs = {k: sum(v) for k, v in timer.seconds.items()}
    calls = {k: len(v) for k, v in timer.seconds.items()}
    step_s = [b - a for a, b in zip([t0] + step_marks, step_marks)]
    log(f"[sd-bf16] SDImagePipeline(dtype=bf16) at {SD_BF16_H}x{SD_BF16_W}, {SD_BF16_STEPS} "
        f"steps, CFG 7.5 (one batch of two): load {load_s:.2f}s, {total:.2f}s in all; seconds "
        f"a step (the first with the prompts) {[round(x, 3) for x in step_s]}; seconds (calls): "
        + ", ".join(f"{k} {secs[k]:.3f} ({calls[k]})" for k in secs)
        + f"; peak memory {peak:.2f} GiB; launches {launches}; {card}")
    want = bf16_expected_launches(sd_plan_attn(sd.SD_UNET_PLAN), SD_BF16_STEPS, 1, next(
        d[1] for d in sd.SD_VAE_DECODER_PLAN if d[0] == "vae_attn"))
    if launches != want:
        raise RuntimeError(f"the bf16 SD image pipeline launched {launches}, expected {want}")
    if image.shape != (SD_BF16_H, SD_BF16_W, 3) or image.dtype != np.uint8 or image.std() == 0:
        raise RuntimeError(f"the bf16 SD image is {image.shape} {image.dtype}, or flat")
    del pipe
    return per_kernel(launches)


# phase 8f (iii): one AnimateDiff motion module in bf16 a width, card against
# CPU, bf16 on both (written before its first card run): one call through
# the module's norms, projections, two temporal attentions and its FFN,
# each side rounding to bf16 in its own places (cuBLAS and the CPU's GEMMs
# sum in other orders; the kernel rounds P for P.V): bf16 roundings (2^-9
# relative) through one block, on top of the residual input; the bound of
# one bf16 model call against the CPU (ZOO_BF16_REL's reading for a whole
# DiT is 1e-2).
MOTION_BF16_REL = 5e-2
MOTION_FRAMES = 16
# the SD 1.5 UNet's widths: channels -> the latent side of the level at
# 256 x 256 (half 512's, so that the CPU's bf16 run of the 1280-wide module
# stays at seconds; the kernel's batch is still 8 x 64 to 8 x 1024 items)
MOTION_LEVELS = {320: 32, 640: 16, 1280: 8}


def phase_motion_bf16(card: str) -> dict:
    """(f, iii) AnimateDiff's motion modules in bf16, the temporal attention
    an SD video pipeline run in bf16 gives the kernel: Sq = Sk = 16 frames
    over every (pixel, head) of a level, on the packed short-sequence kernel.
    The first module of each of the SD UNet's widths (320, 640, 1280
    channels: 8 heads of 40, 80, 160) at the published widths, one call on
    16 frames at its level's side at 256 x 256, bf16 weights and input from
    a seed, card against CPU within MOTION_BF16_REL of the output's scale;
    each card call's launches are its two attentions, at its head dim on the
    sm90 route. Returns the launches per KERNELS name."""
    from svi_tpu_torch.models import motion as mo
    from svi_tpu_torch.models import sd

    chans = mo.plan_channels(sd.SD_UNET_PLAN)
    bids = {}
    for bid in sorted(mo.SD_MOTION_CALL_MAP):
        bids.setdefault(chans[bid], bid)
    call_map = {bids[c]: i for i, c in enumerate(MOTION_LEVELS)}
    sdm = mo.sd_motion_state_dict(seed=81, call_map=call_map)
    rng = np.random.default_rng(82)
    inputs = {c: rng.standard_normal((MOTION_FRAMES, c, side, side), dtype=np.float32)
              for c, side in MOTION_LEVELS.items()}
    total, outs, secs = {}, {}, {}
    for device in ("cuda", "cpu"):
        params = mo.motion_params_from_torch(sdm, device=device, dtype=torch.bfloat16)
        for i, c in enumerate(MOTION_LEVELS):
            x = torch.from_numpy(inputs[c]).to(device, torch.bfloat16)
            head_dim = c // mo.NUM_HEADS
            zero_counts()
            t0 = time.perf_counter()
            with torch.inference_mode():
                y = mo.temporal_block(params["motion_modules"][i], x, mo.NUM_HEADS, head_dim)
            if device == "cuda":
                torch.cuda.synchronize()
                launches = sd_launches()
                want = {"flash_fwd_bnsd": {f"sm90/bfloat16/{head_dim}": 2},
                        "flash_fwd_flat": {}}
                if launches != want:
                    raise RuntimeError(f"the bf16 motion module at D{head_dim} launched "
                                       f"{launches}, expected {want}")
                _add_counts(total, per_kernel(launches))
            secs[(c, device)] = round(time.perf_counter() - t0, 3)
            outs[(c, device)] = y.float().cpu()
        del params
    rels = {c: _rel(outs[(c, "cuda")], outs[(c, "cpu")]) for c in MOTION_LEVELS}
    log(f"[motion-bf16] AnimateDiff motion modules in bf16, {MOTION_FRAMES} frames, card vs "
        f"CPU by channels {({c: f'{r:.3e}' for c, r in rels.items()})} (bound "
        f"{MOTION_BF16_REL}); seconds {secs}; launches {total}; {card}")
    if max(rels.values()) > MOTION_BF16_REL:
        raise RuntimeError("a bf16 motion module on the card disagrees with the CPU")
    return total


def phase_sd(card: str) -> tuple[dict, dict]:
    """Phase 8: (a) the small SD video pipeline card vs CPU, (b) full-width
    files, (c) one full-width UNet + ControlNet + motion forward card vs CPU,
    (d) the runner at 512x512x4, (e) text-to-image LoRA training: the tiny
    trainer card vs CPU, then the full-width UNet on (b)'s files, (f) the
    bf16 paths: the narrow bf16 SD, FLUX and Hunyuan-DiT pipelines card vs
    CPU, the motion modules in bf16 card vs CPU, then the SD 1.5 image
    pipeline in bf16 on (b)'s files. Returns
    (d)'s and (e)'s launches per KERNELS entry; (f)'s full-width run's are
    kept in BF16_PATH_LAUNCHES."""
    import shutil
    import tempfile

    t0 = time.perf_counter()
    phase_sd_small(card)
    root = Path(tempfile.mkdtemp(prefix="_sd_ckpt_", dir=REPO))
    try:
        phase_t2i_small(root, card)
        paths = write_sd_checkpoints(root, card)
        phase_sd_full_forward(paths, card)
        launches = phase_sd_runner(root, paths, card)
        gc.collect()
        torch.cuda.empty_cache()
        t2i_launches = phase_t2i_full(root, paths, card)
        gc.collect()
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        phase_bf16_small(card)
        BF16_PATH_LAUNCHES["motion"] = phase_motion_bf16(card)
        BF16_PATH_LAUNCHES["sd_image"] = phase_sd_bf16(paths, card)
        log(f"[time] phase 8f: {time.perf_counter() - t1:.1f}s")
    finally:
        gc.collect()
        torch.cuda.empty_cache()
        shutil.rmtree(root, ignore_errors=True)
    log(f"[sd] phase 8 passed in {time.perf_counter() - t0:.1f}s; {card}")
    return launches, t2i_launches



# ---------------------------------------------------------------------------
# phase 9: the extensions and the SDXL family
# ---------------------------------------------------------------------------

XL_H, XL_W, XL_FRAMES, XL_STEPS = 1024, 1024, 8, 2  # AnimateDiff-SDXL's setting cut to 8 frames, 2 steps
XL_CN_SCALE, XL_IP_SCALE, XL_CFG = 0.5, 0.6, 7.5
XL_FASTBLEND_FRAMES, XL_ESRGAN_FRAMES, XL_SCORE_FRAMES = 3, 2, 2
XL_UNET_PARAMS = 2_567_463_684  # SDXL base 1.0's UNet
XL_PROMPT = "a dancer in a red dress on a rooftop at sunset, cinematic light, highly detailed"
XL_FILES = {"sdxl_unet": "sdxl_base_unet.safetensors",
            "sdxl_text_encoder": "sdxl_text_encoder.safetensors",
            "sdxl_text_encoder_2": "sdxl_text_encoder_2.safetensors",
            "sdxl_vae_encoder": "sdxl_vae_encoder.safetensors",
            "sdxl_vae_decoder": "sdxl_vae_decoder.safetensors",
            "sdxl_motion_modules": "animatediff_sdxl_motion.safetensors",
            "sdxl_controlnet": "sdxl_controlnet_union.safetensors",
            "sdxl_ipadapter": "ip_adapter_sdxl.safetensors",
            "sdxl_ipadapter_clip_image_encoder": "ip_adapter_image_encoder_vit_h.safetensors",
            "esrgan": "RealESRGAN_x4.safetensors", "rife": "rife_flownet.safetensors",
            "clip-large": "clip-vit-large-patch14/model.safetensors",
            "aesthetic_predictor": "aesthetic_mlp.safetensors",
            "hpsv2": "open_clip_vit_h_14.safetensors"}
# Card against CPU, f32 on both, as phase 8 holds the SD stack: 1e-4 of the
# output's scale for the narrow models' outputs (the image before its uint8
# cast, the video's first UNet output, its positive branch, and its final
# latents), 1e-3 for the full-width forward (its sums are 10-40x longer),
# frames within one level, scores within 1e-4 (f32 towers of one or two
# layers).
XL_SMALL_REL, XL_FULL_REL, XL_LEVELS, XL_SCORE_REL = 1e-4, 1e-3, 1, 1e-4


def xl_expected_launches(passes: int, vae_calls: int, with_controlnet=True,
                         with_motion=True) -> dict:
    """K2 (flash_fwd_bnsd) launches per (route, dtype, head dim) from the
    plans, for `passes` UNet passes (one ControlNet each): two attentions a
    transformer layer, two a motion module; K1 (flash_fwd_flat) once a VAE
    call (its mid-block)."""
    from svi_tpu_torch.models import controlnets as cn
    from svi_tpu_torch.models import motion as mo
    from svi_tpu_torch.models import sd, sdxl

    per = {}

    def add(d, n):
        key = f"f32/float32/{d}"
        per[key] = per.get(key, 0) + n

    for plan in [sdxl.SDXL_UNET_PLAN] + ([cn.SDXL_CONTROLNET_PLAN] if with_controlnet else []):
        for i, desc in enumerate(plan):
            if desc[0] == "attn":
                add(desc[2], 2 * sdxl.SDXL_TRANSFORMER_DEPTH.get(i, 1))
    if with_motion:
        chans = mo.plan_channels(sdxl.SDXL_UNET_PLAN)
        for bid in mo.SDXL_MOTION_CALL_MAP:
            add(chans[bid] // mo.NUM_HEADS, 2)
    flat = {f"f32/float32/{sd.SD_VAE_DECODER_PLAN[1][1]}": vae_calls} if vae_calls else {}
    return {"flash_fwd_bnsd": {k: n * passes for k, n in per.items()}, "flash_fwd_flat": flat}


def _blocky(n: int, h: int, w: int, seed: int) -> list:
    """Integer frames constant on 2x2 blocks, drifting one block a frame."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 200, (h // 2, w // 2, 3))
    return [np.repeat(np.repeat(np.roll(base, i, 1) + rng.integers(0, 40, base.shape), 2, 0),
                      2, 1).astype(np.uint8) for i in range(n)]


def _levels(got, want) -> int:
    return max(int(np.abs(np.asarray(g, int) - np.asarray(w, int)).max())
               for g, w in zip(got, want))


def _quality_files(root: Path, sds: dict) -> dict:
    """The quality towers' files in the reference snapshot's layout."""
    from svi_tpu_torch.utils.safetensors_io import save_file

    (root / "clip-vit-large-patch14").mkdir(parents=True, exist_ok=True)
    paths = {"clip-large": str(root / "clip-vit-large-patch14")}
    for key in ("clip-large", "aesthetic_predictor", "hpsv2"):
        save_file(sds[key], str(root / XL_FILES[key]))
        if key != "clip-large":
            paths[key] = str(root / XL_FILES[key])
    return paths


def phase_xl_small(root: Path, card: str) -> None:
    """(a) The narrow SDXL models of the CPU tests (one head a block, so that
    every head dim has a kernel route) through SDXLImagePipeline (64x64, 2
    steps, CFG 5) and SDXLVideoPipeline (3 frames, a tile ControlNet Union
    unit, an IP-Adapter image, video-to-video over 2 steps), RIFE (c=16) on
    3 frames, FastBlend (its default ebsynth config) on 6 integer frames,
    ESRGAN (2 blocks) on 2 frames, and the Aesthetic and CLIP scores on
    one-layer towers, each on the card against the CPU."""
    from svi_tpu_torch.extensions import ESRGAN, FastBlendSmoother, RIFEInterpolater
    from svi_tpu_torch.extensions import esrgan as esr
    from svi_tpu_torch.extensions import image_quality as iq
    from svi_tpu_torch.extensions import quality_towers as qt
    from svi_tpu_torch.extensions import rife
    from svi_tpu_torch.models import controlnets as cn
    from svi_tpu_torch.models import ipadapter as ip
    from svi_tpu_torch.models import sd, sdxl
    from svi_tpu_torch.pipelines.sdxl_image import SDXLImagePipeline
    from svi_tpu_torch.pipelines.sdxl_video import SDXLVideoPipeline

    fx = _sd_fixtures()
    unet_plan, cn_plan = fx.xl_plans(heads=1)
    loaders = {"sdxl_unet": sdxl.sdxl_unet_params_from_torch,
               "sdxl_text_encoder": sdxl.sdxl_text_encoder_params_from_torch,
               "sdxl_text_encoder_2": sdxl.sdxl_text_encoder_2_params_from_torch,
               "sdxl_vae_encoder": sd.sd_vae_encoder_params_from_torch,
               "sdxl_vae_decoder": sd.sd_vae_decoder_params_from_torch,
               "sdxl_controlnet": cn.sdxl_controlnet_params_from_torch,
               "sdxl_ipadapter": ip.ipadapter_params_from_torch,
               "sdxl_ipadapter_clip_image_encoder": ip.clip_image_encoder_params_from_torch}
    frames, ref = list(sd_frames(3, 64, 64, seed=21)), sd_frames(1, 64, 64, seed=22)[0]
    out = {}
    with patched([(sdxl, "SDXL_UNET_PLAN", unet_plan), (cn, "SDXL_CONTROLNET_PLAN", cn_plan),
                  (sd, "SD_VAE_ENCODER_PLAN", fx.VAE_ENCODER_PLAN),
                  (sd, "SD_VAE_DECODER_PLAN", fx.VAE_DECODER_PLAN)]):
        sds = fx.xl_state_dicts(seed=23)
        for device in ("cuda", "cpu"):
            m = {k: f(sds[k], device=device) for k, f in loaders.items()}
            image = SDXLImagePipeline(m["sdxl_unet"], m["sdxl_text_encoder"],
                                      m["sdxl_text_encoder_2"], m["sdxl_vae_encoder"],
                                      m["sdxl_vae_decoder"])
            decoded = []
            to_image = image.vae_output_to_image
            image.vae_output_to_image = lambda o, _f=to_image, _d=decoded: (
                _d.append(o.float().cpu()), _f(o))[1]
            manager = cn.MultiControlNetManager(
                [(lambda p, s, t, e, c, **kw: cn.sdxl_controlnet_forward(p, s, t, e, c, "tile",
                                                                         **kw),
                  m["sdxl_controlnet"], XL_CN_SCALE)], [cn.Annotator("tile")])
            video = SDXLVideoPipeline(m["sdxl_unet"], None, m["sdxl_text_encoder"],
                                      m["sdxl_text_encoder_2"], m["sdxl_vae_encoder"],
                                      m["sdxl_vae_decoder"], ipadapter=m["sdxl_ipadapter"],
                                      ipadapter_image_encoder=m[
                                          "sdxl_ipadapter_clip_image_encoder"],
                                      controlnet=manager)
            latents, preds = [], []
            decode, unet = video.decode_video, video._unet_all_frames
            video.decode_video = lambda lat, *a, _d=decode, _l=latents, **kw: (
                _l.append(lat.float().cpu()), _d(lat, *a, **kw))[1]
            video._unet_all_frames = lambda *a, _u=unet, _p=preds, **kw: (
                lambda out: (_p.append(out.float().cpu()), out)[1])(_u(*a, **kw))
            zero_counts()
            img = image(XL_PROMPT, negative_prompt="blurry", cfg_scale=5.0, height=64, width=64,
                        num_inference_steps=2, seed=2)
            vid = video(XL_PROMPT, negative_prompt="", cfg_scale=XL_CFG, num_frames=3,
                        input_frames=frames, denoising_strength=0.9, height=64, width=64,
                        num_inference_steps=2, controlnet_frames=[frames],
                        ipadapter_images=[ref], ipadapter_scale=XL_IP_SCALE, seed=3)
            if device == "cuda":
                torch.cuda.synchronize()
                launches = sd_launches()
            out[device] = (decoded[0], img, preds[0], latents[-1], vid)
            del image, video, m
    (dc, ic, pc, lc, vc), (dh, ih, ph, lh, vh) = out["cuda"], out["cpu"]
    img_rel, pred_rel, lat_rel = _rel(dc, dh), _rel(pc, ph), _rel(lc, lh)
    gaps = (_levels([ic], [ih]), _levels(vc, vh))
    routes = {k for entry in launches.values() for k in entry}
    log(f"[xl-small] card vs CPU: image before uint8 {img_rel:.3e}, the video's first UNet "
        f"output (the positive branch) {pred_rel:.3e} (bound {XL_SMALL_REL}), its final latents "
        f"{lat_rel:.3e}; frames {gaps} levels (bound {XL_LEVELS}); launches "
        f"{launches}; {card}")
    if not (img_rel <= XL_SMALL_REL and pred_rel <= XL_SMALL_REL and lat_rel <= XL_SMALL_REL
            and max(gaps) <= XL_LEVELS):
        raise RuntimeError("the small SDXL pipelines on the card disagree with the CPU")
    if not routes or any(not k.startswith("f32/") for k in routes):
        raise RuntimeError(f"the small SDXL pipelines launched {launches}")

    # the extensions on small inputs
    ifnet, esr_sd = rife.ifnet_state_dict(c=16, seed=24), esr.esrgan_state_dict(
        25, cfg=esr.RRDBNetConfig(num_feat=16, num_block=2, num_grow_ch=8))
    esr_cfg = esr.config_from_state_dict(esr_sd)
    clip = [sd_frames(3, 64, 96, seed=26)[i] for i in range(3)]
    style, guide = _blocky(6, 32, 48, 27), _blocky(6, 32, 48, 28)
    qsds = {"clip-large": qt.hf_clip_state_dict(29, vision_width=48, vision_layers=1, patch=32,
                                                text_width=32, text_layers=1, projection=24),
            "aesthetic_predictor": iq.score_mlp_state_dict(30, dim=24),
            "hpsv2": qt.open_clip_state_dict(31, vision_width=48, vision_layers=1, patch=32,
                                             text_width=32, text_layers=1, projection=24)}
    qpaths = _quality_files(root / "quality_small", qsds)
    res = {}
    for device in ("cuda", "cpu"):
        t0 = time.perf_counter()
        inter = RIFEInterpolater(rife.params_from_torch_state_dict(ifnet, device=device))
        blend = FastBlendSmoother(device=device)(style, original_frames=guide)
        up = ESRGAN(esr.params_from_torch_state_dict(esr_sd, esr_cfg, device=device),
                    esr_cfg).upscale(clip[:2], batch_size=1)
        scores = (iq.load_preference_model("Aesthetic", device=device, path=qpaths).score(clip),
                  iq.load_preference_model("HPSv2", device=device, path=qpaths).score(
                      clip, XL_PROMPT))
        res[device] = (inter.interpolate(clip), blend, up, scores, time.perf_counter() - t0)
    (ri, fb, es, sc, t_card), (ri_h, fb_h, es_h, sc_h, t_cpu) = res["cuda"], res["cpu"]
    gaps = {"rife": _levels(ri, ri_h), "fastblend": _levels(fb, fb_h),
            "esrgan": _levels(es, es_h)}
    score_rel = max(_rel(torch.tensor(a), torch.tensor(b)) for a, b in zip(sc, sc_h))
    log(f"[xl-small-ext] card vs CPU: frames {gaps} levels (bound {XL_LEVELS}; FastBlend "
        f"identical: {all(np.array_equal(a, b) for a, b in zip(fb, fb_h))}), scores "
        f"{score_rel:.3e} (bound {XL_SCORE_REL}): Aesthetic {sc[0]}, HPSv2 {sc[1]}; seconds card "
        f"{t_card:.2f}, CPU {t_cpu:.2f}; {card}")
    if max(gaps.values()) > XL_LEVELS or not score_rel <= XL_SCORE_REL \
            or len(ri) != 5 or es[0].shape != (256, 384, 3):
        raise RuntimeError("the small extensions on the card disagree with the CPU")


def write_xl_checkpoints(root: Path, card: str) -> dict:
    """(b) Seeded files at the published widths in the reference's naming:
    SDXL base 1.0 (UNet, CLIP ViT-L text, OpenCLIP bigG text at 2 of its 32
    layers (WRITTEN_DEPTH), VAE encoder and decoder; f16 as it ships), AnimateDiff-SDXL's motion modules, ControlNet
    Union SDXL, IP-Adapter SDXL and its ViT-H/14 image encoder (f16),
    RRDBNet x4 and IFNet (f32), CLIP ViT-L/14 with the aesthetic MLP and
    open_clip ViT-H/14 (f16)."""
    from svi_tpu_torch.extensions import esrgan as esr
    from svi_tpu_torch.extensions import image_quality as iq
    from svi_tpu_torch.extensions import quality_towers as qt
    from svi_tpu_torch.extensions import rife
    from svi_tpu_torch.models import controlnets as cn
    from svi_tpu_torch.models import ipadapter as ip
    from svi_tpu_torch.models import motion as mo
    from svi_tpu_torch.models import sd, sdxl
    from svi_tpu_torch.utils.safetensors_io import save_file

    f16, f32 = torch.float16, torch.float32
    makers = {"sdxl_unet": (sdxl.sdxl_unet_state_dict, f16),
              "sdxl_text_encoder": (sdxl.sdxl_text_encoder_state_dict, f16),
              "sdxl_text_encoder_2": (sdxl.sdxl_text_encoder_2_state_dict, f16),
              "sdxl_vae_encoder": (sd.sd_vae_encoder_state_dict, f16),
              "sdxl_vae_decoder": (sd.sd_vae_decoder_state_dict, f16),
              "sdxl_motion_modules": (mo.sdxl_motion_state_dict, f16),
              "sdxl_controlnet": (cn.sdxl_controlnet_state_dict, f16),
              "sdxl_ipadapter": (ip.sdxl_ipadapter_state_dict, f16),
              "sdxl_ipadapter_clip_image_encoder": (ip.clip_image_encoder_state_dict, f16),
              "esrgan": (esr.esrgan_state_dict, f32), "rife": (rife.ifnet_state_dict, f32),
              "clip-large": (qt.hf_clip_state_dict, f16),
              "aesthetic_predictor": (iq.score_mlp_state_dict, f32),
              "hpsv2": (qt.open_clip_state_dict, f16)}
    (root / "clip-vit-large-patch14").mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    paths, sizes, params = {}, {}, {}
    for i, (kind, (make, dtype)) in enumerate(makers.items()):
        depth, published = WRITTEN_DEPTH.get(("xl", kind), ({}, {}))
        state = make(seed=81 + i, device="cuda", dtype=dtype, **depth)
        params[kind] = sum(t.numel() for t in state.values())
        if published:
            full = full_depth_params(state, published)
            log(f"[xl-files] {kind} cut in depth: {full / 1e6:.1f}M parameters at the "
                "published depth")
        path = str(root / XL_FILES[kind])
        sizes[kind] = save_file(state, path)
        paths[kind] = str(root / "clip-vit-large-patch14") if kind == "clip-large" else path
        del state
    torch.cuda.empty_cache()
    log(f"[xl-files] {', '.join(f'{k} {params[k] / 1e6:.1f}M' for k in makers)} parameters; "
        f"{sum(sizes.values()) / 1e9:.3f} GB written in {time.perf_counter() - t0:.2f}s; {card}")
    if abs(params["sdxl_unet"] - XL_UNET_PARAMS) > 1e6:
        raise RuntimeError(f"the SDXL UNet has {params['sdxl_unet']} parameters, not 2.567B")
    return paths


def _xl_manager(paths: dict, kinds, device):
    """A ModelManager holding `kinds` from (b)'s files (the SDXL VAE named:
    it has the SD VAE's keys)."""
    from svi_tpu_torch.models.model_io import ModelManager

    mm = ModelManager(device=device)
    for kind in kinds:
        got = mm.load_model(paths[kind], model_names=kind if kind.startswith("sdxl_vae") else None)
        if got != kind:
            raise RuntimeError(f"{paths[kind]} loaded as {got}, not {kind}")
    return mm


def phase_xl_full_forward(paths: dict, card: str) -> None:
    """(c) One UNet + ControlNet Union + AnimateDiff-SDXL forward at full
    width on 2 frames of 128x128 (16 x 16 latents), the models loaded from
    (b)'s files by ModelManager on the card and on the CPU."""
    from svi_tpu_torch.models import controlnets as cn
    from svi_tpu_torch.models import motion as mo
    from svi_tpu_torch.models import sdxl

    g = torch.Generator().manual_seed(4)
    lat = torch.randn((2, 4, 16, 16), generator=g)
    ctx = torch.randn((2, 77, sdxl.SDXL_TEXT_DIM), generator=g)
    pooled = torch.randn((2, sdxl.SDXL_POOLED_DIM), generator=g)
    cond = torch.rand((2, 3, 128, 128), generator=g)
    ids = torch.tensor([[128, 128, 0, 0, 128, 128]] * 2, dtype=torch.float32)
    t = torch.tensor([601.0])
    outs, secs = {}, {}
    kinds = ("sdxl_unet", "sdxl_motion_modules", "sdxl_controlnet")
    for device in ("cuda", "cpu"):
        t0 = time.perf_counter()
        mm = _xl_manager(paths, kinds, device)
        load_s = time.perf_counter() - t0
        unet, motion, cnp = (mm.fetch_model(k) for k in kinds)
        args = [x.to(device) for x in (lat, t, ctx)]
        with torch.inference_mode():
            if device == "cuda":
                zero_counts()
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = [r * XL_CN_SCALE for r in cn.sdxl_controlnet_forward(
                cnp, *args, cond.to(device), "tile", ids.to(device), pooled.to(device))]
            out = sdxl.sdxl_unet_forward(
                unet, *args, ids.to(device), pooled.to(device), controlnet_res=res,
                motion=mo.motion_hooks(motion, call_map=mo.SDXL_MOTION_CALL_MAP))
            if device == "cuda":
                torch.cuda.synchronize()
                launches = sd_launches()
            secs[device] = (load_s, time.perf_counter() - t0)
        outs[device] = out.float().cpu()
        del mm, unet, motion, cnp, res, out
        gc.collect()
        torch.cuda.empty_cache()
    rel = _rel(outs["cuda"], outs["cpu"])
    want = xl_expected_launches(passes=1, vae_calls=0)
    (card_load, card_fwd), (cpu_load, cpu_fwd) = secs["cuda"], secs["cpu"]
    log(f"[xl-forward] SDXL UNet + ControlNet Union + AnimateDiff-SDXL at full width, "
        f"2x4x16x16: card vs CPU {rel:.3e} of the output's scale (bound {XL_FULL_REL}); load s / "
        f"forward s card {card_load:.2f} / {card_fwd:.3f}, CPU {cpu_load:.2f} / {cpu_fwd:.2f}; "
        f"launches {launches}; {card}")
    if not rel <= XL_FULL_REL:
        raise RuntimeError("the full-width SDXL forward on the card disagrees with the CPU")
    if launches != want:
        raise RuntimeError(f"the SDXL forward launched {launches}, expected {want}")


def fastblend_op_times(card: str) -> None:
    """FastBlend's three patch operations (plain torch gathers, no kernel)
    at the shape 8d's runner gives them most: a batch of 8 at 512x512 and
    the largest patch (13, pad 6), the guide and style errors stacked (16);
    median CUDA-event ms of 3 calls each, beside the bytes their inputs and
    output take (each read once) over the card's 3.35 TB/s."""
    from svi_tpu_torch.extensions import fastblend as fb

    g = torch.Generator(device="cuda").manual_seed(5)
    b, h, w, ps = 16, 512, 512, 13
    pad = ps // 2
    img = lambda: torch.rand((b, h + 2 * pad, w + 2 * pad, 3), generator=g, device="cuda") * 255
    src, tgt = img(), img()
    nnf = torch.stack([torch.randint(0, h, (b, h, w), generator=g, device="cuda"),
                       torch.randint(0, w, (b, h, w), generator=g, device="cuda")],
                      -1).to(torch.int32)
    calls = {"apply_nnf_to_image": lambda: fb.apply_nnf_to_image(src, nnf, ps, pad),
             "patch_error": lambda: fb.patch_error(src, nnf, tgt, ps, pad),
             "pairwise_patch_error": lambda: fb.pairwise_patch_error(src, nnf, tgt, nnf, ps,
                                                                     pad)}
    out_bytes = {"apply_nnf_to_image": src.numel() * 4, "patch_error": b * h * w * 4,
                 "pairwise_patch_error": b * h * w * 4}
    rows = []
    for name, fn in calls.items():
        ms = median_ms(fn, 3)
        nbytes = _nbytes(src, nnf) + (_nbytes(tgt) if name != "apply_nnf_to_image" else 0) \
            + out_bytes[name]
        rows.append(f"{name} {ms:.2f} ms (bytes bound {1e3 * nbytes / HBM_BYTES_PER_S:.3f} ms)")
    log(f"[fastblend-ops] B{b} {h}x{w}, patch {ps} ({ps * ps} offsets): " + "; ".join(rows)
        + f"; {card}")
    del src, tgt, nnf
    torch.cuda.empty_cache()


def phase_xl_video(paths: dict, card: str) -> dict:
    """(d) SDXLVideoPipeline.from_model_manager on (b)'s files at 1024x1024,
    8 frames (AnimateDiff-SDXL's published setting is 16: cut to make room
    for phase 11), 2 steps, CFG 7.5, a
    tile ControlNet Union unit at 0.5 on a seeded video, an IP-Adapter image
    at 0.6; then RIFE over its frames, FastBlend (its default ebsynth
    config) over its first frames guided by the control video, ESRGAN on 2
    frames, the Aesthetic and HPSv2 scores of 2 frames (HPSv2's token ids
    from clip_bpe). Per-part seconds, peak memory, and the K2 / K1 launches
    against the plans'. Returns the launches per KERNELS entry."""
    from svi_tpu_torch.extensions import ESRGAN, FastBlendSmoother, RIFEInterpolater
    from svi_tpu_torch.extensions import image_quality as iq
    from svi_tpu_torch.models import controlnets as cn
    from svi_tpu_torch.models import ipadapter as ip
    from svi_tpu_torch.models import motion as mo
    from svi_tpu_torch.models import sdxl
    from svi_tpu_torch.pipelines.sdxl_video import SDXLVideoPipeline
    from svi_tpu_torch.prompters.sdxl_prompter import SDXLPrompter
    from svi_tpu_torch.schedulers.ddim import EnhancedDDIMScheduler

    control = list(sd_frames(XL_FRAMES, XL_H, XL_W, seed=31))
    ref = sd_frames(1, XL_H, XL_W, seed=32)[0]
    timer = PhaseTimer()
    step_marks = []
    step = EnhancedDDIMScheduler.step

    def timed_step(self, *a, **kw):
        out = step(self, *a, **kw)
        torch.cuda.synchronize()
        step_marks.append(time.perf_counter())
        return out

    t0 = time.perf_counter()
    kinds = ("sdxl_unet", "sdxl_motion_modules", "sdxl_text_encoder", "sdxl_text_encoder_2",
             "sdxl_vae_decoder", "sdxl_ipadapter", "sdxl_ipadapter_clip_image_encoder")
    mm = _xl_manager(paths, kinds, "cuda")
    pipe = SDXLVideoPipeline.from_model_manager(
        mm, [cn.ControlNetConfigUnit("tile", paths["sdxl_controlnet"], XL_CN_SCALE)])
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    sets = [(sdxl, "sdxl_unet_forward", timer.wrap("unet (with motion)", sdxl.sdxl_unet_forward)),
            (sdxl, "sdxl_vae_decode", timer.wrap("vae_decode", sdxl.sdxl_vae_decode)),
            (mo, "temporal_block", timer.wrap("motion", mo.temporal_block)),
            (cn, "sdxl_controlnet_forward", timer.wrap("controlnet", cn.sdxl_controlnet_forward)),
            (ip, "clip_image_encoder_forward", timer.wrap("image_encoder",
                                                          ip.clip_image_encoder_forward)),
            (SDXLPrompter, "encode_prompt", timer.wrap("text_encoders",
                                                       SDXLPrompter.encode_prompt)),
            (EnhancedDDIMScheduler, "step", timed_step)]
    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with patched(sets):
        frames = pipe(XL_PROMPT, negative_prompt="blurry, low quality", cfg_scale=XL_CFG,
                      num_frames=XL_FRAMES, height=XL_H, width=XL_W,
                      num_inference_steps=XL_STEPS, controlnet_frames=[control],
                      ipadapter_images=[ref], ipadapter_scale=XL_IP_SCALE, seed=0)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launches = sd_launches()
    peak = torch.cuda.max_memory_allocated() / 2**30
    secs = {k: sum(v) for k, v in timer.seconds.items()}
    calls = {k: len(v) for k, v in timer.seconds.items()}
    step_s = [b - a for a, b in zip(step_marks, step_marks[1:])]
    log(f"[xl-video] {XL_FRAMES} frames {XL_H}x{XL_W}, {XL_STEPS} steps, CFG {XL_CFG} (two "
        f"passes of every frame a step), ControlNet Union + IP-Adapter + AnimateDiff-SDXL: load "
        f"{load_s:.2f}s, {total:.2f}s in all; seconds between steps {[round(x, 3) for x in step_s]}"
        f"; seconds (calls): " + ", ".join(f"{k} {secs[k]:.3f} ({calls[k]})" for k in secs)
        + f"; peak memory {peak:.2f} GiB; launches {launches}; {card}")
    want = xl_expected_launches(passes=2 * XL_STEPS, vae_calls=XL_FRAMES)
    if launches != want:
        raise RuntimeError(f"the SDXL video pipeline launched {launches}, expected {want}")
    arr = np.stack(frames)
    if arr.shape != (XL_FRAMES, XL_H, XL_W, 3) or arr.dtype != np.uint8 or arr.std() == 0:
        raise RuntimeError(f"the SDXL video is {arr.shape} {arr.dtype}, or flat")
    del pipe
    mm.models.clear()
    gc.collect()
    torch.cuda.empty_cache()

    fastblend_op_times(card)
    ext = {}
    mm = _xl_manager(paths, ("rife", "esrgan"), "cuda")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    doubled = RIFEInterpolater(mm.fetch_model("rife")).interpolate(frames)
    ext["rife"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    blended = FastBlendSmoother(device="cuda")(frames[:XL_FASTBLEND_FRAMES],
                                                original_frames=control[:XL_FASTBLEND_FRAMES])
    ext["fastblend"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    big = ESRGAN(mm.fetch_model("esrgan")).upscale(frames[:XL_ESRGAN_FRAMES], batch_size=1)
    ext["esrgan"] = time.perf_counter() - t0
    del mm
    t0 = time.perf_counter()
    aesthetic = iq.load_preference_model("Aesthetic", device="cuda", path=paths).score(
        frames[:XL_SCORE_FRAMES])
    hps = iq.load_preference_model("HPSv2", device="cuda", path=paths).score(
        frames[:XL_SCORE_FRAMES], XL_PROMPT)
    ext["scores (with loading)"] = time.perf_counter() - t0
    ext_peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[xl-extensions] RIFE {len(frames)} -> {len(doubled)} frames, FastBlend "
        f"{len(blended)} frames, ESRGAN {len(big)} frames -> {big[0].shape}; Aesthetic "
        f"{aesthetic}, HPSv2 {hps}; seconds " + ", ".join(f"{k} {v:.2f}" for k, v in ext.items())
        + f"; peak memory {ext_peak:.2f} GiB; {card}")
    if len(doubled) != 2 * XL_FRAMES - 1 or _levels(doubled[::2], frames) > XL_LEVELS \
            or len(blended) != XL_FASTBLEND_FRAMES or np.stack(blended).std() == 0 \
            or big[0].shape != (4 * XL_H, 4 * XL_W, 3) \
            or not np.isfinite(aesthetic + hps).all():
        raise RuntimeError("the extensions' outputs on the SDXL frames are wrong")
    gc.collect()
    torch.cuda.empty_cache()
    return {"flash_fwd_bnsd/f32": sum(launches["flash_fwd_bnsd"].values()),
            "flash_fwd_flat/f32": sum(launches["flash_fwd_flat"].values())}


def phase_xl(card: str) -> dict:
    """Phase 9: (a) the small SDXL pipelines and extensions card vs CPU, (b)
    full-width files, (c) one full-width UNet + ControlNet + motion forward
    card vs CPU, (d) the SDXL video pipeline at 1024x1024x8 with the
    extensions after it. Returns (d)'s launches per KERNELS entry."""
    import shutil
    import tempfile

    t0 = time.perf_counter()
    root = Path(tempfile.mkdtemp(prefix="_xl_ckpt_", dir=REPO))
    try:
        phase_xl_small(root, card)
        log(f"[time] phase 9a: {time.perf_counter() - t0:.1f}s")
        paths = write_xl_checkpoints(root, card)
        phase_xl_full_forward(paths, card)
        log(f"[time] phase 9b-c: {time.perf_counter() - t0:.1f}s")
        launches = phase_xl_video(paths, card)
    finally:
        gc.collect()
        torch.cuda.empty_cache()
        shutil.rmtree(root, ignore_errors=True)
    log(f"[xl] phase 9 passed in {time.perf_counter() - t0:.1f}s; {card}")
    return launches


# ---------------------------------------------------------------------------
# phase 10: Kolors, SD3 and FLUX
# ---------------------------------------------------------------------------

FAM_H, FAM_W, FAM_STEPS = 1024, 1024, 2
KOLORS_CFG, SD3_CFG, FLUX_GUIDANCE = 7.5, 7.5, 3.5
# long enough that ChatGLM's 256-token window is full (the prompter cuts it)
KOLORS_PROMPT = ("一位穿着红色汉服的少女站在盛开的樱花树下，微风吹起粉色的花瓣，阳光透过树枝洒在她的脸上，"
                 "远处是古老的寺庙和连绵的青山，水墨画风格与电影感光影结合，细节丰富，8K 超高清，"
                 "a girl in a red hanfu under blooming cherry trees, petals in the wind, ") * 4
SD3_PROMPT = "a glass sculpture of a fox in a snowy forest at golden hour, highly detailed"
FLUX_PROMPT = "a lighthouse on a cliff above a stormy sea at dusk, cinematic, photorealistic"
FAM_FILES = {
    "kolors": {"chatglm": "kolors_text_encoder.safetensors", "unet": "kolors_unet.safetensors",
               "vae_decoder": "sdxl_vae_decoder.safetensors"},
    "sd3": {"dit": "sd3_medium_mmdit.safetensors", "te1": "sd3_clip_l.safetensors",
            "te2": "sd3_clip_g.safetensors", "t5": "t5xxl_2_layers.safetensors",
            "vae_decoder": "sd3_vae_decoder.safetensors"},
    "flux": {"dit": "flux1_dev_dit.safetensors", "te1": "flux_clip_l.safetensors",
             "t5": "t5xxl_2_layers.safetensors", "vae_decoder": "flux_vae_decoder.safetensors"},
}
# the published parameter counts each seeded file must hold at the published
# depth (ChatGLM3-6B with its output layer; SD3-medium's MMDiT with its 192 x
# 192 position table; FLUX.1-dev's DiT): a file written at a cut depth
# (WRITTEN_DEPTH) is counted at the full depth from its blocks

FAM_PARAMS = {("kolors", "chatglm"): 6_243_584_000, ("sd3", "dit"): 2_084_951_104,
              ("flux", "dit"): 11_901_408_320}
# Card against CPU (written before the first card run): the tiny f32
# pipelines at 1e-4 of the decoded image's scale and frames within one level,
# as phase 9a holds SDXL's; the full-width f32 forwards at 1e-3 of the
# output's scale, as phase 9c; the full-width FLUX forward in bf16 on the
# card against the CPU's f32 one at 5e-2 (bf16 weights and activations: 2^-8
# a rounding, over two blocks' sums)
FAM_SMALL_REL, FAM_FULL_REL, FLUX_BF16_REL, FAM_LEVELS = 1e-4, 1e-3, 5e-2, 1
FAM_CUT = {"kolors": "ChatGLM3 at 2 of 28 layers, the UNet whole",
           "sd3": "the file's 2 of 24 blocks",
           "flux": "1 of 19 joint and 1 of 38 single blocks"}  # (c)'s depths
# (d)'s depths are the files' (WRITTEN_DEPTH): ChatGLM3 2 of 28 layers, the
# MMDiT 2 of 24 blocks and OpenCLIP bigG 2 of 32 layers, FLUX 2 + 2 of 19 +
# 38 blocks


def _capture(pipe, store: list, attr="vae_output_to_image"):
    """The decoded image (before its uint8 cast) of each call, on the host."""
    fn = getattr(pipe, attr)
    setattr(pipe, attr, lambda out, *a, **kw: (store.append(out.float().cpu()),
                                               fn(out, *a, **kw))[1])


def phase_families_small(card: str) -> None:
    """(a) The CPU tests' tiny models (tests/torch_sd_fixtures.py; the narrow
    SDXL plans with one head a block and the motion modules at one head, so
    that every head dim has a route) through Kolors' SDXLImagePipeline (64x64,
    2 steps, CFG 5) and SDXLVideoPipeline with AnimateDiff-SDXL (2 frames),
    SD3ImagePipeline (CFG 7.5, T5 on) and FluxImagePipeline (a union
    ControlNet unit, an IP-Adapter embedding, TeaCache and one EliGen entity;
    f32), each on the card against the CPU."""
    from svi_tpu_torch.models import flux, kolors, sd, sd3, sdxl, t5
    from svi_tpu_torch.models import motion as mo
    from svi_tpu_torch.pipelines.flux_image import FluxImagePipeline
    from svi_tpu_torch.pipelines.sd3_image import SD3ImagePipeline
    from svi_tpu_torch.pipelines.sdxl_image import SDXLImagePipeline
    from svi_tpu_torch.pipelines.sdxl_video import SDXLVideoPipeline

    fx = _sd_fixtures()
    unet_plan, _ = fx.xl_plans(heads=1)
    enc_plan, dec_plan = fx.sd3_vae_plans()
    sets = [(sdxl, "SDXL_UNET_PLAN", unet_plan), (sd, "SD_VAE_DECODER_PLAN", fx.VAE_DECODER_PLAN),
            (mo, "NUM_HEADS", 1),
            (kolors, "kolors_encode_prompt",
             functools.partial(kolors.kolors_encode_prompt, **fx.GLM)),
            (flux, "flux_ipadapter_forward",
             functools.partial(flux.flux_ipadapter_forward, num_heads=1))]
    for mod in (sd3, flux):
        sets += [(mod, "SD3_VAE_ENCODER_PLAN", enc_plan), (mod, "SD3_VAE_DECODER_PLAN", dec_plan)]
    image = sd_frames(1, 64, 64, seed=51)[0]
    mask = np.zeros((64, 64, 3), np.uint8)
    mask[8:40, 16:56] = 255
    emb = np.random.default_rng(52).standard_normal((1, 1152)).astype(np.float32) * 0.3
    out = {}
    with patched(sets):
        ks, s3, fl = fx.kolors_state_dicts(61), fx.sd3_state_dicts(62), fx.flux_state_dicts(63)
        for device in ("cuda", "cpu"):
            got = {}
            glm = kolors.chatglm_params_from_torch(ks["chatglm"], device=device)
            unet = sdxl.sdxl_unet_params_from_torch(ks["unet"], device=device)
            dec = sd.sd_vae_decoder_params_from_torch(ks["vae"], device=device)
            motion = mo.motion_params_from_torch(ks["motion"], device=device)
            kimg = SDXLImagePipeline(unet, vae_decoder=dec, chatglm_params=glm)
            kvid = SDXLVideoPipeline(unet, motion, vae_decoder=dec, chatglm_params=glm)
            _capture(kimg, got.setdefault("kolors_image", []))
            _capture(kvid, got.setdefault("kolors_video", []), "decode_video")
            s3m = {k: f(s3[k], device=device) for k, f in (
                ("dit", lambda s, device: sd3.sd3_dit_params_from_torch(s, 1, device=device)),
                ("te1", sd.sd_text_encoder_params_from_torch),
                ("te2", sdxl.sdxl_text_encoder_2_params_from_torch),
                ("vae_encoder", sd3.sd3_vae_encoder_params_from_torch),
                ("vae_decoder", sd3.sd3_vae_decoder_params_from_torch))}
            s3t5 = t5.params_from_torch_state_dict(s3["t5"], s3["t5_cfg"], device=device)
            s3p = SD3ImagePipeline(s3m["dit"], s3m["te1"], s3m["te2"], (s3t5, s3t5.cfg, None),
                                   s3m["vae_encoder"], s3m["vae_decoder"])
            _capture(s3p, got.setdefault("sd3", []))
            f32 = dict(device=device, dtype=torch.float32)
            flm = {"dit": flux.flux_dit_params_from_torch(fl["dit"], **f32),
                   "cnet": flux.flux_controlnet_params_from_torch(fl["cnet"], **f32),
                   "ip": flux.flux_ipadapter_params_from_torch(fl["ip"], **f32),
                   "te1": sd.sd_text_encoder_params_from_torch(fl["te1"], device=device),
                   "enc": flux.flux_vae_encoder_params_from_torch(fl["vae_encoder"], device=device),
                   "dec": flux.flux_vae_decoder_params_from_torch(fl["vae_decoder"], device=device)}
            flt5 = t5.params_from_torch_state_dict(fl["t5"], fl["t5_cfg"], device=device)
            flp = FluxImagePipeline(flm["dit"], flm["te1"], (flt5, flt5.cfg, None), flm["enc"],
                                    flm["dec"], dtype=torch.float32)
            _capture(flp, got.setdefault("flux", []))
            zero_counts()
            t0 = time.perf_counter()
            frames = {
                "kolors_image": [kimg(KOLORS_PROMPT, negative_prompt="模糊", cfg_scale=5.0,
                                      height=64, width=64, num_inference_steps=2, seed=1)],
                "kolors_video": kvid(KOLORS_PROMPT, cfg_scale=5.0, num_frames=2, height=64,
                                     width=64, num_inference_steps=2, seed=2),
                "sd3": [s3p(SD3_PROMPT, negative_prompt="blurry", cfg_scale=SD3_CFG, height=64,
                            width=64, num_inference_steps=2, t5_sequence_length=64, seed=3)],
                "flux": [flp(FLUX_PROMPT, height=64, width=64, num_inference_steps=3,
                             t5_sequence_length=16, seed=4, input_image=image,
                             denoising_strength=0.9,
                             controlnet_units=[(flm["cnet"], image, 0.6, 0)],
                             ipadapter_params=flm["ip"], ipadapter_image_emb=emb,
                             eligen_entity_prompts=["a red door"], eligen_entity_masks=[mask],
                             tea_cache_l1_thresh=0.3)]}
            if device == "cuda":
                torch.cuda.synchronize()
                launches = sd_launches()
            out[device] = (got, frames, time.perf_counter() - t0)
            del kimg, kvid, s3p, flp, glm, unet, dec, motion, s3m, s3t5, flm, flt5
    (gc_, fc, t_card), (gh, fh, t_cpu) = out["cuda"], out["cpu"]
    rels = {k: max(_rel(a, b) for a, b in zip(gc_[k], gh[k])) for k in gc_}
    levels = {k: _levels(fc[k], fh[k]) for k in fc}
    routes = {k for entry in launches.values() for k in entry}
    log(f"[families-small] card vs CPU, decoded images (the video's final latents) "
        f"{ {k: f'{v:.3e}' for k, v in rels.items()} } (bound {FAM_SMALL_REL}); frames {levels} "
        f"levels (bound {FAM_LEVELS}); seconds card {t_card:.2f}, CPU {t_cpu:.2f}; launches "
        f"{launches}; {card}")
    if max(rels.values()) > FAM_SMALL_REL or max(levels.values()) > FAM_LEVELS:
        raise RuntimeError("the small Kolors / SD3 / FLUX pipelines on the card disagree with "
                           "the CPU")
    if not routes or any(not k.startswith("f32/") for k in routes):
        raise RuntimeError(f"the small Kolors / SD3 / FLUX pipelines launched {launches}")


# The written models cut in depth (at full width), and so the (d) pipelines
# that load them: (family, kind) -> (the writer's depth keywords, {block key
# prefix: the published depth}). Each file's full-depth parameter count is
# computed from it: the blocks written times the published depth.
WRITTEN_DEPTH = {
    ("kolors", "chatglm"): (dict(num_layers=2), {"encoder.layers.": 28}),
    ("sd3", "dit"): (dict(num_layers=2), {"blocks.": 24}),
    ("sd3", "te2"): (dict(num_layers=2), {"encoders.": 32}),
    ("xl", "sdxl_text_encoder_2"): (dict(num_layers=2), {"encoders.": 32}),
    ("flux", "dit"): (dict(num_joint=2, num_single=2), {"blocks.": 19, "single_blocks.": 38}),
    ("hunyuan_video", "dit"): (dict(num_double=2, num_single=2),
                               {"double_blocks.": 20, "single_blocks.": 40}),
    ("cog", "dit"): (dict(num_layers=2), {"blocks.": 42}),
    ("stepvideo", "dit"): (dict(num_layers=2), {"transformer_blocks.": 48}),
}


def full_depth_params(state: dict, depths: dict) -> int:
    """A cut-depth state dict's parameter count at the published depth: each
    block family's count per block (from its block 0) times the blocks it
    lacks, added."""
    n = sum(t.numel() for t in state.values())
    for prefix, full in depths.items():
        written = len({k[len(prefix):].split(".", 1)[0] for k in state if k.startswith(prefix)})
        per_block = sum(t.numel() for k, t in state.items() if k.startswith(f"{prefix}0."))
        n += (full - written) * per_block
    return n


def write_checkpoints(family: str, makers: dict, files: dict, root: Path, seed: int,
                      card: str) -> dict:
    """Each kind's seeded state dict (made on the card by its writer, at
    WRITTEN_DEPTH's depth where it names one) saved under `root`; prints the
    parameter counts (and the full-depth count of a cut file) and holds them
    to FAM_PARAMS' published counts. Returns {kind: path}."""
    from svi_tpu_torch.utils.safetensors_io import save_file

    t0 = time.perf_counter()
    paths, sizes, params, full = {}, {}, {}, {}
    for i, (kind, (make, dtype)) in enumerate(makers.items()):
        depth, published = WRITTEN_DEPTH.get((family, kind), ({}, {}))
        state = make(seed=seed + i, device="cuda", dtype=dtype, **depth)
        params[kind] = sum(t.numel() for t in state.values())
        full[kind] = full_depth_params(state, published)
        paths[kind] = str(root / files[kind])
        sizes[kind] = save_file(state, paths[kind])
        del state
        torch.cuda.empty_cache()
    log(f"[{family}-files] " + ", ".join(
        f"{k} {params[k] / 1e6:.1f}M" + (f" cut in depth ({full[k] / 1e6:.1f}M at the "
                                        f"published depth)" if (family, k) in WRITTEN_DEPTH
                                        else "") for k in makers)
        + f" parameters; {sum(sizes.values()) / 1e9:.3f} GB written in "
        f"{time.perf_counter() - t0:.2f}s; {card}")
    for (fam, kind), n in FAM_PARAMS.items():
        if fam == family and full[kind] != n:
            raise RuntimeError(f"{family} {kind} has {full[kind]} parameters at the published "
                               f"depth, not {n}")
    return paths


def write_family_checkpoints(family: str, root: Path, card: str) -> dict:
    """(b) One family's seeded files at the published widths in the
    reference's names: Kolors (ChatGLM3-6B f16 at 2 of 28 layers, the Kolors
    UNet f16, SDXL's VAE decoder f16), SD3-medium (the MMDiT at 2 of 24
    blocks, CLIP-L, OpenCLIP bigG at 2 of 32 layers, the 16-channel VAE
    decoder, f16) or FLUX.1-dev (the DiT
    with its guidance embedder at 2 + 2 of 19 + 38 blocks, CLIP-L, the VAE
    decoder, bf16); SD3 and FLUX each with T5-XXL at 2 of its 24 layers
    (bf16)."""
    from svi_tpu_torch.models import flux, kolors, sd, sd3, sdxl, t5

    f16, bf16 = torch.float16, torch.bfloat16

    def t5_xxl(seed, device, dtype):
        cfg = t5.T5Config(vocab=32128, num_layers=2, dtype=dtype)
        return t5.torch_state_dict_from_params(t5.init_params(cfg, seed, device=device))

    makers = {
        "kolors": {"chatglm": (kolors.chatglm_state_dict, f16),
                   "unet": (functools.partial(sdxl.sdxl_unet_state_dict, pooled_dim=4096,
                                              text_proj_dim=4096), f16),
                   "vae_decoder": (sd.sd_vae_decoder_state_dict, f16)},
        "sd3": {"dit": (sd3.sd3_dit_state_dict, f16), "te1": (sd.sd_text_encoder_state_dict, f16),
                "te2": (sdxl.sdxl_text_encoder_2_state_dict, f16), "t5": (t5_xxl, bf16),
                "vae_decoder": (sd3.sd3_vae_decoder_state_dict, f16)},
        "flux": {"dit": (flux.flux_dit_state_dict, bf16),
                 "te1": (sd.sd_text_encoder_state_dict, bf16), "t5": (t5_xxl, bf16),
                 "vae_decoder": (flux.flux_vae_decoder_state_dict, bf16)},
    }[family]
    return write_checkpoints(family, makers, FAM_FILES[family], root, 101, card)


def _cut(sd: dict, keep) -> dict:
    """The state dict's tensors whose block index (the number after one of
    keep's prefixes) is kept, renumbered from 0; every other tensor as is.
    keep: {prefix: [block indices]}."""
    out = {}
    for k, v in sd.items():
        for prefix, idx in keep.items():
            if k.startswith(prefix):
                i, rest = k[len(prefix):].split(".", 1)
                if int(i) in idx:
                    out[f"{prefix}{idx.index(int(i))}.{rest}"] = v
                break
        else:
            out[k] = v
    return out


def phase_family_forward(family: str, paths: dict, card: str) -> None:
    """(c) One forward of the family's full-width model at a cut depth, card
    against CPU: ChatGLM3 at 2 of 28 layers on the 256-token Kolors prompt
    (its pooled and prompt embeddings) and the Kolors UNet whole on 2 x 4 x 16
    x 16 latents over those 256 tokens and that pooled embedding; the MMDiT at the file's 2
    blocks on 2 x 16 x 32 x 32 latents and 154 tokens; FLUX at one joint and one
    single block on 1 x 16 x 32 x 32 latents and 64 tokens, in f32 and, on
    the card, in bf16."""
    from svi_tpu_torch.models import flux, kolors, sd3, sdxl
    from svi_tpu_torch.models.model_io import load_state_dict
    from svi_tpu_torch.prompters.sp_tokenizer import default_chatglm_tokenizer

    g = torch.Generator().manual_seed(7)
    if family == "kolors":
        glm_sd = _cut(load_state_dict(paths["chatglm"]), {"encoder.layers.": [0, 1]})
        unet_sd = load_state_dict(paths["unet"])
        ids, mask, pos = (torch.from_numpy(a) for a in kolors.kolors_tokenize(
            KOLORS_PROMPT, default_chatglm_tokenizer(), 256))
        lat = torch.randn((2, 4, 16, 16), generator=g)
        tids = torch.tensor([[128, 128, 0, 0, 128, 128]] * 2, dtype=torch.float32)

        def run(device, dtype):
            glm = kolors.chatglm_params_from_torch(glm_sd, device=device)
            p, e = kolors.kolors_encode_prompt(glm, ids, mask, pos)
            unet = sdxl.sdxl_unet_params_from_torch(unet_sd, device=device)
            y = sdxl.sdxl_unet_forward(unet, lat.to(device), torch.tensor([701.0]).to(device),
                                       e.repeat(2, 1, 1), tids.to(device), p.repeat(2, 1))
            return {"pooled": p, "prompt_emb": e, "unet": y}
    elif family == "sd3":
        dit_sd = load_state_dict(paths["dit"])  # the file's 2 blocks
        lat = torch.randn((2, 16, 32, 32), generator=g)
        ctx = torch.randn((2, 154, 4096), generator=g)
        pooled = torch.randn((2, 2048), generator=g)

        def run(device, dtype):
            dit = sd3.sd3_dit_params_from_torch(dit_sd, device=device)
            return {"mmdit": sd3.sd3_dit_forward(dit, *(x.to(device) for x in (
                lat, torch.tensor([801.0, 801.0]), ctx, pooled)))}
    else:
        dit_sd = _cut(load_state_dict(paths["dit"]), {"blocks.": [0], "single_blocks.": [0]})
        lat = torch.randn((1, 16, 32, 32), generator=g)
        ctx = torch.randn((1, 64, 4096), generator=g)
        pooled = torch.randn((1, 768), generator=g)

        def run(device, dtype):
            # the timestep and the guidance (x 1000, scaled in their dtype as
            # svi_tpu does) exact in bf16, so that bf16 and f32 embed the same
            dit = flux.flux_dit_params_from_torch(dit_sd, device=device, dtype=dtype)
            return {"dit": flux.flux_dit_forward(dit, *(x.to(device, dtype) for x in (
                lat, torch.tensor([896.0]), ctx, pooled)),
                guidance=torch.tensor([4.0], device=device, dtype=dtype))}
    outs, secs = {}, {}
    runs = [("cuda", torch.float32), ("cpu", torch.float32)]
    if family == "flux":
        runs.insert(1, ("cuda", torch.bfloat16))
    for device, dtype in runs:
        with torch.inference_mode():
            if device == "cuda":
                zero_counts()
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = {k: v.float().cpu() for k, v in run(device, dtype).items()}
            secs[(device, str(dtype)[6:])] = time.perf_counter() - t0
            if device == "cuda":
                launches = sd_launches()
        outs[(device, dtype)] = res
        gc.collect()
        torch.cuda.empty_cache()
    ref = outs[("cpu", torch.float32)]
    rel = {k: _rel(outs[("cuda", torch.float32)][k], ref[k]) for k in ref}
    bf16 = {k: _rel(outs[("cuda", torch.bfloat16)][k], ref[k]) for k in ref} \
        if family == "flux" else {}
    log(f"[{family}-forward] full width, {FAM_CUT[family]}: "
        f"card f32 vs CPU f32 { {k: f'{v:.3e}' for k, v in rel.items()} } (bound "
        f"{FAM_FULL_REL})" + (f", card bf16 vs CPU f32 { {k: f'{v:.3e}' for k, v in bf16.items()} }"
                              f" (bound {FLUX_BF16_REL})" if bf16 else "")
        + f"; seconds (loads included) {secs}; launches of the last card run {launches}; {card}")
    if max(rel.values()) > FAM_FULL_REL or (bf16 and max(bf16.values()) > FLUX_BF16_REL):
        raise RuntimeError(f"the full-width {family} forward on the card disagrees with the CPU")


def family_expected_launches(family: str, pipe) -> dict:
    """Phase 10d's attention launches per (route, dtype, head dim), from the
    models: Kolors' UNet plan once a step (CFG as one batch of two), the
    MMDiT's joint attention a block a step (the loaded MMDiT's; B2, 24 heads
    of 64: K2), FLUX's joint
    and single blocks a step (the loaded DiT's; B1, 24 heads of 128, bf16:
    K1 sm90); the VAE decode's mid-block once (K1 at D512: f32 for Kolors
    and SD3, bf16 for FLUX, whose pipeline runs its VAE in its bf16). ChatGLM,
    CLIP and T5 run the plain softmax."""
    from svi_tpu_torch.models import sd

    vae = {f"f32/float32/{sd.SD_VAE_DECODER_PLAN[1][1]}": 1}
    if family == "kolors":
        return xl_expected_launches(passes=FAM_STEPS, vae_calls=1, with_controlnet=False,
                                    with_motion=False)
    if family == "sd3":
        m = pipe.dit_params  # SD3-medium's blocks are joint blocks only, the last one final
        blocks = len(m["dual_blocks"]) + len(m["mid_blocks"]) + 1
        return {"flash_fwd_bnsd": {"f32/float32/64": blocks * FAM_STEPS}, "flash_fwd_flat": vae}
    blocks = len(pipe.dit_params["blocks"]) + len(pipe.dit_params["single_blocks"])
    return {"flash_fwd_bnsd": {}, "flash_fwd_flat": {"sm90/bfloat16/128": blocks * FAM_STEPS,
                                                     "sm90/bfloat16/512": 1}}


def phase_family_pipeline(family: str, paths: dict, card: str) -> dict:
    """(d) The family's pipeline at 1024x1024, 2 steps, on (b)'s files
    through the port's converters: Kolors through SDXLImagePipeline (the
    256-token prompt, CFG 7.5), SD3ImagePipeline (batched CFG 7.5, T5 on),
    FluxImagePipeline (embedded guidance 3.5, B1). Per-part seconds, peak
    memory, and the attention launches against the models' count. Returns
    the launches per KERNELS entry."""
    from svi_tpu_torch.models import flux, kolors, sd, sd3, sdxl, t5
    from svi_tpu_torch.models.model_io import load_state_dict
    from svi_tpu_torch.pipelines.flux_image import FluxImagePipeline
    from svi_tpu_torch.pipelines.sd3_image import SD3ImagePipeline
    from svi_tpu_torch.pipelines.sdxl_image import SDXLImagePipeline
    from svi_tpu_torch.schedulers import ddim, flow_match

    timer = PhaseTimer()
    t0 = time.perf_counter()
    ld = {k: load_state_dict(p) for k, p in paths.items()}
    if "t5" in ld:
        t5_sd = ld.pop("t5")
        t5m = t5.params_from_torch_state_dict(t5_sd, t5.config_from_state_dict(t5_sd),
                                              device="cuda")
    if family == "kolors":
        pipe = SDXLImagePipeline(
            sdxl.sdxl_unet_params_from_torch(ld["unet"], device="cuda"),
            vae_decoder=sd.sd_vae_decoder_params_from_torch(ld["vae_decoder"], device="cuda"),
            chatglm_params=kolors.chatglm_params_from_torch(ld["chatglm"], device="cuda"))
        sets = [(sdxl, "sdxl_unet_forward", timer.wrap("unet", sdxl.sdxl_unet_forward)),
                (sdxl, "sdxl_vae_decode", timer.wrap("vae_decode", sdxl.sdxl_vae_decode)),
                (kolors, "kolors_encode_prompt",
                 timer.wrap("chatglm", kolors.kolors_encode_prompt))]
        kw = dict(prompt=KOLORS_PROMPT, negative_prompt="模糊，低质量", cfg_scale=KOLORS_CFG)
        step_cls = ddim.EnhancedDDIMScheduler
    elif family == "sd3":
        pipe = SD3ImagePipeline(
            sd3.sd3_dit_params_from_torch(ld["dit"], device="cuda"),
            sd.sd_text_encoder_params_from_torch(ld["te1"], device="cuda"),
            sdxl.sdxl_text_encoder_2_params_from_torch(ld["te2"], device="cuda"), (t5m, t5m.cfg, None),
            vae_decoder_params=sd3.sd3_vae_decoder_params_from_torch(ld["vae_decoder"], device="cuda"))
        sets = [(sd3, "sd3_dit_forward", timer.wrap("mmdit", sd3.sd3_dit_forward)),
                (sd3, "sd3_vae_decode", timer.wrap("vae_decode", sd3.sd3_vae_decode)),
                (SD3ImagePipeline, "encode_prompt",
                 timer.wrap("text_encoders", SD3ImagePipeline.encode_prompt))]
        kw = dict(prompt=SD3_PROMPT, negative_prompt="blurry, low quality", cfg_scale=SD3_CFG)
        step_cls = flow_match.FlowMatchScheduler
    else:
        pipe = FluxImagePipeline(
            flux.flux_dit_params_from_torch(ld["dit"], device="cuda"),
            sd.sd_text_encoder_params_from_torch(ld["te1"], device="cuda"), (t5m, t5m.cfg, None),
            vae_decoder_params=flux.flux_vae_decoder_params_from_torch(ld["vae_decoder"], device="cuda"))
        sets = [(flux, "flux_dit_forward", timer.wrap("dit", flux.flux_dit_forward)),
                (flux, "flux_vae_decode", timer.wrap("vae_decode", flux.flux_vae_decode)),
                (FluxImagePipeline, "encode_prompt",
                 timer.wrap("text_encoders", FluxImagePipeline.encode_prompt))]
        kw = dict(prompt=FLUX_PROMPT, embedded_guidance=FLUX_GUIDANCE)
        step_cls = flow_match.FlowMatchScheduler
    del ld
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    step_marks = []
    step = step_cls.step

    def timed_step(self, *a, **k):
        out = step(self, *a, **k)
        torch.cuda.synchronize()
        step_marks.append(time.perf_counter())
        return out

    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with patched(sets + [(step_cls, "step", timed_step)]):
        image = pipe(height=FAM_H, width=FAM_W, num_inference_steps=FAM_STEPS, seed=0, **kw)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launches = sd_launches()
    peak = torch.cuda.max_memory_allocated() / 2**30
    secs = {k: sum(v) for k, v in timer.seconds.items()}
    calls = {k: len(v) for k, v in timer.seconds.items()}
    log(f"[{family}-pipeline] {FAM_H}x{FAM_W}, {FAM_STEPS} steps: load {load_s:.2f}s, "
        f"{total:.2f}s in all; seconds at the steps' ends "
        f"{[round(x - t0, 3) for x in step_marks]}; seconds (calls): "
        + ", ".join(f"{k} {secs[k]:.3f} ({calls[k]})" for k in secs)
        + f"; peak memory {peak:.2f} GiB; launches {launches}; {card}")
    want = family_expected_launches(family, pipe)
    if launches != want:
        raise RuntimeError(f"the {family} pipeline launched {launches}, expected {want}")
    if image.shape != (FAM_H, FAM_W, 3) or image.dtype != np.uint8 or image.std() == 0:
        raise RuntimeError(f"the {family} image is {image.shape} {image.dtype}, or flat")
    del pipe
    gc.collect()
    torch.cuda.empty_cache()
    if family == "flux":  # a bf16 path: its VAE decode runs the sm90 route at D512
        BF16_PATH_LAUNCHES["flux"] = per_kernel(launches)
    return per_kernel(launches)


def phase_families(card: str) -> dict:
    """Phase 10: (a) the tiny Kolors, SD3 and FLUX pipelines card vs CPU;
    then, one family at a time (its files and weights freed before the
    next), (b) seeded files at the published widths, (c) one forward at a
    cut depth card vs CPU, (d) its pipeline at 1024x1024, 2 steps. Returns
    {family: launches per KERNELS entry}."""
    import shutil
    import tempfile

    t0 = time.perf_counter()
    phase_families_small(card)
    log(f"[time] phase 10a: {time.perf_counter() - t0:.1f}s")
    launches = {}
    for family in ("kolors", "sd3", "flux"):
        t1 = time.perf_counter()
        root = Path(tempfile.mkdtemp(prefix=f"_{family}_ckpt_", dir=REPO))
        try:
            paths = write_family_checkpoints(family, root, card)
            phase_family_forward(family, paths, card)
            launches[family] = phase_family_pipeline(family, paths, card)
        finally:
            gc.collect()
            torch.cuda.empty_cache()
            shutil.rmtree(root, ignore_errors=True)
        log(f"[time] phase 10 {family} (b-d): {time.perf_counter() - t1:.1f}s")
    log(f"[families] phase 10 passed in {time.perf_counter() - t0:.1f}s; {card}")
    return launches


# ---------------------------------------------------------------------------
# phase 11: SVD, Hunyuan-DiT, HunyuanVideo and CogVideoX
# ---------------------------------------------------------------------------

ZOO_FAMILIES = ("svd", "hunyuan_dit", "hunyuan_video", "cog")
STEP_OMNI_FAMILIES = ("stepvideo", "omnigen")  # phase 12's, through the same tables
ZOO_STEPS = 2
# (d)'s sizes: SVD-XT's 25 frames at 576 x 1024, Hunyuan-DiT at 1024 x 1024,
# HunyuanVideo at 544 x 960 x 33 frames (its default is 720 x 1280 x 129:
# phase 3 times one attention at that size), CogVideoX-5B at 480 x 720 x 49
ZOO_SIZES = {"svd": dict(height=576, width=1024, num_frames=25),
             "hunyuan_dit": dict(height=1024, width=1024),
             "hunyuan_video": dict(height=544, width=960, num_frames=33),
             "cog": dict(height=480, width=720, num_frames=49),
             # StepVideo at 544 x 992 x 17 (3 latent frames, 6324 tokens: one
             # 17-frame chunk of its chunked decode, cut from 51 frames and
             # three chunks to make room for phase 8e; its default 204
             # frames: phase 3 times one attention at S75888), OmniGen at
             # 1024 x 1024 with one 512 x 512 reference image
             "stepvideo": dict(height=544, width=992, num_frames=17),
             "omnigen": dict(height=1024, width=1024)}
ZOO_FILES = {
    "svd": {"unet": "svd_xt_unet.safetensors", "vae_decoder": "svd_vae_decoder.safetensors",
            "vae_encoder": "sd_vae_encoder.safetensors",
            "image_encoder": "clip_vit_h_image_encoder.safetensors"},
    "hunyuan_dit": {"dit": "hunyuan_dit.safetensors",
                    "vae_decoder": "sdxl_vae_decoder.safetensors"},
    "hunyuan_video": {"dit": "hunyuan_video_dit.safetensors",
                      "vae_decoder": "hunyuan_video_vae_decoder.safetensors",
                      "clip": "clip_l.safetensors"},
    "cog": {"dit": "cogvideox_5b_dit.safetensors",
            "vae_decoder": "cogvideox_vae_decoder.safetensors",
            "t5": "t5xxl_2_layers.safetensors"},
    "stepvideo": {"dit": "stepvideo_t2v_dit.safetensors", "vae": "stepvideo_vae.safetensors"},
    "omnigen": {"transformer": "omnigen_v1.safetensors",
                "vae_encoder": "sdxl_vae_encoder.safetensors",
                "vae_decoder": "sdxl_vae_decoder.safetensors"},
}
ZOO_DTYPE = {"svd": torch.float32, "hunyuan_dit": torch.float32,
             "hunyuan_video": torch.bfloat16, "cog": torch.bfloat16,
             "stepvideo": torch.bfloat16, "omnigen": torch.float32}
ZOO_PROMPT = "a red fox running through fresh snow in a birch forest at sunrise, cinematic"
ZOO_PROMPT_ZH = "一只红狐狸在日出时的白桦林雪地里奔跑，电影感，细节丰富"
# Card against CPU (written before the first card run): the tiny f32
# pipelines at 1e-4 of the decoded video's scale and frames within one level
# (as phase 10a); the full-width forwards at a cut depth in f32 at 1e-3 of
# the output's scale (as phase 10c); HunyuanVideo's and CogVideoX's in bf16
# on the card against the CPU's f32 at 5e-2 (bf16 weights and activations,
# 2^-8 a rounding, over two blocks' sums, as FLUX's in phase 10c). Phase 12
# (written before its first card run) holds StepVideo and OmniGen to the
# same bounds: its tiny pipelines at ZOO_SMALL_REL and ZOO_LEVELS, the
# forwards at a cut depth at ZOO_FULL_REL in f32 and StepVideo's and Step1's
# bf16 at ZOO_BF16_REL.
ZOO_SMALL_REL, ZOO_FULL_REL, ZOO_BF16_REL, ZOO_LEVELS = 1e-4, 1e-3, 5e-2, 1
ZOO_CUT = {"svd": "the UNet whole", "hunyuan_dit": "3 of 21 down blocks and the last of 19 up",
           "hunyuan_video": "1 of 20 double and 1 of 40 single blocks",
           "cog": "2 of 42 blocks", "stepvideo": "2 of 48 blocks, Step1 at 2 of 48 layers",
           "omnigen": "the first and last of 32 layers"}  # (c)'s depths
# (d)'s depths: the files' (WRITTEN_DEPTH: HunyuanVideo 2 + 2 of 20 + 40
# blocks, CogVideoX 2 of 42), but StepVideo's DiT runs all 48 blocks, seeded
# on the card (STEP_DEPTH); OmniGen runs its file whole
STEP_DEPTH = 48
STEP_PROMPT_NEG = "blurry, low quality, distorted"
OMNIGEN_PROMPT = ("a fox made of origami paper beside <img><|image_1|></img> in a snowy "
                  "birch forest at sunrise")
OMNIGEN_REFS = 1  # reference images in (d): each is VAE-encoded in the cond and img_cond branches
OMNIGEN_REF_HW = 512  # their size: 1024 of the sequence's tokens each


def _video_fixtures():
    """tests/torch_video_fixtures.py (narrow configurations; no JAX)."""
    _sd_fixtures()
    import torch_video_fixtures

    return torch_video_fixtures


class TableEncoder:
    """A seeded embedding table standing in for a text encoder the
    repository does not hold (Hunyuan-DiT's BERT and mT5, HunyuanVideo's
    LLM): ids -> states, zero where the mask is 0, on the table's device."""

    def __init__(self, vocab, dim, seed, device="cpu", dtype=torch.float32):
        g = torch.Generator(device=device).manual_seed(seed)
        self.table = torch.randn((vocab, dim), generator=g, device=device).to(dtype) * 0.3

    def __call__(self, ids, mask, clip_skip=1, pixel_values=None):
        ids = torch.as_tensor(np.asarray(ids)).to(self.table.device).long()
        mask = torch.as_tensor(np.asarray(mask)).to(self.table.device)
        return self.table[ids % self.table.shape[0]] * mask[..., None].to(self.table.dtype)


def utf8_ids(text) -> list:
    """A stand-in tokenizer (the repository holds neither Step1's
    sentencepiece model nor Phi-3's tokenizer): the text's UTF-8 bytes."""
    return list(text.encode("utf-8"))


def byte_tokenizer(text) -> list:
    """Phi-3's framing around `utf8_ids`: BOS 1 first."""
    return [1] + utf8_ids(text)


def step_text_encoder(device, dtype=torch.bfloat16, clip_dim=1024, llm_dim=6144,
                      llm_vocab=65536):
    """StepVideo's two caption branches on seeded tables (the repository
    holds neither the CLIP-BERT's nor Step1's weights): the vendored BERT
    WordPiece ids (77) into a CLIP table, `step1_tokenize`'s framing of
    `utf8_ids` (320) into an LLM table. Returns prompt -> (clip, llm, mask),
    the prompter's output, the mask left-padded with ones over the CLIP
    tokens."""
    from svi_tpu_torch.models.stepvideo import step1_tokenize
    from svi_tpu_torch.prompters.sp_tokenizer import default_bert_tokenizer

    bert = default_bert_tokenizer()
    clip_t = TableEncoder(47020, clip_dim, 14, device=device, dtype=dtype)
    llm_t = TableEncoder(llm_vocab, llm_dim, 15, device=device, dtype=dtype)

    def encode(prompt):
        ti = bert(prompt, padding="max_length", max_length=77, truncation=True,
                  return_tensors="pt")
        ids, mask = step1_tokenize([prompt], utf8_ids)
        return (clip_t(ti.input_ids, ti.attention_mask), llm_t(ids, mask),
                np.concatenate([np.ones((1, 77), mask.dtype), mask], axis=1))
    return encode


def _hyv_text_encoder(prompter):
    """The pipeline's callable: prompt -> (prompt_emb, text_mask, pooled)."""
    def encode(prompt):
        emb, pooled, mask = prompter.encode_prompt(prompt)
        return emb, mask, pooled
    return encode


def zoo_small_pipelines(device, vfx, fx):
    """The four tiny pipelines on `device`, f32, each with its decoded
    output captured: {family: (pipeline, kwargs, captured list)}."""
    from svi_tpu_torch.models import cog, hunyuan_dit, hunyuan_video, ipadapter, sd, svd, t5
    from svi_tpu_torch.pipelines import cog_video, hunyuan_image, svd_video
    from svi_tpu_torch.pipelines import hunyuan_video as hyv_pipe
    from svi_tpu_torch.prompters.hunyuan_dit_prompter import HunyuanDiTPrompter
    from svi_tpu_torch.prompters.hunyuan_video_prompter import HunyuanVideoPrompter
    from svi_tpu_torch.prompters.sp_tokenizer import default_t5_tokenizer

    out, kw = {}, dict(device=device)
    s = vfx.svd_state_dicts(81)
    pipe = svd_video.SVDVideoPipeline(
        svd.svd_unet_params_from_torch(s["unet"], **kw),
        ipadapter.clip_image_encoder_params_from_torch(s["image_encoder"], **kw),
        sd.sd_vae_encoder_params_from_torch(s["vae_encoder"], **kw),
        svd.svd_vae_decoder_params_from_torch(s["vae_decoder"], **kw))
    image = vfx.frames(2, 64, 64, seed=82)
    out["svd"] = (pipe, dict(input_image=image[0], mask_frames=[image[1]], mask_frame_ids=[2],
                             num_frames=3, height=64, width=64, num_inference_steps=2, seed=3),
                  "svd_vae_decode", svd)
    s = vfx.hunyuan_dit_state_dicts(83) | {"dit": hunyuan_dit.hunyuan_dit_state_dict(
        84, **(vfx.HY_DIT | dict(dim=2 * 88)))}
    d = vfx.HY_DIT
    prompter = HunyuanDiTPrompter(TableEncoder(50000, d["text_dim"], 1), None,
                                  TableEncoder(32128, d["t5_dim"], 2), default_t5_tokenizer())
    pipe = hunyuan_image.HunyuanDiTImagePipeline(
        hunyuan_dit.hunyuan_dit_params_from_torch(s["dit"], **kw), prompter,
        vae_decoder_params=sd.sd_vae_decoder_params_from_torch(s["vae_decoder"], **kw),
        num_layers_down=vfx.HY_DOWN)
    out["hunyuan_dit"] = (pipe, dict(prompt=ZOO_PROMPT_ZH, negative_prompt="模糊", cfg_scale=5.0,
                                     height=64, width=64, num_inference_steps=2, seed=5),
                          "sdxl_vae_decode", hunyuan_image.sdxl)
    s = vfx.hunyuan_video_state_dicts(85)
    s["dit"] = hunyuan_video.hunyuan_video_dit_state_dict(
        86, dtype=torch.float32, **(vfx.HYV_DIT | dict(dim=128)))
    prompter = HunyuanVideoPrompter(None, default_t5_tokenizer(),
                                    sd.sd_text_encoder_params_from_torch(s["clip"], **kw),
                                    TableEncoder(32128, vfx.HYV_DIT["text_dim"], 3))
    pipe = hyv_pipe.HunyuanVideoPipeline(
        hunyuan_video.hunyuan_video_dit_params_from_torch(s["dit"], dtype=torch.float32, **kw),
        _hyv_text_encoder(prompter), vae_decoder_params=hunyuan_video.
        hunyuan_video_vae_decoder_params_from_torch(s["vae_decoder"], **kw), dtype=torch.float32)
    out["hunyuan_video"] = (pipe, dict(prompt=ZOO_PROMPT, negative_prompt="blurry", cfg_scale=2.0,
                                       height=64, width=96, num_frames=9, num_inference_steps=2,
                                       seed=7), "hunyuan_video_vae_decode", hunyuan_video)
    s = vfx.cog_state_dicts(87)
    cfg = fx.tiny_t5_config(vfx.COG_DIT["text_dim"])
    t5m = t5.params_from_torch_state_dict(
        t5.torch_state_dict_from_params(t5.init_params(cfg, 88, device="cpu")), cfg, **kw)
    pipe = cog_video.CogVideoPipeline(
        cog.cog_dit_params_from_torch(s["dit"], dtype=torch.float32, **kw), (t5m, cfg, None),
        cog.cog_vae_encoder_params_from_torch(s["vae_encoder"], **kw),
        cog.cog_vae_decoder_params_from_torch(s["vae_decoder"], **kw), dtype=torch.float32)
    out["cog"] = (pipe, dict(prompt=ZOO_PROMPT, negative_prompt="blurry", cfg_scale=6.0,
                             num_frames=9, height=64, width=96, num_inference_steps=2, seed=9,
                             input_video=list(vfx.frames(9, 64, 96, seed=89)),
                             denoising_strength=0.8), "cog_vae_decode_video", cog)
    return out


def small_card_vs_cpu(make, sets, tag: str, card: str) -> dict:
    """Each tiny pipeline of make(device, vfx, fx) ({name: (pipeline, kwargs,
    the decode function's name, its module)}) on the card and on the CPU
    under the patches `sets`, its decoded output captured: fails unless every
    decoded output agrees within ZOO_SMALL_REL of its scale, the frames within
    ZOO_LEVELS, and every card launch took the f32 route. Returns the card's
    launches per pipeline."""
    vfx, fx = _video_fixtures(), _sd_fixtures()
    res = {}
    with patched(sets):
        for device in ("cuda", "cpu"):
            got, frames, secs, launches = {}, {}, {}, {}
            for fam, (pipe, kw, attr, mod) in make(device, vfx, fx).items():
                store = got.setdefault(fam, [])
                fn = getattr(mod, attr)
                zero_counts()
                t0 = time.perf_counter()
                with patched([(mod, attr, lambda *a, _fn=fn, _s=store, **k: (
                        lambda y: (_s.append(y.float().cpu()), y)[1])(_fn(*a, **k)))]):
                    res_frames = pipe(**kw)
                frames[fam] = res_frames if isinstance(res_frames, list) else [res_frames]
                if device == "cuda":
                    torch.cuda.synchronize()
                    launches[fam] = sd_launches()
                secs[fam] = time.perf_counter() - t0
            res[device] = (got, frames, secs, launches)
    (gc_, fc, sc, lc), (gh, fh, sh, _) = res["cuda"], res["cpu"]
    rels = {k: max(_rel(a, b) for a, b in zip(gc_[k], gh[k])) for k in gc_}
    levels = {k: _levels(fc[k], fh[k]) for k in fc}
    log(f"[{tag}] card vs CPU, decoded outputs { {k: f'{v:.3e}' for k, v in rels.items()} } "
        f"(bound {ZOO_SMALL_REL}); frames {levels} levels (bound {ZOO_LEVELS}); seconds card "
        f"{ {k: round(v, 2) for k, v in sc.items()} }, CPU "
        f"{ {k: round(v, 2) for k, v in sh.items()} }; "
        f"launches {lc}; {card}")
    if max(rels.values()) > ZOO_SMALL_REL or max(levels.values()) > ZOO_LEVELS:
        raise RuntimeError(f"the small {', '.join(rels)} pipelines on the card disagree with "
                           f"the CPU")
    for fam, launch in lc.items():
        routes = {k for entry in launch.values() for k in entry}
        if not routes or any(not k.startswith("f32/") for k in routes):
            raise RuntimeError(f"the small {fam} pipeline launched {launch}")
    return lc


def phase_zoo_small(card: str) -> None:
    """(a) The tiny pipelines (tests/torch_video_fixtures.py's narrow
    configurations, f32) card against CPU: SVD (3 frames at 64 x 64, a mask
    frame), Hunyuan-DiT (2 heads of 88, so the card runs its D = 88 route;
    CFG 5 over the vendored BERT and T5 tokenizers with seeded encoder
    tables), HunyuanVideo (one head of 128; true CFG 2, 9 frames at 64 x 96,
    the prompter with a seeded LLM table), CogVideoX (2 heads of 64;
    video-to-video at strength 0.8, batched CFG 6, 9 frames at 64 x 96)."""
    from svi_tpu_torch.models import cog, hunyuan_dit, hunyuan_video, sd, svd

    vfx, fx = _video_fixtures(), _sd_fixtures()
    sets = [(sd, "SD_VAE_ENCODER_PLAN", fx.VAE_ENCODER_PLAN),
            (sd, "SD_VAE_DECODER_PLAN", fx.VAE_DECODER_PLAN),
            (hunyuan_dit, "NUM_HEADS", 2), (hunyuan_video, "NUM_HEADS", 1),
            (cog, "_cog_block", functools.partial(cog._cog_block, num_heads=vfx.COG_HEADS)),
            (cog, "COG_VAE_ENCODER_PLAN", vfx.COG_VAE_ENCODER_PLAN),
            (cog, "COG_VAE_DECODER_PLAN", vfx.COG_VAE_DECODER_PLAN),
            (svd, "SVD_UNET_PLAN", vfx.SVD_UNET_PLAN),
            (svd, "SVD_VAE_DECODER_PLAN", vfx.SVD_VAE_DECODER_PLAN)]
    lc = small_card_vs_cpu(zoo_small_pipelines, sets, "zoo-small", card)
    if "f32/float32/88" not in lc["hunyuan_dit"]["flash_fwd_bnsd"]:
        raise RuntimeError(f"the small Hunyuan-DiT pipeline did not run the D88 route: {lc}")


def step_omni_small_pipelines(device, vfx, fx):
    """Phase 12a's tiny pipelines on `device`, f32: StepVideo (2 heads of
    128, 2 blocks; 17 frames at 64 x 96, three latent frames through the
    chunked decode, CFG 9, 2 steps; the prompter with a seeded CLIP table, the
    tiny Step1 and `utf8_ids`), OmniGen text only (2 branches) and with one
    32 x 48 reference image (3 branches, image_cfg_scale), both with the KV
    cache, 2 steps at 64 x 64."""
    from svi_tpu_torch.models import omnigen, sd, stepvideo, stepvideo_vae
    from svi_tpu_torch.pipelines import omnigen_image, step_video
    from svi_tpu_torch.prompters.omnigen_prompter import OmniGenPrompter
    from svi_tpu_torch.prompters.stepvideo_prompter import StepVideoPrompter

    kw, f32 = dict(device=device), torch.float32
    s = vfx.stepvideo_state_dicts(101)
    table = TableEncoder(256, vfx.STEP_DIT["clip_channels"], 16)  # on the CPU: the same draws
    prompter = StepVideoPrompter(
        lambda prompts: table(np.asarray([(utf8_ids(p) + [32] * 4)[:4] for p in prompts]),
                              np.ones((len(prompts), 4))),
        stepvideo.step1_params_from_torch(s["step1"], dtype=f32, **kw), lambda t: [
            i % vfx.STEP1["vocab"] for i in utf8_ids(t)],
        num_heads=vfx.STEP1["num_heads"], num_groups=vfx.STEP1["num_groups"], dtype=f32)
    out = {"stepvideo": (step_video.StepVideoPipeline(
        stepvideo.stepvideo_dit_params_from_torch(s["dit"], dtype=f32, **kw),
        vae_params=stepvideo_vae.stepvideo_vae_params_from_torch(s["vae"], **kw),
        prompter=prompter, dtype=f32), dict(
            prompt=ZOO_PROMPT, negative_prompt=STEP_PROMPT_NEG, height=64, width=96,
            num_frames=17, num_inference_steps=2, seed=13, tiled=False),
        "stepvideo_vae_decode", stepvideo_vae)}
    s = vfx.omnigen_state_dicts(103)
    ref = vfx.frames(1, 32, 48, seed=104)[0]
    for name, refs, prompt in (("omnigen", [], "a red fox in the snow"),
                               ("omnigen_ref", [ref], "a fox beside <img><|image_1|></img>")):
        pipe = omnigen_image.OmnigenImagePipeline(
            omnigen.omnigen_params_from_torch(s["transformer"], **kw),
            sd.sd_vae_encoder_params_from_torch(s["vae_encoder"], **kw),
            sd.sd_vae_decoder_params_from_torch(s["vae_decoder"], **kw),
            prompter=OmniGenPrompter(lambda t: [i % vfx.OMNIGEN["vocab"]
                                                for i in byte_tokenizer(t)]),
            rope_cfg=vfx.OMNIGEN_ROPE, num_heads=vfx.OMNIGEN["num_heads"],
            num_kv_heads=vfx.OMNIGEN["num_kv_heads"])
        out[name] = (pipe, dict(prompt=prompt, reference_images=refs, height=64, width=64,
                                num_inference_steps=2, seed=15, cfg_scale=2.5,
                                image_cfg_scale=1.6), "sdxl_vae_decode", omnigen_image.sdxl)
    return out


def write_zoo_checkpoints(family: str, root: Path, card: str) -> dict:
    """(b) One family's seeded files at the published widths in the
    reference's names: SVD-XT's UNet, its temporal VAE decoder, SD's VAE
    encoder and CLIP ViT-H's image tower (f16); Hunyuan-DiT's DiT and the
    SDXL VAE decoder (f16); HunyuanVideo's 13B DiT at 2 + 2 of 20 + 40 blocks
    (bf16), its causal VAE decoder and CLIP-L (f16); CogVideoX-5B's DiT at 2
    of 42 blocks and VAE decoder (bf16) with T5-XXL at 2 of its 24 layers
    (bf16); StepVideo's DiT at 2 of 48 blocks (bf16) and its whole VAE (f32);
    OmniGen's Phi-3 transformer (bf16, loaded as f32) and the SDXL VAE's
    halves (f16)."""
    from svi_tpu_torch.models import (cog, hunyuan_dit, hunyuan_video, ipadapter, omnigen, sd,
                                      stepvideo, stepvideo_vae, svd, t5)

    f16, bf16 = torch.float16, torch.bfloat16

    def t5_xxl(seed, device, dtype):
        cfg = t5.T5Config(vocab=32128, num_layers=2, dtype=dtype)
        return t5.torch_state_dict_from_params(t5.init_params(cfg, seed, device=device))

    makers = {
        "svd": {"unet": (svd.svd_unet_state_dict, f16),
                "vae_decoder": (svd.svd_vae_decoder_state_dict, f16),
                "vae_encoder": (sd.sd_vae_encoder_state_dict, f16),
                "image_encoder": (ipadapter.clip_image_encoder_state_dict, f16)},
        "hunyuan_dit": {"dit": (hunyuan_dit.hunyuan_dit_state_dict, f16),
                        "vae_decoder": (sd.sd_vae_decoder_state_dict, f16)},
        "hunyuan_video": {"dit": (hunyuan_video.hunyuan_video_dit_state_dict, bf16),
                          "vae_decoder": (hunyuan_video.hunyuan_video_vae_decoder_state_dict, f16),
                          "clip": (sd.sd_text_encoder_state_dict, f16)},
        "cog": {"dit": (cog.cog_dit_state_dict, bf16),
                "vae_decoder": (cog.cog_vae_decoder_state_dict, bf16), "t5": (t5_xxl, bf16)},
        "stepvideo": {"dit": (stepvideo.stepvideo_dit_state_dict, bf16),
                      "vae": (stepvideo_vae.stepvideo_vae_state_dict, torch.float32)},
        "omnigen": {"transformer": (omnigen.omnigen_state_dict, bf16),
                    "vae_encoder": (sd.sd_vae_encoder_state_dict, f16),
                    "vae_decoder": (sd.sd_vae_decoder_state_dict, f16)},
    }[family]
    return write_checkpoints(family, makers, ZOO_FILES[family], root, 201, card)


def phase_zoo_forward(family: str, ld: dict, card: str) -> None:
    """(c) One forward of the family's full-width model at a cut depth, card
    against CPU (f32), and for the bf16 families and Hunyuan-DiT (a bf16 path
    on the sm90 route at D88) also in bf16 on the card:
    the SVD UNet whole on 2 frames of 8 x 8 latents; Hunyuan-DiT's first 3
    down blocks and last up block on 2 x 32 x 32 latents; HunyuanVideo's
    first double and single block on 2 x 8 x 8 latents; CogVideoX's file's 2
    blocks on B2 x 2 x 8 x 8 latents over 226 tokens; Step1 at 2 layers and
    StepVideo's file's 2 blocks on 1 x 2 x 4 x 4 latents; OmniGen's first and
    last layer on 16 x 16 latents with a reference image. The timesteps and
    the guidance (x 1000, scaled in its dtype as svi_tpu does) are exact in
    bf16, so that bf16 and f32 embed the same values."""
    from svi_tpu_torch.models import cog, hunyuan_dit, hunyuan_video, omnigen, stepvideo, svd

    g = torch.Generator().manual_seed(17)
    if family == "svd":
        sd_ = ld["unet"]
        args = (torch.randn((2, 8, 8, 8), generator=g) * 0.5, torch.tensor([0.6]),
                torch.randn((1, 1, 1024), generator=g) * 0.3, torch.tensor([6.0, 127.0, 0.02]))

        def run(device, dtype):
            m = svd.svd_unet_params_from_torch(sd_, device=device, dtype=dtype)
            return {"unet": svd.svd_unet_forward(m, *(a.to(device, dtype) for a in args))}
    elif family == "hunyuan_dit":
        sd_ = _cut(ld["dit"], {"blocks.": [0, 1, 2, 39]})
        mask = torch.ones((2, 77), dtype=torch.long)
        mask[:, 30:] = 0
        mask_t5 = torch.ones((2, 256), dtype=torch.long)
        mask_t5[:, 90:] = 0
        args = (torch.randn((2, 4, 32, 32), generator=g), torch.randn((2, 77, 1024), generator=g)
                * 0.3, torch.randn((2, 256, 2048), generator=g) * 0.3)
        freqs = hunyuan_dit.calc_rope(256, 256)

        def run(device, dtype):
            m = hunyuan_dit.hunyuan_dit_params_from_torch(sd_, device=device, dtype=dtype)
            return {"dit": hunyuan_dit.hunyuan_dit_forward(
                m, *(a.to(device, dtype) for a in args), mask.to(device), mask_t5.to(device),
                torch.tensor([391.0], device=device), torch.tensor(
                    [[256.0, 256, 256, 256, 0, 0]] * 2, device=device), freqs,
                num_layers_down=3)}
    elif family == "hunyuan_video":
        sd_ = _cut(ld["dit"], {"double_blocks.": [0], "single_blocks.": [0]})
        mask = torch.ones((1, 256), dtype=torch.long)
        mask[:, 60:] = 0
        args = (torch.randn((1, 16, 2, 8, 8), generator=g) * 0.5,
                torch.randn((1, 256, 4096), generator=g) * 0.1,
                torch.randn((1, 768), generator=g) * 0.1)

        def run(device, dtype):
            m = hunyuan_video.hunyuan_video_dit_params_from_torch(sd_, device=device, dtype=dtype)
            x, emb, pooled = (a.to(device, dtype) for a in args)
            return {"dit": hunyuan_video.hunyuan_video_dit_forward(
                m, x, torch.tensor([896.0], device=device, dtype=dtype), emb, mask.to(device),
                pooled, guidance=torch.tensor([4.0], device=device, dtype=dtype))}
    elif family == "cog":
        sd_ = ld["dit"]  # the file's 2 blocks
        args = (torch.randn((2, 16, 2, 8, 8), generator=g) * 0.5,
                torch.randn((2, 226, 4096), generator=g) * 0.1)

        def run(device, dtype):
            m = cog.cog_dit_params_from_torch(sd_, device=device, dtype=dtype)
            x, emb = (a.to(device, dtype) for a in args)
            return {"dit": cog.cog_dit_forward(m, x, torch.tensor([496.0, 496.0], device=device,
                                                                  dtype=dtype), emb)}
    elif family == "stepvideo":
        # Step1 at 2 of its 48 layers (6144 wide, 64 heads in 8 groups) on 24
        # ids, its states as the DiT's captions beside 77 CLIP states, into
        # the file's 2 blocks on 2 x 4 x 4 latents; the timestep is f32 in
        # both dtypes, as the pipeline passes it
        sd_ = ld["dit"]
        s1 = stepvideo.step1_state_dict(seed=221, dtype=torch.bfloat16, num_layers=2)
        ids = torch.randint(3, 65536, (1, 24), generator=g)
        args = (torch.randn((1, 2, 64, 4, 4), generator=g) * 0.5,
                torch.randn((1, 77, 1024), generator=g) * 0.3)
        mask = torch.ones((1, 77 + 24), dtype=torch.long)
        mask[:, 77 + 20:] = 0

        def run(device, dtype):
            p1 = stepvideo.step1_params_from_torch(s1, device=device, dtype=dtype)
            llm = stepvideo.step1_encode(p1, ids, 64, 8, dtype=dtype)
            m = stepvideo.stepvideo_dit_params_from_torch(sd_, device=device, dtype=dtype)
            x, clip = (a.to(device, dtype) for a in args)
            return {"step1": llm, "dit": stepvideo.stepvideo_dit_forward(
                m, x, llm, mask.to(device), torch.tensor([0.875], device=device),
                encoder_hidden_states_2=clip)}
    else:
        # the first and last of Phi-3's 32 layers on a collated prompt with a
        # 64 x 64 reference image's latent spliced in and 128 x 128 noise
        # latents (f32, OmniGen's default)
        from svi_tpu_torch.prompters import omnigen_prompter

        sd_ = _cut(ld["transformer"], {"llm.layers.": [0, 31]})
        ids = list(range(1, 9)) + [0] * 16 + list(range(40, 48))
        padded, pos, amask, _, _, sizes = omnigen_prompter.process_mllm_input(
            [{"input_ids": ids, "pixel_values": [0], "image_sizes": [[8, 24]]}], [[128, 128]])
        args = (torch.randn((1, 4, 16, 16), generator=g), torch.randn((1, 4, 8, 8), generator=g))

        def run(device, dtype):
            m = omnigen.omnigen_params_from_torch(sd_, device=device, dtype=dtype)
            x, lat = (a.to(device, dtype) for a in args)
            out, _ = omnigen.omnigen_forward(
                m, x, torch.tensor([0.625], device=device, dtype=dtype), torch.from_numpy(padded),
                [lat], sizes, torch.from_numpy(amask).float().to(device),
                torch.from_numpy(pos).to(device))
            return {"transformer": out}
    outs, secs = {}, {}
    runs = [("cuda", torch.float32), ("cpu", torch.float32)]
    if ZOO_DTYPE[family] == torch.bfloat16 or family == "hunyuan_dit":
        runs.insert(1, ("cuda", torch.bfloat16))
    for device, dtype in runs:
        with torch.inference_mode():
            if device == "cuda":
                zero_counts()
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs[(device, dtype)] = {k: v.float().cpu() for k, v in run(device, dtype).items()}
            secs[(device, str(dtype)[6:])] = time.perf_counter() - t0
            if device == "cuda":
                launches = sd_launches()
        gc.collect()
        torch.cuda.empty_cache()
    ref = outs[("cpu", torch.float32)]
    rel = {k: _rel(outs[("cuda", torch.float32)][k], ref[k]) for k in ref}
    bf16 = ({k: _rel(outs[("cuda", torch.bfloat16)][k], ref[k]) for k in ref}
            if ("cuda", torch.bfloat16) in outs else {})
    log(f"[{family}-forward] full width, {ZOO_CUT[family]}: card f32 vs CPU f32 "
        f"{ {k: f'{v:.3e}' for k, v in rel.items()} } (bound {ZOO_FULL_REL})"
        + (f", card bf16 vs CPU f32 { {k: f'{v:.3e}' for k, v in bf16.items()} } (bound "
           f"{ZOO_BF16_REL})" if bf16 else "")
        + f"; seconds (loads included) {secs}; launches of the last card run {launches}; {card}")
    if max(rel.values()) > ZOO_FULL_REL or (bf16 and max(bf16.values()) > ZOO_BF16_REL):
        raise RuntimeError(f"the full-width {family} forward on the card disagrees with the CPU")
    if family == "hunyuan_dit":
        # a bf16 path: the bf16 run (the last card run) on the sm90 route at
        # D88, self- and cross-attention in each of the 4 blocks, B2 in one call
        want = {"flash_fwd_bnsd": {"sm90/bfloat16/88": 2 * 4}, "flash_fwd_flat": {}}
        if launches != want:
            raise RuntimeError(f"the bf16 Hunyuan-DiT forward launched {launches}, expected "
                               f"{want}")
        BF16_PATH_LAUNCHES["hunyuan_dit_forward"] = per_kernel(launches)


def zoo_expected_launches(family: str, pipe) -> dict:
    """Phase 11d's and 12d's attention launches per (route, dtype, head dim),
    from the pipeline's models: the SVD UNet's spatial transformers (self and image
    cross-attention, 5 / 10 / 20 heads of 64: K2 f32) on each of the two CFG
    passes a step, the SD VAE encoder's and the temporal decoder's
    mid-blocks once (K1 f32 D512; the temporal attention and CLIP's are
    plain); Hunyuan-DiT's 40 blocks x 2 attentions on each of the two CFG
    passes (K2 f32 D88), the SDXL VAE's mid-block (K1 f32 D512);
    HunyuanVideo's double and single blocks x 2 groups a step (K1 sm90; the VAE's
    frame-causal attention and the token refiner are plain); CogVideoX's
    blocks a step (batched CFG, K2 sm90 at D = 64); StepVideo's blocks twice a
    step (CFG as two B=1 calls; K1 sm90; the cross-attention and the VAE's
    causal attention are plain); OmniGen's SDXL VAE mid-block once for the
    decode and once for each reference image in the cond and img_cond
    branches (K1 f32 D512; Phi-3's attention is plain). Keys as
    `flash_attention` routes them: the flat entry for one head or D % 128 ==
    0, else (B, N, S, D)."""
    from svi_tpu_torch.models import cog, hunyuan_dit, hunyuan_video, sd, svd
    from svi_tpu_torch.ops import attention as A

    want = {"flash_fwd_bnsd": {}, "flash_fwd_flat": {}}

    def add(n, d, dtype, count):
        entry = "flash_fwd_flat" if A._flat_ok(n, d) else "flash_fwd_bnsd"
        key = f"{A._fwd_route(dtype, d)}/{str(dtype).removeprefix('torch.')}/{d}"
        want[entry][key] = want[entry].get(key, 0) + count

    f32, bf16 = torch.float32, torch.bfloat16
    if family == "svd":
        for desc in svd.SVD_UNET_PLAN:
            if desc[0] == "attn":
                add(desc[1], desc[2], f32, 2 * 2 * ZOO_STEPS)
        for plan in (sd.SD_VAE_ENCODER_PLAN, svd.SVD_VAE_DECODER_PLAN):
            for desc in plan:
                if desc[0] == "vae_attn":
                    add(1, desc[1], f32, 1)
    elif family == "hunyuan_dit":
        blocks = pipe.dit_params["blocks"]
        n = hunyuan_dit.NUM_HEADS
        add(n, blocks[0]["attn1"]["to_q"]["w"].shape[0] // n, f32, len(blocks) * 2 * 2 * ZOO_STEPS)
        add(1, next(d[1] for d in sd.SD_VAE_DECODER_PLAN if d[0] == "vae_attn"), f32, 1)
    elif family == "hunyuan_video":
        m = pipe.dit_params
        n = hunyuan_video.NUM_HEADS
        add(n, m["final_layer"]["linear"]["w"].shape[1] // n, bf16,
            (len(m["double_blocks"]) + len(m["single_blocks"])) * 2 * ZOO_STEPS)
    elif family == "cog":
        m = pipe.dit_params
        dim = m["blocks"][0]["attn1"]["to_q"]["w"].shape[0]
        add(dim // cog.HEAD_DIM, cog.HEAD_DIM, bf16, len(m["blocks"]) * ZOO_STEPS)
    elif family == "stepvideo":
        add(pipe.num_heads, pipe.head_dim, bf16, len(pipe.dit_params["blocks"]) * 2 * ZOO_STEPS)
    else:
        vae_d = next(d[1] for d in sd.SD_VAE_DECODER_PLAN if d[0] == "vae_attn")
        add(1, vae_d, f32, 1 + 2 * OMNIGEN_REFS)
    return want


def phase_zoo_pipeline(family: str, ld: dict, card: str) -> dict:
    """(d) The family's pipeline at full width, ZOO_SIZES, 2 steps, on (b)'s
    files through the port's converters: SVDVideoPipeline (CFG 1 -> 3 per
    frame), HunyuanDiTImagePipeline (CFG 6, seeded BERT / mT5 tables over the
    vendored tokenizers), HunyuanVideoPipeline (embedded guidance 6, the
    prompter with CLIP-L and a seeded LLM table), CogVideoPipeline (batched
    CFG 6, T5-XXL at 2 layers), StepVideoPipeline (bf16, all 48 blocks seeded
    on the card, CFG 9 as two calls a step, seeded CLIP / Step1 tables, the
    tiled f32 decode), OmnigenImagePipeline (f32, one reference image: three
    branches and the condition KV cache, a byte-level stand-in tokenizer).
    Seconds per step, peak memory, and the attention launches against the
    models' count. Returns the launches per KERNELS entry."""
    from svi_tpu_torch.models import (cog, hunyuan_dit, hunyuan_video, ipadapter, omnigen, sd,
                                      stepvideo, stepvideo_vae, svd, t5)
    from svi_tpu_torch.pipelines import cog_video, hunyuan_image, omnigen_image, step_video
    from svi_tpu_torch.pipelines import svd_video
    from svi_tpu_torch.pipelines import hunyuan_video as hyv_pipe
    from svi_tpu_torch.prompters.hunyuan_dit_prompter import HunyuanDiTPrompter
    from svi_tpu_torch.prompters.hunyuan_video_prompter import HunyuanVideoPrompter
    from svi_tpu_torch.prompters.omnigen_prompter import OmniGenPrompter
    from svi_tpu_torch.prompters.sp_tokenizer import default_t5_tokenizer
    from svi_tpu_torch.schedulers import continuous_ode, ddim, flow_match

    timer = PhaseTimer()
    dev, dt = "cuda", ZOO_DTYPE[family]
    t0 = time.perf_counter()
    if family == "svd":
        pipe = svd_video.SVDVideoPipeline(
            svd.svd_unet_params_from_torch(ld["unet"], device=dev),
            ipadapter.clip_image_encoder_params_from_torch(ld["image_encoder"], device=dev),
            sd.sd_vae_encoder_params_from_torch(ld["vae_encoder"], device=dev),
            svd.svd_vae_decoder_params_from_torch(ld["vae_decoder"], device=dev))
        sets = [(svd, "svd_unet_forward", timer.wrap("unet", svd.svd_unet_forward)),
                (svd, "svd_vae_decode", timer.wrap("vae_decode", svd.svd_vae_decode))]
        image = sd_frames(1, ZOO_SIZES["svd"]["height"], ZOO_SIZES["svd"]["width"], seed=91)[0]
        kw = dict(input_image=image, max_cfg_scale=3.0)
        step_cls = continuous_ode.ContinuousODEScheduler
    elif family == "hunyuan_dit":
        prompter = HunyuanDiTPrompter(TableEncoder(47020, 1024, 11), None,
                                      TableEncoder(32128, 2048, 12), default_t5_tokenizer())
        pipe = hunyuan_image.HunyuanDiTImagePipeline(
            hunyuan_dit.hunyuan_dit_params_from_torch(ld["dit"], device=dev), prompter,
            vae_decoder_params=sd.sd_vae_decoder_params_from_torch(ld["vae_decoder"], device=dev))
        sets = [(hunyuan_dit, "hunyuan_dit_forward",
                 timer.wrap("dit", hunyuan_dit.hunyuan_dit_forward)),
                (hunyuan_image.sdxl, "sdxl_vae_decode",
                 timer.wrap("vae_decode", hunyuan_image.sdxl.sdxl_vae_decode))]
        kw = dict(prompt=ZOO_PROMPT_ZH, negative_prompt="模糊，低质量", cfg_scale=6.0)
        step_cls = ddim.EnhancedDDIMScheduler
    elif family == "hunyuan_video":
        prompter = HunyuanVideoPrompter(
            None, default_t5_tokenizer(), sd.sd_text_encoder_params_from_torch(ld["clip"],
                                                                              device=dev),
            TableEncoder(32128, 4096, 13, device=dev, dtype=torch.bfloat16))
        pipe = hyv_pipe.HunyuanVideoPipeline(
            hunyuan_video.hunyuan_video_dit_params_from_torch(ld["dit"], device=dev),
            _hyv_text_encoder(prompter), vae_decoder_params=hunyuan_video.
            hunyuan_video_vae_decoder_params_from_torch(ld["vae_decoder"], device=dev))
        sets = [(hunyuan_video, "hunyuan_video_dit_forward",
                 timer.wrap("dit", hunyuan_video.hunyuan_video_dit_forward)),
                (hunyuan_video, "hunyuan_video_vae_decode",
                 timer.wrap("vae_decode", hunyuan_video.hunyuan_video_vae_decode))]
        kw = dict(prompt=ZOO_PROMPT, embedded_guidance=6.0)
        step_cls = flow_match.FlowMatchScheduler
    elif family == "cog":
        t5_sd = ld.pop("t5")
        t5m = t5.params_from_torch_state_dict(t5_sd, t5.config_from_state_dict(t5_sd), device=dev)
        pipe = cog_video.CogVideoPipeline(
            cog.cog_dit_params_from_torch(ld["dit"], device=dev), (t5m, t5m.cfg, None),
            vae_decoder_params=cog.cog_vae_decoder_params_from_torch(ld["vae_decoder"],
                                                                     device=dev, dtype=dt))
        sets = [(cog, "cog_dit_forward", timer.wrap("dit", cog.cog_dit_forward)),
                (cog, "cog_vae_decode_video", timer.wrap("vae_decode", cog.cog_vae_decode_video))]
        kw = dict(prompt=ZOO_PROMPT, negative_prompt="blurry, low quality", cfg_scale=6.0)
        step_cls = ddim.EnhancedDDIMScheduler
    elif family == "stepvideo":
        # the DiT at all 48 blocks, seeded on the card tensor by tensor and
        # taken by the converter as it lies (no host copy, no second card
        # copy); the VAE from (b)'s file; the captions from seeded tables
        state = stepvideo.stepvideo_dit_state_dict(seed=231, device=dev, dtype=dt,
                                                   num_layers=STEP_DEPTH)
        dit = stepvideo.stepvideo_dit_params_from_torch(state, device=dev, dtype=dt)
        del state
        pipe = step_video.StepVideoPipeline(
            dit, vae_params=stepvideo_vae.stepvideo_vae_params_from_torch(ld["vae"], device=dev))
        sets = [(stepvideo, "stepvideo_dit_forward",
                 timer.wrap("dit", stepvideo.stepvideo_dit_forward)),
                (stepvideo_vae, "stepvideo_vae_decode_chunk",
                 timer.wrap("vae_decode_chunk", stepvideo_vae.stepvideo_vae_decode_chunk))]
        text = step_text_encoder(dev)
        kw = dict(prompt=ZOO_PROMPT, negative_prompt=STEP_PROMPT_NEG,
                  prompt_emb_posi=text(ZOO_PROMPT), prompt_emb_nega=text(STEP_PROMPT_NEG))
        step_cls = flow_match.FlowMatchScheduler
    else:
        pipe = omnigen_image.OmnigenImagePipeline(
            omnigen.omnigen_params_from_torch(ld["transformer"], device=dev),
            sd.sd_vae_encoder_params_from_torch(ld["vae_encoder"], device=dev),
            sd.sd_vae_decoder_params_from_torch(ld["vae_decoder"], device=dev),
            prompter=OmniGenPrompter(byte_tokenizer))
        sets = [(omnigen, "omnigen_forward", timer.wrap("transformer", omnigen.omnigen_forward)),
                (omnigen_image.sdxl, "sdxl_vae_encode",
                 timer.wrap("vae_encode", omnigen_image.sdxl.sdxl_vae_encode)),
                (omnigen_image.sdxl, "sdxl_vae_decode",
                 timer.wrap("vae_decode", omnigen_image.sdxl.sdxl_vae_decode))]
        refs = [sd_frames(1, OMNIGEN_REF_HW, OMNIGEN_REF_HW, seed=95 + i)[0]
                for i in range(OMNIGEN_REFS)]
        kw = dict(prompt=OMNIGEN_PROMPT, reference_images=refs, cfg_scale=2.5,
                  image_cfg_scale=1.6)
        step_cls = flow_match.FlowMatchScheduler
    ld.clear()
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    step_marks = []
    step = step_cls.step

    def timed_step(self, *a, **k):
        out = step(self, *a, **k)
        torch.cuda.synchronize()
        step_marks.append(time.perf_counter())
        return out

    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with patched(sets + [(step_cls, "step", timed_step)]):
        frames = pipe(num_inference_steps=ZOO_STEPS, seed=0, **ZOO_SIZES[family], **kw)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launches = sd_launches()
    peak = torch.cuda.max_memory_allocated() / 2**30
    frames = frames if isinstance(frames, list) else [frames]
    secs = {k: sum(v) for k, v in timer.seconds.items()}
    calls = {k: len(v) for k, v in timer.seconds.items()}
    size = ZOO_SIZES[family]
    log(f"[{family}-pipeline] {size}, {ZOO_STEPS} steps, {dt}: load {load_s:.2f}s, {total:.2f}s "
        f"in all; seconds at the steps' ends {[round(x - t0, 3) for x in step_marks]}; seconds "
        f"(calls): " + ", ".join(f"{k} {secs[k]:.3f} ({calls[k]})" for k in secs)
        + f"; peak memory {peak:.2f} GiB; launches {launches}; {card}")
    want = zoo_expected_launches(family, pipe)
    if family == "cog":
        check_fwd_routes("the CogVideoX pipeline", need_d128=False, need_d64=True)
    elif family == "stepvideo":
        check_fwd_routes("the StepVideo pipeline")
    elif family == "omnigen":
        check_fwd_routes("the OmniGen pipeline", need_f32=True, need_d128=False)
    if launches != want:
        raise RuntimeError(f"the {family} pipeline launched {launches}, expected {want}")
    shape = (size["height"], size["width"], 3)
    if (len(frames) != size.get("num_frames", 1) or frames[0].shape != shape
            or frames[0].dtype != np.uint8 or float(np.std(frames[0])) == 0):
        raise RuntimeError(f"the {family} output is {len(frames)} x {frames[0].shape} "
                           f"{frames[0].dtype}, or flat")
    del pipe
    gc.collect()
    torch.cuda.empty_cache()
    return per_kernel(launches)


def run_zoo_family(family: str, card: str) -> dict:
    """One family of phases 11 and 12, its files and weights freed before the
    next: (b) seeded files at the published widths, (c) one forward at a cut
    depth card vs CPU, (d) its pipeline at full width, 2 steps. Returns the
    launches per KERNELS entry."""
    import shutil
    import tempfile

    from svi_tpu_torch.models.model_io import load_state_dict

    t1 = time.perf_counter()
    root = Path(tempfile.mkdtemp(prefix=f"_{family}_ckpt_", dir=REPO))
    try:
        paths = write_zoo_checkpoints(family, root, card)
        ld = {k: load_state_dict(p) for k, p in paths.items()}
        phase_zoo_forward(family, ld, card)
        launches = phase_zoo_pipeline(family, ld, card)
        del ld
    finally:
        gc.collect()
        torch.cuda.empty_cache()
        shutil.rmtree(root, ignore_errors=True)
    log(f"[time] {family} (b-d): {time.perf_counter() - t1:.1f}s")
    return launches


def phase_zoo(card: str) -> dict:
    """Phase 11: (a) the tiny SVD, Hunyuan-DiT, HunyuanVideo and CogVideoX
    pipelines card vs CPU; then (b)-(d) one family at a time. Returns
    {family: launches per KERNELS entry}."""
    t0 = time.perf_counter()
    phase_zoo_small(card)
    log(f"[time] phase 11a: {time.perf_counter() - t0:.1f}s")
    launches = {family: run_zoo_family(family, card) for family in ZOO_FAMILIES}
    log(f"[zoo] phase 11 passed in {time.perf_counter() - t0:.1f}s; {card}")
    return launches


# ---------------------------------------------------------------------------
# phase 12: StepVideo, OmniGen and the flow-matching solvers
# ---------------------------------------------------------------------------

# The solvers on card tensors against the same on CPU tensors: the same
# host coefficients and float32 products in the same order, so only a
# differing rounding of an elementwise op could move them (written before the
# first card run)
FM_CARD_REL = 1e-6


def fm_solvers_card_vs_cpu(card: str) -> None:
    """UniPC (bh2 order 2, bh1 order 3), DPM-Solver++ (midpoint order 2, order
    3) and sde-dpmsolver++ (heun, the same per-step noise), 8 steps at shift
    5 on a (1, 16, 3, 8, 8) sample with a stand-in model, card against CPU:
    one [fm-solvers] line of the largest step's difference over the
    trajectory's scale."""
    from svi_tpu_torch.schedulers import fm_solvers as fm

    cases = {
        "unipc_bh2_o2": lambda: fm.FlowUniPCMultistepScheduler(solver_order=2),
        "unipc_bh1_o3": lambda: fm.FlowUniPCMultistepScheduler(solver_order=3,
                                                               solver_type="bh1"),
        "dpm_midpoint_o2": lambda: fm.FlowDPMSolverMultistepScheduler(solver_order=2),
        "dpm_o3": lambda: fm.FlowDPMSolverMultistepScheduler(solver_order=3),
        "sde_dpm_heun_o2": lambda: fm.FlowDPMSolverMultistepScheduler(
            solver_order=2, solver_type="heun", algorithm_type="sde-dpmsolver++"),
    }
    g = torch.Generator().manual_seed(19)
    x0 = torch.randn((1, 16, 3, 8, 8), generator=g)
    noises = [torch.randn(x0.shape, generator=g) for _ in range(8)]
    rels = {}
    for name, make in cases.items():
        traj = {}
        for device in ("cuda", "cpu"):
            sched, x = make(), x0.to(device)
            sched.set_timesteps(8, shift=5.0)
            out = []
            for i, t in enumerate(sched.timesteps):
                kw = {"variance_noise": noises[i].to(device)} if name.startswith("sde") else {}
                x = sched.step(0.3 * x + math.sin(i + 1) * 0.1, t, x, **kw)
                out.append(x.cpu())
            traj[device] = torch.stack(out)
        finite = torch.isfinite(traj["cpu"])
        if not torch.equal(finite, torch.isfinite(traj["cuda"])):
            raise RuntimeError(f"fm-solvers {name}: the card's trajectory is finite elsewhere")
        rels[name] = ((traj["cuda"] - traj["cpu"])[finite].abs().max()
                      / traj["cpu"][finite].abs().max()).item()
    log(f"[fm-solvers] card vs CPU, 8 steps, the largest difference over the trajectory's "
        f"scale { {k: f'{v:.3e}' for k, v in rels.items()} } (bound {FM_CARD_REL}); {card}")
    if max(rels.values()) > FM_CARD_REL:
        raise RuntimeError("a flow-matching solver on the card disagrees with the CPU")


def phase_step_omni(card: str) -> dict:
    """Phase 12: (a) the tiny StepVideo and OmniGen pipelines card vs CPU
    (tests/torch_video_fixtures.py's narrow configurations, f32) and the
    flow-matching solvers card vs CPU; then, one family at a time through
    phase 11's tables and functions, (b) seeded files at the published
    widths, (c) forwards at a cut depth card vs CPU, (d) the pipelines at
    full width, 2 steps: StepVideo at 544 x 992 x 17 with all 48 blocks,
    OmniGen at 1024 x 1024 with a reference image. Returns {family: launches
    per KERNELS entry}."""
    from svi_tpu_torch.models import sd

    t0 = time.perf_counter()
    fx = _sd_fixtures()
    small_card_vs_cpu(step_omni_small_pipelines,
                      [(sd, "SD_VAE_ENCODER_PLAN", fx.VAE_ENCODER_PLAN),
                       (sd, "SD_VAE_DECODER_PLAN", fx.VAE_DECODER_PLAN)], "step-omni-small", card)
    fm_solvers_card_vs_cpu(card)
    log(f"[time] phase 12a: {time.perf_counter() - t0:.1f}s")
    launches = {family: run_zoo_family(family, card) for family in STEP_OMNI_FAMILIES}
    log(f"[step-omni] phase 12 passed in {time.perf_counter() - t0:.1f}s; {card}")
    return launches


def main() -> int:
    if not (REPO / "svi_tpu_torch" / "__init__.py").is_file():
        raise SystemExit("chip_smoke.py must run from a checkout of the repository "
                         "(svi_tpu_torch/ not found beside it)")
    t_start = time.perf_counter()
    sys.path.insert(0, str(REPO))
    import svi_tpu_torch
    from svi_tpu_torch.kernels import build

    # 1. environment
    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is False: this smoke run needs a CUDA card")
    log(f"[env] {json.dumps(svi_tpu_torch.capability_probe())}")
    card = nvidia_smi_line()
    log(f"[env] nvidia-smi: {card}")
    # both TF32 switches stay at PyTorch's defaults, as a user's process has
    # them, so every phase measures what users run: f32 matmuls are f32 by
    # default, and the package runs its f32 convolutions with cuDNN TF32 off
    # itself (ops.conv.conv_f32; phase 4b checks that the switch moves no bit)
    log(f"[env] TF32 (PyTorch's defaults, left as they are): matmul "
        f"{torch.backends.cuda.matmul.allow_tf32}, cudnn {torch.backends.cudnn.allow_tf32}")

    # 2. build: one nvcc per source, all started together
    t0 = time.perf_counter()
    for name, res in build.build_all().items():
        ptxas = [line for line in res.log.splitlines() if "registers" in line or "spill" in line]
        log(f"[build] {name} -> {res.path.name} in {res.seconds:.2f}s; ptxas: "
            + " | ".join(ptxas))
    build.load_flash_fwd_sm90()
    build.load_flash_fwd_f32()
    build.load_flash_bwd()
    build.load_flash_bwd_f32()
    build.load_flash_bwd_sm90()
    build.load_flash_bwd_split_sm90()
    build.load_flash_fwd_q8()
    build.load_flash_fwd_q8_sm90()
    build.load_quant_unpack()
    build.load_w4a8_gemm()
    build.load_w4a8_dgrad()
    log(f"[build] all sources in {time.perf_counter() - t0:.2f}s")

    marks = [t_start]

    def mark(phase: str) -> None:
        """The seconds since the last mark, so that a cut can be placed."""
        marks.append(time.perf_counter())
        log(f"[time] {phase}: {marks[-1] - marks[-2]:.1f}s")

    mark("environment and build")
    # 3. kernels against plain
    rows = phase_kernels(card)
    int8_gemm_context(card)
    mark("phase 3")

    # 4. the inference slice, in bf16 and quantized
    phase_small_reference()
    infer_launches, state = phase_slice()
    check_tf32_invariance(state, card)
    phase_forward_81f(state)
    phase_multitalk_step(state, card)  # phase 4f's full-depth step, on 4b's bf16 weights
    phase_small_quantized()
    f32_q8_launches = phase_fidelity_gate(card)
    phase_small_multitalk(card)
    quant_launches = phase_quantized_slice(state)
    phase_quantized_81f(state)
    del state
    gc.collect()  # the pipeline's timer wrappers refer back to it
    torch.cuda.empty_cache()
    mark("phase 4 (a-d)")

    # the driver: checkpoint files through the user's entry point (4e, 4f;
    # 5b: the training drivers, whose quantized run gives K3's launches)
    train_q_launches, pose_launches = phase_driver(card)
    mark("phases 4e, 4f, 7, 5b (the drivers' files)")

    # 5. the training slice
    phase_small_trainer()
    phase_small_variant_trainers(card)
    train_launches, _, _ = phase_training()
    gc.collect()
    torch.cuda.empty_cache()
    mark("phase 5")

    # 6. the parallel slice: ranks on the card
    par_launches = phase_parallel(card)
    mark("phase 6")

    # 8. the SD 1.5 video stack, its runner and text-to-image LoRA training
    sd_launches, t2i_launches = phase_sd(card)
    mark("phase 8")

    # 9. the extensions and the SDXL family
    xl_launches = phase_xl(card)
    mark("phase 9")

    # 10. Kolors, SD3 and FLUX
    fam_launches = phase_families(card)
    mark("phase 10")

    # 11. SVD, Hunyuan-DiT, HunyuanVideo and CogVideoX
    zoo_launches = phase_zoo(card)
    mark("phase 11")

    # 12. StepVideo, OmniGen and the flow-matching solvers
    zoo_launches.update(phase_step_omni(card))
    mark("phase 12")

    # 9. results: the forward kernels' launches are the bf16 inference path's,
    # the backward kernels' the training path's, the W4A8 linear's and K6's
    # the quantized inference path's (K6's f32 route the fidelity gate's f32
    # forward), K3's the quantized training driver's; launches_sd: phase 8's
    # runner; launches_sdxl: phase 9's SDXL video pipeline; launches_kolors,
    # _sd3, _flux: phase 10's pipelines at 1024x1024; launches_svd,
    # _hunyuan_dit, _hunyuan_video, _cog: phase 11's pipelines at full width
    # (the f32 D = 88 and bf16 D = 64 entries' launches are theirs);
    # launches_stepvideo, _omnigen: phase 12's; launches_t2i: phase 8e's
    # full-width text-to-image trainer (the f32 backward kernels' launches);
    # the sm90 route's other bf16 head dims' launches: the bf16 paths' (8f,
    # 10d's FLUX, 11c), each path's in launches_bf16_paths
    kernels = []
    zoo_total = {e: sum(zoo_launches[f].get(e, 0) for f in ZOO_FAMILIES) for e in ZOO_KERNELS}
    bf16_total = {e: sum(c.get(e, 0) for c in BF16_PATH_LAUNCHES.values()) for e in BF16_KERNELS}
    if min(bf16_total.values()) <= 0:
        raise RuntimeError(f"a kernel was not launched on the bf16 paths: {BF16_PATH_LAUNCHES}")
    for entry, (src, replaces) in KERNELS.items():
        mine = [r for r in rows if r["entry"] == entry]
        timed = next(r for r in mine if r["case"] == TIMED_CASE[entry])
        launches = (bf16_total if entry in BF16_KERNELS else zoo_total if entry in ZOO_KERNELS
                    else t2i_launches if entry in T2I_KERNELS
                    else par_launches if entry in PARALLEL_KERNELS
                    else f32_q8_launches if entry in QUANT_F32
                    else train_q_launches if entry in QUANT_TRAIN else quant_launches
                    if entry in QUANT_KERNELS else infer_launches
                    if entry.startswith("flash_fwd") or entry == "rope_rotate_flat"
                    else train_launches)[entry]
        kernels.append({"name": entry, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": launches, "launches_parallel": par_launches.get(entry, 0),
                        "launches_pose": pose_launches.get(entry, 0),
                        "launches_sd": sd_launches.get(entry, 0),
                        "launches_sdxl": xl_launches.get(entry, 0),
                        "launches_t2i": t2i_launches.get(entry, 0),
                        "launches_bf16_paths": {path: c.get(entry, 0)
                                                for path, c in BF16_PATH_LAUNCHES.items()},
                        **{f"launches_{fam}": fam_launches[fam].get(entry, 0)
                           for fam in ("kolors", "sd3", "flux")},
                        **{f"launches_{fam}": zoo_launches[fam].get(entry, 0)
                           for fam in ZOO_FAMILIES + STEP_OMNI_FAMILIES},
                        "max_abs_err": max(r["max_abs_err"] for r in mine),
                        "ms": timed["ms"], "plain_ms": timed["plain_ms"],
                        "bound_ms": timed["bound_ms"], "bound_by": timed["bound_by"],
                        "bound_rate": timed["bound_rate"], "library_ms": timed["library_ms"]})
    log(f"[total] every phase passed in {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
