"""SVI infinite-video inference driver on the card (port of scripts/test_svi.py).

    python -m svi_tpu_torch.scripts.test_svi \
        --dit_root <Wan2.1-I2V-14B-480P dir> \
        --extra_module_root <svi-shot.safetensors> \
        --ref_pad_num -1 --cfg_scale_text 5.0 --num_motion_frames 1 \
        --ref_image_path data/toy_test/shot/frame.jpg \
        --prompt_path data/toy_test/shot/prompt.txt --use_first_prompt_only

It owns the outer loop: per-clip seeds (`chunk_idx * seed_times`), the prompt
stream, motion-frame recycling with the overlap trimmed, and the stitched
video saved again after every clip on a background thread. Its flags are the
JAX driver's, plus `--save_format {mp4,npy}` (default mp4): `npy` writes the
stitched uint8 frames as one (T, H, W, 3) array, for machines with no video
writer (the card's). The reference image is a `.jpg` / `.png` (Pillow opens
and resizes it) or a `.npy` (H, W, 3) uint8 array already of the clip's size.

Files it reads under --dit_root: the DiT as `diffusion_pytorch_model*.safetensors`
shards (else the directory itself), `models_t5_umt5-xxl-enc-bf16.pth`,
`Wan2.1_VAE.pth`, `models_clip_open-clip-xlm-roberta-large-vit-huge-14.pth`,
and the tokenizer `google/umt5-xxl/spiece.model`. --extra_module_root is a
LoRA `.safetensors` or a directory of them.

`main(argv, device)` runs in-process: the models go on `device` (the card
unless the caller asks for the CPU) and it returns what it made.
"""

from __future__ import annotations

import argparse
import glob
import os
import time
from datetime import datetime

import torch

COMMON_NEGATIVE_PROMPT = (
    "bright tones, overexposed, static, blurred details, subtitles, style, works, "
    "paintings, images, static, overall gray, worst quality, low quality, JPEG "
    "compression residue, ugly, incomplete, extra fingers, poorly drawn hands, "
    "poorly drawn faces, deformed, disfigured, misshapen limbs, fused fingers, "
    "still picture, messy background, three legs, many people in the background, "
    "walking backwards"
)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="SVI infinite video inference (PyTorch, CUDA)")
    p.add_argument("--dit_root", type=str, default="weights/Wan2.1-I2V-14B-480P/")
    p.add_argument("--extra_module_root", type=str,
                   default="weights/Stable-Video-Infinity/version-1.0/svi-shot.safetensors")
    p.add_argument("--output", type=str, default="videos/")
    p.add_argument("--cfg_scale_text", type=float, default=5.0)
    p.add_argument("--lora_alpha", type=float, default=1.0)
    p.add_argument("--train_architecture", type=str, default="lora")
    p.add_argument("--ref_pad_cfg", action="store_true", default=False)
    p.add_argument("--num_motion_frames", type=int, default=1)
    p.add_argument("--num_clips", type=int, default=10)
    p.add_argument("--num_steps", type=int, default=50)
    p.add_argument("--data_root", type=str, default="data_inference/wan_i2v/")
    p.add_argument("--ref_image_path", type=str, default=None)
    p.add_argument("--prompt_path", type=str, default=None)
    p.add_argument("--test_samples", type=str, nargs="*", default=None)
    p.add_argument("--max_prompts_per_sample", type=int, default=None)
    p.add_argument("--ref_pad_num", type=int, default=0)
    p.add_argument("--use_first_prompt_only", action="store_true", default=False)
    p.add_argument("--use_first_aug", action="store_true", default=False)
    p.add_argument("--max_width", type=int, default=832)
    p.add_argument("--seed_times", type=int, default=42)
    p.add_argument("--repeat_first_clip", action="store_true", default=False)
    p.add_argument("--tiled", action="store_true", default=False)
    p.add_argument("--tile_size", type=int, nargs=2, default=[30, 52])
    p.add_argument("--tile_stride", type=int, nargs=2, default=[15, 26])
    p.add_argument("--prompt_prefix", type=str, default="none")
    p.add_argument("--prompt_repeat_times", type=int, default=1)
    p.add_argument("--num_persistent_param_in_dit", type=int, default=6 * 10**9)
    p.add_argument("--num_frames", type=int, default=81)
    p.add_argument("--use_teacache", action="store_true", default=False)
    p.add_argument("--quantize", type=str, default="none",
                   choices=["none", "int8", "w8a8", "int4", "int4_w4a8"],
                   help="DiT weight quantization (int4_w4a8: int4 weights run through the "
                        "W4A8 GEMM)")
    p.add_argument("--sequential_cfg", type=str, default=None)
    p.add_argument("--save_format", type=str, default="mp4", choices=["mp4", "npy"],
                   help="mp4 (imageio or cv2), or npy: the stitched uint8 frames as one array")
    return p.parse_args(argv)


def _samples(args) -> list[dict]:
    from ..utils.prompt_files import load_prompts_from_file

    if args.ref_image_path and args.prompt_path:
        return [{"prompt_name": os.path.splitext(os.path.basename(args.ref_image_path))[0],
                 "prompts": load_prompts_from_file(args.prompt_path),
                 "negative_prompt": COMMON_NEGATIVE_PROMPT,
                 "direct_image_path": args.ref_image_path}]
    samples = []
    for d in sorted(os.listdir(args.data_root)):
        dd = os.path.join(args.data_root, d)
        if not os.path.isdir(dd) or (args.test_samples and d not in args.test_samples):
            continue
        samples.append({"prompt_name": d,
                        "prompts": load_prompts_from_file(os.path.join(dd, "prompt.txt")),
                        "negative_prompt": COMMON_NEGATIVE_PROMPT, "ref_image_root": dd})
    return samples


def card_device(device) -> torch.device:
    """`device` as a torch.device; a CUDA device must exist (no silent CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the driver runs on the card (main(device='cpu') "
                           "runs it on the CPU)")
    return device


def refuse_sequential_cfg(args) -> None:
    if args.sequential_cfg == "latent":
        raise NotImplementedError("--sequential_cfg latent: the pipeline then returns (frames, "
                                  "latent) for a caller that chains clips itself; this driver "
                                  "recycles frames, as scripts/test_svi.py does")


def load_manager(args, device, extra_dit_files=()):
    """The ModelManager of a driver: the DiT (the `diffusion_pytorch_model*`
    shards under --dit_root, else the directory, then `extra_dit_files` in
    the same state dict), umT5, the VAE and CLIP where their files are, the
    LoRA file(s) of --extra_module_root fused. Returns (manager, seconds of
    the load, seconds of the fuse)."""
    from ..models.model_io import ModelManager

    t0 = time.perf_counter()
    mm = ModelManager(torch_dtype=torch.bfloat16, device=device,
                      quantize_dit=None if args.quantize == "none" else args.quantize)
    shards = sorted(glob.glob(os.path.join(args.dit_root,
                                           "diffusion_pytorch_model*.safetensors")))
    dit = shards if shards else args.dit_root
    if extra_dit_files:
        dit = (dit if isinstance(dit, list) else [dit]) + list(extra_dit_files)
    model_paths = [dit]
    for name in ("models_t5_umt5-xxl-enc-bf16.pth", "Wan2.1_VAE.pth",
                 "models_clip_open-clip-xlm-roberta-large-vit-huge-14.pth"):
        pth = os.path.join(args.dit_root, name)
        if os.path.exists(pth):
            model_paths.append(pth)
    mm.load_models(model_paths)
    t1 = time.perf_counter()
    extra = args.extra_module_root
    lora_files = [extra] if extra.endswith(".safetensors") else sorted(
        glob.glob(os.path.join(extra, "*.safetensors")))
    mm.load_lora_v2(lora_files, lora_alpha=args.lora_alpha)
    return mm, t1 - t0, time.perf_counter() - t1


def ready_pipeline(pipe, args, mm, device, load_s, fuse_s, t_fetch):
    """The tokenizer under --dit_root, then the load's summary line."""
    tok_dir = os.path.join(args.dit_root, "google/umt5-xxl")
    if os.path.isdir(tok_dir):
        pipe.prompter.fetch_tokenizer(tok_dir)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    print(f"[driver] loaded {sorted(mm.models)} in {load_s:.2f}s, fused LoRA {mm.lora_log} in "
          f"{fuse_s:.2f}s, pipeline ready (quantize {args.quantize}) after "
          f"{time.perf_counter() - t_fetch:.2f}s")
    return pipe


def main(argv=None, device="cuda") -> dict:
    """Run the driver; returns {"pipe", "manager", "samples": [{"prompt_name",
    "path", "frames", "clips": [{"seed", "prompt", "seconds"}]}]}."""
    from ..pipelines.svi_video import SVIVideoPipeline
    from ..utils.image_process import (calculate_dimensions, find_reference_image,
                                       load_reference_image)
    from ..utils.video import AsyncVideoSaver, save_frames_npy, save_video

    args = parse_args(argv)
    # --train_architecture is read nowhere at inference, as in the JAX driver:
    # the DiT's variant (customtalk, multitalk) follows the checkpoint's keys
    refuse_sequential_cfg(args)
    device = card_device(device)
    samples = _samples(args)

    mm, load_s, fuse_s = load_manager(args, device)
    t_fetch = time.perf_counter()
    pipe = SVIVideoPipeline.from_model_manager(mm, torch_dtype=torch.bfloat16, device=device)
    pipe.enable_vram_management(num_persistent_param_in_dit=args.num_persistent_param_in_dit)
    ready_pipeline(pipe, args, mm, device, load_s, fuse_s, t_fetch)

    record = {"pipe": pipe, "manager": mm, "samples": []}
    for sample in samples:
        ref_path = sample.get("direct_image_path") or find_reference_image(
            sample["ref_image_root"])
        height, width = calculate_dimensions(ref_path, max_width=args.max_width)
        print(f"[{sample['prompt_name']}] {width}x{height}, {len(sample['prompts'])} prompts")
        ref_single = load_reference_image(ref_path, height, width)
        motion_frames = ([ref_single] * args.num_motion_frames if args.repeat_first_clip
                         else ref_single)
        prompts = sample["prompts"]
        if args.use_first_prompt_only:
            num_clips = args.num_clips
        else:
            num_clips = min(args.num_clips, len(prompts) * args.prompt_repeat_times)

        ts = datetime.now().strftime("%Y%m%d_%H%M%S")
        out_dir = os.path.join(args.output, f"{sample['prompt_name']}_{ts}")
        os.makedirs(out_dir, exist_ok=True)
        base_name = (f"i2v_{sample['prompt_name']}_cfgt{args.cfg_scale_text}_step"
                     f"{args.num_steps}_{ts}")
        out_path = os.path.join(out_dir, f"{base_name}.{args.save_format}")
        write = save_frames_npy if args.save_format == "npy" else (
            lambda frames, path: save_video(frames, path, fps=24, quality=8))

        video_list, clips = [], []
        saver = AsyncVideoSaver()
        for chunk_idx in range(num_clips):
            seed = None if args.seed_times == -1 else int(chunk_idx * args.seed_times)
            if args.use_first_prompt_only:
                prompt = prompts[0]
            else:
                prompt = prompts[(chunk_idx // args.prompt_repeat_times) % len(prompts)]
            if args.prompt_prefix != "none":
                prompt = f"{args.prompt_prefix}, {prompt}"
            print(f"  clip {chunk_idx + 1}/{num_clips} seed={seed}: {prompt[:70]}")
            t_clip = time.perf_counter()
            video = pipe(
                prompt=prompt,
                negative_prompt=sample["negative_prompt"],
                input_image=motion_frames,
                num_frames=args.num_frames,
                num_inference_steps=args.num_steps,
                cfg_scale=dict(text=args.cfg_scale_text),
                seed=seed,
                tiled=args.tiled,
                tile_size=tuple(args.tile_size),
                tile_stride=tuple(args.tile_stride),
                random_ref_frame=ref_single,
                height=height,
                width=width,
                tea_cache_l1_thresh=0.3 if args.use_teacache else None,
                tea_cache_model_id="Wan2.1-I2V-14B-720P" if args.use_teacache else None,
                args=args,
            )
            clips.append({"seed": seed, "prompt": prompt,
                          "seconds": time.perf_counter() - t_clip})
            # motion-frame recycling + overlap trim
            motion_frames = video[-args.num_motion_frames:]
            if chunk_idx < num_clips - 1:
                video_list += video[:-args.num_motion_frames]
            else:
                video_list += video
            frames_now = list(video_list)  # a snapshot: the saver runs on its own thread
            saver.submit(lambda f=frames_now: write(f, out_path))
        saver.close()
        print(f"  saved {len(video_list)} frames to {out_path}")
        record["samples"].append({"prompt_name": sample["prompt_name"], "path": out_path,
                                  "frames": len(video_list), "clips": clips})
    return record


if __name__ == "__main__":
    main()
