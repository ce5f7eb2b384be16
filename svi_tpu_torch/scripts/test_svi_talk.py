"""SVI-Talk inference driver on the card (port of scripts/test_svi_talk.py).

    python -m svi_tpu_torch.scripts.test_svi_talk \
        --dit_root <Wan2.1-I2V-14B-480P dir> \
        --extra_module_root <svi-talk.safetensors> \
        --multitalk_path <multitalk.safetensors> \
        --wav2vec_path <chinese-wav2vec2-base dir> \
        --ref_image_path data/toy_test/talk/portrait.png \
        --audio_path data/toy_test/talk/speech.wav

--multitalk_path holds the audio branches of the DiT: it joins the DiT's
state dict after the shards, so the DiT loads as multitalk (or customtalk,
by its keys). Clip k takes the audio from frame 81·k − num_motion_frames on
(81·k for the first); the wav2vec2 pass runs once per file. The stitched
video keeps every clip's frames, overlap included, and is saved after every
clip as its own chunk file, muxed with the audio by ffmpeg where that binary
exists (mp4 only).

Flags are the JAX driver's, plus `--save_format {mp4,npy}`. The reference
image is a `.jpg` / `.png` or an (H, W, 3) uint8 `.npy` of the clip's size;
the audio a `.wav` (scipy reads it where librosa is not installed).

`main(argv, device)` runs in-process: the models go on `device` (the card
unless the caller asks for the CPU) and it returns what it made.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import time
from datetime import datetime

import torch

from .test_svi import (COMMON_NEGATIVE_PROMPT, card_device, load_manager, ready_pipeline,
                       refuse_sequential_cfg)

CLIP_STRIDE = 81  # the audio frames between clip starts, as the reference counts them


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="SVI-Talk inference (PyTorch, CUDA)")
    p.add_argument("--dit_root", type=str, default="weights/Wan2.1-I2V-14B-480P/")
    p.add_argument("--extra_module_root", type=str,
                   default="weights/Stable-Video-Infinity/version-1.0/svi-talk.safetensors")
    p.add_argument("--multitalk_path", type=str, default=None,
                   help="multitalk.safetensors with the audio branches (loaded into the DiT)")
    p.add_argument("--wav2vec_path", type=str, default="./weights/chinese-wav2vec2-base/")
    p.add_argument("--output", type=str, default="videos/svi_talk/")
    p.add_argument("--cfg_scale_audio", type=float, default=2.0)
    p.add_argument("--cfg_scale_text", type=float, default=2.0)
    p.add_argument("--train_architecture", type=str, default="lora")
    p.add_argument("--quantize", type=str, default="none",
                   choices=["none", "int8", "w8a8", "int4", "int4_w4a8"],
                   help="DiT weight quantization (int4_w4a8: int4 weights run through the "
                        "W4A8 GEMM)")
    p.add_argument("--lora_alpha", type=float, default=1.0)
    p.add_argument("--ref_pad_cfg", action="store_true", default=False)
    p.add_argument("--tiled", action="store_true", default=False)
    p.add_argument("--ref_pad_num", type=int, default=-1)
    p.add_argument("--num_motion_frames", type=int, default=1)
    p.add_argument("--num_clips", type=int, default=10)
    p.add_argument("--num_steps", type=int, default=50)
    p.add_argument("--ref_image_path", type=str, required=True)
    p.add_argument("--audio_path", type=str, required=True)
    p.add_argument("--prompt", type=str, default="the person is talking")
    p.add_argument("--num_frames", type=int, default=81)
    p.add_argument("--max_width", type=int, default=832)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--use_teacache", action="store_true", default=False)
    p.add_argument("--sequential_cfg", type=str, default=None)
    p.add_argument("--save_format", type=str, default="mp4", choices=["mp4", "npy"],
                   help="mp4 (imageio or cv2), or npy: the stitched uint8 frames as one array")
    return p.parse_args(argv)


def audio_start(chunk_idx: int, num_motion_frames: int) -> int:
    """The first audio frame of clip chunk_idx."""
    start = chunk_idx * CLIP_STRIDE
    return start - num_motion_frames if start > 0 else start


def main(argv=None, device="cuda") -> dict:
    """Run the driver; returns {"pipe", "manager", "paths" (one per chunk),
    "frames", "clips": [{"audio_start", "seconds"}]}."""
    from ..pipelines.svi_video_talk import SVITalkVideoPipeline
    from ..utils.image_process import calculate_dimensions, load_reference_image
    from ..utils.video import AsyncVideoSaver, save_frames_npy, save_video

    args = parse_args(argv)
    refuse_sequential_cfg(args)
    device = card_device(device)

    mm, load_s, fuse_s = load_manager(
        args, device, [args.multitalk_path] if args.multitalk_path else ())
    t_fetch = time.perf_counter()
    wav2vec = args.wav2vec_path if os.path.isdir(args.wav2vec_path) else None
    pipe = SVITalkVideoPipeline.from_model_manager(mm, torch_dtype=torch.bfloat16, device=device,
                                                   wav2vec_path=wav2vec)
    ready_pipeline(pipe, args, mm, device, load_s, fuse_s, t_fetch)

    height, width = calculate_dimensions(args.ref_image_path, max_width=args.max_width)
    ref_gt = load_reference_image(args.ref_image_path, height, width)
    motion_frames = ref_gt

    ts = datetime.now().strftime("%Y%m%d_%H%M%S")
    os.makedirs(args.output, exist_ok=True)
    base = (f"talk_cfga{args.cfg_scale_audio}_cfgt{args.cfg_scale_text}_step{args.num_steps}"
            f"_{ts}")

    def save(frames, out):
        if args.save_format == "npy":
            save_frames_npy(frames, out)
            return
        save_video(frames, out, fps=25, quality=8)
        if shutil.which("ffmpeg") and os.path.exists(args.audio_path):
            subprocess.run(["ffmpeg", "-y", "-i", out, "-i", args.audio_path, "-c:v", "copy",
                            "-c:a", "aac", "-shortest", out.replace(".mp4", "_with_audio.mp4")],
                           check=False, capture_output=True)

    video_list, clips, paths = [], [], []
    saver = AsyncVideoSaver()
    for chunk_idx in range(args.num_clips):
        start = audio_start(chunk_idx, args.num_motion_frames)
        print(f"clip {chunk_idx + 1}/{args.num_clips} audio_start={start}")
        t_clip = time.perf_counter()
        video = pipe(
            prompt=args.prompt,
            negative_prompt=COMMON_NEGATIVE_PROMPT,
            input_image=motion_frames,
            num_frames=args.num_frames,
            num_inference_steps=args.num_steps,
            cfg_scale=dict(audio=args.cfg_scale_audio, text=args.cfg_scale_text),
            seed=args.seed, tiled=args.tiled,
            random_ref_frame=ref_gt,
            height=height, width=width,
            tea_cache_l1_thresh=0.3 if args.use_teacache else None,
            tea_cache_model_id="Wan2.1-I2V-14B-720P" if args.use_teacache else None,
            audio_path=args.audio_path,
            audio_start_idx=start,
            args=args,
        )
        clips.append({"audio_start": start, "seconds": time.perf_counter() - t_clip})
        motion_frames = video[-args.num_motion_frames:]
        video_list += video  # talk keeps the overlap frames
        paths.append(os.path.join(args.output,
                                  f"{base}_chunk_{chunk_idx + 1:02d}.{args.save_format}"))
        frames_now = list(video_list)  # a snapshot: the saver runs on its own thread
        saver.submit(lambda f=frames_now, out=paths[-1]: save(f, out))
    saver.close()
    print(f"saved {len(video_list)} frames")
    return {"pipe": pipe, "manager": mm, "paths": paths, "frames": len(video_list),
            "clips": clips}


if __name__ == "__main__":
    main()
