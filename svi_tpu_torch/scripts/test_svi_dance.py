"""SVI-Dance inference driver on the card (port of scripts/test_svi_dance.py).

    python -m svi_tpu_torch.scripts.test_svi_dance \
        --dit_root <Wan2.1-I2V-14B-480P dir> \
        --extra_module_root <svi-dance.safetensors> \
        --image_path data/toy_test/dance/image.png \
        --pose_path data/toy_test/dance/pose.mp4

The pose video is resized (nearest, aspect kept) and padded to the clip's
size and tiled up to --num_frames; each clip takes the window of poses
whose first --num_motion_frames are the previous window's last ones (the
poses of the recycled motion frames), then the following poses of the
video, wrapping around. --remove_pose drops the pose condition. The
stitched video drops each clip's motion overlap except the last clip's and
is saved again after every clip on a background thread.

Flags are the JAX driver's, plus `--save_format {mp4,npy}` (npy: the
stitched uint8 frames as one (T, H, W, 3) array). The reference image is a
`.jpg` / `.png` or an (H, W, 3) uint8 `.npy` of the clip's size; the pose
video an mp4 (OpenCV or imageio reads it) or an (N, H, W, 3) uint8 `.npy`.
The pose embedding's weights come in the LoRA file (`dwpose_embedding.*`).

`main(argv, device)` runs in-process: the models go on `device` (the card
unless the caller asks for the CPU) and it returns what it made.
"""

from __future__ import annotations

import argparse
import os
import time
from datetime import datetime

import numpy as np
import torch

from .test_svi import (COMMON_NEGATIVE_PROMPT, card_device, load_manager, ready_pipeline,
                       refuse_sequential_cfg)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="SVI-Dance inference (PyTorch, CUDA)")
    p.add_argument("--dit_root", type=str, default="weights/Wan2.1-I2V-14B-480P/")
    p.add_argument("--extra_module_root", type=str,
                   default="weights/Stable-Video-Infinity/version-1.0/svi-dance.safetensors")
    p.add_argument("--output", type=str, default="videos/svi_dance/")
    p.add_argument("--cfg_scale_audio", type=float, default=2.0)
    p.add_argument("--cfg_scale_text", type=float, default=2.0)
    p.add_argument("--train_architecture", type=str, default="lora")
    p.add_argument("--quantize", type=str, default="none",
                   choices=["none", "int8", "w8a8", "int4", "int4_w4a8"],
                   help="DiT weight quantization (int4_w4a8: int4 weights run through the "
                        "W4A8 GEMM)")
    p.add_argument("--ref_pad_cfg", action="store_true", default=False)
    p.add_argument("--ref_pad_num", type=int, default=-1)
    p.add_argument("--num_motion_frames", type=int, default=5)
    p.add_argument("--num_clips", type=int, default=10)
    p.add_argument("--num_steps", type=int, default=50)
    p.add_argument("--lora_alpha", type=float, default=1.0)
    p.add_argument("--remove_pose", action="store_true", default=False)
    p.add_argument("--image_path", type=str, required=True)
    p.add_argument("--pose_path", type=str, required=True)
    p.add_argument("--prompt", type=str, default="the person is dancing")
    p.add_argument("--num_frames", type=int, default=81)
    p.add_argument("--tiled", action="store_true", default=False)
    p.add_argument("--sample_fps", type=int, default=1)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--use_teacache", action="store_true", default=False)
    p.add_argument("--sequential_cfg", type=str, default=None)
    p.add_argument("--save_format", type=str, default="mp4", choices=["mp4", "npy"],
                   help="mp4 (imageio or cv2), or npy: the stitched uint8 frames as one array")
    return p.parse_args(argv)


def load_pose(path: str, height: int, width: int, num_frames: int):
    """The pose video -> (all poses (3, N', H, W) f32, tiled to at least
    num_frames; the first window (3, num_frames, H, W))."""
    from ..utils.image_process import resize_and_pad_to_target
    from ..utils.video import load_video_frames

    pose = np.stack([f.transpose(2, 0, 1) for f in load_video_frames(path)]).astype(np.float32)
    pose = np.transpose(resize_and_pad_to_target(pose, (height, width), pad_value=0),
                        (1, 0, 2, 3))
    if pose.shape[1] < num_frames:
        pose = np.concatenate([pose] * (num_frames // pose.shape[1] + 1), axis=1)
    return pose, pose[:, :num_frames]


def next_pose_window(pose, window, motion: int, sampled_idx: int):
    """The next clip's poses: the last `motion` of `window` (those of the
    recycled motion frames), then pose[sampled_idx...] wrapping around.
    Returns (window, the next sampled_idx)."""
    new = np.zeros_like(window)
    new[:, :motion] = window[:, -motion:]
    for i in range(motion, window.shape[1]):
        sampled_idx = sampled_idx % pose.shape[1]
        new[:, i] = pose[:, sampled_idx]
        sampled_idx += 1
    return new, sampled_idx


def main(argv=None, device="cuda") -> dict:
    """Run the driver; returns {"pipe", "manager", "path", "frames", "clips":
    [{"seconds"}]}."""
    from ..pipelines.svi_video_dance import SVIDanceVideoPipeline
    from ..utils.image_process import calculate_dimensions, load_reference_image
    from ..utils.video import AsyncVideoSaver, save_frames_npy, save_video

    args = parse_args(argv)
    refuse_sequential_cfg(args)
    device = card_device(device)

    mm, load_s, fuse_s = load_manager(args, device)
    t_fetch = time.perf_counter()
    pipe = SVIDanceVideoPipeline.from_model_manager(mm, torch_dtype=torch.bfloat16,
                                                    device=device)
    ready_pipeline(pipe, args, mm, device, load_s, fuse_s, t_fetch)

    height, width = calculate_dimensions(args.image_path, max_width=640)
    ref_gt = load_reference_image(args.image_path, height, width)
    motion_frames = ref_gt
    max_frames = args.num_frames
    pose, humanpose = load_pose(args.pose_path, height, width, max_frames)
    sampled_idx = max_frames - 1

    ts = datetime.now().strftime("%Y%m%d_%H%M%S")
    os.makedirs(args.output, exist_ok=True)
    out_path = os.path.join(
        args.output, f"dance_cfgt{args.cfg_scale_text}_step{args.num_steps}_{ts}."
                     f"{args.save_format}")
    write = save_frames_npy if args.save_format == "npy" else (
        lambda frames, path: save_video(frames, path, fps=25, quality=5))

    video_list, clips = [], []
    saver = AsyncVideoSaver()
    for chunk_idx in range(args.num_clips):
        print(f"clip {chunk_idx + 1}/{args.num_clips}")
        t_clip = time.perf_counter()
        video = pipe(
            prompt=args.prompt,
            negative_prompt=COMMON_NEGATIVE_PROMPT,
            input_image=motion_frames,
            num_frames=args.num_frames,
            num_inference_steps=args.num_steps,
            cfg_scale=dict(audio=args.cfg_scale_audio, text=args.cfg_scale_text),
            seed=args.seed, tiled=args.tiled,
            humanpose_data=None if args.remove_pose else humanpose,
            random_ref_frame=ref_gt,
            height=height, width=width,
            tea_cache_l1_thresh=0.3 if args.use_teacache else None,
            tea_cache_model_id="Wan2.1-I2V-14B-720P" if args.use_teacache else None,
            cond_wo_pose=True,
            args=args,
        )
        clips.append({"seconds": time.perf_counter() - t_clip})
        motion_frames = video[-args.num_motion_frames:]
        if chunk_idx < args.num_clips - 1:
            video_list += video[:-args.num_motion_frames]
        else:
            video_list += video
        frames_now = list(video_list)  # a snapshot: the saver runs on its own thread
        saver.submit(lambda f=frames_now: write(f, out_path))
        humanpose, sampled_idx = next_pose_window(pose, humanpose, args.num_motion_frames,
                                                  sampled_idx)
    saver.close()
    print(f"saved {len(video_list)} frames")
    return {"pipe": pipe, "manager": mm, "path": out_path, "frames": len(video_list),
            "clips": clips}


if __name__ == "__main__":
    main()
