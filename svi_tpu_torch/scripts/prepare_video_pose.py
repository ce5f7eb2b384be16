"""Offline DWPose preprocessing for SVI-Dance training (port of
scripts/prepare_video_pose.py).

    python -m svi_tpu_torch.scripts.prepare_video_pose --video_dir clips/ \
        --out_dir data/dance/ --det_onnx yolox_l.onnx --pose_onnx dw-ll_ucoco_384.onnx

For each video of --video_dir (mp4 / mov / avi / mkv, or an (N, H, W, 3)
uint8 .npy) and each of its frames: detect the people (YOLOX) and their
whole-body keypoints (DWPose), render the OpenPose skeleton, and write a
sample directory <out_dir>/<stem>/ with video.mp4 + dwpose.mp4
(`training.dataset.DanceVideoDataset`'s layout). Where no mp4 writer is
installed (neither imageio nor cv2) it writes video.npy + dwpose.npy, which
the dataset reads the same way. The ONNX graphs run through the port's
executor on the card unless --device cpu is given (it raises when no card
is present); no cv2 or onnxruntime is needed.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

VIDEO_SUFFIXES = (".mp4", ".mov", ".avi", ".mkv", ".npy")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--video_dir", type=str, required=True)
    p.add_argument("--out_dir", type=str, required=True)
    p.add_argument("--det_onnx", type=str, default="./weights/UniAnimate-DiT/yolox_l.onnx")
    p.add_argument("--pose_onnx", type=str, default="./weights/UniAnimate-DiT/dw-ll_ucoco_384.onnx")
    p.add_argument("--fps", type=int, default=25)
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def pose_to_draw(kpts: np.ndarray, scores: np.ndarray, h: int, w: int) -> dict:
    """Wholebody's (n, 134, 2) pixel keypoints and scores -> draw_pose_frame's
    dict, normalised (DWPose's 134: body 18 | feet 6 | face 68 | hands 2x21)."""
    norm = kpts / np.array([w, h], np.float32)
    return {"bodies": norm[:, :18], "body_scores": scores[:, :18],
            "hands": norm[:, 92:134].reshape(-1, 21, 2), "faces": norm[:, 24:92]}


def main(argv=None, device=None) -> dict:
    """Run the tool (device, when given, overrides --device); returns
    {stem: (frames, the files written)}."""
    from ..dwpose import Wholebody, draw_pose_frame
    from ..utils.video import load_video_frames
    from .make_toy_data import Writer
    from .test_svi import card_device

    args = parse_args(argv)
    device = card_device(args.device if device is None else device)
    extractor = Wholebody(args.det_onnx, args.pose_onnx, device=device)
    writer = Writer(pillow=False)
    os.makedirs(args.out_dir, exist_ok=True)
    done = {}
    for fname in sorted(os.listdir(args.video_dir)):
        if not fname.lower().endswith(VIDEO_SUFFIXES):
            continue
        stem = os.path.splitext(fname)[0]
        out = os.path.join(args.out_dir, stem)
        os.makedirs(out, exist_ok=True)
        frames = load_video_frames(os.path.join(args.video_dir, fname))
        h, w = frames[0].shape[:2]
        pose_frames = []
        for frame in frames:
            kpts, scores = extractor(frame)
            pose_frames.append(draw_pose_frame(pose_to_draw(kpts, scores, h, w), h, w))
        files = (writer.video(frames, os.path.join(out, "video.mp4"), fps=args.fps),
                 writer.video(pose_frames, os.path.join(out, "dwpose.mp4"), fps=args.fps))
        print(f"[{stem}] {len(frames)} frames -> {out} ({', '.join(files)})")
        done[stem] = (len(frames), files)
    return done


if __name__ == "__main__":
    main()
