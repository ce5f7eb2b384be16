"""Curate Mixkit-style clips into a training set (port of
scripts/process_mixkit.py). Host only.

    python -m svi_tpu_torch.scripts.process_mixkit --input_dir raw/ \
        --output_dir data/train/ [--caption_dir captions/]

Keeps the clips of about 16:9 (within 10%) that have at least --num_frames
frames, cut to the first --num_frames, resized to --width x --height, in
<output_dir>/<category>/, with <category>.csv of their captions when
--caption_dir is given: the layout `training.dataset.TextVideoDataset`
reads. mp4 / mov / avi / mkv clips are read, resized (INTER_AREA) and
written through OpenCV and the port's video writer, as the JAX script does,
and need cv2 (the tool raises a clear error without it); (N, H, W, 3) uint8
.npy clips need no decoder: they are resized by area averaging in torch and
written as .npy.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch
import torch.nn.functional as F

VIDEO_SUFFIXES = (".mp4", ".mov", ".avi", ".mkv")


def is_16_9_ratio(width: int, height: int, tolerance: float = 0.1) -> bool:
    target = 16 / 9
    return abs(width / height - target) <= target * tolerance


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--input_dir", type=str, required=True)
    p.add_argument("--output_dir", type=str, required=True)
    p.add_argument("--caption_dir", type=str, default=None)
    p.add_argument("--width", type=int, default=832)
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--fps", type=int, default=16)
    p.add_argument("--num_frames", type=int, default=81)
    p.add_argument("--category", type=str, default="mixkit")
    return p.parse_args(argv)


def _cv2(path: str):
    try:
        import cv2
    except ImportError as err:
        raise RuntimeError(f"{path}: reading and resizing this video needs OpenCV (cv2), which "
                           "is not installed; give the clips as (N, H, W, 3) uint8 .npy files "
                           "instead") from err
    return cv2


def resize_area(frames: np.ndarray, width: int, height: int) -> np.ndarray:
    """(N, H, W, 3) uint8 -> (N, height, width, 3) uint8 by area averaging."""
    x = torch.from_numpy(np.array(frames)).permute(0, 3, 1, 2).float()
    y = F.interpolate(x, size=(height, width), mode="area")
    return y.round().clamp_(0, 255).to(torch.uint8).permute(0, 2, 3, 1).numpy()


def curate(path: str, out_path: str, args) -> bool:
    """One clip -> out_path when it is kept; returns whether it was."""
    from ..utils.video import load_video_frames, open_npy_video, save_video

    if path.endswith(".npy"):
        video = open_npy_video(path)
        if not is_16_9_ratio(video.shape[2], video.shape[1]) or len(video) < args.num_frames:
            return False
        np.save(out_path, resize_area(video[:args.num_frames], args.width, args.height))
        return True
    cv2 = _cv2(path)
    cap = cv2.VideoCapture(path)
    w, h = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)), int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
    cap.release()
    if not is_16_9_ratio(w, h):
        return False
    frames = load_video_frames(path)[:args.num_frames]
    if len(frames) < args.num_frames:
        return False
    save_video([cv2.resize(f, (args.width, args.height), interpolation=cv2.INTER_AREA)
                for f in frames], out_path, fps=args.fps)
    return True


def main(argv=None) -> tuple[int, int]:
    """Run the tool; returns (kept, skipped)."""
    from ..utils.project_utils import generate_metadata_with_captions

    args = parse_args(argv)
    out_cat = os.path.join(args.output_dir, args.category)
    os.makedirs(out_cat, exist_ok=True)
    kept, skipped = 0, 0
    for fname in sorted(os.listdir(args.input_dir)):
        if not fname.lower().endswith(VIDEO_SUFFIXES + (".npy",)):
            continue
        if curate(os.path.join(args.input_dir, fname), os.path.join(out_cat, fname), args):
            kept += 1
        else:
            skipped += 1
    if args.caption_dir:
        generate_metadata_with_captions(out_cat, args.caption_dir,
                                        os.path.join(out_cat, f"{args.category}.csv"))
    print(f"kept {kept}, skipped {skipped} -> {out_cat}")
    return kept, skipped


if __name__ == "__main__":
    main()
