"""Pose alignment / retargeting driver (port of scripts/run_align_pose.py).

    python -m svi_tpu_torch.scripts.run_align_pose --ref_name ref.jpg \
        --source_video_paths dance.mp4 --saved_pose_dir poses/

Extracts DWPose skeletons from a driving video (or every video of a
directory) with the port's ONNX executor, retargets every frame to the
reference image's body proportions (`dwpose.align`) and writes the rendered
skeleton frames 0000.jpg, 0001.jpg, ... and pose.jpg (the reference's) that
SVI-Dance's data pipeline reads. Without Pillow the reference image is read
from an (H, W, 3) uint8 .npy and the frames are written as .npy files of
the same names. Runs on the card unless --device cpu is given (it raises
when no card is present); no cv2 or onnxruntime is needed.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="DWPose extraction + retargeting")
    p.add_argument("--ref_name", type=str, required=True, help="reference image")
    p.add_argument("--source_video_paths", type=str, required=True,
                   help="driving video (.mp4, or an (N, H, W, 3) uint8 .npy) or a directory "
                        "of videos")
    p.add_argument("--saved_pose_dir", type=str, required=True)
    p.add_argument("--det_onnx", type=str, default="./weights/UniAnimate-DiT/yolox_l.onnx")
    p.add_argument("--pose_onnx", type=str, default="./weights/UniAnimate-DiT/dw-ll_ucoco_384.onnx")
    p.add_argument("--height", type=int, default=768, help="render height (ref: 768)")
    p.add_argument("--width", type=int, default=512, help="render width (ref: 512)")
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def load_image(path: str, pillow: bool) -> np.ndarray:
    """The reference image as (H, W, 3) uint8 RGB: a .npy as it is, else
    through Pillow."""
    if path.endswith(".npy"):
        img = np.load(path)
        if img.dtype != np.uint8 or img.ndim != 3 or img.shape[-1] != 3:
            raise ValueError(f"{path}: {img.shape} {img.dtype}, expected (H, W, 3) uint8")
        return img
    if not pillow:
        raise RuntimeError(f"cannot read {path}: Pillow is not installed; pass the reference "
                           "image as an (H, W, 3) uint8 .npy")
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"))


def _to_draw_dict(pose):
    """align.py pose dict -> draw.draw_pose_frame inputs (body-18 subset)."""
    cand = np.asarray(pose["bodies"]["candidate"])[None, :18]
    subset = np.asarray(pose["bodies"]["subset"])[:, :18]
    return {
        "bodies": cand,
        "body_scores": np.where(subset >= 0, 1.0, -1.0),
        "hands": np.asarray(pose["hands"]),
        "faces": np.asarray(pose["faces"]),
    }


def main(argv=None, device=None) -> dict:
    """Run the tool (device, when given, overrides --device); returns
    {"aligned": the aligned pose dicts, "ref": the reference's, "files": the
    names written}."""
    from ..dwpose.align import align_pose_sequence, pose_from_openpose
    from ..dwpose.draw import draw_pose_frame
    from ..dwpose.wholebody import Wholebody
    from ..utils.video import load_video_frames
    from .make_toy_data import Writer
    from .test_svi import card_device

    args = parse_args(argv)
    writer = Writer(videos=False)  # the frames through Pillow, else .npy
    device = card_device(args.device if device is None else device)
    if args.source_video_paths.endswith((".mp4", ".npy")):
        video_paths = [args.source_video_paths]
    else:
        video_paths = [os.path.join(args.source_video_paths, f)
                       for f in sorted(os.listdir(args.source_video_paths))]

    model = Wholebody(det_onnx=args.det_onnx, pose_onnx=args.pose_onnx, device=device)

    poses = []
    for path in video_paths:
        print(f"extracting poses: {path}")
        for frame in load_video_frames(path):
            kpts, scores = model(frame[..., :3])
            poses.append(pose_from_openpose(kpts, scores, frame.shape[0], frame.shape[1]))

    ref_img = load_image(args.ref_name, writer.pillow)
    kpts, scores = model(ref_img)
    pose_ref = pose_from_openpose(kpts, scores, ref_img.shape[0], ref_img.shape[1])

    aligned = align_pose_sequence(poses, pose_ref)

    os.makedirs(args.saved_pose_dir, exist_ok=True)
    H, W = args.height, args.width
    files = [writer.image(draw_pose_frame(_to_draw_dict(pose), H, W),
                          os.path.join(args.saved_pose_dir, f"{i:04d}.jpg"))
             for i, pose in enumerate(aligned)]
    files.append(writer.image(draw_pose_frame(_to_draw_dict(pose_ref), H, W),
                              os.path.join(args.saved_pose_dir, "pose.jpg")))
    print(f"wrote {len(aligned)} aligned pose frames to {args.saved_pose_dir}")
    return {"aligned": aligned, "ref": pose_ref, "files": files}


if __name__ == "__main__":
    main()
