"""DWPose whole-body keypoint extraction (offline data preprocessing).

Port of svi_tpu/dwpose/wholebody.py: YOLOX-L person detection and DWPose
133-keypoint estimation over two ONNX graphs, then the COCO -> OpenPose
joint conversion (neck = mean of the shoulders, index remap).

The graphs run through the port's ONNX executor (`utils.onnx_torch`) on the
card by default (`engine="torch"`, `device="cuda"`; it raises without CUDA
unless `device="cpu"`), so extraction needs neither onnxruntime nor cv2.
`engine="ort"` is onnxruntime (an ImportError without it); `engine="auto"`
keeps the JAX package's meaning when a caller names it: onnxruntime when it
is installed, else the executor. The JAX package's default is "auto",
whose onnxruntime default providers are the CPU's: on the card that would
be a silent CPU run, so the port's default is the executor on the card
(ROADMAP records the changed default).
"""

from __future__ import annotations

import numpy as np

# COCO (mmpose) -> OpenPose body-18 conversion (standard mapping).
_MMPOSE_IDX = [17, 6, 8, 10, 7, 9, 12, 14, 16, 13, 15, 2, 1, 4, 3]
_OPENPOSE_IDX = [1, 2, 3, 4, 6, 7, 8, 9, 10, 12, 13, 14, 15, 16, 17]

ENGINES = ("torch", "ort", "auto")


def keypoints_to_openpose(keypoints: np.ndarray, scores: np.ndarray):
    """(n, 133, 2) keypoints + (n, 133) scores -> OpenPose-ordered
    (n, 134, 2)/(n, 134) with the synthetic neck joint inserted at 17."""
    info = np.concatenate([keypoints, scores[..., None]], axis=-1)  # (n,133,3)
    neck = info[:, [5, 6]].mean(axis=1)
    neck[:, 2] = np.logical_and(info[:, 5, 2] > 0.3, info[:, 6, 2] > 0.3).astype(info.dtype)
    info = np.insert(info, 17, neck, axis=1)  # (n,134,3)
    out = info.copy()
    out[:, _OPENPOSE_IDX] = info[:, _MMPOSE_IDX]
    return out[..., :2], out[..., 2]


class Wholebody:
    """The detector and pose sessions and the per-frame pipeline."""

    def __init__(self, det_onnx="./weights/UniAnimate-DiT/yolox_l.onnx",
                 pose_onnx="./weights/UniAnimate-DiT/dw-ll_ucoco_384.onnx",
                 providers=("CPUExecutionProvider",), engine="torch", device="cuda"):
        """engine: 'torch' (utils.onnx_torch on `device`), 'ort'
        (onnxruntime with `providers`) or 'auto' (onnxruntime if installed,
        else 'torch')."""
        if engine not in ENGINES:
            raise ValueError(f"engine={engine!r}; choose from {ENGINES}")
        ort = None
        if engine in ("auto", "ort"):
            try:
                import onnxruntime as ort  # noqa: F811
            except ImportError:
                if engine == "ort":
                    raise
        if ort is not None:
            mk = lambda p: ort.InferenceSession(p, providers=list(providers))  # noqa: E731
        else:
            from ..utils import onnx_torch

            device = onnx_torch.session_device(device)
            mk = lambda p: onnx_torch.InferenceSession(p, device=device)  # noqa: E731
        self.session_det = mk(det_onnx)
        self.session_pose = mk(pose_onnx)

    def __call__(self, frame_rgb):
        """An (H, W, 3) uint8 RGB frame -> OpenPose-ordered keypoints
        (n, 134, 2) in pixels and scores (n, 134)."""
        from . import onnx_infer

        img = onnx_infer._image(frame_rgb, onnx_infer._device(self.session_det))  # one upload
        det = onnx_infer.inference_detector(self.session_det, img)
        keypoints, scores = onnx_infer.inference_pose(self.session_pose, det, img)
        return keypoints_to_openpose(keypoints, scores)
