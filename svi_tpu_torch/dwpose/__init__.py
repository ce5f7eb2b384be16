"""DWPose extraction, skeleton rendering and pose alignment (port of
svi_tpu/dwpose/), with no cv2 and no onnxruntime on its default path."""

from .draw import draw_pose_frame
from .wholebody import Wholebody, keypoints_to_openpose

__all__ = ["Wholebody", "keypoints_to_openpose", "draw_pose_frame"]
