"""DWPose's detector and pose-network steps around the ONNX sessions.

Port of svi_tpu/dwpose/onnx_infer.py: YOLOX-L person detection (keep-ratio
resize with 114 padding to 640x640, grid decode, person-class filter,
class-agnostic NMS) and top-down DWPose (box -> 288x384 affine crop, SimCC
argmax decode). The decode, NMS, box and SimCC steps are the JAX package's
numpy on the host, in its order; its two OpenCV calls are torch ops on the
session's device here (no cv2 on the pose path):

- `_preprocess_det`: cv2.resize(INTER_LINEAR) of the uint8 frame becomes a
  half-pixel bilinear resize without antialiasing, rounded to uint8;
- `_crop`: cv2.getAffineTransform + cv2.warpAffine (bilinear, constant 0
  border) becomes the same three-point transform, inverted as
  cv2.invertAffineTransform does, and a bilinear gather with zeros outside.

OpenCV computes both in fixed point (11-bit resize weights, warp
coordinates on a 1/32-pixel grid), so these differ from it by a level or a
few (tests/test_torch_dwpose.py holds the bounds).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.onnx_torch import InferenceSession

# mmpose's ImageNet normalisation of the pose network's input
_POSE_MEAN = (123.675, 116.28, 103.53)
_POSE_STD = (58.395, 57.12, 57.375)


def _device(session) -> torch.device:
    """Where a session's inputs are made: its device (the port's session),
    else the host (an onnxruntime session)."""
    return getattr(session, "device", torch.device("cpu"))


def _feed(session, x: torch.Tensor):
    """The port's session takes the device tensor; onnxruntime takes numpy."""
    return x if isinstance(session, InferenceSession) else x.cpu().numpy()


def _image(img, device) -> torch.Tensor:
    """An (H, W, 3) uint8 frame (numpy or tensor) on `device`."""
    if isinstance(img, torch.Tensor):
        return img.to(device)
    return torch.from_numpy(np.require(img, requirements=["C", "W"])).to(device)


def _round_u8(x: torch.Tensor) -> torch.Tensor:
    """f32 -> uint8, rounding halves up and saturating (as OpenCV's casts)."""
    return torch.floor(x + 0.5).clamp_(0, 255).to(torch.uint8)


def resize_linear_u8(img: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """cv2.resize(img, (width, height), interpolation=INTER_LINEAR) of an
    (H, W, C) uint8 tensor: half-pixel bilinear sampling with the source
    coordinate clamped at the borders, no antialiasing, rounded to uint8."""
    if tuple(img.shape[:2]) == (height, width):
        return img.clone()
    x = img.permute(2, 0, 1)[None].float()
    y = F.interpolate(x, size=(height, width), mode="bilinear", align_corners=False,
                      antialias=False)
    return _round_u8(y[0].permute(1, 2, 0))


def _preprocess_det(img, input_size=(640, 640), device=None):
    """-> ((1, 3, 640, 640) f32 on `device`, ratio): the frame resized to fit
    with its aspect kept, uint8 again, on a 114 canvas."""
    device = torch.device("cpu") if device is None else device
    img = _image(img, device)
    r = min(input_size[0] / img.shape[0], input_size[1] / img.shape[1])
    resized = resize_linear_u8(img, int(img.shape[0] * r), int(img.shape[1] * r))
    padded = torch.full((input_size[0], input_size[1], 3), 114, dtype=torch.uint8,
                        device=device)
    padded[: resized.shape[0], : resized.shape[1]] = resized
    return padded.permute(2, 0, 1)[None].float().contiguous(), r


def _yolox_decode(outputs: np.ndarray, input_size=(640, 640), p6=False):
    """Raw YOLOX head outputs -> absolute xywh boxes (standard grid decode)."""
    strides = [8, 16, 32] if not p6 else [8, 16, 32, 64]
    grids, expanded_strides = [], []
    hsizes = [input_size[0] // s for s in strides]
    wsizes = [input_size[1] // s for s in strides]
    for h, w, stride in zip(hsizes, wsizes, strides):
        xv, yv = np.meshgrid(np.arange(w), np.arange(h))
        grid = np.stack((xv, yv), 2).reshape(1, -1, 2)
        grids.append(grid)
        expanded_strides.append(np.full((*grid.shape[:2], 1), stride))
    grids = np.concatenate(grids, 1)
    expanded_strides = np.concatenate(expanded_strides, 1)
    outputs[..., :2] = (outputs[..., :2] + grids) * expanded_strides
    outputs[..., 2:4] = np.exp(outputs[..., 2:4]) * expanded_strides
    return outputs


def _nms(boxes, scores, iou_thr=0.45):
    x1, y1, x2, y2 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    areas = (x2 - x1 + 1) * (y2 - y1 + 1)
    order = scores.argsort()[::-1]
    keep = []
    while order.size > 0:
        i = order[0]
        keep.append(i)
        xx1 = np.maximum(x1[i], x1[order[1:]])
        yy1 = np.maximum(y1[i], y1[order[1:]])
        xx2 = np.minimum(x2[i], x2[order[1:]])
        yy2 = np.minimum(y2[i], y2[order[1:]])
        w = np.maximum(0.0, xx2 - xx1 + 1)
        h = np.maximum(0.0, yy2 - yy1 + 1)
        ovr = (w * h) / (areas[i] + areas[order[1:]] - w * h)
        order = order[np.where(ovr <= iou_thr)[0] + 1]
    return keep


def inference_detector(session, img, score_thr=0.3, nms_thr=0.45):
    """-> (n, 4) person boxes in image coords (x1, y1, x2, y2)."""
    inp, ratio = _preprocess_det(img, device=_device(session))
    out = session.run(None, {session.get_inputs()[0].name: _feed(session, inp)})[0]
    preds = _yolox_decode(out[0][None] if out.ndim == 2 else out)[0]
    boxes_xywh = preds[:, :4]
    scores = preds[:, 4:5] * preds[:, 5:]
    boxes = np.empty_like(boxes_xywh)
    boxes[:, 0] = boxes_xywh[:, 0] - boxes_xywh[:, 2] / 2
    boxes[:, 1] = boxes_xywh[:, 1] - boxes_xywh[:, 3] / 2
    boxes[:, 2] = boxes_xywh[:, 0] + boxes_xywh[:, 2] / 2
    boxes[:, 3] = boxes_xywh[:, 1] + boxes_xywh[:, 3] / 2
    boxes /= ratio
    cls_scores = scores[:, 0]  # person class
    valid = cls_scores > score_thr
    boxes, cls_scores = boxes[valid], cls_scores[valid]
    if len(boxes) == 0:
        return np.zeros((0, 4), np.float32)
    keep = _nms(boxes, cls_scores, nms_thr)
    return boxes[keep].astype(np.float32)


def _bbox_to_center_scale(bbox, padding=1.25):
    x1, y1, x2, y2 = bbox
    center = np.array([(x1 + x2) / 2, (y1 + y2) / 2], np.float32)
    scale = np.array([(x2 - x1), (y2 - y1)], np.float32) * padding
    return center, scale


def affine_from_points(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """cv2.getAffineTransform: the (2, 3) f64 map taking three src points to
    three dst points, from the same 6x6 system."""
    a = np.zeros((6, 6), np.float64)
    b = np.zeros(6, np.float64)
    for i in range(3):
        a[2 * i, 0:2] = a[2 * i + 1, 3:5] = src[i]
        a[2 * i, 2] = a[2 * i + 1, 5] = 1.0
        b[2 * i], b[2 * i + 1] = dst[i]
    return np.linalg.solve(a, b).reshape(2, 3)


def invert_affine(m: np.ndarray) -> np.ndarray:
    """cv2.invertAffineTransform."""
    d = m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22, a12, a21 = m[1, 1] * d, m[0, 0] * d, -m[0, 1] * d, -m[1, 0] * d
    b1 = -a11 * m[0, 2] - a12 * m[1, 2]
    b2 = -a21 * m[0, 2] - a22 * m[1, 2]
    return np.array([[a11, a12, b1], [a21, a22, b2]], np.float64)


def warp_affine_u8(img: torch.Tensor, m: np.ndarray, width: int, height: int) -> torch.Tensor:
    """cv2.warpAffine(img, m, (width, height)) of an (H, W, C) uint8 tensor:
    each output pixel samples the source at the inverse map's point,
    bilinearly, with zeros outside the source; rounded to uint8."""
    inv = torch.from_numpy(invert_affine(m)).to(img.device)
    ys, xs = torch.meshgrid(torch.arange(height, dtype=torch.float64, device=img.device),
                            torch.arange(width, dtype=torch.float64, device=img.device),
                            indexing="ij")
    sx = inv[0, 0] * xs + inv[0, 1] * ys + inv[0, 2]
    sy = inv[1, 0] * xs + inv[1, 1] * ys + inv[1, 2]
    x0, y0 = torch.floor(sx), torch.floor(sy)
    fx, fy = (sx - x0).float()[..., None], (sy - y0).float()[..., None]
    x0, y0 = x0.long(), y0.long()
    h, w = img.shape[:2]
    src = F.pad(img.permute(2, 0, 1).float(), (1, 1, 1, 1)).permute(1, 2, 0)  # zeros around

    def at(yy, xx):
        inside = (yy >= -1) & (yy <= h) & (xx >= -1) & (xx <= w)
        v = src[(yy + 1).clamp(0, h + 1), (xx + 1).clamp(0, w + 1)]
        return v * inside[..., None]

    out = ((1 - fy) * ((1 - fx) * at(y0, x0) + fx * at(y0, x0 + 1))
           + fy * ((1 - fx) * at(y0 + 1, x0) + fx * at(y0 + 1, x0 + 1)))
    return _round_u8(out)


def _crop(img, center, scale, out_size=(288, 384)):
    """Affine top-down crop with aspect fix (mmpose convention) -> the
    (h, w, 3) uint8 crop on the image's device and (sw, sh)."""
    w, h = out_size
    aspect = w / h
    sw, sh = scale
    if sw > aspect * sh:
        sh = sw / aspect
    else:
        sw = sh * aspect
    warp = affine_from_points(
        np.array([center - np.array([sw / 2, sh / 2]),
                  center + np.array([sw / 2, -sh / 2]),
                  center + np.array([sw / 2, sh / 2])], np.float32),
        np.array([[0, 0], [w, 0], [w, h]], np.float32),
    )
    return warp_affine_u8(img, warp, w, h), (sw, sh)


def inference_pose(session, det_boxes: np.ndarray, img, input_size=(288, 384),
                   simcc_ratio=2.0):
    """Top-down DWPose: per detected person, SimCC decode to image coords.
    -> keypoints (n, 133, 2), scores (n, 133)."""
    device = _device(session)
    img = _image(img, device)
    if len(det_boxes) == 0:
        det_boxes = np.array([[0, 0, img.shape[1], img.shape[0]]], np.float32)
    mean = torch.tensor(_POSE_MEAN, dtype=torch.float32, device=device)
    std = torch.tensor(_POSE_STD, dtype=torch.float32, device=device)
    all_kpts, all_scores = [], []
    for bbox in det_boxes:
        center, scale = _bbox_to_center_scale(bbox)
        crop, (sw, sh) = _crop(img, center, scale, input_size)
        inp = ((crop.float() - mean) / std).permute(2, 0, 1)[None].contiguous()
        simcc_x, simcc_y = session.run(None, {session.get_inputs()[0].name: _feed(session, inp)})
        # SimCC argmax decode
        x_locs = simcc_x[0].argmax(axis=1).astype(np.float32) / simcc_ratio
        y_locs = simcc_y[0].argmax(axis=1).astype(np.float32) / simcc_ratio
        conf = np.minimum(simcc_x[0].max(axis=1), simcc_y[0].max(axis=1))
        kpts = np.stack([x_locs, y_locs], axis=-1)
        # back to image coords
        kpts[:, 0] = kpts[:, 0] / input_size[0] * sw + center[0] - sw / 2
        kpts[:, 1] = kpts[:, 1] / input_size[1] * sh + center[1] - sh / 2
        all_kpts.append(kpts)
        all_scores.append(conf)
    return np.stack(all_kpts), np.stack(all_scores)
