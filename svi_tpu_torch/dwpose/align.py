"""Pose retargeting / alignment for SVI-Dance data preparation.

A copy of svi_tpu/dwpose/align.py (pure numpy, held to it by
tests/test_torch_dwpose.py), kept in the port so that it reads no module
of the JAX package. Given a driving video's per-frame DWPose skeletons and
one reference image's skeleton, every frame's skeleton is warped to the
reference person's body proportions:

  1. a global x scale from the shoulder width and a y scale from the torso
     height;
  2. per-limb length corrections, with ratios measured once between the
     scaled first frame and the reference, applied per frame along each
     kinematic chain together with the attached hands;
  3. a global translation that puts the corrected first frame's neck
     (joint 1) on the reference neck, applied to every frame.

Joint order is OpenPose body-18 plus two synthetic foot centers at 18/19.
All coordinates normalized to [0,1].
"""

from __future__ import annotations

import copy
import math

import numpy as np

# (ratio name, (anchor, end), body joints moved, hand indices moved)
# offset = (joint[anchor] - joint[end]) * (1 - ratio); ratio = |ref anchor-end|
# / |frame0 anchor-end|. Order matters: later steps see earlier corrections.
_CHAIN = [
    ("neck", (1, 0), [0, 14, 15, 16, 17], []),
    ("shoulder2", (1, 2), [2, 3, 4], [1]),
    ("shoulder5", (1, 5), [5, 6, 7], [0]),
    ("arm3", (2, 3), [3, 4], [1]),
    ("arm4", (3, 4), [4], [1]),
    ("arm6", (5, 6), [6, 7], [0]),
    ("arm7", (6, 7), [7], [0]),
    ("head14", (0, 14), [14, 16], []),
    ("head15", (0, 15), [15, 17], []),
    ("head16", (14, 16), [16], []),
    ("head17", (15, 17), [17], []),
    ("ll1", (8, 9), [9, 10, 19], []),
    ("ll2", (9, 10), [10, 19], []),
    ("rl1", (11, 12), [12, 13, 18], []),
    ("rl2", (12, 13), [13, 18], []),
]


def pose_from_openpose(keypoints: np.ndarray, scores: np.ndarray, H: int, W: int) -> dict:
    """(n, 134, 2) pixel keypoints + scores (wholebody.keypoints_to_openpose)
    -> the reference pose dict for person 0 (ref DWposeDetector :98-166):
    bodies.candidate (20,2) normalized with synthetic foot centers, hands
    (2,21,2), faces (1,68,2); joints below score 0.3 are -1."""
    cand = keypoints[0:1].astype(np.float64).copy()
    sub = scores[0:1].astype(np.float64).copy()
    cand[..., 0] /= float(W)
    cand[..., 1] /= float(H)
    cand[sub < 0.3] = -1.0

    bodyfoot = cand[0, :24].copy()
    bodyfoot_score = sub[0, :24].copy()
    # foot centers: 18 <- mean(18,19), 19 <- mean(21,22) (ref :129-152)
    if -1.0 not in bodyfoot[18] and -1.0 not in bodyfoot[19]:
        bodyfoot[18] = (bodyfoot[18] + bodyfoot[19]) / 2
    else:
        bodyfoot[18] = np.array([-1.0, -1.0])
    if -1.0 not in bodyfoot[21] and -1.0 not in bodyfoot[22]:
        bodyfoot[19] = (bodyfoot[21] + bodyfoot[22]) / 2
    else:
        bodyfoot[19] = np.array([-1.0, -1.0])
    subset = np.where(bodyfoot_score[:20] > 0.3, np.arange(20, dtype=np.float64), -1.0)

    faces = cand[:, 24:92][0:1]
    hands = np.concatenate([cand[:, 92:113], cand[:, 113:134]], axis=0)
    return {
        "bodies": {"candidate": bodyfoot[:20], "subset": subset[None]},
        "hands": hands,
        "faces": faces,
    }


def _dist(c, a, b):
    return math.hypot(c[a][0] - c[b][0], c[a][1] - c[b][1])


def compute_retarget_params(pose0: dict, pose_ref: dict) -> dict:
    """Global x/y scale + per-limb length ratios (ref :254-289 etc.).

    Ratios are measured between the reference skeleton and the SCALED first
    frame (the reference aliases the frame-0 array, so its in-place global
    scaling happens before any ratio is read)."""
    c0 = np.asarray(pose0["bodies"]["candidate"], np.float64)
    cr = np.asarray(pose_ref["bodies"]["candidate"], np.float64)
    x_ratio = (cr[5][0] - cr[2][0]) / (c0[5][0] - c0[2][0])
    ref_c1 = 0.5 * (cr[2] + cr[5])
    ref_c2 = 0.5 * (cr[8] + cr[11])
    z_c1 = 0.5 * (c0[2] + c0[5])
    z_c2 = 0.5 * (c0[8] + c0[11])
    y_ratio = (ref_c2[1] - ref_c1[1]) / (z_c2[1] - z_c1[1])

    cs = c0.copy()
    cs[:, 0] *= x_ratio
    cs[:, 1] *= y_ratio
    params = {"x_ratio": x_ratio, "y_ratio": y_ratio}
    for name, (a, b), _, _ in _CHAIN:
        params[name] = _dist(cr, a, b) / max(_dist(cs, a, b), 1e-12)
    return params


def retarget_pose(pose: dict, params: dict) -> dict:
    """Scale + sequential chain corrections for one frame (the per-frame body
    of ref :545-692; frame 0 goes through the identical math :279-507)."""
    out = copy.deepcopy(pose)
    cand = np.asarray(out["bodies"]["candidate"], np.float64)
    faces = np.asarray(out["faces"], np.float64)
    hands = np.asarray(out["hands"], np.float64)
    cand[:, 0] *= params["x_ratio"]
    cand[:, 1] *= params["y_ratio"]
    faces[..., 0] *= params["x_ratio"]
    faces[..., 1] *= params["y_ratio"]
    hands[..., 0] *= params["x_ratio"]
    hands[..., 1] *= params["y_ratio"]

    for name, (a, b), body_targets, hand_targets in _CHAIN:
        off = (cand[a] - cand[b]) * (1.0 - params[name])
        cand[body_targets] += off
        for h in hand_targets:
            hands[h] += off

    out["bodies"]["candidate"] = cand
    out["faces"] = faces
    out["hands"] = hands
    return out


def align_pose_sequence(poses: list[dict], pose_ref: dict) -> list[dict]:
    """Retarget every frame to the reference proportions and translate the
    whole sequence so frame 0's neck lands on the reference neck
    (ref mp_main :243-693). Returns new pose dicts."""
    if not poses:
        return []
    params = compute_retarget_params(poses[0], pose_ref)
    aligned = [retarget_pose(p, params) for p in poses]
    cr = np.asarray(pose_ref["bodies"]["candidate"], np.float64)
    offset = cr[1] - aligned[0]["bodies"]["candidate"][1]
    for p in aligned:
        p["bodies"]["candidate"] = p["bodies"]["candidate"] + offset
        p["faces"] = p["faces"] + offset
        p["hands"] = p["hands"] + offset
    return aligned


# ---------------------------------------------------------------------------
# One Euro filter (ref :36-78) — optional keypoint smoothing
# ---------------------------------------------------------------------------


def _smoothing_factor(t_e, cutoff):
    r = 2 * math.pi * cutoff * t_e
    return r / (r + 1)


class OneEuroFilter:
    """Jitter-adaptive exponential smoothing of a keypoint signal
    (ref :45-78)."""

    def __init__(self, t0, x0, dx0=0.0, min_cutoff=1.0, beta=0.0, d_cutoff=1.0):
        self.min_cutoff = float(min_cutoff)
        self.beta = float(beta)
        self.d_cutoff = float(d_cutoff)
        self.x_prev = np.asarray(x0, np.float64)
        self.dx_prev = np.full_like(self.x_prev, float(dx0))
        self.t_prev = float(t0)

    def __call__(self, t, x):
        x = np.asarray(x, np.float64)
        t_e = t - self.t_prev
        a_d = _smoothing_factor(t_e, self.d_cutoff)
        dx = (x - self.x_prev) / t_e
        dx_hat = a_d * dx + (1 - a_d) * self.dx_prev
        cutoff = self.min_cutoff + self.beta * np.abs(dx_hat)
        a = _smoothing_factor(t_e, cutoff)
        x_hat = a * x + (1 - a) * self.x_prev
        self.x_prev = x_hat
        self.dx_prev = dx_hat
        self.t_prev = t
        return x_hat
