"""OpenPose-style skeleton rendering for pose conditioning videos, without cv2.

Port of svi_tpu/dwpose/draw.py (`draw_body`, `draw_hands`, `draw_face`,
`draw_pose_frame`: the OpenPose 18-joint limb and colour scheme that
SVI-Dance's pose videos use). The JAX package draws with OpenCV; this
module rasterises the same shapes in numpy on the host with OpenCV's
integer rules, so that the card's machine needs no cv2:

- `ellipse2poly`: cv2.ellipse2Poly's vertices, 1 degree apart from its
  sine table (7 decimals), rounded half to even, repeats dropped;
- `fill_convex_poly`: cv2.fillConvexPoly's scanline fill in 16-bit fixed
  point, its outline drawn first (8-connected Bresenham lines, or the
  fixed-point line of a sub-pixel polygon);
- `circle`: cv2.circle(thickness=-1)'s midpoint spans;
- `line`: cv2.line(thickness=2): the fixed-point quad around the segment
  plus a radius-1 disc at each end.

tests/test_torch_dwpose.py holds the frames against the JAX package's cv2
rendering.
"""

from __future__ import annotations

import math

import numpy as np

EPS = 0.01

# OpenPose body-18 limb pairs (1-indexed, standard) + the standard color wheel.
LIMB_SEQ = [
    [2, 3], [2, 6], [3, 4], [4, 5], [6, 7], [7, 8], [2, 9], [9, 10],
    [10, 11], [2, 12], [12, 13], [13, 14], [2, 1], [1, 15], [15, 17],
    [1, 16], [16, 18],
]
COLORS = [
    [255, 0, 0], [255, 85, 0], [255, 170, 0], [255, 255, 0], [170, 255, 0],
    [85, 255, 0], [0, 255, 0], [0, 255, 85], [0, 255, 170], [0, 255, 255],
    [0, 170, 255], [0, 85, 255], [0, 0, 255], [85, 0, 255], [170, 0, 255],
    [255, 0, 255], [255, 0, 170], [255, 0, 85],
]
HAND_EDGES = [
    [0, 1], [1, 2], [2, 3], [3, 4], [0, 5], [5, 6], [6, 7], [7, 8],
    [0, 9], [9, 10], [10, 11], [11, 12], [0, 13], [13, 14], [14, 15],
    [15, 16], [0, 17], [17, 18], [18, 19], [19, 20],
]

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT
# OpenCV's sine table: sin of 0..450 degrees, single precision, 7 decimals
_SIN_TABLE = np.round(np.sin(np.deg2rad(np.arange(451, dtype=np.float64))), 7).astype(np.float32)


# ---------------------------------------------------------------------------
# OpenCV's rasteriser (drawing.cpp), integer for integer
# ---------------------------------------------------------------------------


def _cdiv(a: int, b: int) -> int:
    """C's integer division (truncation toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _hline(canvas, y: int, x1: int, x2: int, color) -> None:
    if x1 <= x2:
        canvas[y, x1:x2 + 1] = color


def _put(canvas, x: int, y: int, color) -> None:
    if 0 <= x < canvas.shape[1] and 0 <= y < canvas.shape[0]:
        canvas[y, x] = color


def _clip_line(w: int, h: int, x1: int, y1: int, x2: int, y2: int):
    """cv2.clipLine to [0, w-1] x [0, h-1]: the clipped ends, or None."""
    right, bottom = w - 1, h - 1
    if w <= 0 or h <= 0:
        return None
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * float(x2 - x1) / float(y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * float(x2 - x1) / float(y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * float(y2 - y1) / float(x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * float(y2 - y1) / float(x2 - x1))
                x2 = a
                c2 = 0
    if c1 | c2:
        return None
    return x1, y1, x2, y2


def _line8(canvas, x1: int, y1: int, x2: int, y2: int, color) -> None:
    """cv2.line's 8-connected Bresenham walk (LineIterator, left to right),
    clipped to the canvas first."""
    h, w = canvas.shape[:2]
    if not (0 <= x1 < w and 0 <= x2 < w and 0 <= y1 < h and 0 <= y2 < h):
        clipped = _clip_line(w, h, x1, y1, x2, y2)
        if clipped is None:
            return
        x1, y1, x2, y2 = clipped
    dx, dy = x2 - x1, y2 - y1
    if dx < 0:  # left to right
        dx, dy = -dx, -dy
        x1, y1, x2, y2 = x2, y2, x1, y1
    sx, sy = 1, 1
    if dy < 0:
        dy, sy = -dy, -1
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
    err = dx - 2 * dy
    x, y = x1, y1
    for _ in range(dx + 1):
        canvas[y, x] = color
        minor = err < 0
        err += -2 * dy + (2 * dx if minor else 0)
        if vert:
            y += sy
            x += sx if minor else 0
        else:
            x += sx
            y += sy if minor else 0


def _line2(canvas, x1: int, y1: int, x2: int, y2: int, color) -> None:
    """cv2's fixed-point (16-bit) line between sub-pixel points (Line2)."""
    h, w = canvas.shape[:2]
    clipped = _clip_line(w << XY_SHIFT, h << XY_SHIFT, x1, y1, x2, y2)
    if clipped is None:
        return
    x1, y1, x2, y2 = clipped
    dx, dy = x2 - x1, y2 - y1
    ax, ay = abs(dx), abs(dy)
    if ax > ay:
        if dx < 0:
            dy = -dy
            x1, y1, x2, y2 = x2, y2, x1, y1
        y_step = _cdiv(dy << XY_SHIFT, ax | 1)
        ecount = (x2 >> XY_SHIFT) - (x1 >> XY_SHIFT)
    else:
        if dy < 0:
            dx = -dx
            x1, y1, x2, y2 = x2, y2, x1, y1
        x_step = _cdiv(dx << XY_SHIFT, ay | 1)
        ecount = (y2 >> XY_SHIFT) - (y1 >> XY_SHIFT)
    x1 += XY_ONE >> 1
    y1 += XY_ONE >> 1
    _put(canvas, (x2 + (XY_ONE >> 1)) >> XY_SHIFT, (y2 + (XY_ONE >> 1)) >> XY_SHIFT, color)
    if ax > ay:
        x1 >>= XY_SHIFT
        while ecount >= 0:
            _put(canvas, x1, y1 >> XY_SHIFT, color)
            x1 += 1
            y1 += y_step
            ecount -= 1
    else:
        y1 >>= XY_SHIFT
        while ecount >= 0:
            _put(canvas, x1 >> XY_SHIFT, y1, color)
            x1 += x_step
            y1 += 1
            ecount -= 1


def fill_convex_poly(canvas: np.ndarray, pts, color, shift: int = 0) -> np.ndarray:
    """cv2.fillConvexPoly(canvas, pts, color) (8-connected, `shift`
    fractional bits): the outline, then the scanline fill between the left
    and right edges, inclusive."""
    v = [(int(x), int(y)) for x, y in pts]
    npts = len(v)
    h, w = canvas.shape[:2]
    delta = 1 << shift >> 1
    half = XY_ONE >> 1
    s = XY_SHIFT - shift
    p0 = (v[-1][0] << s, v[-1][1] << s)
    xmin = xmax = v[0][0]
    ymin = ymax = v[0][1]
    imin = 0
    for i, (px, py) in enumerate(v):
        if py < ymin:
            ymin, imin = py, i
        ymax, xmax, xmin = max(ymax, py), max(xmax, px), min(xmin, px)
        p = (px << s, py << s)
        if shift == 0:
            _line8(canvas, p0[0] >> XY_SHIFT, p0[1] >> XY_SHIFT, p[0] >> XY_SHIFT,
                   p[1] >> XY_SHIFT, color)
        else:
            _line2(canvas, p0[0], p0[1], p[0], p[1], color)
        p0 = p
    xmin, xmax = (xmin + delta) >> shift, (xmax + delta) >> shift
    ymin, ymax = (ymin + delta) >> shift, (ymax + delta) >> shift
    if npts < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return canvas
    ymax = min(ymax, h - 1)
    # per edge: [idx, di, x, dx, ye]
    edge = [[imin, 1, -XY_ONE, 0, ymin], [imin, npts - 1, -XY_ONE, 0, ymin]]
    edges = npts
    y = ymin
    while True:
        for e in edge:
            if y >= e[4]:
                idx0, di = e[0], e[1]
                idx = idx0 + di
                if idx >= npts:
                    idx -= npts
                while edges > 0:
                    edges -= 1
                    ty = (v[idx][1] + delta) >> shift
                    if ty > y:
                        xs, xe = v[idx0][0] << s, v[idx][0] << s
                        e[4] = ty
                        e[3] = _cdiv((xe - xs) * 2 + (ty - y), 2 * (ty - y))
                        e[2] = xs
                        e[0] = idx
                        break
                    idx0 = idx
                    idx += di
                    if idx >= npts:
                        idx -= npts
                else:
                    edges -= 1
        if edges < 0:
            break
        if y >= 0:
            left, right = (1, 0) if edge[0][2] > edge[1][2] else (0, 1)
            xx1 = (edge[left][2] + half) >> XY_SHIFT
            xx2 = (edge[right][2] + half) >> XY_SHIFT
            if xx2 >= 0 and xx1 < w:
                _hline(canvas, y, max(xx1, 0), min(xx2, w - 1), color)
        else:  # rows above the canvas: step straight to row 0 or the next vertex
            skip = min(0, edge[0][4], edge[1][4]) - y - 1
            if skip > 0:
                edge[0][2] += edge[0][3] * skip
                edge[1][2] += edge[1][3] * skip
                y += skip
        edge[0][2] += edge[0][3]
        edge[1][2] += edge[1][3]
        y += 1
        if y > ymax:
            break
    return canvas


def circle(canvas: np.ndarray, center, radius: int, color) -> np.ndarray:
    """cv2.circle(canvas, center, radius, color, thickness=-1): the
    midpoint circle's horizontal spans, clipped to the canvas."""
    h, w = canvas.shape[:2]
    cx, cy = int(center[0]), int(center[1])
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    inside = radius <= cx < w - radius and radius <= cy < h - radius
    while dx >= dy:
        y11, y12, y21, y22 = cy - dy, cy + dy, cy - dx, cy + dx
        x11, x12, x21, x22 = cx - dx, cx + dx, cx - dy, cx + dy
        if inside:
            for yy, (xa, xb) in ((y11, (x11, x12)), (y12, (x11, x12)), (y21, (x21, x22)),
                                 (y22, (x21, x22))):
                _hline(canvas, yy, xa, xb, color)
        elif x11 < w and x12 >= 0 and y21 < h and y22 >= 0:
            x11, x12 = max(x11, 0), min(x12, w - 1)
            for yy in (y11, y12):
                if 0 <= yy < h:
                    _hline(canvas, yy, x11, x12, color)
            if x21 < w and x22 >= 0:
                x21, x22 = max(x21, 0), min(x22, w - 1)
                for yy in (y21, y22):
                    if 0 <= yy < h:
                        _hline(canvas, yy, x21, x22, color)
        dy += 1
        err += plus
        plus += 2
        mask = 0 if err <= 0 else -1
        err -= minus & mask
        dx += mask
        minus -= mask & 2
    return canvas


def line(canvas: np.ndarray, p1, p2, color, thickness: int = 2) -> np.ndarray:
    """cv2.line(canvas, p1, p2, color, thickness) for thickness > 1 (8-connected,
    no shift): the quad of half-width thickness/2 in 16-bit fixed point and
    a filled disc at each end."""
    x0, y0 = int(p1[0]) << XY_SHIFT, int(p1[1]) << XY_SHIFT
    x1, y1 = int(p2[0]) << XY_SHIFT, int(p2[1]) << XY_SHIFT
    dx, dy = (x0 - x1) / XY_ONE, (y1 - y0) / XY_ONE
    r = dx * dx + dy * dy
    odd = thickness & 1
    half = thickness << (XY_SHIFT - 1)
    if abs(r) > np.finfo(np.float64).eps:
        r = (half + odd * XY_ONE * 0.5) / math.sqrt(r)
        dpx, dpy = round(dy * r), round(dx * r)
        fill_convex_poly(canvas, [(x0 + dpx, y0 + dpy), (x0 - dpx, y0 - dpy),
                                  (x1 - dpx, y1 - dpy), (x1 + dpx, y1 + dpy)], color,
                         shift=XY_SHIFT)
    for px, py in ((x0, y0), (x1, y1)):
        circle(canvas, ((px + (XY_ONE >> 1)) >> XY_SHIFT, (py + (XY_ONE >> 1)) >> XY_SHIFT),
               (half + (XY_ONE >> 1)) >> XY_SHIFT, color)
    return canvas


def ellipse2poly(center, axes, angle: int, arc_start: int = 0, arc_end: int = 360,
                 delta: int = 1) -> np.ndarray:
    """cv2.ellipse2Poly with integer arguments -> (n, 2) int32 vertices."""
    angle = int(angle)
    while angle < 0:
        angle += 360
    while angle > 360:
        angle -= 360
    if arc_start > arc_end:
        arc_start, arc_end = arc_end, arc_start
    while arc_start < 0:
        arc_start, arc_end = arc_start + 360, arc_end + 360
    while arc_end > 360:
        arc_start, arc_end = arc_start - 360, arc_end - 360
    if arc_end - arc_start > 360:
        arc_start, arc_end = 0, 360
    alpha, beta = float(_SIN_TABLE[450 - angle]), float(_SIN_TABLE[angle])  # cos, sin
    cx, cy = float(center[0]), float(center[1])
    pts, prev = [], None
    for i in range(arc_start, arc_end + delta, delta):
        a = min(i, arc_end)
        if a < 0:
            a += 360
        x = axes[0] * float(_SIN_TABLE[450 - a])
        y = axes[1] * float(_SIN_TABLE[a])
        pt = (round(cx + x * alpha - y * beta), round(cy + x * beta + y * alpha))
        if pt != prev:
            pts.append(pt)
            prev = pt
    if len(pts) == 1:
        pts = [(int(center[0]), int(center[1]))] * 2
    return np.asarray(pts, np.int32)


# ---------------------------------------------------------------------------
# the skeleton, as the JAX package draws it
# ---------------------------------------------------------------------------


def draw_body(canvas: np.ndarray, body_kpts: np.ndarray, body_scores: np.ndarray,
              stickwidth: int = 4, conf_thr: float = 0.3) -> np.ndarray:
    """body_kpts: (n, 18, 2) normalized [0,1]; draws limbs then joints."""
    H, W = canvas.shape[:2]
    for person, score in zip(body_kpts, body_scores):
        for limb, color in zip(LIMB_SEQ, COLORS[: len(LIMB_SEQ)]):
            a, b = limb[0] - 1, limb[1] - 1
            if score[a] < conf_thr or score[b] < conf_thr:
                continue
            y = person[[a, b], 0] * W
            x = person[[a, b], 1] * H
            mx, my = x.mean(), y.mean()
            length = ((x[0] - x[1]) ** 2 + (y[0] - y[1]) ** 2) ** 0.5
            angle = math.degrees(math.atan2(x[0] - x[1], y[0] - y[1]))
            poly = ellipse2poly((int(my), int(mx)), (int(length / 2), stickwidth), int(angle),
                                0, 360, 1)
            fill_convex_poly(canvas, poly, [int(c * 0.6) for c in color])
        for j in range(18):
            if score[j] < conf_thr:
                continue
            x, y = person[j]
            circle(canvas, (int(x * W), int(y * H)), 4, COLORS[j % len(COLORS)])
    return canvas


def draw_hands(canvas: np.ndarray, hands: np.ndarray) -> np.ndarray:
    """hands: (m, 21, 2) normalized; standard HSV-cycled edges."""
    H, W = canvas.shape[:2]
    for peaks in hands:
        for ie, (e0, e1) in enumerate(HAND_EDGES):
            x1, y1 = peaks[e0]
            x2, y2 = peaks[e1]
            if min(x1, y1, x2, y2) < EPS:
                continue
            rgb = [int(c * 255) for c in _hsv_to_rgb(ie / len(HAND_EDGES), 1.0, 1.0)]
            line(canvas, (int(x1 * W), int(y1 * H)), (int(x2 * W), int(y2 * H)), rgb,
                 thickness=2)
        for x, y in peaks:
            if min(x, y) > EPS:
                circle(canvas, (int(x * W), int(y * H)), 4, (0, 0, 255))
    return canvas


def draw_face(canvas: np.ndarray, faces: np.ndarray) -> np.ndarray:
    H, W = canvas.shape[:2]
    for lmks in faces:
        for x, y in lmks:
            if min(x, y) > EPS:
                circle(canvas, (int(x * W), int(y * H)), 3, (255, 255, 255))
    return canvas


def _hsv_to_rgb(h, s, v):
    import colorsys

    return colorsys.hsv_to_rgb(h, s, v)


def draw_pose_frame(pose: dict, height: int, width: int, draw_face_pts: bool = False) -> np.ndarray:
    """pose dict with normalized coords: {'bodies': (n,18,2), 'body_scores':
    (n,18), 'hands': (m,21,2), 'faces': (k,68,2)} -> HWC uint8 canvas."""
    canvas = np.zeros((height, width, 3), np.uint8)
    if "bodies" in pose and len(pose["bodies"]):
        canvas = draw_body(canvas, np.asarray(pose["bodies"]), np.asarray(pose["body_scores"]))
    if "hands" in pose and len(pose["hands"]):
        canvas = draw_hands(canvas, np.asarray(pose["hands"]))
    if draw_face_pts and "faces" in pose and len(pose["faces"]):
        canvas = draw_face(canvas, np.asarray(pose["faces"]))
    return canvas
