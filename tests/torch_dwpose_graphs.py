"""ONNX graphs for the pose path, built from seeded weights with the port's
writer (svi_tpu_torch.utils.onnx_torch.build_model); imports no JAX.

- `synthetic_det_graph`, `synthetic_pose_graph`: the fixtures of
  tests/test_dwpose.py (a constant YOLOX-shaped output with one person, a
  one-hot SimCC output that depends on the input only through a zero
  product), so that boxes and keypoints are exact;
- `crop_pose_graph`: a SimCC graph whose rows depend on the crop's pixels;
- `yolox(depth, width, size)`: YOLOX as Megvii's ONNX export lays it out
  (CSPDarknet with Focus and SPP, the PAFPN, the decoupled head with the
  objectness and class sigmoids applied, output (1, anchors, 85)); at
  depth 1.0, width 1.0 and 640x640 it is YOLOX-L, the detector of DWPose
  (mmdetection's configs/yolox/yolox_l_8xb8-300e_coco.py: deepen_factor
  1.0, widen_factor 1.0, neck out 256, 3 CSP blocks, head 256 wide with 2
  stacked convs; BN folded into the convs as the export does);
- `rtmpose(depth, width, size)`: RTMPose's top-down network: a CSPNeXt P5
  backbone (3-conv stem, stages of 3/6/6/3 CSPNeXt blocks with 5x5
  depthwise convs and channel attention, SPPF in the last stage) and the
  RTMCC head (7x7 conv to 133 keypoints, ScaleNorm + linear to 256, one
  gated attention unit with s=128 and expansion 2, SimCC linears of
  split ratio 2); at depth 1.0, width 1.0 and 384x288 it is DWPose-l
  (mmpose's configs/wholebody_2d_keypoint/rtmpose/cocktail13/
  rtmpose-l_8xb64-270e_coco-wholebody-384x288.py, the network of DWPose's
  dw-ll_ucoco_384.onnx), outputs simcc_x (1, 133, 576), simcc_y
  (1, 133, 768).

`yolox` and `rtmpose` return (model bytes, stats): the op count and the
FLOPs counted from the shapes (2 per multiply-add of the convolutions and matmuls;
elementwise work not counted).
"""

from __future__ import annotations

import math

import numpy as np

from svi_tpu_torch.utils.onnx_torch import build_model

# ---------------------------------------------------------------------------
# the fixtures
# ---------------------------------------------------------------------------

N_ANCHORS_640 = 80 * 80 + 40 * 40 + 20 * 20
SIMCC_W, SIMCC_H = 288 * 2, 384 * 2


def synthetic_det_graph() -> bytes:
    """A YOLOX-shaped detector that ignores the image: one confident person
    at grid cell (10, 10) of stride 8 (tests/test_dwpose.py's)."""
    det_out = np.zeros((1, N_ANCHORS_640, 6), np.float32)
    det_out[0, 10 * 80 + 10] = [10.0, 10.0, 3.0, 3.5, 5.0, 5.0]
    nodes = [("Shape", ["images"], ["shp"], {}), ("Identity", ["det_const"], ["output"], {})]
    return build_model(nodes, {"det_const": det_out}, ["images"], ["output"])


def synthetic_pose_graph() -> bytes:
    """One-hot SimCC rows (x at 100, y at 200) added to a zero multiple of
    the crop's mean (tests/test_dwpose.py's)."""
    sx = np.zeros((1, 133, SIMCC_W), np.float32)
    sy = np.zeros((1, 133, SIMCC_H), np.float32)
    sx[0, :, 100] = 0.9
    sy[0, :, 200] = 0.8
    nodes = [
        ("GlobalAveragePool", ["input"], ["g"], {}),
        ("ReduceSum", ["g"], ["gsum"], {"axes": [1, 2, 3], "keepdims": 0}),
        ("Mul", ["gsum", "zero"], ["z"], {}),
        ("Add", ["sx0", "z"], ["simcc_x"], {}),
        ("Add", ["sy0", "z"], ["simcc_y"], {}),
    ]
    return build_model(nodes, {"sx0": sx, "sy0": sy, "zero": np.zeros((), np.float32)},
                       ["input"], ["simcc_x", "simcc_y"])


def crop_pose_graph(seed: int = 0) -> bytes:
    """SimCC rows that depend on the crop: a 1x1 conv to 133 maps, their
    column means through a (288, 576) matmul and row means through a
    (384, 768) one."""
    rng = np.random.default_rng(seed)
    inits = {"cw": rng.standard_normal((133, 3, 1, 1)).astype(np.float32),
             "wx": rng.standard_normal((288, SIMCC_W)).astype(np.float32) / 17,
             "wy": rng.standard_normal((384, SIMCC_H)).astype(np.float32) / 20}
    nodes = [
        ("Conv", ["input", "cw"], ["maps"], {"kernel_shape": [1, 1]}),
        ("ReduceMean", ["maps"], ["cols"], {"axes": [2], "keepdims": 0}),
        ("ReduceMean", ["maps"], ["rows"], {"axes": [3], "keepdims": 0}),
        ("MatMul", ["cols", "wx"], ["simcc_x"], {}),
        ("MatMul", ["rows", "wy"], ["simcc_y"], {}),
    ]
    return build_model(nodes, inits, ["input"], ["simcc_x", "simcc_y"])


# ---------------------------------------------------------------------------
# a graph under construction that tracks shapes and counts FLOPs
# ---------------------------------------------------------------------------


class _Graph:
    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed)
        self.nodes, self.inits, self.shapes = [], {}, {}
        self.flops = 0
        self.n = 0
        self.bias = 0.1  # the std of the seeded conv biases (BN folded in)

    def name(self, stem: str) -> str:
        self.n += 1
        return f"{stem}_{self.n}"

    def init(self, stem: str, arr: np.ndarray) -> str:
        name = self.name(stem)
        self.inits[name] = arr.astype(np.float32) if arr.dtype.kind == "f" else arr
        return name

    def op(self, op_type: str, ins: list, attrs: dict, shape, n_out: int = 1):
        outs = [self.name(op_type.lower()) for _ in range(n_out)]
        self.nodes.append((op_type, ins, outs, attrs))
        for o in outs:
            self.shapes[o] = shape
        return outs[0] if n_out == 1 else outs

    def conv(self, x: str, cout: int, k: int, stride: int = 1, groups: int = 1,
             act: bool = True, gain: float = 1.4, bias: float = None) -> str:
        """Conv (BN folded in: a bias) and SiLU as Sigmoid + Mul."""
        cin, h, w = self.shapes[x]
        fan_in = cin // groups * k * k
        wt = self.init("w", self.rng.standard_normal((cout, cin // groups, k, k))
                       * (gain / math.sqrt(fan_in)))
        b = self.init("b", self.rng.standard_normal(cout) * (self.bias if bias is None else bias))
        p = k // 2
        ho, wo = (h + 2 * p - k) // stride + 1, (w + 2 * p - k) // stride + 1
        self.flops += 2 * cout * (cin // groups) * k * k * ho * wo
        y = self.op("Conv", [x, wt, b], {"kernel_shape": [k, k], "strides": [stride, stride],
                                         "pads": [p, p, p, p], "group": groups}, (cout, ho, wo))
        return self.silu(y) if act else y

    def silu(self, x: str) -> str:
        s = self.op("Sigmoid", [x], {}, self.shapes[x])
        return self.op("Mul", [x, s], {}, self.shapes[x])

    def add(self, a: str, b: str) -> str:
        return self.op("Add", [a, b], {}, self.shapes[a])

    def concat(self, xs: list) -> str:
        c = sum(self.shapes[x][0] for x in xs)
        return self.op("Concat", xs, {"axis": 1}, (c,) + tuple(self.shapes[xs[0]][1:]))

    def maxpool(self, x: str, k: int) -> str:
        p = k // 2
        return self.op("MaxPool", [x], {"kernel_shape": [k, k], "strides": [1, 1],
                                        "pads": [p, p, p, p]}, self.shapes[x])

    def upsample2(self, x: str) -> str:
        c, h, w = self.shapes[x]
        scales = self.init("scales", np.array([1, 1, 2, 2], np.float32))
        return self.op("Resize", [x, "", scales], {"mode": b"nearest"}, (c, 2 * h, 2 * w))

    def matmul(self, x: str, k: int, n: int, scale: float = 1.0) -> str:
        """x (..., M, k) @ a seeded (k, n) weight (a bias-free linear)."""
        wt = self.init("lin", self.rng.standard_normal((k, n)) * (scale / math.sqrt(k)))
        shape = tuple(self.shapes[x][:-1]) + (n,)
        self.flops += 2 * int(np.prod(shape[:-1])) * k * n
        return self.op("MatMul", [x, wt], {}, shape)

    def model(self, inputs: list, outputs: list) -> tuple[bytes, dict]:
        data = build_model(self.nodes, self.inits, inputs, outputs)
        n_params = int(sum(a.size for a in self.inits.values()))
        return data, {"ops": len(self.nodes), "flops": self.flops, "params": n_params,
                      "bytes": len(data)}


# ---------------------------------------------------------------------------
# YOLOX (Megvii's export layout)
# ---------------------------------------------------------------------------


def _yolox_csp(g: _Graph, x: str, cout: int, n: int, shortcut: bool) -> str:
    hidden = cout // 2
    x1 = g.conv(x, hidden, 1)
    x2 = g.conv(x, hidden, 1)
    for _ in range(n):
        y = g.conv(g.conv(x1, hidden, 1), hidden, 3, gain=0.7 if shortcut else 1.4)
        x1 = g.add(y, x1) if shortcut else y
    return g.conv(g.concat([x1, x2]), cout, 1)


def yolox(depth: float = 1.0, width: float = 1.0, size: int = 640, seed: int = 0,
          obj_bias: float = 0.0, person_bias: float = 8.0) -> tuple[bytes, dict]:
    """YOLOX at (depth, width) on size x size input 'images' -> 'output'
    (1, anchors, 85): box regression, sigmoid(objectness), sigmoid(80
    classes). obj_bias and person_bias are the objectness and person-class
    biases of every level (they steer how many boxes pass the threshold)."""
    g = _Graph(seed)
    ch = lambda c: int(c * width)  # noqa: E731
    n = max(round(3 * depth), 1)
    g.shapes["images"] = (3, size, size)
    # Focus: the four pixel phases stacked on the channels
    parts = []
    for r0, c0 in ((0, 0), (1, 0), (0, 1), (1, 1)):
        st = g.init("focus_start", np.array([r0, c0], np.int64))
        parts.append(g.op("Slice", ["images", st, g.init("focus_end", np.array([2**31, 2**31],
                                                                               np.int64)),
                                    g.init("focus_axes", np.array([2, 3], np.int64)),
                                    g.init("focus_step", np.array([2, 2], np.int64))], {},
                          (3, size // 2, size // 2)))
    x = g.conv(g.concat(parts), ch(64), 3, gain=1.6 / 128)  # raw 0..255 pixels in
    x = _yolox_csp(g, g.conv(x, ch(128), 3, 2), ch(128), n, True)
    dark3 = _yolox_csp(g, g.conv(x, ch(256), 3, 2), ch(256), 3 * n, True)
    dark4 = _yolox_csp(g, g.conv(dark3, ch(512), 3, 2), ch(512), 3 * n, True)
    x = g.conv(dark4, ch(1024), 3, 2)
    # SPP bottleneck, 5 / 9 / 13
    h = g.conv(x, ch(512), 1)
    x = g.conv(g.concat([h] + [g.maxpool(h, k) for k in (5, 9, 13)]), ch(1024), 1)
    dark5 = _yolox_csp(g, x, ch(1024), n, False)
    # PAFPN
    fpn_out0 = g.conv(dark5, ch(512), 1)
    f_out0 = _yolox_csp(g, g.concat([g.upsample2(fpn_out0), dark4]), ch(512), n, False)
    fpn_out1 = g.conv(f_out0, ch(256), 1)
    pan_out2 = _yolox_csp(g, g.concat([g.upsample2(fpn_out1), dark3]), ch(256), n, False)
    pan_out1 = _yolox_csp(g, g.concat([g.conv(pan_out2, ch(256), 3, 2), fpn_out1]), ch(512), n,
                          False)
    pan_out0 = _yolox_csp(g, g.concat([g.conv(pan_out1, ch(512), 3, 2), fpn_out0]), ch(1024), n,
                          False)
    # decoupled head per level
    levels = []
    for feat in (pan_out2, pan_out1, pan_out0):
        stem = g.conv(feat, ch(256), 1)
        cls = g.conv(g.conv(stem, ch(256), 3), ch(256), 3)
        reg = g.conv(g.conv(stem, ch(256), 3), ch(256), 3)
        box = g.conv(reg, 4, 1, act=False, gain=0.01, bias=0.0)
        # boxes of about 12 strides (100-400 px): exp(2.5) times the stride
        g.inits[g.nodes[-1][1][2]] = np.array([0.0, 0.0, 2.5, 2.5], np.float32)
        obj = g.conv(reg, 1, 1, act=False, gain=0.5, bias=0.0)
        g.inits[g.nodes[-1][1][2]] = np.full(1, obj_bias, np.float32)
        cls_out = g.conv(cls, 80, 1, act=False, gain=0.5, bias=0.0)
        cls_b = np.full(80, -4.0, np.float32)
        cls_b[0] = person_bias
        g.inits[g.nodes[-1][1][2]] = cls_b
        _, hh, ww = g.shapes[box]
        cat = g.concat([box, g.op("Sigmoid", [obj], {}, g.shapes[obj]),
                        g.op("Sigmoid", [cls_out], {}, g.shapes[cls_out])])
        levels.append(g.op("Reshape", [cat, g.init("shape", np.array([1, 85, -1], np.int64))],
                           {}, (85, hh * ww)))
    anchors = sum(g.shapes[lv][1] for lv in levels)
    flat = g.op("Concat", levels, {"axis": 2}, (85, anchors))
    g.op("Transpose", [flat], {"perm": [0, 2, 1]}, (anchors, 85))
    g.nodes[-1] = (g.nodes[-1][0], g.nodes[-1][1], ["output"], g.nodes[-1][3])
    return g.model(["images"], ["output"])


# ---------------------------------------------------------------------------
# RTMPose (CSPNeXt + RTMCC head)
# ---------------------------------------------------------------------------


def _cspnext_layer(g: _Graph, x: str, cout: int, n: int, add_identity: bool) -> str:
    mid = cout // 2
    short = g.conv(x, mid, 1)
    main = g.conv(x, mid, 1)
    for _ in range(n):
        y = g.conv(main, mid, 3)
        y = g.conv(g.conv(y, mid, 5, groups=mid), mid, 1,  # depthwise 5x5 + pointwise
                   gain=0.7 if add_identity else 1.4)
        main = g.add(y, main) if add_identity else y
    x = g.concat([main, short])
    # channel attention: global mean -> 1x1 conv -> HardSigmoid -> scale
    c = g.shapes[x][0]
    pooled = g.op("GlobalAveragePool", [x], {}, (c, 1, 1))
    att = g.conv(pooled, c, 1, act=False)
    att = g.op("HardSigmoid", [att], {"alpha": 1 / 6, "beta": 0.5}, (c, 1, 1))
    return g.conv(g.op("Mul", [x, att], {}, g.shapes[x]), cout, 1)


def _scale_norm(g: _Graph, x: str, eps: float = 1e-5) -> str:
    """x / max(|x| * d^-0.5, eps) * g (g = 1), over the last dim."""
    shape = g.shapes[x]
    sq = g.op("Mul", [x, x], {}, shape)
    ss = g.op("ReduceSum", [sq, g.init("axes", np.array([-1], np.int64))], {"keepdims": 1},
              tuple(shape[:-1]) + (1,))
    norm = g.op("Mul", [g.op("Sqrt", [ss], {}, g.shapes[ss]),
                        g.init("rsqrt_d", np.array(shape[-1] ** -0.5, np.float32))], {},
                g.shapes[ss])
    norm = g.op("Clip", [norm, g.init("eps", np.array(eps, np.float32)), ""], {}, g.shapes[ss])
    return g.op("Div", [x, norm], {}, shape)


def rtmpose(depth: float = 1.0, width: float = 1.0, size: tuple = (384, 288), seed: int = 1,
            keypoints: int = 133) -> tuple[bytes, dict]:
    """RTMPose at (depth, width) on an (h, w) crop 'input' -> 'simcc_x'
    (1, K, 2w), 'simcc_y' (1, K, 2h)."""
    g = _Graph(seed)
    g.bias = 0.0  # seeded biases would outweigh the crop and pin every keypoint in place
    ch = lambda c: int(c * width)  # noqa: E731
    h, w = size
    g.shapes["input"] = (3, h, w)
    x = g.conv(g.conv(g.conv("input", ch(32), 3, 2), ch(32), 3), ch(64), 3)
    for cout, n, add_identity, spp in ((128, 3, True, False), (256, 6, True, False),
                                       (512, 6, True, False), (1024, 3, False, True)):
        x = g.conv(x, ch(cout), 3, 2)
        if spp:  # SPPF: one 5x5 max pool three times
            hid = g.conv(x, ch(cout) // 2, 1)
            p1 = g.maxpool(hid, 5)
            p2 = g.maxpool(p1, 5)
            x = g.conv(g.concat([hid, p1, p2, g.maxpool(p2, 5)]), ch(cout), 1)
        x = _cspnext_layer(g, x, ch(cout), max(round(n * depth), 1), add_identity)
    # RTMCC head
    k = keypoints
    x = g.conv(x, k, 7, act=False, gain=1.0)
    # zero-mean over the input channels: the SiLU features share one spatial
    # profile, which would otherwise put every keypoint's argmax in one place
    w7 = g.nodes[-1][1][1]
    g.inits[w7] = g.inits[w7] - g.inits[w7].mean(axis=1, keepdims=True)
    _, fh, fw = g.shapes[x]
    tokens = g.op("Reshape", [x, g.init("shape", np.array([1, k, -1], np.int64))], {},
                  (k, fh * fw))
    feats = g.matmul(_scale_norm(g, tokens), fh * fw, 256)
    # gated attention unit (self-attention, s = 128, e = 512), residual
    # scaled per channel
    e, s = 512, 128
    uv = g.silu(g.matmul(_scale_norm(g, feats), 256, 2 * e + s))
    u, v, base = g.op("Split", [uv, g.init("split", np.array([e, e, s], np.int64))],
                      {"axis": 2}, None, n_out=3)
    g.shapes[u], g.shapes[v], g.shapes[base] = (k, e), (k, e), (k, s)
    gamma = g.rng.standard_normal((2, s)).astype(np.float32) * 0.02 + 0.1
    beta = g.rng.standard_normal((2, s)).astype(np.float32) * 0.02
    q = g.op("Add", [g.op("Mul", [base, g.init("gamma_q", gamma[0])], {}, (k, s)),
                     g.init("beta_q", beta[0])], {}, (k, s))
    kk = g.op("Add", [g.op("Mul", [base, g.init("gamma_k", gamma[1])], {}, (k, s)),
                      g.init("beta_k", beta[1])], {}, (k, s))
    kt = g.op("Transpose", [kk], {"perm": [0, 2, 1]}, (s, k))
    qk = g.op("MatMul", [q, kt], {}, (k, k))
    g.flops += 2 * k * k * s
    qk = g.op("Div", [qk, g.init("sqrt_s", np.array(math.sqrt(s), np.float32))], {}, (k, k))
    relu = g.op("Relu", [qk], {}, (k, k))
    kernel = g.op("Mul", [relu, relu], {}, (k, k))
    kv = g.op("MatMul", [kernel, v], {}, (k, e))
    g.flops += 2 * k * k * e
    gated = g.matmul(g.op("Mul", [u, kv], {}, (k, e)), e, 256)
    res = g.op("Mul", [feats, g.init("res_scale", np.ones(256, np.float32))], {}, (k, 256))
    feats = g.add(res, gated)
    sx = g.matmul(feats, 256, 2 * w)
    sy = g.matmul(feats, 256, 2 * h)
    for old, new in ((sx, "simcc_x"), (sy, "simcc_y")):
        i = next(i for i, nd in enumerate(g.nodes) if nd[2] == [old])
        g.nodes[i] = (g.nodes[i][0], g.nodes[i][1], [new], g.nodes[i][3])
    return g.model(["input"], ["simcc_x", "simcc_y"])


def keypoint_pose_graph(seed: int = 0) -> bytes:
    """One-hot SimCC rows at seeded places, one per keypoint (a skeleton
    that does not collapse to a point), independent of the crop but for a
    zero product."""
    rng = np.random.default_rng(seed)
    sx = np.zeros((1, 133, SIMCC_W), np.float32)
    sy = np.zeros((1, 133, SIMCC_H), np.float32)
    sx[0, np.arange(133), rng.integers(150, 430, 133)] = rng.uniform(0.5, 1.0, 133)
    sy[0, np.arange(133), rng.integers(200, 570, 133)] = rng.uniform(0.5, 1.0, 133)
    nodes = [
        ("ReduceMean", ["input"], ["m"], {"keepdims": 0}),
        ("Mul", ["m", "zero"], ["z"], {}),
        ("Add", ["sx0", "z"], ["simcc_x"], {}),
        ("Add", ["sy0", "z"], ["simcc_y"], {}),
    ]
    return build_model(nodes, {"sx0": sx, "sy0": sy, "zero": np.zeros((), np.float32)},
                       ["input"], ["simcc_x", "simcc_y"])


def op_family_graphs(seed: int = 0) -> list:
    """Small graphs of the executor's op families, with seeded feeds:
    [(name, model bytes, feeds)]. conv + BN + SiLU + ceil-mode pools,
    depthwise + transpose conv, Resize nearest / linear / cubic, Gemm /
    MatMul / Softmax, and the shape plumbing."""
    rng = np.random.default_rng(seed)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    out = []
    x = f32(1, 3, 37, 45)
    bn = {"cw": f32(16, 3, 3, 3) * 0.3, "cb": f32(16), "bw": np.abs(f32(16)) + 0.5,
          "bb": f32(16), "bm": f32(16) * 0.1, "bv": np.abs(f32(16)) + 0.5}
    out.append(("conv_bn_silu_pools", build_model([
        ("Conv", ["x", "cw", "cb"], ["c"], {"strides": [2, 2], "pads": [1, 1, 1, 1],
                                            "kernel_shape": [3, 3]}),
        ("BatchNormalization", ["c", "bw", "bb", "bm", "bv"], ["n"], {"epsilon": 1e-3}),
        ("Sigmoid", ["n"], ["s"], {}), ("Mul", ["n", "s"], ["silu"], {}),
        ("MaxPool", ["silu"], ["mp"], {"kernel_shape": [3, 3], "strides": [2, 2],
                                       "ceil_mode": 1}),
        ("AveragePool", ["silu"], ["ap"], {"kernel_shape": [3, 3], "strides": [2, 2],
                                           "pads": [1, 1, 1, 1], "ceil_mode": 1}),
    ], bn, ["x"], ["mp", "ap"]), {"x": x}))
    out.append(("depthwise_convtranspose", build_model([
        ("Conv", ["x", "dw", "db"], ["h"], {"pads": [2, 2, 2, 2], "group": 16,
                                            "kernel_shape": [5, 5]}),
        ("ConvTranspose", ["h", "tw", "tb"], ["y"], {"strides": [2, 2], "pads": [1, 1, 1, 1],
                                                     "kernel_shape": [4, 4]}),
    ], {"dw": f32(16, 1, 5, 5) * 0.2, "db": f32(16), "tw": f32(16, 8, 4, 4) * 0.2,
        "tb": f32(8)}, ["x"], ["y"]), {"x": f32(2, 16, 19, 23)}))
    nodes, inits = [], {}
    for i, (mode, scales) in enumerate(((b"nearest", [1, 1, 2, 2]),
                                        (b"nearest", [1, 1, 1.5, 0.6]),
                                        (b"linear", [1, 1, 2, 1.6]),
                                        (b"linear", [1, 1, 0.5, 0.6]),
                                        (b"cubic", [1, 1, 2, 1.5]),
                                        (b"cubic", [1, 1, 0.5, 0.7]))):
        inits[f"s{i}"] = np.array(scales, np.float32)
        nodes.append(("Resize", ["x", "", f"s{i}"], [f"r{i}"], {"mode": mode}))
    out.append(("resize", build_model(nodes, inits, ["x"], [f"r{i}" for i in range(6)]),
                {"x": f32(1, 8, 24, 40)}))
    out.append(("gemm_matmul_softmax", build_model([
        ("Gemm", ["x", "w", "b"], ["h"], {"transB": 1}),
        ("Softmax", ["h"], ["s"], {"axis": -1}),
        ("MatMul", ["s", "m"], ["y"], {}),
    ], {"w": f32(256, 512) / 20, "b": f32(256), "m": f32(256, 128)}, ["x"], ["y"]),
        {"x": f32(133, 512)}))
    out.append(("shape_plumbing", build_model([
        ("Shape", ["x"], ["shp"], {}),
        ("Gather", ["shp", "zero"], ["b"], {"axis": 0}),
        ("Unsqueeze", ["b", "ax0"], ["b1"], {}),
        ("Concat", ["b1", "neg1"], ["target"], {"axis": 0}),
        ("Reshape", ["x", "target"], ["flat"], {}),
        ("Slice", ["flat", "starts", "ends", "axes", "steps"], ["sl"], {}),
        ("Transpose", ["sl"], ["t"], {"perm": [1, 0]}),
        ("Split", ["t"], ["p0", "p1"], {"axis": 0}),
        ("Concat", ["p1", "p0"], ["y"], {"axis": 0}),
    ], {"zero": np.array(0, np.int64), "ax0": np.array([0], np.int64),
        "neg1": np.array([-1], np.int64), "starts": np.array([3], np.int64),
        "ends": np.array([2**62], np.int64), "axes": np.array([1], np.int64),
        "steps": np.array([2], np.int64)}, ["x"], ["y", "shp"]), {"x": f32(4, 6, 10)}))
    return out


def steered_yolox(run, people: int = 3, **kw) -> tuple[bytes, dict]:
    """YOLOX whose objectness bias lets `people` anchors of a given frame
    pass the detector's person score (sigmoid(objectness + bias) *
    sigmoid(person) > 0.3): run(model bytes) returns the graph's output on
    that frame. Each anchor passes above its own bias; the bias is set
    halfway between the people-th smallest of those and the next. stats
    gains "obj_bias"."""
    data, _ = yolox(obj_bias=0.0, **kw)
    out = np.asarray(run(data), np.float64)[0]
    obj = np.clip(out[:, 4], 1e-12, 1 - 1e-12)
    person = out[:, 5]
    able = person > 0.3
    need = np.log(0.3 / person[able]) - np.log1p(-0.3 / person[able])  # logit(0.3 / person)
    above = np.sort(need - (np.log(obj[able]) - np.log1p(-obj[able])))
    bias = float((above[people - 1] + above[people]) / 2)
    data, stats = yolox(obj_bias=bias, **kw)
    stats["obj_bias"] = bias
    return data, stats
