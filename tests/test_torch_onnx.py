"""The port's ONNX executor (svi_tpu_torch/utils/onnx_torch.py) against the
JAX package's (svi_tpu/utils/onnx_jax.py) on the CPU.

The same `build_model` bytes and the same seeded numpy feeds go through
both sessions. Bounds: f32 outputs within 1e-5 of the JAX output's largest
magnitude (sums in another order); shape and integer outputs exactly
equal. Every op family of tests/test_onnx_jax.py is covered, plus Resize
cubic, non-integer nearest and antialiased linear downscale, and both pools
with ceil_mode. Shapes repeat across tests: the JAX executor compiles each
op once per shape.
"""

import numpy as np
import pytest

from svi_tpu.utils import onnx_jax
from svi_tpu_torch.utils import onnx_torch

F32_REL = 1e-5


def _match(jax_out, torch_out, where=""):
    j, t = np.asarray(jax_out), np.asarray(torch_out)
    assert j.shape == t.shape, (where, j.shape, t.shape)
    if np.issubdtype(j.dtype, np.floating):
        assert t.dtype == j.dtype, (where, t.dtype, j.dtype)
        scale = max(float(np.abs(j).max()), 1e-30) if j.size else 1.0
        err = float(np.abs(j.astype(np.float64) - t).max()) if j.size else 0.0
        assert err <= F32_REL * scale, (where, err, scale)
    else:
        np.testing.assert_array_equal(t, j, err_msg=where)


def _run_both(model: bytes, feeds: dict) -> tuple:
    jo = onnx_jax.InferenceSession(model).run(None, feeds)
    to = onnx_torch.InferenceSession(model, device="cpu").run(None, feeds)
    return jo, to


def _check(nodes, inits, inputs, outputs, feeds) -> list:
    model = onnx_jax.build_model(nodes, inits, inputs, outputs)
    assert onnx_torch.build_model(nodes, inits, inputs, outputs) == model
    jo, to = _run_both(model, feeds)
    for name, j, t in zip(outputs, jo, to):
        _match(j, t, name)
    return to


def _rng(seed):
    return np.random.default_rng(seed)


def _ld(fno, payload):
    return bytes([fno << 3 | 2, len(payload)]) + payload


def test_parser_handmade_bytes():
    """A ModelProto assembled byte by byte from the protobuf spec (graph {
    node {Relu x->y} input x output y }), independent of build_model."""
    node = _ld(1, b"x") + _ld(2, b"y") + _ld(4, b"Relu")
    model = _ld(7, _ld(1, node) + _ld(11, _ld(1, b"x")) + _ld(12, _ld(1, b"y")))
    g = onnx_torch.parse_model(model)
    assert g.inputs == ["x"] and g.outputs == ["y"] and g.nodes[0].op_type == "Relu"
    jo, to = _run_both(model, {"x": np.array([-1.0, 2.0], np.float32)})
    np.testing.assert_array_equal(to[0], [0.0, 2.0])
    _match(jo[0], to[0])


def test_tensor_roundtrip_dtypes():
    rng = _rng(0)
    for arr in [rng.standard_normal((3, 4)).astype(np.float32),
                rng.integers(-5, 5, (2, 3)).astype(np.int64),
                rng.integers(0, 2, (4,)).astype(np.bool_),
                rng.standard_normal((2, 2, 2)).astype(np.float16)]:
        model = onnx_torch.build_model([("Identity", ["w"], ["y"], {})], {"w": arr}, [], ["y"])
        jo, to = _run_both(model, {})
        np.testing.assert_array_equal(to[0], arr)
        np.testing.assert_array_equal(to[0], jo[0])
        assert to[0].dtype == arr.dtype


def _conv_bn(rng, cin, cout, k=3):
    lim = 1 / np.sqrt(cin * k * k)
    return {"cw": rng.uniform(-lim, lim, (cout, cin, k, k)).astype(np.float32),
            "cb": rng.uniform(-lim, lim, (cout,)).astype(np.float32),
            "bw": rng.uniform(0.5, 1.5, (cout,)).astype(np.float32),
            "bb": rng.standard_normal(cout).astype(np.float32) * 0.1,
            "bm": rng.standard_normal(cout).astype(np.float32) * 0.1,
            "bv": rng.uniform(0.5, 1.5, (cout,)).astype(np.float32)}


@pytest.mark.parametrize("pool", [
    ("MaxPool", {}), ("AveragePool", {}), ("AveragePool", {"pads": [1, 1, 1, 1]}),
    ("AveragePool", {"pads": [1, 1, 1, 1], "count_include_pad": 1})])
def test_conv_bn_silu_pool_ceil_mode(pool):
    """The YOLOX building block: Conv(s2, p1) + BN + SiLU (Sigmoid, Mul) and
    a ceil_mode pool (the end pads grow so that every window fits)."""
    op, extra = pool
    rng = _rng(1)
    nodes = [
        ("Conv", ["x", "cw", "cb"], ["c"],
         {"strides": [2, 2], "pads": [1, 1, 1, 1], "kernel_shape": [3, 3]}),
        ("BatchNormalization", ["c", "bw", "bb", "bm", "bv"], ["n"], {"epsilon": 1e-3}),
        ("Sigmoid", ["n"], ["s"], {}),
        ("Mul", ["n", "s"], ["silu"], {}),
        (op, ["silu"], ["y"], {"kernel_shape": [3, 3], "strides": [2, 2], "ceil_mode": 1,
                               **extra}),
    ]
    x = rng.standard_normal((1, 3, 17, 23)).astype(np.float32)
    (y,) = _check(nodes, _conv_bn(rng, 3, 8), ["x"], ["y"], {"x": x})
    # conv 9 x 12, then ceil((9 + pads - 3) / 2) + 1 rows
    assert y.shape == ((1, 8, 4, 6) if not extra else (1, 8, 5, 7))


def test_depthwise_conv_and_convtranspose():
    rng = _rng(2)
    inits = {"dw": rng.standard_normal((6, 1, 5, 5)).astype(np.float32) * 0.2,
             "db": rng.standard_normal(6).astype(np.float32),
             "tw": rng.standard_normal((6, 4, 4, 4)).astype(np.float32) * 0.2,
             "tb": rng.standard_normal(4).astype(np.float32)}
    nodes = [
        ("Conv", ["x", "dw", "db"], ["h"],
         {"pads": [2, 2, 2, 2], "group": 6, "kernel_shape": [5, 5]}),
        ("ConvTranspose", ["h", "tw", "tb"], ["y"],
         {"strides": [2, 2], "pads": [1, 1, 1, 1], "kernel_shape": [4, 4]}),
        ("ConvTranspose", ["h", "tw"], ["z"],
         {"strides": [2, 2], "pads": [0, 1, 2, 0], "kernel_shape": [4, 4]}),
    ]
    x = rng.standard_normal((2, 6, 9, 11)).astype(np.float32)
    y, z = _check(nodes, inits, ["x"], ["y", "z"], {"x": x})
    assert y.shape == (2, 4, 18, 22) and z.shape == (2, 4, 18, 23)


def test_gemm_matmul_softmax():
    rng = _rng(3)
    inits = {"w": rng.standard_normal((7, 12)).astype(np.float32),
             "b": rng.standard_normal(7).astype(np.float32),
             "m": rng.standard_normal((7, 5)).astype(np.float32)}
    nodes = [
        ("Gemm", ["x", "w", "b"], ["h"], {"transB": 1, "alpha": 0.5, "beta": 2.0}),
        ("Softmax", ["h"], ["s"], {"axis": -1}),
        ("MatMul", ["s", "m"], ["y"], {}),
    ]
    _check(nodes, inits, ["x"], ["s", "y"], {"x": rng.standard_normal((5, 12)).astype(np.float32)})


@pytest.mark.parametrize("mode,ct,scales", [
    (b"nearest", b"asymmetric", [1, 1, 2, 2]),     # integer upscale: repetition
    (b"nearest", b"half_pixel", [1, 1, 1.5, 0.6]),  # non-integer: half-pixel floor
    (b"linear", b"half_pixel", [1, 1, 2, 2]),
    (b"linear", b"align_corners", [1, 1, 0.5, 0.8]),  # downscale antialiases; ct unread
    (b"cubic", b"half_pixel", [1, 1, 2, 1.6]),     # Keys' a = -0.5, renormalised borders
    (b"cubic", b"half_pixel", [1, 1, 0.5, 0.6]),
])
def test_resize_modes(mode, ct, scales):
    x = _rng(4).standard_normal((1, 4, 6, 10)).astype(np.float32)
    nodes = [("Resize", ["x", "", "scales"], ["y"],
              {"mode": mode, "coordinate_transformation_mode": ct})]
    _check(nodes, {"scales": np.array(scales, np.float32)}, ["x"], ["y"], {"x": x})


def test_resize_sizes_and_upsample():
    x = _rng(5).standard_normal((1, 4, 6, 10)).astype(np.float32)
    nodes = [("Resize", ["x", "", "", "sizes"], ["y"], {"mode": b"linear"}),
             ("Upsample", ["x", "up"], ["z"], {})]
    _check(nodes, {"sizes": np.array([1, 4, 9, 7], np.int64),
                   "up": np.array([1, 1, 2, 2], np.float32)}, ["x"], ["y", "z"], {"x": x})


def test_shape_plumbing_ops():
    """Shape / Gather / Unsqueeze / Concat / Reshape / Slice / Transpose /
    Split / Cast / Expand / Tile / ConstantOfShape / Range / Where — the
    plumbing of exported heads, on the host."""
    x = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    nodes = [
        ("Shape", ["x"], ["shp"], {}),
        ("Gather", ["shp", "zero"], ["b"], {"axis": 0}),
        ("Unsqueeze", ["b", "ax0"], ["b1"], {}),
        ("Concat", ["b1", "neg1"], ["target"], {"axis": 0}),
        ("Reshape", ["x", "target"], ["flat"], {}),
        ("Slice", ["flat", "starts", "ends", "axes"], ["sl"], {}),
        ("Transpose", ["sl"], ["t"], {"perm": [1, 0]}),
        ("Cast", ["t"], ["ti"], {"to": 7}),
        ("Slice", ["x", "rs", "re", "raxes", "rstep"], ["rev"], {}),
        ("ConstantOfShape", ["target2"], ["ones"], {"value": np.ones(1, np.float32)}),
        ("Range", ["r0", "r1", "r2"], ["rng"], {}),
        ("Expand", ["colv", "eshape"], ["ex"], {}),
        ("Tile", ["x", "reps"], ["tiled"], {}),
        ("Greater", ["x", "ten"], ["mask"], {}),
        ("Where", ["mask", "x", "ones_x"], ["wh"], {}),
        ("Gather", ["x", "gidx"], ["g2"], {"axis": 2}),
    ]
    inits = {
        "zero": np.array(0, np.int64), "ax0": np.array([0], np.int64),
        "neg1": np.array([-1], np.int64),
        "starts": np.array([2], np.int64), "ends": np.array([9], np.int64),
        "axes": np.array([1], np.int64),
        "rs": np.array([-1], np.int64), "re": np.array([-2**62], np.int64),
        "raxes": np.array([2], np.int64), "rstep": np.array([-2], np.int64),
        "target2": np.array([2, 3], np.int64),
        "r0": np.array(1, np.int64), "r1": np.array(9, np.int64), "r2": np.array(3, np.int64),
        "colv": np.arange(3, dtype=np.float32).reshape(3, 1),
        "eshape": np.array([2, 3, 4], np.int64), "reps": np.array([1, 2, 1], np.int64),
        "ten": np.array(10.0, np.float32), "ones_x": np.ones((2, 3, 4), np.float32),
        "gidx": np.array([[3, -1], [0, 1]], np.int64),
    }
    outs = ["shp", "target", "t", "ti", "rev", "ones", "rng", "ex", "tiled", "wh", "g2"]
    got = _check(nodes, inits, ["x"], outs, {"x": x})
    np.testing.assert_array_equal(got[2], x.reshape(2, -1)[:, 2:9].T)
    np.testing.assert_array_equal(got[4], x[:, :, ::-2])

    nodes = [("Split", ["x"], ["a", "b", "c"], {"axis": 1, "num_outputs": 3})]
    outs = _check(nodes, {}, ["x"], ["a", "b", "c"], {"x": x})
    for i, o in enumerate(outs):
        np.testing.assert_array_equal(o, x[:, i:i + 1])


def test_focus_slice_pattern():
    """YOLOX Focus: 4 strided Slices + Concat halve HW and 4x channels."""
    x = _rng(6).standard_normal((1, 3, 8, 8)).astype(np.float32)
    nodes, names = [], []
    inits = {"big": np.array([2**31, 2**31], np.int64),
             "hw_axes": np.array([2, 3], np.int64), "two": np.array([2, 2], np.int64)}
    for i, (r0, c0) in enumerate([(0, 0), (1, 0), (0, 1), (1, 1)]):
        nodes.append(("Slice", ["x", f"s{i}", "big", "hw_axes", "two"], [f"p{i}"], {}))
        names.append(f"p{i}")
        inits[f"s{i}"] = np.array([r0, c0], np.int64)
    nodes.append(("Concat", names, ["y"], {"axis": 1}))
    (y,) = _check(nodes, inits, ["x"], ["y"], {"x": x})
    expect = np.concatenate([x[:, :, 0::2, 0::2], x[:, :, 1::2, 0::2],
                             x[:, :, 0::2, 1::2], x[:, :, 1::2, 1::2]], axis=1)
    np.testing.assert_array_equal(y, expect)


def test_reductions_elementwise_and_argmax():
    x = _rng(7).standard_normal((3, 5, 7)).astype(np.float32)
    nodes = [("ReduceMean", ["x"], ["m"], {"axes": [2], "keepdims": 0}),
             ("ArgMax", ["m"], ["am"], {"axis": 1, "keepdims": 0}),
             ("ReduceSum", ["x", "ax"], ["s"], {"keepdims": 1}),
             ("ReduceMax", ["x"], ["mx"], {"keepdims": 0}),
             ("ReduceMin", ["x"], ["mn"], {"axes": [0, -1]}),
             ("Abs", ["x"], ["ab"], {}),
             ("Sqrt", ["ab"], ["sq"], {}),
             ("Pow", ["x", "two"], ["p2"], {}),
             ("Exp", ["x"], ["ex"], {}),
             ("Log", ["p2"], ["lg"], {}),
             ("Erf", ["x"], ["er"], {}),
             ("Tanh", ["x"], ["th"], {}),
             ("HardSigmoid", ["x"], ["hs"], {}),
             ("LeakyRelu", ["x"], ["lr"], {"alpha": 0.1}),
             ("Clip", ["x", "lo", "hi"], ["cl"], {}),
             ("Floor", ["x"], ["fl"], {}),
             ("Max", ["x", "sq"], ["mxx"], {}),
             ("Min", ["x", "sq", "lr"], ["mnx"], {}),
             ("Neg", ["x"], ["ng"], {}),
             ("Div", ["x", "two"], ["dv"], {}),
             ("Sub", ["x", "two"], ["sb"], {}),
             ("Equal", ["fl", "zero"], ["eq"], {}),
             ("Less", ["x", "zero"], ["ls"], {}),
             ("Pad", ["x", "pads"], ["pd"], {"mode": b"reflect"}),
             ("Pad", ["x", "pads", "cv"], ["pc"], {}),
             ("Flatten", ["x"], ["fla"], {"axis": 2}),
             ("Squeeze", ["s", "sax"], ["sqz"], {}),
             ("GlobalAveragePool", ["x"], ["gap"], {}),
             ("GlobalMaxPool", ["x"], ["gmp"], {})]
    inits = {"ax": np.array([1], np.int64), "two": np.array(2.0, np.float32),
             "lo": np.array(-0.5, np.float32), "hi": np.array(0.7, np.float32),
             "zero": np.array(0.0, np.float32),
             "pads": np.array([0, 0, 1, 0, 0, 2], np.int64), "cv": np.array(3.0, np.float32),
             "sax": np.array([1], np.int64)}
    outs = [n[2][0] for n in nodes if n[2][0] not in ("m",)]
    got = _check(nodes, inits, ["x"], outs, {"x": x})
    assert got[0].dtype == np.int64
    np.testing.assert_array_equal(got[0], x.mean(axis=2).argmax(axis=1))


def test_simcc_head_through_session_api():
    """A DWPose-shaped SimCC tail (Conv 1x1 -> Flatten -> Gemm -> two output
    branches) driven through the ORT-compatible API as
    dwpose/onnx_infer.inference_pose drives it; run() takes numpy or
    tensors and returns numpy."""
    import torch

    rng = _rng(8)
    inits = {"cw": rng.standard_normal((13, 4, 1, 1)).astype(np.float32),
             "cb": rng.standard_normal(13).astype(np.float32),
             "wx": rng.standard_normal((156, 624)).astype(np.float32) * 0.05,
             "bx": rng.standard_normal(156).astype(np.float32),
             "wy": rng.standard_normal((208, 624)).astype(np.float32) * 0.05,
             "by": rng.standard_normal(208).astype(np.float32),
             "shx": np.array([1, 13, 12], np.int64), "shy": np.array([1, 13, 16], np.int64)}
    nodes = [
        ("Conv", ["input", "cw", "cb"], ["c"], {"kernel_shape": [1, 1]}),
        ("Flatten", ["c"], ["h"], {"axis": 1}),
        ("Gemm", ["h", "wx", "bx"], ["gx"], {"transB": 1}),
        ("Gemm", ["h", "wy", "by"], ["gy"], {"transB": 1}),
        ("Reshape", ["gx", "shx"], ["simcc_x"], {}),
        ("Reshape", ["gy", "shy"], ["simcc_y"], {}),
    ]
    x = rng.standard_normal((1, 4, 6, 8)).astype(np.float32)
    _check(nodes, inits, ["input"], ["simcc_x", "simcc_y"], {"input": x})
    sess = onnx_torch.InferenceSession(
        onnx_torch.build_model(nodes, inits, ["input"], ["simcc_x", "simcc_y"]), device="cpu")
    assert [i.name for i in sess.get_inputs()] == ["input"]
    assert [o.name for o in sess.get_outputs()] == ["simcc_x", "simcc_y"]
    a = sess.run(None, {"input": x})
    b = sess.run(["simcc_y"], {"input": torch.from_numpy(x)})
    assert isinstance(b[0], np.ndarray)
    np.testing.assert_array_equal(a[1], b[0])


def test_unknown_op_raises_with_name():
    model = onnx_torch.build_model([("NoSuchOp", ["x"], ["y"], {})], {}, ["x"], ["y"])
    sess = onnx_torch.InferenceSession(model, device="cpu")
    with pytest.raises(NotImplementedError, match="NoSuchOp"):
        sess.run(None, {"x": np.zeros(2, np.float32)})


def test_zero_valued_typed_attrs_proto3_omission():
    """AttributeProto{name:'axis', type:INT} with no i field parses as 0."""
    attr = _ld(1, b"axis") + bytes([0xA0, 0x01, 2])  # tag(20, varint) + INT(2)
    node = _ld(1, b"x") + _ld(1, b"idx") + _ld(2, b"y") + _ld(4, b"Gather") + _ld(5, attr)
    model = _ld(7, _ld(1, node) + _ld(11, _ld(1, b"x")) + _ld(11, _ld(1, b"idx"))
                + _ld(12, _ld(1, b"y")))
    assert onnx_torch.parse_model(model).nodes[0].attrs["axis"] == 0
    x = np.arange(6, dtype=np.float32).reshape(3, 2)
    jo, to = _run_both(model, {"x": x, "idx": np.array([2, 0], np.int64)})
    np.testing.assert_array_equal(to[0], x[[2, 0]])
    _match(jo[0], to[0])
    attrf = _ld(1, b"alpha") + bytes([0xA0, 0x01, 1])  # FLOAT(1) with f omitted
    assert onnx_torch._parse_attribute(memoryview(attrf)) == ("alpha", 0.0)


def test_unsqueeze_negative_axes_and_split_default_outputs():
    x = np.zeros((2, 3), np.float32)
    (out,) = _check([("Unsqueeze", ["x"], ["y"], {"axes": [-2, -1]})], {}, ["x"], ["y"],
                    {"x": x})
    assert out.shape == (2, 3, 1, 1)
    x = np.arange(12, dtype=np.float32).reshape(6, 2)
    outs = _check([("Split", ["x"], ["a", "b", "c"], {"axis": 0})], {}, ["x"], ["a", "b", "c"],
                  {"x": x})
    assert [o.shape for o in outs] == [(2, 2), (2, 2), (2, 2)]


def test_resize_scales_floor_and_same_pads_conv():
    (out,) = _check([("Resize", ["x", "", "scales"], ["y"], {"mode": b"linear"})],
                    {"scales": np.array([1.0, 1.0, 0.6, 0.6], np.float32)}, ["x"], ["y"],
                    {"x": np.ones((1, 1, 3, 3), np.float32)})
    assert out.shape == (1, 1, 1, 1)
    rng = _rng(9)
    xx = rng.standard_normal((1, 2, 5, 5)).astype(np.float32)
    w = rng.standard_normal((3, 2, 2, 2)).astype(np.float32)
    for auto_pad in (b"SAME_LOWER", b"SAME_UPPER"):
        (got,) = _check([("Conv", ["x", "w"], ["y"], {"auto_pad": auto_pad, "strides": [2, 2],
                                                       "kernel_shape": [2, 2]})],
                        {"w": w}, ["x"], ["y"], {"x": xx})
        assert got.shape == (1, 3, 3, 3)


def test_session_runs_on_the_card_unless_asked():
    """InferenceSession's default device is the card: without CUDA it raises
    (no silent CPU run); device='cpu' runs on the CPU."""
    import torch

    model = onnx_torch.build_model([("Relu", ["x"], ["y"], {})], {}, ["x"], ["y"])
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        onnx_torch.InferenceSession(model)
    assert onnx_torch.InferenceSession(model, device="cpu").device.type == "cpu"


@pytest.mark.parametrize("graph", ["yolox", "rtmpose"])
def test_runs_read_nothing_back_and_upload_each_initializer_once(monkeypatch, graph):
    """The two DWPose architectures at a small width: the float initializers
    (Resize scales, the Clip and Div constants among them) stay numpy, a run
    reads no tensor back to the host, and a second run uploads nothing
    again."""
    import torch
    from torch_dwpose_graphs import rtmpose, yolox

    if graph == "yolox":
        data, _ = yolox(depth=0.33, width=0.125, size=64)
        feed = {"images": _rng(10).standard_normal((1, 3, 64, 64)).astype(np.float32)}
    else:
        data, _ = rtmpose(depth=0.33, width=0.125, size=(64, 48), keypoints=5)
        feed = {"input": _rng(11).standard_normal((1, 3, 64, 48)).astype(np.float32)}
    sess = onnx_torch.InferenceSession(data, device="cpu")
    to_host = onnx_torch._np

    def host_only(x):
        assert not isinstance(x, torch.Tensor), "a run read a tensor back"
        return to_host(x)

    monkeypatch.setattr(onnx_torch, "_np", host_only)
    first = sess.run_tensors(None, feed)
    uploaded = dict(sess._exec._uploaded)
    second = sess.run_tensors(None, feed)
    assert all(isinstance(v, np.ndarray) for v in sess.graph.initializers.values())
    assert uploaded and all(sess._exec._uploaded[k] is v for k, v in uploaded.items())
    assert len(sess._exec._uploaded) == len(uploaded)
    for a, b in zip(first, second):
        assert torch.equal(a, b)
