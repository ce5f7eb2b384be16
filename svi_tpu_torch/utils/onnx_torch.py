"""ONNX graphs run as PyTorch ops on the card (no onnxruntime, no onnx package).

Port of svi_tpu/utils/onnx_jax.py: the ONNX wire-format parser (through the
port's `utils/proto.py` readers), the writer `build_model`, the eager
interpreter `_Executor` and the onnxruntime-shaped `InferenceSession` that
DWPose extraction (`dwpose/onnx_infer.py`) drives.

Tensor ops run on the session's device; shape plumbing (Shape, Gather on
shapes, Reshape targets, Slice bounds, Constant, ConstantOfShape, Range) and
every initializer stay on the host as numpy values, as in the JAX executor,
so no op reads a device tensor back to learn a shape, a Resize scale or a
Pad constant. A tensor op uploads an initializer once, on first use, and
every other host value through a pinned buffer without waiting for the
card's queue. f32 convolutions go through `ops.conv.conv_f32` (cuDNN with
TF32 off, whatever the process's switch); Gemm / MatMul / Resize are
torch.matmul under the process's cuBLAS switch, which PyTorch leaves at
full f32 and the port never sets.

Where the JAX executor departs from the ONNX spec, this one follows the JAX
executor (ROADMAP's quirk list): Resize linear and cubic are
`jax.image.resize` (half-pixel sampling whatever
`coordinate_transformation_mode` says, a kernel widened to antialias a
downscale, Keys' cubic with a = -0.5, weights renormalised at the borders),
non-integer nearest is its half-pixel floor, pools emulate `ceil_mode` with
extra end pads, ConvTranspose ignores `group` and `dilations`, and ArgMax
is int64. Unknown ops raise with the op's name.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.conv import conv_f32
from .proto import _iter_fields, _read_varint

# ---------------------------------------------------------------------------
# wire format
# ---------------------------------------------------------------------------


def _packed_ints(val) -> list:
    if isinstance(val, int):
        return [val]
    out = []
    pos = 0
    while pos < len(val):
        v, pos = _read_varint(val, pos)
        out.append(v)
    return out


def _signed(v: int) -> int:
    """protobuf int64 varints are two's-complement in 64 bits."""
    return v - (1 << 64) if v >= (1 << 63) else v


# TensorProto.DataType -> numpy dtype
_ONNX_DTYPES = {
    1: np.float32, 2: np.uint8, 3: np.int8, 4: np.uint16, 5: np.int16,
    6: np.int32, 7: np.int64, 9: np.bool_, 10: np.float16, 11: np.float64,
    12: np.uint32, 13: np.uint64,
}


def _parse_tensor(buf: memoryview) -> tuple:
    """TensorProto -> (name, np.ndarray)."""
    dims, dtype, name = [], 1, ""
    raw = None
    floats, ints32, ints64, doubles = [], [], [], []
    for fno, wt, val in _iter_fields(buf):
        if fno == 1:  # dims (repeated int64)
            dims += [_signed(v) for v in _packed_ints(val)]
        elif fno == 2:  # data_type
            dtype = val
        elif fno == 8:  # name
            name = bytes(val).decode("utf-8")
        elif fno == 9:  # raw_data
            raw = bytes(val)
        elif fno == 4:  # float_data (packed or repeated fixed32)
            if wt == 5:
                floats.append(struct.unpack("<f", val)[0])
            else:
                floats += [x[0] for x in struct.iter_unpack("<f", bytes(val))]
        elif fno == 5:  # int32_data
            ints32 += [_signed(v) for v in _packed_ints(val)]
        elif fno == 7:  # int64_data
            ints64 += [_signed(v) for v in _packed_ints(val)]
        elif fno == 10:  # double_data
            if wt == 1:
                doubles.append(struct.unpack("<d", val)[0])
            else:
                doubles += [x[0] for x in struct.iter_unpack("<d", bytes(val))]
    np_dtype = _ONNX_DTYPES.get(dtype, np.float32)
    if raw is not None:
        arr = np.frombuffer(raw, dtype=np_dtype)
    elif floats:
        arr = np.asarray(floats, np.float32)
    elif doubles:
        arr = np.asarray(doubles, np.float64)
    elif ints64:
        arr = np.asarray(ints64, np.int64)
    elif ints32:
        # int32_data also carries (u)int8/16/bool payloads
        arr = np.asarray(ints32).astype(np_dtype)
    else:
        arr = np.zeros(0, np_dtype)
    return name, arr.reshape(dims) if dims else arr.reshape(())


def _parse_attribute(buf: memoryview) -> tuple:
    """AttributeProto -> (name, value). Proto3 writers omit zero-valued
    scalars (i=0, f=0.0, s=b""), so a typed attribute with no payload is
    that zero (the type field, 20, says which)."""
    name, value = "", None
    f_val = i_val = s_val = t_val = None
    a_type = None
    floats, ints, strings = [], [], []
    for fno, wt, val in _iter_fields(buf):
        if fno == 1:
            name = bytes(val).decode("utf-8")
        elif fno == 2:  # f (fixed32)
            f_val = struct.unpack("<f", val)[0]
        elif fno == 3:  # i
            i_val = _signed(val)
        elif fno == 4:  # s
            s_val = bytes(val)
        elif fno == 5:  # t (tensor)
            t_val = _parse_tensor(val)[1]
        elif fno == 7:  # floats
            if wt == 5:
                floats.append(struct.unpack("<f", val)[0])
            else:
                floats += [x[0] for x in struct.iter_unpack("<f", bytes(val))]
        elif fno == 8:  # ints
            ints += [_signed(v) for v in _packed_ints(val)]
        elif fno == 9:  # strings
            strings.append(bytes(val))
        elif fno == 20:  # type
            a_type = val if isinstance(val, int) else int(val)
    # 1=FLOAT 2=INT 3=STRING 4=TENSOR 6=FLOATS 7=INTS 8=STRINGS
    typed = {1: f_val if f_val is not None else 0.0, 2: i_val if i_val is not None else 0,
             3: s_val if s_val is not None else b"", 4: t_val, 6: floats, 7: ints, 8: strings}
    if a_type in typed:
        return name, typed[a_type]
    for v in (t_val, s_val, f_val, i_val):
        if v is not None:
            value = v
            break
    if value is None:
        value = floats or ints or strings or None
    return name, value


@dataclass
class _Node:
    op_type: str
    inputs: list
    outputs: list
    attrs: dict = field(default_factory=dict)
    name: str = ""


@dataclass
class Graph:
    nodes: list
    initializers: dict
    inputs: list   # runtime input names (initializers excluded)
    outputs: list


def _parse_graph(buf: memoryview) -> Graph:
    nodes, initializers, inputs, outputs = [], {}, [], []
    for fno, _wt, val in _iter_fields(buf):
        if fno == 1:  # node
            n = _Node("", [], [])
            for nf, _nwt, nval in _iter_fields(val):
                if nf == 1:
                    n.inputs.append(bytes(nval).decode("utf-8"))
                elif nf == 2:
                    n.outputs.append(bytes(nval).decode("utf-8"))
                elif nf == 3:
                    n.name = bytes(nval).decode("utf-8")
                elif nf == 4:
                    n.op_type = bytes(nval).decode("utf-8")
                elif nf == 5:
                    k, v = _parse_attribute(nval)
                    n.attrs[k] = v
            nodes.append(n)
        elif fno == 5:  # initializer
            name, arr = _parse_tensor(val)
            initializers[name] = arr
        elif fno in (11, 12):  # input / output ValueInfoProto
            vi_name = ""
            for vf, _vwt, vval in _iter_fields(val):
                if vf == 1:
                    vi_name = bytes(vval).decode("utf-8")
                    break
            (inputs if fno == 11 else outputs).append(vi_name)
    inputs = [n for n in inputs if n not in initializers]
    return Graph(nodes, initializers, inputs, outputs)


def parse_model(data: bytes) -> Graph:
    """ONNX ModelProto bytes -> Graph (field 7 = graph)."""
    for fno, _wt, val in _iter_fields(memoryview(data)):
        if fno == 7:
            return _parse_graph(val)
    raise ValueError("no GraphProto (field 7) found — not an ONNX ModelProto?")


# ---------------------------------------------------------------------------
# host / device values
# ---------------------------------------------------------------------------

_TORCH_DTYPES = {np.dtype(np.float32): torch.float32, np.dtype(np.float16): torch.float16,
                 np.dtype(np.float64): torch.float32, np.dtype(np.int64): torch.int64,
                 np.dtype(np.int32): torch.int32, np.dtype(np.int16): torch.int16,
                 np.dtype(np.int8): torch.int8, np.dtype(np.uint8): torch.uint8,
                 np.dtype(np.bool_): torch.bool}


def _np(x) -> np.ndarray:
    """A host value as numpy (a device tensor is read back: only graphs that
    compute a shape on the device take this path)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _is_host(x) -> bool:
    return not isinstance(x, torch.Tensor)


def _pair_pads(pads, ndim_spatial):
    """ONNX pads [b1..bn, e1..en] -> ((b1,e1),...)"""
    pads = list(pads or [0] * (2 * ndim_spatial))
    return tuple((int(pads[i]), int(pads[i + ndim_spatial])) for i in range(ndim_spatial))


def _torch_pad(pairs) -> list:
    """((b1, e1), ..., (bn, en)) over the last n dims -> F.pad's order."""
    out = []
    for lo, hi in reversed(pairs):
        out += [lo, hi]
    return out


def _str_attr(a: dict, key: str, default: str) -> str:
    v = a.get(key, default)
    return v.decode() if isinstance(v, bytes) else v


def _resize_weights(n_in: int, n_out: int, kernel) -> np.ndarray:
    """The (n_in, n_out) f32 weight matrix of `jax.image.resize` along one
    dim (`jax._src.image.scale.compute_weight_mat` with antialias on):
    half-pixel samples, the kernel widened by the downscale factor, weights
    normalised to sum 1 and zeroed where the sample lies outside the input."""
    scale = np.float32(n_out) / np.float32(n_in)
    inv_scale = np.float32(1.0) / scale
    kernel_scale = max(inv_scale, np.float32(1.0))
    sample = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * inv_scale - np.float32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=np.float32)[:, None]) / kernel_scale
    w = kernel(x).astype(np.float32)
    total = w.sum(axis=0, keepdims=True, dtype=np.float32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1), 0).astype(np.float32)
    inside = (sample >= -0.5) & (sample <= np.float32(n_in) - np.float32(0.5))
    return np.where(inside[None, :], w, 0).astype(np.float32)


def _triangle(x):
    return np.maximum(0, 1 - np.abs(x))


def _keys_cubic(x):
    """Keys' cubic with a = -0.5 (jax.image's `_keys_cubic_kernel`)."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


# ---------------------------------------------------------------------------
# graph interpreter
# ---------------------------------------------------------------------------


class _Executor:
    def __init__(self, graph: Graph, device):
        self.g = graph
        self.device = torch.device(device)
        # the initializers stay on the host; their device copies, made on
        # first use, by id (the graph keeps every initializer alive)
        self._uploaded = {}
        self._initializer_ids = {id(v) for v in graph.initializers.values()}

    def _dev(self, x) -> torch.Tensor:
        """A value as a tensor on the session's device (f64 becomes f32, as
        JAX without x64 makes it): an initializer is uploaded once, any
        other host value on each call."""
        if isinstance(x, torch.Tensor):
            return x.to(self.device)
        if id(x) not in self._initializer_ids:
            return self._upload(x)
        if id(x) not in self._uploaded:
            self._uploaded[id(x)] = self._upload(x)
        return self._uploaded[id(x)]

    def _upload(self, x) -> torch.Tensor:
        """A host value on the device; on the card through a pinned buffer,
        so that the copy is queued and the host does not wait for the card."""
        arr = np.asarray(x)
        arr = np.array(arr, np.float32 if arr.dtype == np.float64 else arr.dtype)
        t = torch.from_numpy(arr)
        if self.device.type != "cuda":
            return t.to(self.device)
        return t.pin_memory().to(self.device, non_blocking=True)

    def _both(self, x, y):
        """Two operands of an elementwise op: numpy when both are host
        values, else both tensors on the device."""
        if _is_host(x) and _is_host(y):
            return np.asarray(x), np.asarray(y)
        return self._dev(x), self._dev(y)

    def run(self, feeds: dict) -> dict:
        env = dict(self.g.initializers)
        for k, v in feeds.items():
            env[k] = self._dev(v)
        for node in self.g.nodes:
            fn = getattr(self, f"op_{node.op_type}", None)
            if fn is None:
                raise NotImplementedError(
                    f"ONNX op '{node.op_type}' not implemented in onnx_torch "
                    f"(node '{node.name}')")
            args = [env[i] if i else None for i in node.inputs]
            out = fn(node, *args)
            if not isinstance(out, tuple):
                out = (out,)
            for name, val in zip(node.outputs, out):
                if name:
                    env[name] = val
        return {o: env[o] for o in self.g.outputs}

    # convolution / linear ---------------------------------------------------

    def op_Conv(self, node, x, w, b=None):
        a = node.attrs
        x, w = self._dev(x), self._dev(w)
        nsp = x.ndim - 2
        strides = tuple(a.get("strides", [1] * nsp))
        dilations = tuple(a.get("dilations", [1] * nsp))
        group = int(a.get("group", 1))
        auto_pad = a.get("auto_pad", b"NOTSET")
        if auto_pad in (b"SAME_UPPER", b"SAME_LOWER"):
            # SAME_LOWER puts the odd pad element before the input
            pads = []
            for i in range(nsp):
                k_eff = (w.shape[2 + i] - 1) * dilations[i] + 1
                out = -(-x.shape[2 + i] // strides[i])  # ceil
                total = max(0, (out - 1) * strides[i] + k_eff - x.shape[2 + i])
                lo, hi = total // 2, total - total // 2
                pads.append((hi, lo) if auto_pad == b"SAME_LOWER" else (lo, hi))
        else:
            pads = _pair_pads(a.get("pads"), nsp)
        if any(lo != hi for lo, hi in pads):
            x = F.pad(x, _torch_pad(pads))
            padding = 0
        else:
            padding = tuple(lo for lo, _ in pads)
        conv = (F.conv1d, F.conv2d, F.conv3d)[nsp - 1]
        y = conv_f32(conv, x, w, None, stride=strides, padding=padding, dilation=dilations,
                     groups=group)
        if b is not None:
            y = y + self._dev(b).reshape((1, -1) + (1,) * nsp)
        return y

    def op_ConvTranspose(self, node, x, w, b=None):
        a = node.attrs
        x, w = self._dev(x), self._dev(w)
        nsp = x.ndim - 2
        strides = tuple(a.get("strides", [1] * nsp))
        pads = _pair_pads(a.get("pads"), nsp)
        conv_t = (F.conv_transpose1d, F.conv_transpose2d, F.conv_transpose3d)[nsp - 1]
        # unpadded transpose, then the pads crop the output (group and
        # dilations are not read, as in the JAX executor)
        y = conv_f32(lambda x_, w_, b_, s, p, d, g: conv_t(x_, w_, b_, s), x, w, None,
                     stride=strides)
        crop = [slice(None), slice(None)] + [slice(lo, y.shape[2 + i] - hi)
                                             for i, (lo, hi) in enumerate(pads)]
        y = y[tuple(crop)]
        if b is not None:
            y = y + self._dev(b).reshape((1, -1) + (1,) * nsp)
        return y

    def op_Gemm(self, node, a_in, b_in, c_in=None):
        a = node.attrs
        x, w = self._dev(a_in), self._dev(b_in)
        x = x.t() if a.get("transA", 0) else x
        w = w.t() if a.get("transB", 0) else w
        y = (x @ w) * a.get("alpha", 1.0)
        if c_in is not None:
            y = y + self._dev(c_in) * a.get("beta", 1.0)
        return y

    def op_MatMul(self, node, x, w):
        return torch.matmul(self._dev(x), self._dev(w))

    # normalization / activations -------------------------------------------

    def op_BatchNormalization(self, node, x, scale, b, mean, var):
        x, scale, b, mean, var = (self._dev(t) for t in (x, scale, b, mean, var))
        eps = node.attrs.get("epsilon", 1e-5)
        shape = (1, -1) + (1,) * (x.ndim - 2)
        inv = torch.reciprocal(torch.sqrt(var + eps))
        return (x - mean.reshape(shape)) * (inv * scale).reshape(shape) + b.reshape(shape)

    def op_Relu(self, node, x):
        return torch.relu(self._dev(x))

    def op_LeakyRelu(self, node, x):
        x = self._dev(x)
        return torch.where(x >= 0, x, x * node.attrs.get("alpha", 0.01))

    def op_Sigmoid(self, node, x):
        return torch.sigmoid(self._dev(x))

    def op_HardSigmoid(self, node, x):
        alpha = node.attrs.get("alpha", 0.2)
        beta = node.attrs.get("beta", 0.5)
        return torch.clamp(self._dev(x) * alpha + beta, 0, 1)

    def op_Tanh(self, node, x):
        return torch.tanh(self._dev(x))

    def op_Erf(self, node, x):
        return torch.erf(self._dev(x))

    def op_Softmax(self, node, x):
        return torch.softmax(self._dev(x), dim=node.attrs.get("axis", -1))

    def op_Exp(self, node, x):
        return torch.exp(self._dev(x))

    def op_Log(self, node, x):
        return torch.log(self._dev(x))

    def op_Sqrt(self, node, x):
        return torch.sqrt(self._dev(x))

    def op_Pow(self, node, x, y):
        x, y = self._both(x, y)
        return x ** y

    def op_Neg(self, node, x):
        return -x

    def op_Abs(self, node, x):
        return abs(x)

    def op_Floor(self, node, x):
        return np.floor(x) if _is_host(x) else torch.floor(x)

    def op_Clip(self, node, x, lo=None, hi=None):
        a = node.attrs
        lo = a.get("min") if lo is None else lo
        hi = a.get("max") if hi is None else hi
        x = self._dev(x)
        if lo is None and hi is None:
            return x
        bound = lambda v: None if v is None else self._dev(v).to(x.dtype)  # noqa: E731
        return torch.clamp(x, bound(lo), bound(hi))

    # elementwise binary -----------------------------------------------------

    def op_Add(self, node, x, y):
        x, y = self._both(x, y)
        return x + y

    def op_Sub(self, node, x, y):
        x, y = self._both(x, y)
        return x - y

    def op_Mul(self, node, x, y):
        x, y = self._both(x, y)
        return x * y

    def op_Div(self, node, x, y):
        x, y = self._both(x, y)
        return x / y

    def op_Equal(self, node, x, y):
        x, y = self._both(x, y)
        return x == y

    def op_Greater(self, node, x, y):
        x, y = self._both(x, y)
        return x > y

    def op_Less(self, node, x, y):
        x, y = self._both(x, y)
        return x < y

    def op_Where(self, node, c, x, y):
        if all(_is_host(v) for v in (c, x, y)):
            return np.where(c, x, y)
        return torch.where(self._dev(c), self._dev(x), self._dev(y))

    def op_Max(self, node, *xs):
        out = xs[0]
        for x in xs[1:]:
            out, x = self._both(out, x)
            out = np.maximum(out, x) if _is_host(out) else torch.maximum(out, x)
        return out

    def op_Min(self, node, *xs):
        out = xs[0]
        for x in xs[1:]:
            out, x = self._both(out, x)
            out = np.minimum(out, x) if _is_host(out) else torch.minimum(out, x)
        return out

    # pooling ----------------------------------------------------------------

    def _pool_pads(self, node, x):
        """The kernel, strides and pads of a pool; ceil_mode grows the end
        pads so that every window fits (the JAX executor's emulation)."""
        a = node.attrs
        k = tuple(a["kernel_shape"])
        nsp = len(k)
        strides = tuple(a.get("strides", [1] * nsp))
        pads = _pair_pads(a.get("pads"), nsp)
        if a.get("ceil_mode", 0):
            grown = []
            for i in range(nsp):
                size = x.shape[2 + i] + pads[i][0] + pads[i][1]
                rem = (size - k[i]) % strides[i]
                extra = (strides[i] - rem) % strides[i] if rem else 0
                grown.append((pads[i][0], pads[i][1] + extra))
            pads = tuple(grown)
        return k, strides, pads

    def op_MaxPool(self, node, x):
        x = self._dev(x)
        k, strides, pads = self._pool_pads(node, x)
        x = F.pad(x, _torch_pad(pads), value=float("-inf"))
        pool = (F.max_pool1d, F.max_pool2d, F.max_pool3d)[len(k) - 1]
        return pool(x, k, strides)

    def _window_sum(self, x, k, strides, pads):
        """Sum over each window of x zero-padded by pads (avg_pool with
        divisor 1: no rounding beyond the sum's)."""
        x = F.pad(x, _torch_pad(pads))
        if len(k) == 1:
            return F.avg_pool2d(x[..., None], (k[0], 1), (strides[0], 1),
                                divisor_override=1)[..., 0]
        pool = F.avg_pool2d if len(k) == 2 else F.avg_pool3d
        return pool(x, k, strides, divisor_override=1)

    def op_AveragePool(self, node, x):
        x = self._dev(x)
        k, strides, pads = self._pool_pads(node, x)
        s = self._window_sum(x, k, strides, pads)
        a = node.attrs
        if a.get("count_include_pad", 0) or not any(
                p for pr in _pair_pads(a.get("pads"), len(k)) for p in pr):
            return s / float(np.prod(k))
        return s / self._window_sum(torch.ones_like(x), k, strides, pads)

    def op_GlobalAveragePool(self, node, x):
        x = self._dev(x)
        return x.mean(dim=tuple(range(2, x.ndim)), keepdim=True)

    def op_GlobalMaxPool(self, node, x):
        x = self._dev(x)
        return x.amax(dim=tuple(range(2, x.ndim)), keepdim=True)

    # resize -----------------------------------------------------------------

    def op_Resize(self, node, x, roi=None, scales=None, sizes=None):
        a = node.attrs
        x = self._dev(x)
        mode = _str_attr(a, "mode", "nearest")
        if sizes is not None and _np(sizes).size:
            out_shape = tuple(int(v) for v in _np(sizes))
        else:
            # ONNX spec: output_size = floor(input_size * scale)
            out_shape = tuple(int(np.floor(s * f)) for s, f in zip(x.shape, _np(scales)))
        dims = [d for d in range(x.ndim) if out_shape[d] != x.shape[d]]
        if mode == "nearest":
            ct = _str_attr(a, "coordinate_transformation_mode", "half_pixel")
            # integer upscale (the CNN upsample case): exact by repetition,
            # each element broadcast r times along a new dim next to its own
            if all(o % i == 0 for o, i in zip(out_shape[2:], x.shape[2:])) \
                    and ct in ("asymmetric", "half_pixel"):
                for d in range(2, x.ndim):
                    r = out_shape[d] // x.shape[d]
                    shape = x.shape[:d + 1] + (r,) + x.shape[d + 1:]
                    x = x.unsqueeze(d + 1).expand(shape).flatten(d, d + 1)
                return x
            # jax.image.resize's nearest: floor((i + 0.5) * in / out) in f32
            for d in dims:
                m, n = x.shape[d], out_shape[d]
                idx = np.floor((np.arange(n, dtype=np.float32) + np.float32(0.5))
                               * np.float32(m) / np.float32(n)).astype(np.int64)
                x = x.index_select(d, self._upload(idx))
            return x
        kernel = _triangle if mode in ("linear", "bilinear") else _keys_cubic
        dtype = x.dtype
        x = x.float()
        for d in dims:
            w = self._upload(_resize_weights(x.shape[d], out_shape[d], kernel))
            x = torch.movedim(torch.movedim(x, d, -1) @ w, -1, d)
        return x.to(dtype)

    def op_Upsample(self, node, x, scales=None):
        if scales is None:
            scales = node.attrs.get("scales")
        node.attrs.setdefault("mode", b"nearest")
        return self.op_Resize(node, x, None, np.asarray(_np(scales), np.float32), None)

    # shape plumbing (host-side concrete values) ----------------------------

    def op_Shape(self, node, x):
        return np.asarray(x.shape, np.int64)

    def op_Size(self, node, x):
        return np.asarray(int(np.prod(x.shape)), np.int64)

    def op_Constant(self, node):
        a = node.attrs
        if "value" in a:
            v = a["value"]
            return v if isinstance(v, np.ndarray) else np.asarray(v)
        for k in ("value_float", "value_int"):
            if k in a:
                return np.asarray(a[k])
        if "value_floats" in a:
            return np.asarray(a["value_floats"], np.float32)
        if "value_ints" in a:
            return np.asarray(a["value_ints"], np.int64)
        raise NotImplementedError("Constant without value")

    def op_ConstantOfShape(self, node, shape):
        v = _np(node.attrs.get("value", np.zeros(1, np.float32)))
        return np.full(tuple(int(s) for s in _np(shape)), v.ravel()[0], v.dtype)

    def op_Range(self, node, start, limit, delta):
        return np.arange(int(_np(start)), int(_np(limit)), int(_np(delta)),
                         dtype=_np(start).dtype)

    def op_Cast(self, node, x):
        dtype = _ONNX_DTYPES[node.attrs["to"]]
        if _is_host(x):
            return np.asarray(x).astype(dtype)
        return x.to(_TORCH_DTYPES[np.dtype(dtype)])

    def op_Gather(self, node, x, idx):
        axis = node.attrs.get("axis", 0)
        idx = _np(idx).astype(np.int64)
        if _is_host(x):
            return np.take(x, idx, axis=axis)
        axis %= x.ndim
        flat = self._upload(idx.ravel() % x.shape[axis])
        out = x.index_select(axis, flat)
        return out.reshape(x.shape[:axis] + idx.shape + x.shape[axis + 1:])

    def op_Reshape(self, node, x, shape):
        target = [int(s) for s in _np(shape)]
        if not node.attrs.get("allowzero", 0):
            target = [x.shape[i] if s == 0 else s for i, s in enumerate(target)]
        return x.reshape(target)

    def op_Flatten(self, node, x):
        axis = node.attrs.get("axis", 1)
        lead = int(np.prod(x.shape[:axis])) if axis else 1
        return x.reshape(lead, -1)

    def op_Transpose(self, node, x):
        perm = node.attrs.get("perm")
        if perm is None:
            perm = list(range(x.ndim))[::-1]
        return x.transpose(tuple(perm)) if _is_host(x) else x.permute(tuple(perm))

    def op_Squeeze(self, node, x, axes=None):
        if axes is None:
            axes = node.attrs.get("axes")
        if axes is None:
            return x.reshape([s for s in x.shape if s != 1])
        axes = sorted(int(a) % x.ndim for a in _np(axes).ravel())
        return x.reshape([s for i, s in enumerate(x.shape) if i not in axes])

    def op_Unsqueeze(self, node, x, axes=None):
        if axes is None:
            axes = node.attrs.get("axes")
        # axes are positions in the OUTPUT rank (spec): resolve negatives
        # against the final rank first, then insert ascending
        out_rank = x.ndim + len(_np(axes).ravel())
        axes = sorted(int(a) % out_rank for a in _np(axes).ravel())
        shape = list(x.shape)
        for a in axes:
            shape.insert(a, 1)
        return x.reshape(shape)

    def op_Concat(self, node, *xs):
        axis = node.attrs["axis"]
        if all(_is_host(x) for x in xs):
            return np.concatenate(xs, axis=axis)
        return torch.cat([self._dev(x) for x in xs], dim=axis)

    def op_Split(self, node, x, split=None):
        axis = node.attrs.get("axis", 0)
        if split is None:
            split = node.attrs.get("split")
        if split is None:
            # with no sizes and no num_outputs attr the split count is the
            # node's output count (pre-opset-18 behavior); uneven dims give
            # ceil-sized chunks with a smaller last chunk (opset-18 rule)
            n = node.attrs.get("num_outputs") or len(node.outputs)
            chunk = -(-x.shape[axis] // n)
            sizes = [chunk] * (n - 1) + [x.shape[axis] - chunk * (n - 1)]
        else:
            sizes = [int(s) for s in _np(split).ravel()]
        out, start = [], 0
        for s in sizes:
            idx = [slice(None)] * x.ndim
            idx[axis] = slice(start, start + s)
            out.append(x[tuple(idx)])
            start += s
        return tuple(out)

    def op_Slice(self, node, x, starts=None, ends=None, axes=None, steps=None):
        a = node.attrs
        starts = _np(a["starts"] if starts is None else starts).ravel()
        ends = _np(a["ends"] if ends is None else ends).ravel()
        if axes is None:
            axes = a.get("axes", list(range(len(starts))))
        axes = _np(axes).ravel()
        steps = _np([1] * len(starts) if steps is None else steps).ravel()
        for s, e, ax, st in zip(starts, ends, axes, steps):
            s, e, ax, st = int(s), int(e), int(ax) % x.ndim, int(st)
            # onnx encodes "to the end" as INT64_MAX (huge values clip)
            e = min(e, x.shape[ax]) if st > 0 else max(e, -x.shape[ax] - 1)
            if _is_host(x) or st > 0:
                idx = [slice(None)] * x.ndim
                idx[ax] = slice(s, e, st)
                x = x[tuple(idx)]
            else:  # torch slices take no negative step
                keep = np.arange(x.shape[ax])[slice(s, e, st)].copy()
                x = x.index_select(ax, self._upload(keep))
        return x

    def op_Expand(self, node, x, shape):
        target = tuple(int(s) for s in _np(shape))
        full = np.broadcast_shapes(tuple(x.shape), target)
        return np.broadcast_to(x, full) if _is_host(x) else x.broadcast_to(full)

    def op_Tile(self, node, x, repeats):
        reps = tuple(int(r) for r in _np(repeats))
        return np.tile(x, reps) if _is_host(x) else x.tile(reps)

    def op_Pad(self, node, x, pads=None, value=None):
        a = node.attrs
        x = self._dev(x)
        pads = _np(a["pads"] if pads is None else pads).ravel()
        n = x.ndim
        pairs = tuple((int(pads[i]), int(pads[i + n])) for i in range(n))
        cval = float(_np(value)) if value is not None else a.get("value", 0.0)
        mode = _str_attr(a, "mode", "constant")
        if mode == "constant":
            return F.pad(x, _torch_pad(pairs), value=cval)
        # reflect / replicate pad the trailing dims only: drop the leading
        # unpadded ones
        while pairs and pairs[0] == (0, 0):
            pairs = pairs[1:]
        return F.pad(x, _torch_pad(pairs), mode={"reflect": "reflect", "edge": "replicate"}[mode])

    def op_Identity(self, node, x):
        return x

    def op_Dropout(self, node, x):
        return x

    # reductions -------------------------------------------------------------

    def _axes(self, node, x, axes_in):
        axes = node.attrs.get("axes") if axes_in is None else [
            int(a) for a in _np(axes_in).ravel()]
        if axes is None:
            return None
        return tuple(int(a) % x.ndim for a in axes)

    def _reduce(self, node, x, axes, host_fn, torch_fn):
        ax = self._axes(node, x, axes)
        keep = bool(node.attrs.get("keepdims", 1))
        if _is_host(x):
            return host_fn(x, axis=ax, keepdims=keep)
        return torch_fn(x, dim=ax if ax is not None else tuple(range(x.ndim)), keepdim=keep)

    def op_ReduceMean(self, node, x, axes=None):
        return self._reduce(node, x, axes, np.mean, torch.mean)

    def op_ReduceSum(self, node, x, axes=None):
        return self._reduce(node, x, axes, np.sum, torch.sum)

    def op_ReduceMax(self, node, x, axes=None):
        return self._reduce(node, x, axes, np.max, torch.amax)

    def op_ReduceMin(self, node, x, axes=None):
        return self._reduce(node, x, axes, np.min, torch.amin)

    def op_ArgMax(self, node, x):
        x = self._dev(x)
        axis = node.attrs.get("axis", 0)
        return x.argmax(dim=axis, keepdim=bool(node.attrs.get("keepdims", 1)))


class _IOInfo:
    def __init__(self, name):
        self.name = name
        self.shape = None
        self.type = None


def session_device(device) -> torch.device:
    """`device` as a torch.device; a CUDA device must exist (no silent CPU:
    the CPU runs only when asked for)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the ONNX session runs on the card "
                           "(pass device='cpu' to run it on the CPU)")
    return device


class InferenceSession:
    """onnxruntime.InferenceSession-shaped facade over the executor (the part
    dwpose/onnx_infer.py uses: get_inputs(), get_outputs(), run()). Runs on
    `device` (the card unless the caller asks for the CPU)."""

    def __init__(self, path_or_bytes, providers=None, device="cuda"):  # providers: ORT's, unread
        if isinstance(path_or_bytes, (bytes, bytearray, memoryview)):
            data = bytes(path_or_bytes)
        else:
            with open(path_or_bytes, "rb") as f:
                data = f.read()
        self.device = session_device(device)
        self.graph = parse_model(data)
        self._exec = _Executor(self.graph, self.device)

    def get_inputs(self):
        return [_IOInfo(n) for n in self.graph.inputs]

    def get_outputs(self):
        return [_IOInfo(n) for n in self.graph.outputs]

    @torch.inference_mode()
    def run_tensors(self, output_names, feeds: dict) -> list:
        """run(), with the outputs as they are: device tensors, or numpy for
        host values."""
        out = self._exec.run(feeds)
        return [out[n] for n in (output_names or self.graph.outputs)]

    def run(self, output_names, feeds: dict) -> list:
        """feeds: numpy arrays or tensors; returns numpy arrays (copies), as
        onnxruntime does."""
        return [np.array(_np(v)) for v in self.run_tensors(output_names, feeds)]


# ---------------------------------------------------------------------------
# minimal writer (tests + tooling): build ModelProto bytes from a dict spec
# ---------------------------------------------------------------------------


def _varint(v: int) -> bytes:
    out = bytearray()
    v &= (1 << 64) - 1
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(fno: int, wt: int) -> bytes:
    return _varint((fno << 3) | wt)


def _ld(fno: int, payload: bytes) -> bytes:
    return _tag(fno, 2) + _varint(len(payload)) + payload


_NP_TO_ONNX = {np.dtype(np.float32): 1, np.dtype(np.uint8): 2,
               np.dtype(np.int8): 3, np.dtype(np.int32): 6,
               np.dtype(np.int64): 7, np.dtype(np.bool_): 9,
               np.dtype(np.float16): 10, np.dtype(np.float64): 11}


def _encode_tensor(name: str, arr: np.ndarray) -> bytes:
    arr = np.asarray(arr)
    out = [_tag(1, 0) + _varint(d) for d in arr.shape]
    out += [_tag(2, 0) + _varint(_NP_TO_ONNX[arr.dtype]), _ld(8, name.encode()),
            _ld(9, arr.tobytes())]
    return b"".join(out)


def _encode_attr(name: str, value) -> bytes:
    out = _ld(1, name.encode())
    if isinstance(value, bytes):
        out += _ld(4, value) + _tag(20, 0) + _varint(3)  # STRING
    elif isinstance(value, str):
        out += _ld(4, value.encode()) + _tag(20, 0) + _varint(3)
    elif isinstance(value, float):
        out += _tag(2, 5) + struct.pack("<f", value) + _tag(20, 0) + _varint(1)
    elif isinstance(value, (int, np.integer)):
        out += _tag(3, 0) + _varint(int(value)) + _tag(20, 0) + _varint(2)
    elif isinstance(value, np.ndarray):
        out += _ld(5, _encode_tensor("", value)) + _tag(20, 0) + _varint(4)
    elif isinstance(value, (list, tuple)):
        if all(isinstance(v, (int, np.integer)) for v in value):
            for v in value:
                out += _tag(8, 0) + _varint(int(v))
            out += _tag(20, 0) + _varint(7)  # INTS
        else:
            for v in value:
                out += _tag(7, 5) + struct.pack("<f", float(v))
            out += _tag(20, 0) + _varint(6)  # FLOATS
    else:
        raise TypeError(f"unsupported attr {name}={value!r}")
    return out


def build_model(nodes, initializers: dict, inputs, outputs) -> bytes:
    """nodes: [(op_type, [in], [out], {attrs})]; returns ModelProto bytes
    (for tests and fixtures, without the onnx package; the JAX package's
    bytes, joined once so that a graph of full-size weights builds in
    linear time)."""
    g = []
    for op_type, ins, outs, attrs in nodes:
        n = [_ld(1, i.encode()) for i in ins] + [_ld(2, o.encode()) for o in outs]
        n.append(_ld(4, op_type.encode()))
        n += [_ld(5, _encode_attr(k, v)) for k, v in (attrs or {}).items()]
        g.append(_ld(1, b"".join(n)))
    g += [_ld(5, _encode_tensor(name, arr)) for name, arr in initializers.items()]
    g += [_ld(11, _ld(1, i.encode())) for i in inputs]
    g += [_ld(12, _ld(1, o.encode())) for o in outputs]
    # ModelProto: ir_version(1) + graph(7) + opset_import(8, version 17)
    opset = _tag(2, 0) + _varint(17)
    return _tag(1, 0) + _varint(8) + _ld(7, b"".join(g)) + _ld(8, opset)
