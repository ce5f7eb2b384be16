"""The port's f32 policy for cuDNN convolutions.

PyTorch lets cuDNN compute an f32 convolution in TF32 by default
(`torch.backends.cudnn.allow_tf32` is True), which keeps about three decimal
digits. The JAX package computes the VAE's, the pose stack's and wav2vec2's
convolutions in f32, so the port runs each of them through `conv_f32`: an f32
convolution runs under cuDNN's flags with TF32 off and every other flag as
the caller left it, restored on exit, in the forward and, where a gradient
is taken (the pose stack in training), in its backward too. The caller's
process state is never changed. Other dtypes (the SD family's, FLUX's and
Hunyuan-DiT's bf16 VAEs and UNets) run the convolution without its bias and
add the bias to the rounded result in that dtype, as the JAX package's
`conv(x, w) + b.astype(x.dtype)` rounds twice; a bias inside the
convolution would round once, and moved 30% of the values of a bf16
convolution by one ulp against the JAX package's.
"""

from __future__ import annotations

import inspect

import torch


def _tf32_off():
    """`torch.backends.cudnn.flags` that keep every flag as it is now but
    TF32; flags of this PyTorch version that name no current value
    (fp32_precision, depthwise_kernel) are passed as None: unchanged."""
    cudnn = torch.backends.cudnn
    kw = dict(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
              benchmark_limit=cudnn.benchmark_limit, deterministic=cudnn.deterministic,
              allow_tf32=False)
    kw.update({name: None for name in inspect.signature(cudnn.flags).parameters
               if name not in kw})
    return cudnn.flags(**kw)


def _dims(v, n: int) -> list:
    return list(v) if isinstance(v, (tuple, list)) else [v] * n


class _F32Conv(torch.autograd.Function):
    """conv(x, weight, bias, ...) with TF32 off in the forward and, where a
    gradient is taken, in the backward (aten's convolution_backward, which
    reads the flags when the backward runs, not when the forward did)."""

    @staticmethod
    def forward(ctx, conv, x, weight, bias, stride, padding, dilation, groups):
        with _tf32_off():
            y = conv(x, weight, bias, stride, padding, dilation, groups)
        n = weight.ndim - 2
        ctx.conf = (_dims(stride, n), _dims(padding, n), _dims(dilation, n), groups,
                    None if bias is None else [bias.shape[0]])
        ctx.save_for_backward(x, weight)
        return y

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        stride, padding, dilation, groups, bias_sizes = ctx.conf
        with _tf32_off():
            gx, gw, gb = torch.ops.aten.convolution_backward(
                g, x, weight, bias_sizes, stride, padding, dilation, False,
                [0] * len(stride), groups, list(ctx.needs_input_grad[1:4]))
        return None, gx, gw, gb, None, None, None, None


def conv_f32(conv, x: torch.Tensor, weight: torch.Tensor, bias=None, stride=1, padding=0,
             dilation=1, groups=1) -> torch.Tensor:
    """conv (F.conv1d, F.conv2d or F.conv3d) of x: in full f32 when x is f32
    (cuDNN TF32 off, scoped, in the forward and the backward); in any other
    dtype the bias is added to the rounded convolution in that dtype."""
    if x.dtype != torch.float32:
        y = conv(x, weight, None, stride, padding, dilation, groups)
        if bias is None:
            return y
        return y + bias.to(y.dtype).reshape(-1, *([1] * (y.ndim - 2)))
    return _F32Conv.apply(conv, x, weight, bias, stride, padding, dilation, groups)


def conv_transpose2d_f32(x: torch.Tensor, weight: torch.Tensor, bias=None, stride=1,
                         padding=0) -> torch.Tensor:
    """F.conv_transpose2d of x, in full f32 when x is f32 (cuDNN TF32 off,
    scoped); forward only (RIFE's flow heads, at inference)."""
    if x.dtype != torch.float32:
        return torch.nn.functional.conv_transpose2d(x, weight, bias, stride, padding)
    with _tf32_off():
        return torch.nn.functional.conv_transpose2d(x, weight, bias, stride, padding)
