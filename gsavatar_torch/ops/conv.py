"""2-D convolution in full f32 precision, forward and backward, with the
same bits on every run.

cuDNN computes f32 convolutions in TF32 unless
`torch.backends.cudnn.allow_tf32` is off, and may pick algorithms whose
backward sums in a run-dependent order (atomics) unless
`torch.backends.cudnn.deterministic` is on; autograd reads both flags when
the backward pass runs, not when the forward did. `conv2d_f32` sets both
around both passes, so that the losses that own their convolutions (SSIM,
LPIPS) are f32 and reproducible whatever the caller has set. On the CPU the
flags have no effect."""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch.nn.modules.utils import _pair

from gsavatar_torch import tracing


@contextlib.contextmanager
def _f32_deterministic():
    cudnn = torch.backends.cudnn
    old = cudnn.allow_tf32, cudnn.deterministic
    cudnn.allow_tf32, cudnn.deterministic = False, True
    try:
        yield
    finally:
        cudnn.allow_tf32, cudnn.deterministic = old


class _Conv2dF32(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, weight, bias, stride, padding, groups):
        ctx.save_for_backward(x, weight)
        ctx.conf = (_pair(stride), _pair(padding), groups, bias is not None)
        with _f32_deterministic():
            return F.conv2d(x, weight, bias, stride, padding, 1, groups)

    @staticmethod
    def backward(ctx, grad):
        x, weight = ctx.saved_tensors
        stride, padding, groups, has_bias = ctx.conf
        need = ctx.needs_input_grad
        with tracing.span('backward/conv'), _f32_deterministic():
            gx, gw, gb = torch.ops.aten.convolution_backward(
                grad, x, weight, [weight.shape[0]] if has_bias else None,
                list(stride), list(padding), [1, 1], False, [0, 0], groups,
                [need[0], need[1], has_bias and need[2]])
        return gx, gw, gb, None, None, None


def conv2d_f32(x, weight, bias=None, stride=1, padding=0, groups: int = 1):
    """`F.conv2d` (dilation 1) with TF32 off and cuDNN held to
    deterministic algorithms in the forward and the backward pass."""
    return _Conv2dF32.apply(x, weight, bias, stride, padding, groups)
