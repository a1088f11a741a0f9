"""The float32 forward of a square-stencil 3×3 convolution (stride 1,
padding 1, bias) on NHWC maps, and its autograd Function.

``conv3x3(x, weight, bias)`` launches csrc/conv3x3_f32_sm90.cu for CUDA
tensors (an implicit GEMM in full f32 FFMA, the bias in its epilogue; the
same bits from launch to launch) and runs ``conv3x3_plain`` (``F.conv2d``)
for CPU tensors. It replaces no TPU kernel: the JAX package leaves the
convolution to XLA. cuDNN takes its FFT route for the SwinIR trunk's f32
convs at C = 180, some 400× this kernel's bound (PERF.md), so the SwinIR
trunk calls this for its square 3×3 convs when it computes in f32.

``Conv3x3Function`` takes the NCHW view of an NHWC map, as the trunk's
``x.permute(0, 3, 1, 2)`` hands ``F.conv2d``: its forward is ``conv3x3``
and its backward is ``aten.convolution_backward`` on the same arguments
autograd's convolution node passes, so the gradients are those of
``F.conv2d`` (the same library algorithms).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ciaosr_torch.ops import kernels
from ciaosr_torch.ops.kernels import _build

# the C entry point's prototype: x, w, bias, out, B, H, W, Cin, Cout, stream
ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def relayout_weight(weight: torch.Tensor) -> torch.Tensor:
    """(Cout, Cin, 3, 3) → the kernel's tap-major (9·Cin, Cout) matrix: row
    (3·dy + dx)·Cin + ci holds w[:, ci, dy, dx]."""
    cout, cin = weight.shape[:2]
    return weight.permute(2, 3, 1, 0).reshape(9 * cin, cout)


def conv3x3_plain(x: torch.Tensor, weight: torch.Tensor,
                  bias: torch.Tensor) -> torch.Tensor:
    """x (B, H, W, Cin) → (B, H, W, Cout): ``F.conv2d`` with padding 1 on
    the NCHW view, returned as the NHWC view of its output."""
    return F.conv2d(x.permute(0, 3, 1, 2), weight, bias,
                    padding=1).permute(0, 2, 3, 1)


def _check_aligned(t: torch.Tensor, name: str) -> None:
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def conv3x3(x: torch.Tensor, weight: torch.Tensor,
            bias: torch.Tensor) -> torch.Tensor:
    """The kernel on CUDA tensors, the plain version on CPU tensors. x
    (B, H, W, Cin) f32, weight (Cout, Cin, 3, 3) f32, bias (Cout,) f32 →
    (B, H, W, Cout) f32 (contiguous on the card). The kernel takes Cin and
    Cout multiples of 4."""
    b, h, w, cin = x.shape
    cout = weight.shape[0]
    if tuple(weight.shape) != (cout, cin, 3, 3):
        raise ValueError(f"weight must be ({cout}, {cin}, 3, 3), got "
                         f"{tuple(weight.shape)}")
    if x.is_cpu:
        return conv3x3_plain(x, weight, bias)
    if cin % 4 or cout % 4:
        raise ValueError(f"conv3x3 takes channel counts that are multiples "
                         f"of 4, got {cin} → {cout}")
    x = x.contiguous()
    wt = relayout_weight(weight)
    bias = bias.contiguous()
    _build.check_tensor(x, (b, h, w, cin), "x", torch.float32)
    _build.check_tensor(wt, (9 * cin, cout), "weight", torch.float32)
    _build.check_tensor(bias, (cout,), "bias", torch.float32)
    _check_aligned(x, "x")
    out = x.new_empty((b, h, w, cout))
    fn = _build.function("conv3x3_f32_sm90", "conv3x3_f32", ARGTYPES)
    err = fn(x.data_ptr(), wt.data_ptr(), bias.data_ptr(), out.data_ptr(),
             b, h, w, cin, cout, _build.stream_ptr(x.device))
    kernels.LAUNCHES["conv3x3_f32"] += 1
    _build.check(err, "conv3x3_f32")
    return out


class Conv3x3Function(torch.autograd.Function):
    """``F.conv2d(x, weight, bias, padding=1)`` for x the NCHW view of an
    NHWC map: the forward by ``conv3x3``, the backward by
    ``aten.convolution_backward`` on the same x, weight and arguments."""

    @staticmethod
    def forward(ctx, x, weight, bias):
        ctx.save_for_backward(x, weight)
        return conv3x3(x.permute(0, 2, 3, 1), weight, bias).permute(
            0, 3, 1, 2)

    @staticmethod
    def backward(ctx, grad):
        x, weight = ctx.saved_tensors
        return torch.ops.aten.convolution_backward(
            grad, x, weight, [weight.shape[0]], [1, 1], [1, 1], [1, 1],
            False, [0, 0], 1, list(ctx.needs_input_grad))
