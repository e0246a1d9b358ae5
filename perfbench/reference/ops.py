"""Plain PyTorch operations of the reference model, and the operand rounding of its control.

Every product of the reference (linear layers, matrix products, convolutions) goes through
``lin``, ``mm`` or ``conv``, which round both operands, and for fp8 also the result, when a
rounding is set (``operand_rounding``): "tf32" keeps 10 mantissa bits of each operand and a
float32 result (TF32 tensor-core math); "fp8_e4m3" keeps 3 mantissa bits of the operands and
of the result (computing in fp8; its exponent range is not modelled: values keep float32's).
Without a rounding every product is float32; the caller keeps TF32 off (``exact_float32``).
"""

from __future__ import annotations

import contextlib
import threading

import torch
import torch.nn.functional as F

#: each named rounding of the control: (mantissa bits kept, whether results are rounded too)
ROUNDINGS = {"tf32": (10, False), "fp8_e4m3": (3, True)}

_STATE = threading.local()


@contextlib.contextmanager
def operand_rounding(name):
    """Inside the block every product of the reference rounds its operands to the mantissa
    of `name` (``ROUNDINGS``; None: no rounding)."""
    before = getattr(_STATE, "mode", None)
    _STATE.mode = None if name is None else ROUNDINGS[name]
    try:
        yield
    finally:
        _STATE.mode = before


@contextlib.contextmanager
def exact_float32():
    """TF32 off for cuBLAS and cuDNN inside the block, the caller's flags restored after."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def round_mantissa(t: torch.Tensor, bits: int) -> torch.Tensor:
    """float32 `t` rounded to `bits` mantissa bits, to nearest with ties to even."""
    drop = 23 - bits
    i = t.float().contiguous().view(torch.int32)
    lsb = (i >> drop) & 1
    i = (i + ((1 << (drop - 1)) - 1) + lsb) & ~((1 << drop) - 1)
    return i.view(torch.float32)


def q(t: torch.Tensor) -> torch.Tensor:
    """An operand of a product, rounded as the current rounding says."""
    mode = getattr(_STATE, "mode", None)
    return t if mode is None else round_mantissa(t, mode[0])


def r(t: torch.Tensor) -> torch.Tensor:
    """The result of a product, rounded where the current rounding rounds results."""
    mode = getattr(_STATE, "mode", None)
    return t if mode is None or not mode[1] else round_mantissa(t, mode[0])


def lin(x: torch.Tensor, layer, bias=True) -> torch.Tensor:
    """x @ W^T + b of an ``nn.Linear`` (or any module with ``weight`` [out, in] and ``bias``)."""
    return r(F.linear(q(x), q(layer.weight), layer.bias if bias else None))


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return r(torch.matmul(q(a), q(b)))


def conv(x: torch.Tensor, layer, stride=1, padding=None, groups=None) -> torch.Tensor:
    """An ``nn.Conv2d``'s convolution of an NCHW tensor with its own padding and groups
    unless given."""
    return r(F.conv2d(q(x), q(layer.weight), layer.bias,
                      stride=stride if stride != 1 else layer.stride,
                      padding=layer.padding if padding is None else padding,
                      groups=layer.groups if groups is None else groups))


def conv_w(x: torch.Tensor, weight, bias=None, padding=0, stride=1, groups=1) -> torch.Tensor:
    return r(F.conv2d(q(x), q(weight), bias, stride=stride, padding=padding, groups=groups))


def ln(x: torch.Tensor, norm, eps=None) -> torch.Tensor:
    """LayerNorm over the last axis with the module's parameters and eps."""
    return F.layer_norm(x, (x.shape[-1],), norm.weight, norm.bias,
                        norm.eps if eps is None else eps)


def bn(x: torch.Tensor, norm) -> torch.Tensor:
    """Eval-mode BatchNorm of an NCHW tensor from its running statistics."""
    shape = (1, -1) + (1,) * (x.dim() - 2)
    inv = torch.rsqrt(norm.running_var + norm.eps) * norm.weight
    return (x - norm.running_mean.reshape(shape)) * inv.reshape(shape) + norm.bias.reshape(shape)


def resize(x: torch.Tensor, h: int, w: int, mode: str = "bilinear") -> torch.Tensor:
    """NCHW resize with align_corners=False and no antialiasing."""
    return F.interpolate(x, size=(h, w), mode=mode, align_corners=False)


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x)
