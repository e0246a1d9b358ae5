"""DAT's Adaptive Interaction Module: kernels B5a (conv branch) and B5b (gates + proj), with
their plain versions.

Twin of ``freqfusion_tpu/ops/pallas/aim.py``. Every DAT block joins its attention branch
to a depthwise-conv branch through two sigmoid gates and an output projection:

    conv_x = GELU(BN(dwconv3x3(v)))
    C-Map  = the channel gate, an MLP on a pooled [B,1,1,C] vector (the caller's, in torch)
    S-Map  = fc2(GELU(BN(fc1(.))))   the spatial gate, per pixel, C -> C/16 -> 1
    out    = proj(attened * sigmoid(gate_1) + conv_x * sigmoid(gate_2))

On a CUDA tensor each wrapper launches its kernel from ``csrc/aim.cu`` or raises; on a CPU
tensor it runs the plain PyTorch version. Parameters come in the JAX package's layouts:
the depthwise kernel (3,3,1,C) HWIO, 1x1 convs (1,1,I,O), proj [C,C] as [in,out]. B5b's
projection runs f32-exact on the tensor cores (3xTF32) on its weight split into TF32 hi and
lo parts, and both it and the S-Map's padded fc1 are made once for each weight
(``gates_planes``): the S-Map's fc1 and proj may be views (DAT passes its parameters' own).

Every tensor of a call is float32, or every one bfloat16: then B5a computes in f32 on the
bf16 values and rounds conv_x once (its sums are f32), and B5b rounds each matmul operand to
bf16 as the TPU kernel casts it (the S-Map's source and its GELU output, the gated sum, and
the weights), with f32 accumulation and a bf16 output; above _mma.MAX_ROW_K channels its K
pieces sum in an f32 scratch and the output is rounded once. At float32 with bf16 operands
(``mxu_dtype``, or precision "default": ``_mma.operand_dtype``) B5b rounds the same operands
and stores f32; B5a has no product and no ``mxu_dtype`` (as ``aim.py:77``): its f32 kernel
serves precision "default".
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build, _mma

#: Kernel launches since the last reset, by kernel. Plain runs are not counted.
launches = {"aim_conv_branch": 0, "aim_gates_proj": 0}

#: What csrc/aim.cu takes: both kernels' channels (B5a: slices of at most 48 channel quads a
#: block; B5b: up to _mma.MAX_ROW_K a row of 128 pixels is staged whole beside tile_mma's
#: ring, above it the projection takes K in pieces) and B5b's S-Map width (DAT: C // 16),
#: whose sums a lane keeps in registers SMAP_GROUP at a time, one pass over the rows a group.
MAX_C = 1024
MAX_MID = 64
SMAP_GROUP = 12


def depthwise3x3_plain(x, wdw, bdw):
    """3x3 depthwise SAME conv of an NHWC tensor; wdw (3,3,1,C) HWIO."""
    c = x.shape[-1]
    x, wdw, bdw = map(_mma.up, (x, wdw, bdw))
    y = F.conv2d(x.permute(0, 3, 1, 2), wdw.reshape(9, c).t().reshape(c, 1, 3, 3), bdw,
                 padding=1, groups=c)
    return y.permute(0, 2, 3, 1)


def aim_conv_branch_plain(v, wdw, bdw, bn_scale, bn_shift):
    """v [B,H,W,C] -> (conv_x [B,H,W,C], sums [B,1,1,C] = the sum of conv_x over H, W).
    bn_scale/bn_shift: the folded eval-mode BatchNorm affine."""
    cx = F.gelu(depthwise3x3_plain(v, wdw, bdw) * _mma.up(bn_scale)
                + _mma.up(bn_shift)).contiguous()
    return cx.to(v.dtype), cx.sum(dim=(1, 2), keepdim=True)


def aim_gates_proj_plain(attened, conv_x, chmap_vec, si_w1, si_b1, si_bn_scale,
                         si_bn_shift, si_w2, si_b2, proj_w, proj_b, swap: bool = False,
                         mxu_dtype=None):
    """The pointwise AIM tail. chmap_vec [B,1,1,C] is the C-Map before its sigmoid.
    swap=False (spatial block): attened * s(C-Map) + conv_x * s(S-Map(attened));
    swap=True (channel block):  attened * s(S-Map(conv_x)) + conv_x * s(C-Map)."""
    c = attened.shape[-1]
    dt = attened.dtype
    mdt = _mma.operand_dtype(dt, mxu_dtype)
    (attened, conv_x, chmap_vec, si_w1, si_b1, si_bn_scale, si_bn_shift, si_w2, si_b2,
     proj_w, proj_b) = map(_mma.up, (attened, conv_x, chmap_vec, si_w1, si_b1, si_bn_scale,
                                     si_bn_shift, si_w2, si_b2, proj_w, proj_b))
    si_w1, si_w2, proj_w = (_mma.rnd(t, mdt) for t in (si_w1, si_w2, proj_w))
    src = conv_x if swap else attened
    g = _mma.rnd(src, mdt) @ si_w1.reshape(c, -1) + si_b1
    g = (_mma.rnd(F.gelu(g * si_bn_scale + si_bn_shift), mdt) @ si_w2.reshape(-1, 1)
         + si_b2)
    smap, cgate = torch.sigmoid(g), torch.sigmoid(chmap_vec)
    if swap:
        y = attened * smap + conv_x * cgate
    else:
        y = attened * cgate + conv_x * smap
    return (_mma.rnd(y, mdt) @ proj_w + proj_b).to(dt)


def smap_groups(w1: torch.Tensor) -> torch.Tensor:
    """The S-Map's fc1 [C,mid] in the kernel's groups of SMAP_GROUP hidden units:
    [ceil(mid / SMAP_GROUP), C, SMAP_GROUP], zero past mid (one group, [1,C,12], at DAT's
    mid of 11)."""
    c, mid = w1.shape
    ng = -(-mid // SMAP_GROUP)
    return F.pad(w1, (0, ng * SMAP_GROUP - mid)).reshape(c, ng, SMAP_GROUP).transpose(
        0, 1).contiguous()


def gates_planes(si_w1: torch.Tensor, proj_w: torch.Tensor, bf16: bool = False):
    """(kp, the S-Map's fc1 in groups (``smap_groups``), the projection's planes): proj [C,C]
    as tile_mma's B fragments, hi and lo, of [kp,kp] (kp = C padded to a multiple of 8; of
    its bf16 rounding with `bf16`). Both are made once for each weight (``_mma.kept``), so
    the views that the model passes will do; the kernel rounds fc1 as it stages it."""
    c, mid = si_w1.shape[-2:]
    kp = -(-c // 8) * 8
    w1 = si_w1.reshape(c, mid)
    fc1 = _mma.kept(("aim_smap",), lambda: smap_groups(_mma.up(w1)), w1)
    return kp, fc1, _mma.planes(proj_w, kp, kp, bf16)


def aim_conv_branch(v, wdw, bdw, bn_scale, bn_shift):
    """Kernel B5a on CUDA, its plain version on the CPU. Returns (conv_x, sums [B,1,1,C])."""
    _build.require_no_grad("aim_conv_branch", v, wdw, bdw, bn_scale, bn_shift)
    _build.require_dtypes("aim_conv_branch", v, wdw, bdw, bn_scale, bn_shift)
    if v.device.type == "cpu":
        return aim_conv_branch_plain(v, wdw, bdw, bn_scale, bn_shift)
    b, h, w, c = v.shape
    if c % 4 or c > MAX_C:
        raise ValueError(f"aim_conv_branch: C={c} is not a multiple of 4 up to {MAX_C}")
    io = _build.io_code(v, "v", torch.float32)   # no product: f32 operands at float32
    _build.require(v, "v")
    _build.require(wdw, "wdw", (3, 3, 1, c))
    for name, t in (("bdw", bdw), ("bn_scale", bn_scale), ("bn_shift", bn_shift)):
        _build.require(t, name, (c,))
    wdw, bdw, bn_scale, bn_shift = map(_mma.f32, (wdw, bdw, bn_scale, bn_shift))
    lib = _build.library()
    cx = torch.empty_like(v)
    part = torch.empty((b, lib.aim_conv_branch_blocks(h, w, c), c), device=v.device,
                       dtype=torch.float32)
    sums = torch.empty((b, 1, 1, c), device=v.device, dtype=torch.float32)
    with torch.cuda.device(v.device):
        err = lib.aim_conv_branch(v.data_ptr(), wdw.data_ptr(), bdw.data_ptr(),
                                  bn_scale.data_ptr(), bn_shift.data_ptr(), cx.data_ptr(),
                                  part.data_ptr(), sums.data_ptr(), b, h, w, c, io,
                                  _build.stream_ptr(v.device))
    _build.check(err, "aim_conv_branch")
    _build.count(launches, "aim_conv_branch", (b, h, w, c))
    return cx, sums


def aim_gates_proj(attened, conv_x, chmap_vec, si_w1, si_b1, si_bn_scale, si_bn_shift,
                   si_w2, si_b2, proj_w, proj_b, swap: bool = False, mxu_dtype=None):
    """Kernel B5b on CUDA, its plain version on the CPU. Returns [B,H,W,C]. `mxu_dtype`:
    the matmul operand dtype (``_mma.operand_dtype``; None: the process-wide one)."""
    _build.require_no_grad("aim_gates_proj", attened, conv_x, chmap_vec, si_w1, si_b1,
                           si_bn_scale, si_bn_shift, si_w2, si_b2, proj_w, proj_b)
    _build.require_dtypes("aim_gates_proj", attened, conv_x, si_w1, si_b1,
                          si_bn_scale, si_bn_shift, si_w2, si_b2, proj_w, proj_b)
    if attened.device.type == "cpu":
        return aim_gates_proj_plain(attened, conv_x, chmap_vec, si_w1, si_b1, si_bn_scale,
                                    si_bn_shift, si_w2, si_b2, proj_w, proj_b, swap, mxu_dtype)
    b, h, w, c = attened.shape
    mid = si_w1.shape[-1]
    if c % 4 or c > MAX_C:
        raise ValueError(f"aim_gates_proj: C={c} is not a multiple of 4 up to {MAX_C}")
    if not 1 <= mid <= MAX_MID:
        raise ValueError(f"aim_gates_proj: S-Map width {mid} outside [1, {MAX_MID}]")
    io = _build.io_code(attened, "attened", mxu_dtype)
    _build.require(attened, "attened")
    _build.require(conv_x, "conv_x", attened.shape)
    # the C-Map may be f32 (from B5a's f32 sums) where attened is bf16
    _build.require(chmap_vec, "chmap_vec", (b, 1, 1, c))
    # fc1 and proj are laid out anew (gates_planes): views will do
    _build.require(si_w1, "si_w1", (1, 1, c, mid), contiguous=False)
    _build.require(proj_w, "proj_w", (c, c), contiguous=False)
    _build.require(si_w2, "si_w2", (1, 1, mid, 1))
    _build.require(si_b2, "si_b2", (1,))
    for name, t in (("si_b1", si_b1), ("si_bn_scale", si_bn_scale),
                    ("si_bn_shift", si_bn_shift)):
        _build.require(t, name, (mid,))
    _build.require(proj_b, "proj_b", (c,))
    kp, fc1, projp = gates_planes(si_w1, proj_w, io == 2)
    si_b1, si_bn_scale, si_bn_shift, si_w2, si_b2, proj_b = map(
        _mma.f32, (si_b1, si_bn_scale, si_bn_shift, si_w2, si_b2, proj_b))
    chmap_vec = _mma.up(chmap_vec).contiguous()
    lib = _build.library()
    out = torch.empty_like(attened)
    # the K pieces' f32 sums above MAX_ROW_K channels at bf16 (f32 storage sums them in out)
    y = (torch.empty(attened.shape, device=attened.device, dtype=torch.float32)
         if io == 1 and kp > _mma.MAX_ROW_K else None)
    with torch.cuda.device(attened.device):
        err = lib.aim_gates_proj(attened.data_ptr(), conv_x.data_ptr(), chmap_vec.data_ptr(),
                                 fc1.data_ptr(), si_b1.data_ptr(), si_bn_scale.data_ptr(),
                                 si_bn_shift.data_ptr(), si_w2.data_ptr(), si_b2.data_ptr(),
                                 projp.data_ptr(), proj_b.data_ptr(), out.data_ptr(),
                                 None if y is None else y.data_ptr(),
                                 b, h, w, c, mid, kp, int(bool(swap)), io,
                                 _build.stream_ptr(attened.device))
    _build.check(err, "aim_gates_proj")
    _build.count(launches, "aim_gates_proj", (b, h, w, c, mid))
    return out
