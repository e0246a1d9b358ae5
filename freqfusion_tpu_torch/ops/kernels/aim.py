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
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build, _mma

#: Kernel launches since the last reset, by kernel. Plain runs are not counted.
launches = {"aim_conv_branch": 0, "aim_gates_proj": 0}

#: What csrc/aim.cu takes: B5a's channels (a thread a channel quad), B5b's S-Map width
#: (DAT: 180 // 16 = 11; its sums sit in a lane's registers) and B5b's channels (a row of
#: 128 pixels staged whole beside tile_mma's ring: _mma.MAX_ROW_K).
MAX_CONV_C = 1024
MAX_MID = 12
MAX_C = _mma.MAX_ROW_K


def depthwise3x3_plain(x, wdw, bdw):
    """3x3 depthwise SAME conv of an NHWC tensor; wdw (3,3,1,C) HWIO."""
    c = x.shape[-1]
    y = F.conv2d(x.permute(0, 3, 1, 2), wdw.reshape(9, c).t().reshape(c, 1, 3, 3), bdw,
                 padding=1, groups=c)
    return y.permute(0, 2, 3, 1)


def aim_conv_branch_plain(v, wdw, bdw, bn_scale, bn_shift):
    """v [B,H,W,C] -> (conv_x [B,H,W,C], sums [B,1,1,C] = the sum of conv_x over H, W).
    bn_scale/bn_shift: the folded eval-mode BatchNorm affine."""
    cx = F.gelu(depthwise3x3_plain(v, wdw, bdw) * bn_scale + bn_shift).contiguous()
    return cx, cx.sum(dim=(1, 2), keepdim=True)


def aim_gates_proj_plain(attened, conv_x, chmap_vec, si_w1, si_b1, si_bn_scale,
                         si_bn_shift, si_w2, si_b2, proj_w, proj_b, swap: bool = False):
    """The pointwise AIM tail. chmap_vec [B,1,1,C] is the C-Map before its sigmoid.
    swap=False (spatial block): attened * s(C-Map) + conv_x * s(S-Map(attened));
    swap=True (channel block):  attened * s(S-Map(conv_x)) + conv_x * s(C-Map)."""
    c = attened.shape[-1]
    src = conv_x if swap else attened
    g = src @ si_w1.reshape(c, -1) + si_b1
    g = F.gelu(g * si_bn_scale + si_bn_shift) @ si_w2.reshape(-1, 1) + si_b2
    smap, cgate = torch.sigmoid(g), torch.sigmoid(chmap_vec)
    if swap:
        y = attened * smap + conv_x * cgate
    else:
        y = attened * cgate + conv_x * smap
    return y @ proj_w + proj_b


def gates_planes(si_w1: torch.Tensor, proj_w: torch.Tensor):
    """(kp, the S-Map's fc1 [C,MAX_MID] zero-padded, the projection's planes): proj [C,C] as
    tile_mma's B fragments, hi and lo, of [kp,kp] (kp = C padded to a multiple of 8). Both
    are made once for each weight (``_mma.kept``), so the views that the model passes
    will do."""
    c, mid = si_w1.shape[-2:]
    kp = -(-c // 8) * 8
    w1 = si_w1.reshape(c, mid)
    fc1 = _mma.kept(("aim_smap",), lambda: F.pad(w1, (0, MAX_MID - mid)).contiguous(), w1)
    return kp, fc1, _mma.planes(proj_w, kp, kp)


def aim_conv_branch(v, wdw, bdw, bn_scale, bn_shift):
    """Kernel B5a on CUDA, its plain version on the CPU. Returns (conv_x, sums [B,1,1,C])."""
    _build.require_no_grad("aim_conv_branch", v, wdw, bdw, bn_scale, bn_shift)
    if v.device.type == "cpu":
        return aim_conv_branch_plain(v, wdw, bdw, bn_scale, bn_shift)
    b, h, w, c = v.shape
    if c % 4 or c > MAX_CONV_C:
        raise ValueError(f"aim_conv_branch: C={c} is not a multiple of 4 up to {MAX_CONV_C}")
    _build.require(v, "v")
    _build.require(wdw, "wdw", (3, 3, 1, c))
    for name, t in (("bdw", bdw), ("bn_scale", bn_scale), ("bn_shift", bn_shift)):
        _build.require(t, name, (c,))
    lib = _build.library()
    cx = torch.empty_like(v)
    part = torch.empty((b, lib.aim_conv_branch_blocks(h, w), c), device=v.device,
                       dtype=torch.float32)
    sums = torch.empty((b, 1, 1, c), device=v.device, dtype=torch.float32)
    with torch.cuda.device(v.device):
        err = lib.aim_conv_branch(v.data_ptr(), wdw.data_ptr(), bdw.data_ptr(),
                                  bn_scale.data_ptr(), bn_shift.data_ptr(), cx.data_ptr(),
                                  part.data_ptr(), sums.data_ptr(), b, h, w, c,
                                  _build.stream_ptr(v.device))
    _build.check(err, "aim_conv_branch")
    launches["aim_conv_branch"] += 1
    return cx, sums


def aim_gates_proj(attened, conv_x, chmap_vec, si_w1, si_b1, si_bn_scale, si_bn_shift,
                   si_w2, si_b2, proj_w, proj_b, swap: bool = False):
    """Kernel B5b on CUDA, its plain version on the CPU. Returns [B,H,W,C]."""
    _build.require_no_grad("aim_gates_proj", attened, conv_x, chmap_vec, si_w1, si_b1,
                           si_bn_scale, si_bn_shift, si_w2, si_b2, proj_w, proj_b)
    if attened.device.type == "cpu":
        return aim_gates_proj_plain(attened, conv_x, chmap_vec, si_w1, si_b1, si_bn_scale,
                                    si_bn_shift, si_w2, si_b2, proj_w, proj_b, swap)
    b, h, w, c = attened.shape
    mid = si_w1.shape[-1]
    if c % 4 or c > MAX_C:
        raise ValueError(f"aim_gates_proj: C={c} is not a multiple of 4 up to {MAX_C}")
    if mid > MAX_MID:
        raise ValueError(f"aim_gates_proj: S-Map width {mid} exceeds {MAX_MID}")
    _build.require(attened, "attened")
    _build.require(conv_x, "conv_x", attened.shape)
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
    kp, fc1, projp = gates_planes(si_w1, proj_w)
    lib = _build.library()
    out = torch.empty_like(attened)
    with torch.cuda.device(attened.device):
        err = lib.aim_gates_proj(attened.data_ptr(), conv_x.data_ptr(), chmap_vec.data_ptr(),
                                 fc1.data_ptr(), si_b1.data_ptr(), si_bn_scale.data_ptr(),
                                 si_bn_shift.data_ptr(), si_w2.data_ptr(), si_b2.data_ptr(),
                                 projp.data_ptr(), proj_b.data_ptr(), out.data_ptr(),
                                 b, h, w, c, mid, kp, int(bool(swap)),
                                 _build.stream_ptr(attened.device))
    _build.check(err, "aim_gates_proj")
    launches["aim_gates_proj"] += 1
    return out
