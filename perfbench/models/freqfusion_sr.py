"""FreqFusionSR (``models/experts.py``): HAT, DAT and NAFNet experts and the fusion head, served
behind the program's ``InferencePipeline``.

The check compares, for each sampled row, each expert's image, the head's three guidance bands
(LR; the band fusion's output, fed by the cross-band attention B11 and the LKA gate B12) and
its fused image (the input of its refinement, before the clamp):

* ``hat``, ``dat``, ``nafnet``, ``bands``: max |program - reference| over the reference's
  max |.|;
* ``fused``: the 99.9th percentile of |program - reference| over the reference's max |.|. A
  percentile, not the maximum: the selector's gate is a step (a gate within 1% of the pixel's
  largest is raised to 0.9), so a rounding can put a few pixels of a correct run on its other
  side.

At bfloat16 the fused and served images are set by their own rounding to bf16 (about a level
near white) and by the selector's step, whatever the products did, so they do not separate
there from the control; the experts' images and the bands do.
"""

from __future__ import annotations

import torch

from perfbench.core import bounds
from perfbench.reference import freqfusion

EXPERTS = ("hat", "dat", "nafnet")
UNSERVED = freqfusion.UNSERVED
NUMBERS = {"hat": "rel_max", "dat": "rel_max", "nafnet": "rel_max", "bands": "rel_max",
           "fused": "rel_q999"}
#: a small FreqFusionSR, for runs of the harness on the CPU
TINY = {
    "hat": dict(embed_dim=24, depths=[2], num_heads=[4], window=8, compress=3, squeeze=4,
                conv_scale=0.01, overlap_ratio=0.5, mlp_ratio=2.0, num_feat=16, img_range=1.0),
    "dat": dict(embed_dim=64, depths=[2], num_heads=[4], split_size=[4, 16], expansion=2.0,
                num_feat=16, img_range=1.0),
    "nafnet": dict(width=8, middle_blk_num=1, enc_blk_nums=[1, 1], dec_blk_nums=[1, 1]),
    "head": dict(fusion_dim=16, num_heads=2, refine_depth=2, refine_channels=8, block_size=8)}


def build(cfg: dict, device):
    from freqfusion_tpu_torch.models.experts import FreqFusionSR
    from freqfusion_tpu_torch.models.fusion import FusionConfig

    torch.manual_seed(0)
    with torch.device(device):
        model = FreqFusionSR(FusionConfig(upscale=cfg["upscale"], **cfg["head"]),
                             hat_kwargs=cfg["hat"], dat_kwargs=cfg["dat"],
                             nafnet_kwargs=cfg["nafnet"])
    return model.to(device)


def reference(cfg: dict):
    return freqfusion.FreqFusionRef(cfg)


def taps(model):
    """The experts' images (NHWC in the program), the head's bands (three NHWC tensors) and
    its fused image (NCHW), each as the reference lays it out (NCHW)."""
    head = model.fusion
    return [
        (model.experts,
         lambda args, out: {n: out[0][n].permute(0, 3, 1, 2) for n in EXPERTS}),
        (head.multi_domain_freq.band_fusion,
         lambda args, out: {"bands": torch.cat(out, -1).permute(0, 3, 1, 2)}),
        (head.refine_net, lambda args, out: {"fused": args[0]})]


def timed(model):
    return {"hat": model.experts.hat, "dat": model.experts.dat, "head": model.fusion}


def window_attention_qkv(b, h, w, c, heads, hs, ws, shifted):
    """B13: attention of pre-projected q, k, v in (hs, ws) windows: q k^T and p v on the
    tensor cores, bias (+ mask) and softmax on the CUDA cores; reads q, k, v, the bias and
    the 4 mask types, writes the attended image."""
    npix, n = b * h * w, hs * ws
    nwin, hd = npix // n, c // heads
    return (nwin * heads * n * n * 8, nwin * heads * n * n * 4 * hd,
            4 * npix * c + (heads + (4 if shifted else 0)) * n * n)


def window_attention(b, h, w, c, heads, hs, ws, shifted):
    """B14: the qkv projection, B13's attention and the output projection; every product
    on the tensor cores; reads x, the weights, the biases, the bias and the 4 mask types,
    writes the attended image."""
    npix, n = b * h * w, hs * ws
    nwin, hd = npix // n, c // heads
    return (nwin * heads * n * n * 8, npix * 8 * c * c + nwin * heads * n * n * 4 * hd,
            2 * npix * c + 4 * c * c + 4 * c + (heads + (4 if shifted else 0)) * n * n)


#: the bounds of this model's kernel wrappers that ``core/bounds.py`` lacks (B13 and B14,
#: which a served forward launches only at tile 176, an odd side or a window under 8 px), by
#: the operation and element counts of ``chip_smoke.py``'s checks of those kernels
BOUNDS = {"fused_window_attention_qkv": window_attention_qkv,
          "fused_window_attention": window_attention}


def _dat_shifts(group, block):
    if group % 2 == 0:
        return block > 0 and (block - 2) % 4 == 0
    return block % 4 == 0


def launches(cfg: dict, b: int, h: int, w: int):
    """[(kernel, (CUDA-core FLOPs, tensor-core FLOPs, elements))] of the hand-written kernels
    one forward of FreqFusionSR launches on a [b, h, w, 3] LR batch whose sides are whole
    windows (a serving bucket or tile)."""
    out = []
    hat, dat, naf, head = cfg["hat"], cfg["dat"], cfg["nafnet"], cfg["head"]
    c = hat["embed_dim"]
    hid, ws = int(c * hat["mlp_ratio"]), hat["window"]
    for depth, heads in zip(hat["depths"], hat["num_heads"]):
        for j in range(depth):
            out.append(("cab_chain", bounds.cab_chain(b, h, w, c, c // hat["compress"])))
            out.append(("hab_block", bounds.hab_block(b, h, w, c, hid, heads, ws, j % 2 == 1)))
        wse = ws + int(ws * hat["overlap_ratio"])
        out.append(("overlap_attention", bounds.overlap_attention(b, h, w, c, heads, ws, wse)))
        out.append(("residual_ln_mlp", bounds.residual_ln_mlp(b, h, w, c, hid)))
        out.append(("conv3x3", bounds.conv3x3(b, h, w, c, c)))
    out.append(("conv3x3", bounds.conv3x3(b, h, w, c, c)))
    c = dat["embed_dim"]
    s0, s1 = dat["split_size"]
    hid = int(c * dat["expansion"])
    for g, (depth, heads) in enumerate(zip(dat["depths"], dat["num_heads"])):
        for j in range(depth):
            if j % 2 == 0:
                for hs, wsb in ((s0, s1), (s1, s0)):
                    out.append(("window_attention_xqkv", bounds.window_attention_xqkv(
                        b, h, w, c, c // 2, heads // 2, hs, wsb, _dat_shifts(g, j))))
            out.append(("aim_conv_branch", bounds.aim_conv_branch(b, h, w, c)))
            out.append(("aim_gates_proj", bounds.aim_gates_proj(b, h, w, c, c // 16)))
            out.append(("sgfn_tail", bounds.sgfn_tail(b, h, w, c, hid)))
        out.append(("conv3x3", bounds.conv3x3(b, h, w, c, c)))
    out.append(("conv3x3", bounds.conv3x3(b, h, w, c, c)))
    s = cfg["upscale"]
    width = naf["width"]
    out.append(("conv3x3", bounds.conv3x3(b, s * h, s * w, 3, width)))
    out.append(("conv3x3", bounds.conv3x3(b, s * h, s * w, width, 3)))
    levels = len(naf["enc_blk_nums"])
    for lvl, n in enumerate(naf["enc_blk_nums"]):
        cc = width << lvl
        if cc <= 256:
            for _ in range(n):
                hh, ww = s * h >> lvl, s * w >> lvl
                out.append(("naf_stage_a", bounds.naf_stage_a(b, hh, ww, cc)))
                out.append(("naf_stage_b", bounds.naf_stage_b(b, hh, ww, cc)))
    for i, n in enumerate(naf["dec_blk_nums"]):
        lvl = levels - 1 - i
        cc = width << lvl
        if cc <= 256:
            for _ in range(n):
                hh, ww = s * h >> lvl, s * w >> lvl
                out.append(("naf_stage_a", bounds.naf_stage_a(b, hh, ww, cc)))
                out.append(("naf_stage_b", bounds.naf_stage_b(b, hh, ww, cc)))
    d = head["fusion_dim"]
    out.append(("band_mha", bounds.band_mha(b, h, w, 9, d, head["num_heads"])))
    out.append(("lka_gate", bounds.lka_gate(9 * b, h, w, d)))
    return out
