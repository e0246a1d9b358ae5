"""Checkpoint loading and conversion from the JAX package's parameter trees.

Twin of ``freqfusion_tpu/utils/convert.py`` in pure Python and torch: the port cannot
import that module, which imports flax. The port's modules carry the reference's torch
state-dict keys, so a reference ``.pth`` loads with ``load_state_dict`` directly.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

_IDX = re.compile(r"^(.*)_(\d+)$")


def load_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """Load a .pth into {key: tensor}: unwraps params_ema/params/state_dict/model and
    strips module./model. prefixes, like the reference's tolerant loader."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict):
        for key in ("params_ema", "params", "state_dict", "model", "model_state_dict"):
            if key in ckpt and isinstance(ckpt[key], dict):
                ckpt = ckpt[key]
                break
    out = {}
    for k, v in ckpt.items():
        if isinstance(v, torch.Tensor):
            for pref in ("module.", "model."):
                if k.startswith(pref):
                    k = k[len(pref):]
            out[k] = v.detach().cpu()
    return out


def layout_rule(torch_shape, flax_shape, leaf: str = "kernel") -> str:
    """Which rule of the JAX package's loader (``_adapt`` in its ``utils/convert.py``; own
    copy) carries a reference torch tensor of `torch_shape` onto a flax leaf of `flax_shape`
    named `leaf`: "OIHW->HWIO", "OI11->IO", "OI->IO" or "equal"; "unit axes" where its
    reshape only adds or drops axes of length 1 (NAF's beta [1,C,1,1] for [C], the FFT mask
    [1,1,S,S] for [1,S,S,1]: no element moves); "reshape" where only a blind reshape of the
    same element count would fit, "mismatch" where nothing does. A port parameter whose
    rule is "reshape" would load here and mean something else there."""
    t, f = tuple(torch_shape), tuple(flax_shape)
    transposable = leaf in ("kernel", "in_proj_weight") or leaf.endswith("_kernel")
    if len(t) == 4 and len(f) == 4 and transposable:
        if (t[2], t[3], t[1], t[0]) == f:
            return "OIHW->HWIO"
    elif len(t) == 4 and t[2:] == (1, 1) and len(f) == 2 and transposable and t[:2] == f[::-1]:
        return "OI11->IO"
    elif len(t) == 2 and len(f) == 2 and transposable and t == f[::-1]:
        return "OI->IO"
    elif t == f:
        return "equal"
    if [d for d in t if d != 1] == [d for d in f if d != 1]:
        return "unit axes"
    return "reshape" if int(np.prod(t)) == int(np.prod(f)) else "mismatch"


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def nafnet_key(path: Tuple[str, ...]) -> str:
    """JAX NAFNet param path -> reference torch key (as the JAX package's
    ``nafnet_key_fn``): ('encoders_0','blocks_1','conv1','kernel') ->
    'encoders.0.1.conv1.weight'; ups_i -> 'ups.i.0'; sca -> 'sca.1'."""
    parts = [p for p in path if p not in ("params", "nafnet")]
    toks = []
    for p in parts[:-1]:
        m = _IDX.match(p)
        if m and m.group(1) == "blocks":
            toks.append(m.group(2))
        elif m:
            toks.extend([m.group(1), m.group(2)])
            if m.group(1) == "ups":
                toks.append("0")
        else:
            toks.append(p)
    if toks and toks[-1] == "sca":
        toks.append("1")
    leaf = {"kernel": "weight"}.get(parts[-1], parts[-1])
    return ".".join(toks + [leaf])


# Renames of the JAX DAT's module paths back to the reference layout (own copy of the
# tables beside the JAX package's ``dat_key_fn``).
_DAT_SEQ = {
    "before_rg_norm": "before_RG.1", "conv_before_upsample": "conv_before_upsample.0",
    "dwconv": "dwconv.0", "dwconv_bn": "dwconv.1", "sg_norm": "sg.norm", "sg_conv": "sg.conv",
    "pos1_norm": "pos1.0", "pos1_fc": "pos1.2", "pos2_norm": "pos2.0", "pos2_fc": "pos2.2",
    "pos3_norm": "pos3.0", "pos3_fc": "pos3.2",
}
_DAT_CI = {"fc1": "1", "bn": "2", "fc2": "4"}   # Sequential(GAP, Conv, BN, GELU, Conv)
_DAT_SI = {"fc1": "0", "bn": "1", "fc2": "3"}   # Sequential(Conv, BN, GELU, Conv)


def dat_key(path: Tuple[str, ...]) -> str:
    """Unrolled JAX DAT param path -> reference torch key:
    ('layers_0','blocks_1','attn','attns_0','pos','pos1_fc','kernel') ->
    'layers.0.blocks.1.attn.attns.0.pos.pos1.2.weight'."""
    parts = [p for p in path if p != "params"]
    toks = []
    for i, p in enumerate(parts[:-1]):
        m = _IDX.match(p)
        if p == "conv_branch":
            continue   # the JAX AIM conv-branch wrapper is flat in the reference
        if m and m.group(1) == "upsample":
            toks.extend(["upsample", str(2 * int(m.group(2)))])
        elif p in _DAT_SEQ:
            toks.append(_DAT_SEQ[p])
        elif p in ("fc1", "bn", "fc2") and i and parts[i - 1] in (
                "channel_interaction", "spatial_interaction"):
            toks.append((_DAT_CI if parts[i - 1] == "channel_interaction" else _DAT_SI)[p])
        elif m:
            toks.extend([m.group(1), m.group(2)])
        else:
            toks.append(p)
    leaf = {"kernel": "weight", "scale": "weight"}.get(parts[-1], parts[-1])
    return ".".join(toks + [leaf])


def dat_params_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX package's DAT param tree, as nested dicts of arrays -> a state dict for the
    port's ``DAT``.

    Takes both JAX layouts: the unrolled ``layers_i/...`` and the scan-stacked
    ``layers/g{0,1}/...``, whose leaves carry a leading axis over the (even, odd) group
    pairs: slice gi of ``g`` is torch group 2*gi+g. Dense kernels go [in,out] -> [out,in],
    convs HWIO -> OIHW (the depthwise (3,3,1,C) -> (C,1,3,3)), LayerNorm ``scale`` ->
    ``weight``; each BatchNorm also gets the ``num_batches_tracked`` counter nn.BatchNorm2d
    keeps."""
    sd = {}

    def put(path, a):
        a = np.asarray(a, dtype=np.float32)
        if path[-1] == "kernel":
            a = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T
        key = dat_key(path)
        sd[key] = torch.from_numpy(np.ascontiguousarray(a))
        if key.endswith("running_mean"):
            sd[key[:-len("running_mean")] + "num_batches_tracked"] = torch.tensor(0)

    for path, leaf in _flatten(params):
        path = tuple(p for p in path if p != "params")
        if path[0] == "layers":   # scan-stacked pairs
            g = int(path[1][1:])
            for gi, piece in enumerate(np.asarray(leaf)):
                put((f"layers_{2 * gi + g}",) + path[2:], piece)
        else:
            put(path, leaf)
    return sd


# Renames of the JAX HAT's module paths back to the reference layout (own copy of the
# tables beside the JAX package's ``hat_key_fn``): Sequential indices of CAB, of
# ChannelAttention and of the upsample head.
_HAT_SEQ = {
    "patch_norm": "patch_embed.norm", "conv_before_upsample": "conv_before_upsample.0",
    "conv_block": "conv_block.cab", "conv1": "0", "conv2": "2", "ca": "3.attention",
}
_HAT_CA = {"fc1": "1", "fc2": "3"}   # Sequential(GAP, Conv, ReLU, Conv, Sigmoid)
_HAT_RAW = {"qkv_kernel": "qkv.weight", "qkv_bias": "qkv.bias",
            "proj_kernel": "proj.weight", "proj_bias": "proj.bias"}


def hat_key(path: Tuple[str, ...]) -> str:
    """Unrolled JAX HAT param path -> reference torch key:
    ('layers_0','blocks_1','conv_block','ca','fc1','kernel') ->
    'layers.0.residual_group.blocks.1.conv_block.cab.3.attention.1.weight'."""
    parts = [p for p in path if p != "params"]
    toks = []
    for i, p in enumerate(parts[:-1]):
        m = _IDX.match(p)
        if m and m.group(1) == "layers":
            toks.extend(["layers", m.group(2)])
            nxt = parts[i + 1] if i + 1 < len(parts) - 1 else ""
            if nxt.startswith("blocks") or nxt == "overlap_attn":
                toks.append("residual_group")
        elif m and m.group(1) == "upsample":
            toks.extend(["upsample", str(2 * int(m.group(2)))])
        elif p in _HAT_CA and i and parts[i - 1] == "ca":
            toks.append(_HAT_CA[p])
        elif p in _HAT_SEQ:
            toks.append(_HAT_SEQ[p])
        elif m:
            toks.extend([m.group(1), m.group(2)])
        else:
            toks.append(p)
    leaf = _HAT_RAW.get(parts[-1]) or {"kernel": "weight", "scale": "weight"}.get(
        parts[-1], parts[-1])
    return ".".join(toks + [leaf])


def hat_params_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX package's HAT param tree, as nested dicts of arrays -> a state dict for the
    port's ``HAT``.

    Takes every JAX layout: unrolled (``layers_i/blocks_j``), group-scanned (``layers/...``,
    whose leaves carry a leading axis over the groups), pair-scanned (``pairs/blk{0,1}``
    inside a group, a leading axis over the (shift-0, shifted) HAB pairs) and both at once
    (two leading axes, groups first): slice [gi, pi] of ``blk b`` is torch
    ``layers.gi.residual_group.blocks.(2*pi+b)``. Dense kernels, the raw ``qkv_kernel`` and
    ``proj_kernel`` included, go [in,out] -> [out,in], convs HWIO -> OIHW, LayerNorm
    ``scale`` -> ``weight``."""
    sd = {}
    for path, leaf in _flatten(params):
        path = tuple(p for p in path if p != "params")
        group_scan = path[0] == "layers"
        pair_pos = path.index("pairs") if "pairs" in path else None
        a = np.asarray(leaf, dtype=np.float32)
        naxes = int(group_scan) + int(pair_pos is not None)
        for idx in np.ndindex(a.shape[:naxes]):
            own = list(path)
            if pair_pos is not None:
                b = int(own[pair_pos + 1][3:])      # 'blk0' / 'blk1'
                own[pair_pos:pair_pos + 2] = [f"blocks_{2 * idx[-1] + b}"]
            if group_scan:
                own[0] = f"layers_{idx[0]}"
            piece = a[idx]
            if path[-1].endswith("kernel"):
                piece = piece.transpose(3, 2, 0, 1) if piece.ndim == 4 else piece.T
            sd[hat_key(tuple(own))] = torch.from_numpy(np.ascontiguousarray(piece))
    return sd


def nafnet_params_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX package's NAFNetSR (or NAFNet) param tree, as nested dicts of arrays ->
    a state dict for the port's ``NAFNet``.

    Conv kernels go HWIO -> OIHW (the depthwise (3,3,1,2C) -> (2C,1,3,3), a 1x1
    (1,1,I,O) -> (O,I,1,1)); beta/gamma (C,) -> (1,C,1,1)."""
    sd = {}
    for path, leaf in _flatten(params):
        a = np.asarray(leaf, dtype=np.float32)
        if a.ndim == 4:
            a = a.transpose(3, 2, 0, 1)
        elif path[-1] in ("beta", "gamma"):
            a = a.reshape(1, -1, 1, 1)
        sd[nafnet_key(path)] = torch.from_numpy(np.ascontiguousarray(a))
    return sd


def _split_idx(name: str):
    m = _IDX.match(name)
    return (m.group(1), int(m.group(2))) if m else (name, None)


_LEAF = {"kernel": "weight", "scale": "weight", "mean": "running_mean", "var": "running_var"}
_FREQ_SEQ = {"transform_fc1": "fusion_transform.0", "transform_fc2": "fusion_transform.2",
             "gate_fc1": "fusion_gate.0", "gate_fc2": "fusion_gate.2"}


def freq_key(path: Tuple[str, ...]) -> str:
    """JAX frequency-stack param path -> reference torch key (own copy of the JAX package's
    ``freq_key_fn``): ('band_fusion','band_attention_0','conv','kernel') ->
    'band_fusion.band_attention.0.conv.0.weight'."""
    parts = [p for p in path if p != "params"]
    toks = []
    for p in parts[:-1]:
        base, idx = _split_idx(p)
        if base == "band_attention":
            toks.extend(["band_attention", str(idx), "conv", "0"])
        elif p in _FREQ_SEQ:
            toks.append(_FREQ_SEQ[p])
        elif p == "conv" and toks and toks[-1] == "0":
            continue   # already emitted by band_attention
        elif idx is not None:
            toks.extend([base, str(idx)])
        else:
            toks.append(p)
    return ".".join(toks + [_LEAF.get(parts[-1], parts[-1])])


# Sequential indices of the reference's fusion head (own copy of the JAX package's table).
_FUSION_SEQ = {
    "ffn_fc1": "ffn.0", "ffn_fc2": "ffn.2",
    "to_rgb_conv1": "to_rgb.0", "to_rgb_conv2": "to_rgb.2",
    "diff_conv1": "difficulty_estimator.0", "diff_conv2": "difficulty_estimator.2",
    "diff_conv3": "difficulty_estimator.4",
    "fusion_conv1": "fusion.0", "fusion_conv2": "fusion.2",
}


def fusion_key(path: Tuple[str, ...]) -> str:
    """JAX fusion-head path (``params`` or ``batch_stats``) -> reference torch key (own copy
    of the JAX package's ``fusion_key_fn``):
    ('multi_res_fusion','stage1','gate','fc1','kernel') ->
    'multi_res_fusion.stage1_gate.gate.0.weight';
    ('refine_net','refine_1','kernel') -> 'refine_net.2.weight';
    ('multiscale','conv_2x_bn','mean') -> 'multiscale.conv_2x.2.running_mean'."""
    parts = [p for p in path if p not in ("params", "batch_stats")]
    leaf, body = parts[-1], parts[:-1]
    toks = []
    for i, p in enumerate(body):
        base, idx = _split_idx(p)
        prev = body[i - 1] if i else ""
        if p in _FREQ_SEQ:
            toks.append(_FREQ_SEQ[p])
        elif base == "band_attention" and idx is not None:
            toks.extend(["band_attention", str(idx), "conv", "0"])
        elif p == "conv" and prev.startswith("band_attention_"):
            continue   # already emitted above
        elif p.startswith("align_"):
            toks.extend(["align_layers", p[len("align_"):]])
        elif p.startswith("mod_") and p.endswith(("_fc1", "_fc2")):
            toks.extend(["modulation", p.split("_")[1], "0" if p.endswith("_fc1") else "3"])
        elif base == "mod" and idx is not None:   # standard collaborative
            toks.extend(["modulation", str(idx), "1"])
        elif prev in ("stage1", "stage2", "stage3"):
            st = toks.pop()   # 'stageN' + child are flat names in the reference
            toks.append({"conv1": f"{st}_conv.0", "conv2": f"{st}_conv.2",
                         "gate": f"{st}_gate", "res": f"{st}_res"}[p])
        elif prev == "gate" and p in ("fc1", "fc2"):
            toks.append({"fc1": "gate.0", "fc2": "gate.2"}[p])
        elif prev == "res" and p in ("conv1", "conv2"):
            toks.append({"conv1": "block.0", "conv2": "block.2"}[p])
        elif p.endswith("_conv") and prev == "multiscale":
            toks.append(p[:-5] + ".0")
        elif p.endswith("_bn") and prev == "multiscale":
            toks.append(p[:-3] + ".2")
        elif p in ("fc1", "fc2") and prev == "channel_attention":
            toks.append({"fc1": "mlp.0", "fc2": "mlp.2"}[p])
        elif p in ("fc1", "fc2") and prev == "attn":
            toks.append({"fc1": "attn.0", "fc2": "attn.2"}[p])
        elif p in ("fc1", "fc2") and prev == "adaptive_band_predictor":
            toks.append({"fc1": "predictor.0", "fc2": "predictor.2"}[p])
        elif p in ("gate_conv1", "gate_conv2"):
            scope = "edge_gate" if "edge_refine" in body else "expert_gate"
            toks.append(f"{scope}.{0 if p == 'gate_conv1' else 2}")
        elif p in _FUSION_SEQ:
            toks.append(_FUSION_SEQ[p])
        elif base == "refine" and idx is not None and prev == "refine_net":
            toks.append(str(2 * idx))   # refine_net is a flat Sequential
        elif p.startswith("layer") and p.endswith(("_conv", "_bn")):
            lnum = p.split("_")[0]   # router layers: layer1 .. layer4
            local = (0 if lnum in ("layer1", "layer3") else 3) + (2 if p.endswith("_bn") else 0)
            toks.extend(["conv_block1" if lnum in ("layer1", "layer2") else "conv_block2",
                         str(local)])
        elif idx is not None:
            toks.extend([base, str(idx)])
        else:
            toks.append(p)
    if toks and toks[0] == "refine_net" and leaf == "residual_scale":
        toks = []   # a parameter of the head itself in the reference
    if leaf == "scale" and body and not ("norm" in body[-1] or "bn" in body[-1]):
        return ".".join(toks + ["scale"])   # ResBlock's learnable residual scale
    return ".".join(toks + [_LEAF.get(leaf, leaf)])


def fusion_params_from_flax(params: Mapping, batch_stats: Optional[Mapping] = None
                            ) -> Dict[str, torch.Tensor]:
    """The JAX package's FusionHead trees, as nested dicts of arrays -> a state dict for the
    port's ``FusionHead``.

    Conv kernels go HWIO -> OIHW (the depthwise [k,k,1,C] -> [C,1,k,k]), Dense kernels
    [in,out] -> [out,in], the packed ``in_proj_weight`` [E,3E] -> [3E,E], the FFT mask
    logits [1,S,S,1] -> [1,1,S,S], LayerNorm / BatchNorm ``scale`` -> ``weight``. BatchNorm's
    running statistics come from ``batch_stats`` (``mean`` / ``var``), and each BatchNorm
    also gets the ``num_batches_tracked`` counter nn.BatchNorm2d keeps."""
    sd = {}
    for path, leaf in _flatten(params):
        a = np.asarray(leaf, dtype=np.float32)
        if path[-1] == "kernel":
            a = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T
        elif path[-1] == "in_proj_weight":
            a = a.T
        elif path[-1] == "freq_mask_logits":
            a = a.transpose(0, 3, 1, 2)
        sd[fusion_key(path)] = torch.from_numpy(np.ascontiguousarray(a))
    for path, leaf in _flatten(batch_stats or {}):
        key = fusion_key(path)
        sd[key] = torch.from_numpy(np.array(leaf, dtype=np.float32))
        if key.endswith("running_mean"):
            sd[key[:-len("running_mean")] + "num_batches_tracked"] = torch.tensor(0)
    return sd


def freqfusion_params_from_flax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX package's FreqFusionSR variables ({"params": {"experts": {"hat", "dat",
    "nafnet"}, "fusion"}, "batch_stats": {"fusion"}}) -> a state dict for the port's
    ``FreqFusionSR``: the experts under ``experts.{hat,dat,nafnet}``, the head under
    ``fusion``."""
    params = variables["params"]
    experts = params["experts"]
    stats = variables.get("batch_stats", {}).get("fusion", {})
    parts = (("experts.hat.", hat_params_from_flax(experts["hat"])),
             ("experts.dat.", dat_params_from_flax(experts["dat"])),
             ("experts.nafnet.nafnet.", nafnet_params_from_flax(experts["nafnet"])),
             ("fusion.", fusion_params_from_flax(params["fusion"], stats)))
    return {prefix + k: v for prefix, sd in parts for k, v in sd.items()}


def v2_key(path: Tuple[str, ...]) -> str:
    """JAX V2 fusion-head param path -> reference torch key (own copy of the JAX package's
    ``v2_key_fn``): ('freq_decomp','thresh_fc1','kernel') ->
    'freq_decomp.threshold_predictor.2.weight'; ('multi_res','router_64_2','bias') ->
    'multi_res.router_64.2.bias'; ('collaborative','proj_hat','kernel') ->
    'collaborative.feature_projectors.hat.weight'."""
    parts = [p for p in path if p != "params"]
    body, leaf = parts[:-1], parts[-1]
    toks = []
    for p in body:
        base, idx = _split_idx(p)
        if p == "thresh_fc1":
            toks.append("threshold_predictor.2")
        elif p == "thresh_fc2":
            toks.append("threshold_predictor.4")
        elif base == "band_proj":
            toks.extend(["band_projectors", str(idx)])
        elif base == "out_proj" and idx is not None:
            toks.extend(["output_projectors", str(idx)])
        elif p.startswith("proj_") and p[5:] in ("hat", "dat", "nafnet"):
            toks.extend(["feature_projectors", p[5:]])
        elif base == "feat_refine":
            toks.extend(["feature_refine", str(idx)])
        elif base == "mod":
            toks.extend(["modulation_head", str(idx)])
        elif base == "diff":
            toks.extend(["difficulty_net", str(idx)])
        elif base == "gate":
            toks.extend(["gate_net", str(idx)])
        elif p.startswith("router_"):
            toks.extend(p.rsplit("_", 1))
        elif idx is not None:
            toks.extend([base, str(idx)])
        else:
            toks.append(p)
    return ".".join(toks + [_LEAF.get(leaf, leaf)])


# Sequential indices of MambaIR's CAB (conv, GELU, conv, ChannelAttention(GAP, conv, ReLU,
# conv, Sigmoid)): own copy of the table beside the JAX package's ``mambair_key_fn``
_MAMBA_CAB = {"conv1": "cab.0", "conv2": "cab.2", "ca_fc1": "cab.3.attention.1",
              "ca_fc2": "cab.3.attention.3"}


def mambair_key(path: Tuple[str, ...]) -> str:
    """JAX MambaIR param path -> reference torch key (own copy of the JAX package's
    ``mambair_key_fn``): ('layers_0','blocks_1','self_attention','in_proj','kernel') ->
    'layers.0.residual_group.blocks.1.self_attention.in_proj.weight';
    ('patch_norm','scale') -> 'patch_embed.norm.weight'; ('upsample_1','kernel') ->
    'upsample.2.weight'. SS2D's merged parameters (x_proj_weight, dt_projs_weight,
    dt_projs_bias, A_logs, Ds) and the skip scales keep their names and stacked shapes."""
    parts = [p for p in path if p != "params"]
    toks = []
    for i, p in enumerate(parts[:-1]):
        base, idx = _split_idx(p)
        nxt = parts[i + 1] if i + 1 < len(parts) - 1 else ""
        if base == "layers":
            toks.extend(["layers", str(idx)])
            if nxt.startswith("blocks"):
                toks.append("residual_group")
        elif base == "blocks":
            toks.extend(["blocks", str(idx)])
        elif base == "upsample":
            toks.extend(["upsample", str(2 * idx)])
        elif p == "patch_norm":
            toks.extend(["patch_embed", "norm"])
        elif p == "conv_before_upsample":
            toks.extend(["conv_before_upsample", "0"])
        elif p in _MAMBA_CAB:
            toks.append(_MAMBA_CAB[p])
        else:
            toks.append(p)
    return ".".join(toks + [_LEAF.get(parts[-1], parts[-1])])


# ---------------------------------------------------------------------------
# The eval towers and the perceptual losses: own copies of the JAX package's key functions
# (``*_key_fn`` beside each tower), flax params -> torch state dicts, and the strict loader
# the towers share.
# ---------------------------------------------------------------------------

_TOWER_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias", "weight": "weight"}


def lpips_key(path: Tuple[str, ...]) -> str:
    """('conv_0','kernel') -> 'features.0.weight'; ('lin_2',) -> 'lin2.model.1.weight'."""
    parts = [p for p in path if p != "params"]
    if parts[0].startswith("lin_"):
        return f"lin{parts[0].split('_')[1]}.model.1.weight"
    return f"features.{parts[0].split('_')[1]}.{_TOWER_LEAF[parts[-1]]}"


def vgg_key(path: Tuple[str, ...]) -> str:
    """('conv_8','kernel') -> 'features.8.weight': torchvision's VGG16 and VGG19 layout,
    the DISTS trunk's and the VGG loss's."""
    parts = [p for p in path if p != "params"]
    return f"features.{parts[0].split('_')[1]}.{_TOWER_LEAF[parts[-1]]}"


def _clip_block_key(base: str, parts, leaf: str) -> str:
    sub = parts[1]
    if sub == "attn":
        if leaf in ("in_proj_weight", "in_proj_bias"):
            return f"{base}.attn.{leaf}"
        return f"{base}.attn.out_proj.{_TOWER_LEAF[leaf]}"
    if sub in ("ln_1", "ln_2"):
        return f"{base}.{sub}.{_TOWER_LEAF[leaf]}"
    if sub in ("c_fc", "c_proj"):
        return f"{base}.mlp.{sub}.{_TOWER_LEAF[leaf]}"
    raise KeyError(parts)


def clip_vision_key(path: Tuple[str, ...]) -> str:
    """JAX CLIP vision path -> OpenAI CLIP ``visual.*`` key."""
    parts = [p for p in path if p != "params"]
    if parts[0] == "conv1_kernel":
        return "visual.conv1.weight"
    if parts[0] in ("class_embedding", "positional_embedding", "proj"):
        return f"visual.{parts[0]}"
    if parts[0] in ("ln_pre", "ln_post"):
        return f"visual.{parts[0]}.{_TOWER_LEAF[parts[-1]]}"
    if parts[0].startswith("resblocks_"):
        base = f"visual.transformer.resblocks.{parts[0].split('_')[1]}"
        return _clip_block_key(base, parts, parts[-1])
    raise KeyError(path)


def clip_text_key(path: Tuple[str, ...]) -> str:
    """JAX CLIP text path -> OpenAI CLIP text-side key (no ``visual.`` prefix)."""
    parts = [p for p in path if p != "params"]
    if parts[0] == "token_embedding":
        return "token_embedding.weight"
    if parts[0] in ("positional_embedding", "text_projection"):
        return parts[0]
    if parts[0] == "ln_final":
        return f"ln_final.{_TOWER_LEAF[parts[-1]]}"
    if parts[0].startswith("resblocks_"):
        base = f"transformer.resblocks.{parts[0].split('_')[1]}"
        return _clip_block_key(base, parts, parts[-1])
    raise KeyError(path)


def musiq_key(path: Tuple[str, ...]) -> str:
    """JAX MUSIQ path -> the torch key of ``utils/musiq.py``'s documented layout."""
    parts = [p for p in path if p != "params"]
    leaf = _TOWER_LEAF.get(parts[-1], parts[-1])
    top = parts[0]
    if top in ("cls_token", "spatial_embedding", "scale_embedding"):
        return top
    if top in ("patch_embed", "norm", "head"):
        return f"{top}.{leaf}"
    if top == "patch_root":
        sub = parts[1]
        if sub == "conv_root":
            return "conv_root.weight"
        if sub in ("gn_root", "embedding"):
            return f"{sub}.{leaf}"
        if sub == "block1_unit01":
            return f"block1.unit01.{parts[2]}.{leaf}"
    if top.startswith("blocks_"):
        return _vit_block_key(f"blocks.{top.split('_')[1]}", parts[1], leaf)
    raise KeyError(path)


def _vit_block_key(base: str, sub: str, leaf: str) -> str:
    if sub in ("norm1", "norm2"):
        return f"{base}.{sub}.{leaf}"
    if sub in ("qkv", "proj"):
        return f"{base}.attn.{sub}.{leaf}"
    if sub in ("fc1", "fc2"):
        return f"{base}.mlp.{sub}.{leaf}"
    raise KeyError((base, sub))


def maniqa_key(path: Tuple[str, ...]) -> str:
    """JAX MANIQA path -> the torch key of ``utils/maniqa.py``'s documented layout."""
    parts = [p for p in path if p != "params"]
    leaf = _TOWER_LEAF.get(parts[-1], parts[-1])
    top = parts[0]
    if top == "vit":
        sub = parts[1]
        if sub == "patch_embed":
            return f"vit.patch_embed.proj.{leaf}"
        if sub in ("cls_token", "pos_embed"):
            return f"vit.{sub}"
        if sub.startswith("blocks_"):
            return _vit_block_key(f"vit.blocks.{sub.split('_')[1]}", parts[2], leaf)
    if top.startswith("tablock"):
        stage, i = top.split("_")
        return f"{stage}.{i}.{parts[1]}.{leaf}"
    if top in ("conv1", "conv2"):
        return f"{top}.{leaf}"
    if top.startswith("swin"):
        stage, j = top.split("_")
        base = f"swintransformer{stage[4:]}.blocks.{j}"
        if parts[1] == "relative_position_bias_table":
            return f"{base}.attn.relative_position_bias_table"
        return _vit_block_key(base, parts[1], leaf)
    if top.startswith(("fc_score_", "fc_weight_")):
        stem, idx = top.rsplit("_", 1)
        return f"{stem}.{idx}.{leaf}"
    raise KeyError(path)


_FROM_FLAX = {
    "OIHW->HWIO": lambda a, t: a.transpose(3, 2, 0, 1),
    "OI11->IO": lambda a, t: a.T[:, :, None, None],
    "OI->IO": lambda a, t: a.T,
    "equal": lambda a, t: a,
    "unit axes": lambda a, t: a.reshape(t),
}


def tower_params_from_flax(params: Mapping, key_fn, shapes: Mapping[str, Tuple[int, ...]]
                           ) -> Dict[str, torch.Tensor]:
    """A JAX tower's param tree -> a state dict for the port's twin, whose parameter shapes
    `shapes` gives ({key: shape}). Each leaf goes to ``key_fn(path)`` by the inverse of the
    ``layout_rule`` that carries the torch tensor onto it (conv kernels HWIO -> OIHW, Dense
    kernels and the packed ``in_proj_weight`` [in,out] -> [out,in], a Dense standing for a
    1x1 conv -> [out,in,1,1], a per-channel vector -> [1,C,1,1]); a leaf that would need a
    blind reshape raises."""
    sd = {}
    for path, leaf in _flatten(params):
        a = np.asarray(leaf, dtype=np.float32)
        key = key_fn(path)
        t = tuple(shapes[key])
        rule = layout_rule(t, a.shape, path[-1])
        if rule not in _FROM_FLAX:
            raise ValueError(f"{key}: flax {a.shape} against torch {t} ({rule})")
        sd[key] = torch.from_numpy(np.ascontiguousarray(_FROM_FLAX[rule](a, t)))
    return sd


def _shapes(module: torch.nn.Module) -> Dict[str, Tuple[int, ...]]:
    return {k: tuple(v.shape) for k, v in module.state_dict().items()}


def lpips_params_from_flax(params: Mapping, model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The JAX ``AlexLPIPS`` params -> a state dict for the port's ``AlexLPIPS``."""
    return tower_params_from_flax(params, lpips_key, _shapes(model))


def dists_params_from_flax(params: Mapping, alpha, beta,
                           model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The JAX ``VGG16L2Stages`` params and the DISTS alpha / beta ([sum C] each, any
    layout of that many elements) -> a state dict for the port's ``DISTS``."""
    shapes = _shapes(model)
    sd = tower_params_from_flax(params, vgg_key, shapes)
    for name, a in (("alpha", alpha), ("beta", beta)):
        sd[name] = torch.from_numpy(np.asarray(a, np.float32).reshape(shapes[name]).copy())
    return sd


def vgg19_params_from_flax(params: Mapping, model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The JAX ``VGG19Features`` params -> a state dict for the port's ``VGG19Features``."""
    return tower_params_from_flax(params, vgg_key, _shapes(model))


def clip_vision_params_from_flax(params: Mapping,
                                 model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The JAX ``CLIPVisionTransformer`` params -> the ``visual.*`` keys of an OpenAI CLIP
    state dict; `model` is the port's vision tower (keys without the prefix)."""
    shapes = {"visual." + k: s for k, s in _shapes(model).items()}
    return tower_params_from_flax(params, clip_vision_key, shapes)


def clip_text_params_from_flax(params: Mapping,
                               model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The JAX ``CLIPTextTransformer`` params -> the text-side keys of an OpenAI CLIP state
    dict; `model` is the port's text tower."""
    return tower_params_from_flax(params, clip_text_key, _shapes(model))


def musiq_params_from_flax(params: Mapping, model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The JAX ``MUSIQTransformer`` params -> a state dict for the port's twin."""
    return tower_params_from_flax(params, musiq_key, _shapes(model))


def maniqa_params_from_flax(params: Mapping, model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The JAX ``MANIQA`` params -> a state dict for the port's twin."""
    return tower_params_from_flax(params, maniqa_key, _shapes(model))


def fusion_v2_params_from_flax(params: Mapping,
                               model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The JAX ``FusionHeadV2`` (or one of its blocks) params -> a state dict for the port's
    twin `model`."""
    return tower_params_from_flax(params, v2_key, _shapes(model))


def mambair_params_from_flax(params: Mapping, model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The JAX ``MambaIR`` params -> a state dict for the port's ``MambaIR``."""
    return tower_params_from_flax(params, mambair_key, _shapes(model))


def load_tower_state(module: torch.nn.Module, sd: Mapping[str, torch.Tensor],
                     prefix: str = "") -> torch.nn.Module:
    """Loads ``sd[prefix + key]`` into each of `module`'s parameters and buffers, as the
    JAX package's ``fill_params(strict=True)``: a missing key raises KeyError, a tensor of
    another element count ValueError; one of the same count in another shape (a [1,C,1,1]
    head weight stored as [C]) is reshaped. Keys the module does not hold are ignored."""
    own = module.state_dict()
    out = {}
    for k, v in own.items():
        if prefix + k not in sd:
            raise KeyError(f"torch key {prefix + k!r} not found")
        t = torch.as_tensor(sd[prefix + k])
        if t.numel() != v.numel():
            raise ValueError(f"{prefix + k}: {tuple(t.shape)} for {tuple(v.shape)}")
        out[k] = t.reshape(v.shape).to(v.dtype)
    module.load_state_dict(out, strict=True)
    return module
