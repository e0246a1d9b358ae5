"""Percent: the least time the card could take for the hand-written kernel launches the
program counted in the window (its ``launches`` counter: each wrapper's call with the shape
of its launch), over the device time of those kernels in the trace. ``kernels.port_roofline``
takes its launches from the model's file instead; the two agree while that list is right.

Each launch is bounded by its family's formula in ``core/bounds.py``; B13 and B14, which no
served cell launched when that file was written, by the two below (the operation and
element counts of ``chip_smoke.py``'s checks of those kernels). A wrapper without a bound
leaves the metric out.
"""

from perfbench.core import bounds
from perfbench.core.records import program_records


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


#: the program's kernel wrapper -> its family's (CUDA-core FLOPs, tensor-core FLOPs,
#: elements) from the shape the wrapper counts
FAMILIES = {
    "conv3x3_dense": bounds.conv3x3,
    "naf_block_stage_a": bounds.naf_stage_a,
    "naf_block_stage_b": bounds.naf_stage_b,
    "fused_window_attention_xqkv": bounds.window_attention_xqkv,
    "aim_conv_branch": bounds.aim_conv_branch,
    "aim_gates_proj": bounds.aim_gates_proj,
    "fused_sgfn_tail": bounds.sgfn_tail,
    "cab_chain": bounds.cab_chain,
    "fused_hab_block": bounds.hab_block,
    "fused_overlap_attention": bounds.overlap_attention,
    "fused_residual_ln_mlp": bounds.residual_ln_mlp,
    "fused_band_mha": bounds.band_mha,
    "lka_gate": bounds.lka_gate,
    "fused_window_attention_qkv": window_attention_qkv,
    "fused_window_attention": window_attention,
}


def least_s(launches: dict, dtype: str):
    """Least seconds of the counted launches {(wrapper, shape): n} at `dtype`, or None if a
    wrapper has no bound here."""
    if any(name not in FAMILIES for name, _ in launches):
        return None
    return sum(n * bounds.launch_s(*FAMILIES[name](*shape), dtype)
               for (name, shape), n in launches.items())


def read(run):
    if run.trace is None or not run.trace["port_s"]:
        return None
    rec = program_records()
    launches = {} if rec is None else rec["counts"].get("launches", {})
    least = least_s(launches, run.dtype) if launches else None
    return None if least is None else 100.0 * least / run.trace["port_s"]
