"""Percent: the least time the card could take for the hand-written kernel launches the
program counted in the window (its ``launches`` counter: each wrapper's call with the shape
of its launch), over the device time of those kernels in the trace. ``kernels.port_roofline``
takes its launches from the model's file instead; the two agree while that list is right.

Each launch is bounded by its family's formula, at the peaks of the cell's numerics
(``core/precision.py``): the wrappers of ``FAMILIES`` by ``core/bounds.py``'s, any other
wrapper by the formula the model file's ``BOUNDS`` gives it. A wrapper without a bound leaves
the metric out.
"""

from perfbench.core import bounds
from perfbench.core.records import program_records

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
}


def least_s(launches: dict, dtype: str, precision: str = "highest", model_bounds=None):
    """Least seconds of the counted launches {(wrapper, shape): n} at `dtype` and
    `precision`, or None if a wrapper has no bound in ``FAMILIES`` or `model_bounds` (a
    model file's ``BOUNDS``)."""
    families = {**FAMILIES, **(model_bounds or {})}
    if any(name not in families for name, _ in launches):
        return None
    return sum(n * bounds.launch_s(*families[name](*shape), dtype, precision)
               for (name, shape), n in launches.items())


def read(run):
    if run.trace is None or not run.trace["port_s"]:
        return None
    rec = program_records()
    launches = {} if rec is None else rec["counts"].get("launches", {})
    if not launches:
        return None
    # a run made by hand may name no model and no precision
    model = getattr(run, "model", None)
    least = least_s(launches, run.dtype, getattr(run, "precision", "highest"),
                    getattr(model, "BOUNDS", None))
    return None if least is None else 100.0 * least / run.trace["port_s"]
