"""Runs one cell of the benchmark of ``freqfusion_tpu_torch`` on the cards of this machine.

    python3 perfbench/run.py --workload ff-f32.div2k --seed 7 --seconds 40 --trace 0

Prints the set-up split and the check (each number beside its limit, the last lines) on
standard error, and one JSON object as the last line of standard output. Exits non-zero,
printing no result, without the cards the cell asks for, or if JAX was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: top-level modules that must not be loaded: the JAX package and JAX itself
FORBIDDEN = ("jax", "jaxlib", "flax", "freqfusion_tpu")


def forbidden_modules(modules) -> list:
    """Loaded modules whose top-level name (before the first dot) is a forbidden one."""
    return sorted({m.split(".")[0] for m in modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every cache of the run at a fixed place inside the checkout
    cache = ROOT / ".perfbench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["PYTORCH_KERNEL_CACHE_PATH"] = str(cache / "kernels")
    for sub in ("triton", "torch_extensions", "kernels"):
        (cache / sub).mkdir(parents=True, exist_ok=True)
    sys.path.insert(0, str(ROOT))

    import torch

    from perfbench.core import cell

    spec = cell.Spec(ROOT)
    wl = spec.workload(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < wl["chips"]:
        print(f"{args.workload} needs {wl['chips']} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} present",
              file=sys.stderr)
        return 2

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    result, rows, _ = cell.run(spec, args.workload, args.seed, args.seconds, bool(args.trace), T0,
                            log=log)
    found = forbidden_modules(sys.modules)
    if found:
        print(f"modules of JAX or the JAX package were loaded: {found}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    for name, value, limit in rows:
        held = value is not None and value <= limit
        log(f"check {name} {value!r} limit {limit!r} {'ok' if held else 'FAIL'}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
