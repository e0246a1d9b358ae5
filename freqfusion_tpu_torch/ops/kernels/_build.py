"""Builds the hand-written CUDA kernels in ``freqfusion_tpu_torch/csrc`` at first use.

Each ``*.cu`` file is compiled by its own ``nvcc`` for ``sm_90a``, all started together, and
the objects are linked into one shared library with a plain C interface, loaded with
``ctypes``. The library's name carries a hash of the
sources and flags, so an edited source is rebuilt and an unchanged one is loaded from the
build directory. Nothing here runs when the module is imported: the CPU tests import every
module on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

from . import _mma

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# C entry point -> argument types; every entry returns its cudaError_t as an int. The int
# before the stream of a kernel entry is its instantiation (``io_code``: 0 f32, 1 bf16, 2 f32
# storage with bf16 operands).
SIGNATURES = {
    "naf_stage_a": [_P] * 10 + [_I] * 5 + [_P],
    "naf_stage_b": [_P] * 17 + [_I] * 5 + [_P],
    "conv3x3_dense": [_P] * 4 + [_I] * 5 + [_P, _P, _I, _I, _I, _P],
    "conv3x3_dense_is_wide": [_I, _I],
    "naf_stage_a_blocks": [_I] * 4,
    "aim_conv_branch": [_P] * 8 + [_I] * 5 + [_P],
    "aim_conv_branch_blocks": [_I] * 3,
    "aim_gates_proj": [_P] * 13 + [_I] * 8 + [_P],
    "rows_ln_fc1": [_P] * 11 + [_L] + [_I] * 5 + [_P],
    "sgfn_gate_fc2": [_P] * 7 + [_I] * 8 + [_P],
    "cab_chain": [_P] * 11 + [_I] * 10 + [_P],
    "cab_chain_blocks": [_I, _I],
    "xqkv_attention": [_P] * 8 + [_I] * 11 + [_P],
    "hab_tail": [_P] * 15 + [_I] * 9 + [_F, _I, _P],
    "residual_ln_mlp": [_P] * 11 + [_L] + [_I] * 6 + [_P],
    "rows_linear": [_P] * 5 + [_L] + [_I] * 5 + [_P],
    "wattn_qkv": [_P] * 6 + [_I] * 9 + [_P],
    "oca_attention": [_P] * 5 + [_I] * 9 + [_P],
    "band_mha": [_P] * 8 + [_L] + [_I] * 5 + [_F, _I, _P],
    "band_mha_wide": [_P] * 10 + [_L] + [_I] * 5 + [_F, _I, _P],
    "lka_gate": [_P] * 9 + [_I] * 7 + [_P],
}

#: Storage types the kernels take: f32, and bf16 (bf16 in device memory, bf16 products with
#: f32 accumulation, as the TPU kernels compute on bf16 refs).
KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def find_nvcc() -> str:
    """nvcc from CUDA_HOME, then PATH, then /usr/local/cuda; raises if there is none."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        cands.append(which)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, $PATH and /usr/local/cuda/bin): the "
        "CUDA kernels of freqfusion_tpu_torch cannot be built")


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def build() -> tuple[Path, float, str]:
    """Compiles the kernels if the hashed library is missing.

    Returns (library path, seconds spent compiling (0 when cached), nvcc's output)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    lib = BUILD_DIR / f"libfreqfusion_kernels_{h.hexdigest()[:16]}.so"
    log = lib.with_suffix(".log")
    if lib.exists():
        return lib, 0.0, log.read_text() if log.exists() else ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    nvcc = find_nvcc()
    t0 = time.perf_counter()
    # one compiler per source, all running at once; then one link
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = BUILD_DIR / f"{src.stem}.{os.getpid()}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True)))
    out, failed = "", None
    for cmd, _, proc in jobs:
        text = proc.communicate()[0]
        out += text
        if proc.returncode != 0 and failed is None:
            failed = (cmd, proc.returncode, text)
    objs = [obj for _, obj, _ in jobs]
    if failed is None:
        cmd = [nvcc, "-shared", "-o", str(tmp), *[str(o) for o in objs]]
        proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
        out += proc.stdout + proc.stderr
        if proc.returncode != 0:
            failed = (cmd, proc.returncode, proc.stdout + proc.stderr)
    for obj in objs:
        obj.unlink(missing_ok=True)
    secs = time.perf_counter() - t0
    if failed is not None:
        cmd, rc, text = failed
        raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{text}")
    log.write_text(out)
    os.replace(tmp, lib)  # atomic: a concurrent loader never sees a half-written file
    return lib, secs, out


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    path, _, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


_COUNTING = threading.Lock()


def count(launches: dict, name: str) -> None:
    """One launch of `name` more in a wrapper module's `launches`: under a lock, since
    serving replicas launch from threads of their own (``infer/io.py``)."""
    with _COUNTING:
        launches[name] += 1


def check(err: int, name: str) -> None:
    """Raises if a C entry point returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError_t {err}")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def require_no_grad(name: str, *tensors: torch.Tensor) -> None:
    """Raises where autograd would record the call: these kernels have no backward, and a
    wrapper must not drop a gradient silently. Call under ``torch.no_grad()``."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{name} has no backward: a tensor requires grad; call it under "
                           "torch.no_grad() or torch.inference_mode()")


def io_code(x: torch.Tensor, name: str = "x", mxu_dtype=None) -> int:
    """The instantiation argument of a kernel entry for its activation x (csrc/common.cuh:
    IoMode): 0 for float32 with f32-exact products, 1 for bfloat16, 2 for float32 with bf16
    operands (precision "default": ``_mma.operand_dtype`` of x's dtype and `mxu_dtype` is
    bfloat16); raises on any other dtype."""
    if x.dtype not in KERNEL_DTYPES:
        raise ValueError(f"{name}: expected float32 or bfloat16, got {x.dtype}")
    if x.dtype == torch.bfloat16:
        return 1
    return 2 if _mma.operand_dtype(x.dtype, mxu_dtype) == torch.bfloat16 else 0


def require_dtypes(name: str, x: torch.Tensor, *others) -> None:
    """One dtype for every tensor of a call (None skipped): float32 or bfloat16, or float64
    on the CPU, where the plain version serves as a reference. Raises on any other dtype
    (float16 among them) and on a mix, on every device."""
    ok = KERNEL_DTYPES + ((torch.float64,) if x.device.type == "cpu" else ())
    if x.dtype not in ok:
        raise ValueError(f"{name}: expected float32 or bfloat16, got {x.dtype}")
    for t in others:
        if t is not None and t.dtype != x.dtype:
            raise ValueError(f"{name}: one dtype for every tensor of a call, got {x.dtype} "
                             f"and {t.dtype}")


def require(t: torch.Tensor, name: str, shape=None, contiguous: bool = True) -> None:
    """Checks what every kernel takes: a contiguous float32 or bfloat16 CUDA tensor of
    `shape` (``require_dtypes`` holds a call to one dtype). ``contiguous=False`` for a weight
    that the wrapper lays out anew, which may be a view."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype not in KERNEL_DTYPES:
        raise ValueError(f"{name}: expected float32 or bfloat16, got {t.dtype}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if contiguous and t.data_ptr() % 16:
        raise ValueError(f"{name}: expected a 16-byte aligned tensor")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
