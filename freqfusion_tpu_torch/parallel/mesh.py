"""Data parallelism over ranks. Twin of ``freqfusion_tpu/parallel/mesh.py``.

The JAX package runs one jitted program on a 1-D ``('data',)`` mesh: the batch is sharded
over the devices, parameters are replicated, and XLA inserts the reductions. The port runs
one process a rank (``torchrun --nproc_per_node N``, or ``run_ranks``), each on its own
device, joined by a ``torch.distributed`` process group: ``nccl`` between cards, ``gloo`` on
the CPU or, when asked, between processes that share one card. A ``Mesh`` records the rank's
place in it. What XLA inserts by itself is written out here:

* ``shard_batch`` cuts this rank's rows out of the global batch (every rank reads the same
  global batch in the same order);
* ``replicate`` broadcasts rank 0's parameters and buffers;
* ``all_reduce_mean`` averages the gradients before the optimizer's clip;
* inside ``active(mesh)`` the batch-coupled ops of the model see the global batch:
  ``models/layers.py`` ``BatchNorm2d`` (train-mode statistics) and ``dropout`` (the mask of
  the global batch), ``models/fusion.py``'s adaptive-band split (``global_batch_mean``).
  Their reductions are ``all_reduce_sum``, which has a backward (the all-reduce of the
  gradient), so that the gradient is that of the global batch's loss.

Serving does not use a process group: ``infer/io.py`` keeps one replica of the model a card
in one process.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
import pickle
import socket
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional

import numpy as np
import torch
import torch.distributed as dist

#: seconds that forming a process group or one collective may take before it raises
TIMEOUT_S = 300


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of the data-parallel mesh: its size (the world size), this rank, the
    rank's device and the process group (None for a mesh of one)."""
    size: int
    rank: int
    device: torch.device
    group: Any = None

    @property
    def via_host(self) -> bool:
        """gloo between processes on cards: collectives run on host copies."""
        return (self.group is not None and self.device.type == "cuda"
                and dist.get_backend(self.group) == "gloo")


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, default))


def make_mesh(n_devices: Optional[int] = None, device="cuda", backend: Optional[str] = None,
              timeout_s: float = TIMEOUT_S) -> Mesh:
    """This rank's ``Mesh`` over `n_devices` ranks.

    `n_devices` None means the world size that ``torchrun`` set (``WORLD_SIZE``), else 1.
    A mesh of more than one rank (or any mesh with an explicit `backend`) joins the process
    group, forming it where it is not formed yet from ``MASTER_ADDR`` / ``MASTER_PORT``,
    ``RANK`` and ``WORLD_SIZE``: ``nccl`` on cards, ``gloo`` on the CPU, or `backend` where
    given (``gloo`` lets several processes share one card). The rank's device is
    ``cuda:LOCAL_RANK`` (modulo the cards present under gloo) or the CPU. Raises
    ``ValueError`` where fewer ranks or cards are present than asked for, as the JAX twin
    does; nothing shrinks the mesh."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA card is available: training runs on the card unless the "
                           "caller asks for another device (device=\"cpu\")")
    world = dist.get_world_size() if dist.is_initialized() else _env_int("WORLD_SIZE", 1)
    n = world if n_devices is None else int(n_devices)
    if n < 1:
        raise ValueError(f"n_devices={n_devices}: expected at least 1")
    if n != world:
        raise ValueError(f"requested {n} devices but {world} rank(s) are running: launch one "
                         f"process a rank (torchrun --nproc_per_node {n})")
    if n == 1 and backend is None:
        return Mesh(1, 0, device, None)
    if device.type == "cuda":
        backend = backend or "nccl"
        cards = torch.cuda.device_count()
        local = _env_int("LOCAL_WORLD_SIZE", n)
        if backend == "nccl" and cards < local:
            raise ValueError(f"requested {n} devices but only {cards} card(s) present "
                             "(nccl takes one card a rank; gloo lets ranks share one)")
        device = torch.device("cuda", _env_int("LOCAL_RANK", 0) % cards)
        torch.cuda.set_device(device)
    else:
        backend = backend or "gloo"
    if not dist.is_initialized():
        addr, port = os.environ.get("MASTER_ADDR"), os.environ.get("MASTER_PORT")
        if not (addr and port):
            raise ValueError("a mesh of several ranks needs MASTER_ADDR and MASTER_PORT "
                             "(torchrun sets them; so does run_ranks)")
        dist.init_process_group(backend, init_method=f"tcp://{addr}:{port}", world_size=n,
                                rank=_env_int("RANK", 0),
                                timeout=datetime.timedelta(seconds=timeout_s))
    elif dist.get_backend() != backend:
        raise ValueError(f"the process group runs {dist.get_backend()}, not {backend}")
    return Mesh(n, dist.get_rank(), device, dist.group.WORLD)


def _on(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    return t.cpu() if mesh.via_host else t


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks; the gradient of each rank's input is the sum of the ranks'
    output gradients."""

    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        out = _on(mesh, t).clone()
        dist.all_reduce(out, group=mesh.group)
        return out.to(t.device)

    @staticmethod
    def backward(ctx, grad):
        return _AllReduceSum.apply(grad.contiguous(), ctx.mesh), None


def all_reduce_sum(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of `t` over the ranks, with autograd; `t` itself on a mesh of one."""
    if mesh.size == 1:
        return t
    return _AllReduceSum.apply(t, mesh)


def all_reduce_mean(tensors, mesh: Mesh):
    """Averages a list of tensors over the ranks in place, as one collective (the flattened
    tensors in one buffer), and returns them; a dict of tensors is averaged into a new one."""
    if isinstance(tensors, dict):
        keys = list(tensors)
        vals = all_reduce_mean([tensors[k].detach().clone() for k in keys], mesh)
        return dict(zip(keys, vals))
    if mesh.size == 1 or not tensors:
        return tensors
    flat = _on(mesh, torch.cat([t.reshape(-1) for t in tensors]))
    dist.all_reduce(flat, group=mesh.group)
    flat = flat.to(tensors[0].device) / mesh.size
    at = 0
    for t in tensors:
        t.copy_(flat[at:at + t.numel()].view_as(t))
        at += t.numel()
    return tensors


def all_gather(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's `t` (one shape on every rank) concatenated along axis 0 in rank order."""
    if mesh.size == 1:
        return t
    src = _on(mesh, t.contiguous())
    parts = [torch.empty_like(src) for _ in range(mesh.size)]
    dist.all_gather(parts, src, group=mesh.group)
    return torch.cat(parts).to(t.device)


def replicate(module: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Rank 0's parameters and buffers on every rank (in place); returns `module`."""
    if mesh.size > 1:
        with torch.no_grad():
            for t in list(module.parameters()) + list(module.buffers()):
                src = _on(mesh, t.detach()).clone()
                dist.broadcast(src, 0, group=mesh.group)
                t.copy_(src)
    return module


def shard_batch(tree, mesh):
    """This rank's rows of a global batch (a nested dict of numpy arrays or tensors), on
    its device, as float32. `mesh` is a ``Mesh`` or, for one rank, a device. Raises
    ``ValueError`` where the mesh size does not divide the batch (as the JAX twin's
    ``device_put`` with ``P('data')``)."""
    if not isinstance(mesh, Mesh):
        mesh = Mesh(1, 0, torch.device(mesh))
    if isinstance(tree, dict):
        return {k: shard_batch(v, mesh) for k, v in tree.items()}
    if isinstance(tree, np.ndarray):
        tree = torch.from_numpy(np.ascontiguousarray(tree))
    if not isinstance(tree, torch.Tensor):
        return tree
    if mesh.size > 1:
        b = tree.shape[0]
        if b % mesh.size:
            raise ValueError(f"a global batch of {b} does not split over {mesh.size} ranks")
        per = b // mesh.size
        tree = tree[mesh.rank * per:(mesh.rank + 1) * per]
    return tree.to(device=mesh.device, dtype=torch.float32, non_blocking=True)


_ACTIVE: List[Optional[Mesh]] = [None]


@contextlib.contextmanager
def active(mesh: Optional[Mesh]):
    """Inside the block, the batch-coupled ops of the models reduce over `mesh` (None, or
    a mesh of one: over this process's batch)."""
    before, _ACTIVE[0] = _ACTIVE[0], mesh if mesh is not None and mesh.size > 1 else None
    try:
        yield
    finally:
        _ACTIVE[0] = before


def current() -> Optional[Mesh]:
    """The mesh of ``active``, or None."""
    return _ACTIVE[0]


def global_batch_mean(t: torch.Tensor, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """The mean of every element of `t` over the global batch (each rank holding as many
    rows), with autograd: ``t.mean()`` outside a mesh."""
    mesh = mesh or current()
    if mesh is None or mesh.size == 1:
        return t.mean()
    return all_reduce_sum(t.sum(), mesh) / (t.numel() * mesh.size)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, n: int, port: int, out_dir: str, fn: Callable, args: tuple) -> None:
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(n),
                      LOCAL_WORLD_SIZE=str(n), MASTER_ADDR="localhost", MASTER_PORT=str(port))
    path = os.path.join(out_dir, f"rank{rank}.pkl")

    def write(blob):
        with open(path + ".tmp", "wb") as f:
            f.write(blob)
        os.replace(path + ".tmp", path)

    try:
        write(pickle.dumps(("ok", fn(rank, *args))))
    except BaseException:
        write(pickle.dumps(("error", traceback.format_exc())))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn: Callable, n: int, *args, timeout_s: float = 600) -> list:
    """Runs ``fn(rank, *args)`` in `n` new processes (spawned), with the environment that
    ``make_mesh`` forms a process group from (localhost, a free port), and returns their
    results in rank order. `fn` must be importable by name; its results picklable. Raises
    if a rank raises or exits without a result; a rank that is still running after
    `timeout_s` seconds is killed, with all the others, and ``TimeoutError`` is raised."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    port = _free_port()
    with tempfile.TemporaryDirectory(prefix="ranks") as out_dir:
        procs = [ctx.Process(target=_rank_main, args=(r, n, port, out_dir, fn, args),
                             daemon=True) for r in range(n)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        try:
            for p in procs:
                p.join(max(deadline - time.monotonic(), 0.0))
            hung = [r for r, p in enumerate(procs) if p.is_alive()]
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(10)
        results, errors = [], []
        for r, p in enumerate(procs):
            path = os.path.join(out_dir, f"rank{r}.pkl")
            if not os.path.exists(path):
                errors.append(f"rank {r}: no result (exit code {p.exitcode})")
                results.append(None)
                continue
            with open(path, "rb") as f:
                status, value = pickle.load(f)
            if status != "ok":
                errors.append(f"rank {r} raised:\n{value}")
            results.append(value)
        if hung:
            raise TimeoutError(f"ranks {hung} still ran after {timeout_s} s and were killed"
                               + "".join("\n" + e for e in errors))
        if errors:
            raise RuntimeError("\n".join(errors))
    return results
