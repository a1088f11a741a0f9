"""Process groups and the data-parallel helpers on torch.distributed.

Counterpart of ciaosr_tpu/parallel/mesh.py. The JAX package runs one SPMD
program over a 'data' axis of devices, and XLA reduces the gradients. The
port runs one process per GPU (``torch.distributed.run`` starts them) and
reduces explicitly:

* ``shard_batch``: every rank loads the same global batch (the loader's
  draws are seeded by the batch's sequence number) and keeps rank r's rows
  ``[r·B/N, (r+1)·B/N)``;
* ``replicate``: rank 0's tensors broadcast to every rank;
* ``all_reduce_grads``: after ``backward``, the mean of the gradients over
  the ranks, in one flat buffer per dtype. No ``DistributedDataParallel``:
  its reducer expects a ``forward`` through the wrapper, and the restorers
  call ``gen_feature``, ``query_rgb`` and ``decode_grid`` directly;
* ``all_reduce_sum_`` and ``all_gather_rows``, for the tiled eval and the
  gathered eval summary.

Every helper takes ``mesh=None`` or a mesh without a process group (one
process, no launcher) and then does nothing. On a gloo group a collective
on a CUDA tensor runs on a host copy (gloo's CUDA support covers only some
collectives), so two ranks can share one card under gloo; NCCL refuses two
ranks on one device.
"""

from __future__ import annotations

import argparse
import os
from dataclasses import dataclass
from datetime import timedelta
from typing import Any

import numpy as np
import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from ciaosr_torch.core.device import resolve_device

LAUNCHERS = ("none", "pytorch")
# how long a rank waits in one collective before the group fails
DEFAULT_TIMEOUT = timedelta(minutes=30)


@dataclass(frozen=True)
class Mesh:
    """This process's place in the run: its rank, the world size, its
    device and the process group (None in one process without a
    launcher)."""
    rank: int = 0
    world: int = 1
    device: torch.device = torch.device("cpu")
    group: Any = None

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def barrier(self) -> None:
        if self.group is not None:
            dist.barrier(group=self.group)


def init_mesh(launcher: str = "none", device=None, backend: str | None = None,
              init_method: str = "env://",
              timeout: timedelta = DEFAULT_TIMEOUT) -> Mesh:
    """This process's mesh. ``"none"``: world 1 on ``device`` (default: the
    CUDA device), no process group. ``"pytorch"``: rank, world size and
    local rank from torchrun's ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK``;
    the device ``cuda:LOCAL_RANK`` (or ``device``: ``"cpu"``, or one card
    that several ranks share) is made the current device before anything
    is built on it; the group is NCCL on a card and gloo on the CPU, or
    ``backend``."""
    if launcher not in LAUNCHERS:
        raise ValueError(f"launcher must be one of {LAUNCHERS}, got "
                         f"{launcher!r}")
    if launcher == "none":
        return Mesh(device=resolve_device(device))
    try:
        rank, world, local = (int(os.environ[k]) for k in
                              ("RANK", "WORLD_SIZE", "LOCAL_RANK"))
    except KeyError as e:
        raise RuntimeError(f"--launcher pytorch: {e} is not set; start the "
                           "run with python -m torch.distributed.run") from e
    dev = resolve_device(device if device is not None else f"cuda:{local}")
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", local)
        # the kernels launch on the current device's stream: pin it first
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world, timeout=timeout)
    return Mesh(rank, world, dev, dist.group.WORLD)


def close_mesh(mesh: Mesh | None) -> None:
    """Destroy the mesh's process group, if it has one."""
    if mesh is not None and mesh.group is not None:
        dist.destroy_process_group()


def _grouped(mesh: Mesh | None) -> bool:
    return mesh is not None and mesh.group is not None


def _on_host(mesh: Mesh, t: torch.Tensor) -> bool:
    return t.device.type == "cuda" and dist.get_backend(mesh.group) != "nccl"


def _collective(mesh: Mesh, t: torch.Tensor, fn) -> None:
    """``fn(t)`` in place; on a host copy where the backend needs one."""
    if _on_host(mesh, t):
        h = t.cpu()
        fn(h)
        t.copy_(h)
    else:
        fn(t)


def _buckets(tensors) -> list[list[torch.Tensor]]:
    """The tensors grouped by (dtype, device), in order."""
    out: dict = {}
    for t in tensors:
        out.setdefault((t.dtype, t.device), []).append(t)
    return list(out.values())


def _flat_apply(mesh: Mesh, tensors, fn) -> None:
    """``fn`` on one flat copy of each bucket of ``tensors``, copied back."""
    for bucket in _buckets(tensors):
        flat = _flatten_dense_tensors(bucket)
        _collective(mesh, flat, fn)
        for t, r in zip(bucket, _unflatten_dense_tensors(flat, bucket)):
            t.copy_(r)


def shard_batch(mesh: Mesh | None, batch: dict) -> dict:
    """This rank's rows ``[r·B/N, (r+1)·B/N)`` of every field of the global
    batch with a leading dimension (arrays, tensors, the 'meta' list);
    raises when N does not divide B, as JAX's sharding does."""
    if mesh is None or mesh.world == 1:
        return batch
    sizes = {len(v) for k, v in batch.items()
             if k == "meta" or getattr(v, "ndim", 0) >= 1}
    if len(sizes) != 1:
        raise ValueError(f"batch fields disagree on the batch size: {sizes}")
    b = sizes.pop()
    if b % mesh.world:
        raise ValueError(f"a global batch of {b} does not split over "
                         f"{mesh.world} ranks")
    n = b // mesh.world
    lo, hi = mesh.rank * n, (mesh.rank + 1) * n
    return {k: v[lo:hi] if k == "meta" or getattr(v, "ndim", 0) >= 1 else v
            for k, v in batch.items()}


@torch.no_grad()
def replicate(mesh: Mesh | None, obj) -> None:
    """Broadcast rank 0's tensors into every rank's, in place: a module's
    parameters and buffers, or a dict or list of tensors."""
    if not _grouped(mesh):
        return
    if isinstance(obj, torch.nn.Module):
        tensors = list(obj.state_dict().values())
    elif isinstance(obj, dict):
        tensors = list(obj.values())
    else:
        tensors = list(obj)
    _flat_apply(mesh, tensors,
                lambda t: dist.broadcast(t, 0, group=mesh.group))


@torch.no_grad()
def all_reduce_grads(mesh: Mesh | None, params) -> None:
    """Replace each parameter's gradient by its mean over the ranks (the
    parameters without one are skipped: the same ones on every rank)."""
    if not _grouped(mesh):
        return
    grads = [p.grad for p in params if p.grad is not None]
    world = mesh.world

    def mean(t):
        dist.all_reduce(t, group=mesh.group)
        t.div_(world)

    _flat_apply(mesh, grads, mean)


def all_reduce_sum_(mesh: Mesh | None, t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the ranks, in place; returns it."""
    if _grouped(mesh):
        _collective(mesh, t, lambda x: dist.all_reduce(x, group=mesh.group))
    return t


def all_gather_rows(mesh: Mesh | None, array: np.ndarray) -> np.ndarray:
    """Every rank's ``array`` (the same shape on each) stacked along the
    first axis in rank order."""
    if not _grouped(mesh):
        return array
    nccl = dist.get_backend(mesh.group) == "nccl"
    t = torch.from_numpy(np.ascontiguousarray(array)).to(
        mesh.device if nccl else "cpu")
    parts = [torch.empty_like(t) for _ in range(mesh.world)]
    dist.all_gather(parts, t, group=mesh.group)
    return torch.cat(parts).cpu().numpy()


def add_launcher_args(p: argparse.ArgumentParser) -> None:
    """The CLIs' launcher flags."""
    p.add_argument("--launcher", default="none", choices=LAUNCHERS,
                   help="'pytorch': one process per GPU, started by python "
                        "-m torch.distributed.run")
    p.add_argument("--local_rank", "--local-rank", type=int, default=0,
                   help="the process's GPU; torchrun's LOCAL_RANK wins")
    p.add_argument("--dist-backend", choices=("nccl", "gloo"),
                   help="the process group's backend (default: NCCL on a "
                        "card, gloo on the CPU); gloo lets several ranks "
                        "share one card (--device cuda:0)")


def mesh_from_args(args) -> Mesh:
    """The mesh of parsed CLI ``args`` (``add_launcher_args`` and
    ``--device``)."""
    if args.launcher == "pytorch":
        os.environ.setdefault("LOCAL_RANK", str(args.local_rank))
    return init_mesh(args.launcher, args.device, args.dist_backend)
