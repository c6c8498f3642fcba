"""Device meshes and sharding helpers over ``torch.distributed``.

Counterpart of ``one2345_tpu/core/meshes.py``, with its names.  The JAX
package runs one controller over every chip and lets XLA insert the
collectives from sharding annotations; the port runs one process per rank
(``torchrun``) and its collectives are explicit.  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the process group, with
the JAX package's named axes:

- ``data``: scene / batch data parallelism in training, and the view
  batch of the diffusion sampler at inference;
- ``model``: parameter sharding of the trained Zero123 UNet (FSDP2, HSDP
  on a ``(data, model)`` mesh).

Ranks are laid out as ``np.arange(world).reshape(axis_sizes)``, the JAX
mesh's device order, so the rank at mesh coordinate (d, m) holds the rows
JAX's ``NamedSharding(mesh, P('data'))`` gives that device.

Beside these, the plumbing JAX's single controller does not need:
``init_process_group`` / ``process_group`` start (and stop) the group from
``torchrun``'s environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``) or
from explicit arguments, NCCL for the card and gloo when the caller asks
for the CPU (or for gloo).  Without ``torchrun`` and without arguments no
group is started: the world is one process and nothing changes.  Gloo has
no average, so means are sums divided by the group size.
"""

from __future__ import annotations

import contextlib
import os
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

from one2345_tpu_torch.core.device import resolve_device

# the device type of this process's rank, set by init_process_group
_DEVICE_TYPE = None


def world_size() -> int:
    """Ranks of the process group; 1 without one."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    """This process's rank; 0 without a process group."""
    return dist.get_rank() if dist.is_initialized() else 0


def init_process_group(device=None, backend: str | None = None, rank: int | None = None,
                       world_size: int | None = None, init_method: str | None = None):
    """Join the process group and return this rank's device.

    Rank and world size come from the arguments or ``torchrun``'s
    ``RANK`` / ``WORLD_SIZE`` (``init_method`` defaults to ``env://``,
    which reads ``MASTER_ADDR`` / ``MASTER_PORT``).  Without either, no
    group is started and the device is ``resolve_device(device)``.  The
    device: ``device``, else ``cuda:LOCAL_RANK`` (``core/device.py``);
    the backend: ``backend``, else NCCL on the card and gloo on the CPU.
    """
    global _DEVICE_TYPE
    dev = resolve_device(device)
    if rank is None and "RANK" in os.environ:
        rank = int(os.environ["RANK"])
    if world_size is None and "WORLD_SIZE" in os.environ:
        world_size = int(os.environ["WORLD_SIZE"])
    if rank is None or world_size is None:
        return dev
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised")
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method or "env://", rank=rank,
                            world_size=world_size)
    _DEVICE_TYPE = dev.type
    return dev


def destroy_process_group() -> None:
    """Tear the process group down (nothing without one)."""
    global _DEVICE_TYPE
    if dist.is_initialized():
        dist.destroy_process_group()
    _DEVICE_TYPE = None


@contextlib.contextmanager
def process_group(device=None, **kwargs):
    """``init_process_group`` for a block: yields this rank's device; a
    group this call started is destroyed on the way out."""
    started = not dist.is_initialized()
    dev = init_process_group(device, **kwargs) if started else resolve_device(device)
    try:
        yield dev
    finally:
        if started:
            destroy_process_group()


def create_mesh(axis_names: Sequence[str] = ("data",), axis_sizes: Sequence[int] | None = None):
    """A ``DeviceMesh`` over the process group.

    With the default sizes the whole world lies on the first axis and 1 on
    the rest.  ``axis_sizes`` carves e.g. (data=2, model=2).  Raises
    ``ValueError`` when their product is not the world size (with no
    process group the world is one process), and ``RuntimeError`` with no
    process group to build the mesh on."""
    from torch.distributed.device_mesh import init_device_mesh

    n = world_size()
    if axis_sizes is None:
        axis_sizes = [n] + [1] * (len(axis_names) - 1)
    if int(np.prod(axis_sizes)) != n:
        raise ValueError(f"mesh {tuple(axis_sizes)} != {n} devices")
    if not dist.is_initialized():
        raise RuntimeError("create_mesh needs a process group: call init_process_group first")
    return init_device_mesh(_DEVICE_TYPE or "cpu", tuple(int(s) for s in axis_sizes),
                            mesh_dim_names=tuple(axis_names))


def axis_size(mesh, axis: str = "data") -> int:
    """Ranks along ``axis`` (1 for no mesh or an axis it lacks)."""
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        return 1
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_rank(mesh, axis: str = "data") -> int:
    """This rank's coordinate along ``axis`` (0 for no mesh)."""
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        return 0
    return mesh.get_local_rank(axis)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree)


def shard_batch(mesh, tree, axis: str = "data"):
    """This rank's contiguous rows of the leading axis of every leaf (numpy
    arrays or tensors): block ``axis_rank`` of ``axis_size`` equal blocks,
    as ``NamedSharding(mesh, P(axis))`` places them.  Raises ``ValueError``
    when the size does not divide a leading axis."""
    n, r = axis_size(mesh, axis), axis_rank(mesh, axis)

    def rows(x):
        if x.shape[0] % n:
            raise ValueError(f"leading axis {x.shape[0]} does not shard over {axis}={n}")
        b = x.shape[0] // n
        return x[r * b:(r + 1) * b]

    return _map(tree, rows)


def replicate(mesh, tree):
    """Every leaf as rank 0 holds it, on every rank (a mesh spans the
    world): tensors are broadcast in place, numpy arrays come back as new
    arrays."""
    dev = (torch.device("cuda", torch.cuda.current_device()) if mesh.device_type == "cuda"
           else torch.device("cpu"))

    def bcast(x):
        if isinstance(x, torch.Tensor):
            dist.broadcast(x, 0)
            return x
        t = torch.as_tensor(np.ascontiguousarray(x)).to(dev)
        dist.broadcast(t, 0)
        return t.cpu().numpy()

    return _map(tree, bcast)


def all_reduce_mean(tensors: Sequence[torch.Tensor], group=None) -> None:
    """Replace each tensor by its mean over the group, in one flat
    collective (a sum divided by the group size: gloo has no average)."""
    if not tensors:
        return
    dt = torch.float32
    for t in tensors:
        dt = torch.promote_types(dt, t.dtype)
    flat = torch.cat([t.reshape(-1).to(dt) for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    flat /= dist.get_world_size(group)
    i = 0
    for t in tensors:
        t.copy_(flat[i:i + t.numel()].view_as(t))
        i += t.numel()


def batch_spec(axis: str = "data") -> tuple:
    """The placements of a batch sharded on its leading axis."""
    from torch.distributed.tensor import Shard

    return (Shard(0),)


def replicated_spec() -> tuple:
    """The placements of a tensor every rank holds whole."""
    from torch.distributed.tensor import Replicate

    return (Replicate(),)


def pad_to_multiple(n: int, m: int) -> int:
    """Smallest multiple of ``m`` that is >= ``n`` (for sharding-friendly pads)."""
    return ((n + m - 1) // m) * m
