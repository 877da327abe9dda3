"""Multi-process sweeps over `torch.distributed`.

Counterpart of the JAX package's multihost module.  A sweep is
embarrassingly parallel at the cell level, so the design is the JAX one: a
2-D mesh of ranks, [hosts, ranks per host], with each chunk of cells split
over every rank of it.  No collective runs while the cells run; the one
cross-rank transfer of a chunk is the gather of its result to every rank.

The mesh lays out ranks; it holds no tensors.  Each rank computes on the
sweep's `device=` (a card of its own, or a card it shares), and the
gathered frames are host numpy that travel over a gloo group, so no NCCL
communicator is ever made on the sweep's path.

Usage, one process per rank:

    import torch.distributed as dist
    dist.init_process_group("gloo", init_method="tcp://host:port",
                            world_size=..., rank=...)
    mesh = multihost.multihost_sweep_mesh()
    df = run_landscape_robustness_sweep(..., mesh=mesh)

Without a process group, `multihost_sweep_mesh` joins the one that
`torchrun`'s rendezvous variables describe (MASTER_ADDR, MASTER_PORT,
RANK, WORLD_SIZE), and without those makes a one-rank gloo group in
memory (no network), so the same call runs in a single process.
"""
import functools
import os
import socket
from typing import Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


_RENDEZVOUS = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")


def _ensure_process_group() -> None:
    if dist.is_initialized():
        return
    if all(name in os.environ for name in _RENDEZVOUS):
        dist.init_process_group("gloo")  # torchrun's rendezvous (env://)
    else:
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)


@functools.lru_cache(maxsize=None)
def _gloo_group_over(default_group):
    """A gloo group over every rank of `default_group` (made once per default group)."""
    return dist.new_group(list(range(dist.get_world_size())), backend="gloo")


def host_group():
    """The gloo group host frames travel over: the default group if it is gloo."""
    if dist.get_backend() == "gloo":
        return None  # the default group
    return _gloo_group_over(dist.group.WORLD)


def multihost_sweep_mesh(axis_names=("hosts", "cells")) -> DeviceMesh:
    """The [hosts, ranks per host] sweep mesh over every rank.

    Collective: every rank calls it at the same point.  The first axis
    follows the hosts (ranks grouped by host name, hosts in the order of
    their first rank), the second the ranks within a host.  With one rank
    this is a [1, 1] mesh, and a sweep over it equals the sweep with
    `mesh=None` bitwise.  Raises ValueError if the hosts hold unequal
    numbers of ranks.
    """
    _ensure_process_group()
    world = dist.get_world_size()
    hosts = [None] * world
    dist.all_gather_object(hosts, socket.gethostname(), group=host_group())
    ranks = [[r for r in range(world) if hosts[r] == h] for h in dict.fromkeys(hosts)]
    if len({len(r) for r in ranks}) != 1:
        raise ValueError(f"hosts hold unequal numbers of ranks: {ranks}")
    return DeviceMesh("cpu", torch.tensor(ranks), mesh_dim_names=tuple(axis_names))


def mesh_ranks(mesh) -> list:
    """The mesh's ranks in the order its cell blocks are laid out (row-major)."""
    return mesh.mesh.flatten().tolist()


def mesh_share(mesh) -> Tuple[int, int]:
    """(this rank's position among the mesh's cell blocks, the mesh's size); (0, 1) for None.

    Raises TypeError for a mesh that is not a `DeviceMesh`, and ValueError
    unless it spans every rank of the default group.
    """
    if mesh is None:
        return 0, 1
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a DeviceMesh (multihost_sweep_mesh()), got {type(mesh)}")
    ranks = mesh_ranks(mesh)
    if sorted(ranks) != list(range(dist.get_world_size())):
        raise ValueError(f"the mesh's ranks {ranks} do not span all "
                         f"{dist.get_world_size()} ranks")
    return ranks.index(dist.get_rank()), len(ranks)


def broadcast_from_first(value, mesh):
    """`value` as the mesh's first rank holds it, on every rank (a picklable object)."""
    if mesh is None or mesh.size() == 1:
        return value
    box = [value]
    dist.broadcast_object_list(box, src=mesh_ranks(mesh)[0], group=host_group())
    return box[0]


def all_reduce_sum(tensor: torch.Tensor) -> torch.Tensor:
    """The sum of `tensor` over every rank, on `tensor`'s device (through the host)."""
    host = tensor.detach().cpu().clone()
    dist.all_reduce(host, group=host_group())
    return host.to(tensor.device)


def _tree_map(fn, *trees):
    first = trees[0]
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*(_tree_map(fn, *xs) for xs in zip(*trees)))
    if isinstance(first, (tuple, list)):
        return type(first)(_tree_map(fn, *xs) for xs in zip(*trees))
    if isinstance(first, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


def _to_numpy(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def gather_to_host(tree, mesh=None):
    """Each rank's share of a tree (leaves with a leading cell axis) as full host numpy.

    One rank: a plain copy to host numpy.  Several ranks: every rank's
    share is all-gathered over a gloo group and the shares are
    concatenated on their leading axis, in the mesh's order (rank order
    without a mesh), so every rank holds the full result.
    """
    host = _tree_map(_to_numpy, tree)
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return host
    shares = [None] * dist.get_world_size()
    dist.all_gather_object(shares, host, group=host_group())
    order = mesh_ranks(mesh) if mesh is not None else range(len(shares))
    return _tree_map(lambda *xs: np.concatenate(xs, axis=0), *(shares[r] for r in order))
