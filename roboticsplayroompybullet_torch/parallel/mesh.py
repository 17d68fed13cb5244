"""Device mesh and batch sharding over torch.distributed (port of
roboticsplayroompybullet_tpu/parallel/mesh.py).

One process per device: a rank holds one card (or, with device="cpu", one
CPU process) and the mesh is a `DeviceMesh` over the ranks of the world.

Mesh convention, as the JAX package's:
  * 1-D mesh, axis "env": the batch shards over every rank.
  * 2-D mesh, axes ("dcn", "env"): nodes × the devices of one node, the
    world divided as JAX's `devices.reshape(n_hosts, -1)`. A batch shards
    over both axes, dcn-major: rank dcn·env_size + env (`mesh_rank`)
    holds block `mesh_rank` of the global batch, as JAX's
    P(("dcn", "env")) lays it out.

The JAX package's `batch_sharding` / `replicated_sharding` have no
counterpart here: a torch tensor lives on one rank. A "sharded" batch is
each rank's own block (`shard_batch`), a "replicated" value is the same
copy on every rank (made from the same seed), and the collectives run
over `mesh_group`.

Backend: NCCL for CUDA tensors, gloo for CPU tensors, chosen by the device
the caller names. A device that does not match the process group's
backend raises: nothing trades NCCL for gloo, or the card for the CPU.
"""
from __future__ import annotations

import os
import socket
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..envs.state import EnvState

ENV_AXIS = "env"
DCN_AXIS = "dcn"


def backend_for(device) -> str:
    """"nccl" for a CUDA device, "gloo" for the CPU."""
    kind = torch.device(device).type
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"no process-group backend for device {device!r}")
    return "nccl" if kind == "cuda" else "gloo"


def _check_backend(device) -> None:
    want, have = backend_for(device), dist.get_backend()
    if want != have:
        raise ValueError(f"device {device!r} needs a {want} process group; "
                         f"this one is {have}")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def initialize(device="cuda", init_method: Optional[str] = None,
               rank: Optional[int] = None,
               world_size: Optional[int] = None) -> None:
    """Start this process's process group for `device`, once.

    rank / world size default to torchrun's RANK / WORLD_SIZE (0 / 1
    without torchrun); on a CUDA device the process takes card LOCAL_RANK.
    init_method defaults to torchrun's env:// rendezvous, or for a world
    of one to a free port on localhost. A group already started must
    have the device's backend."""
    if dist.is_initialized():
        _check_backend(device)
        return
    backend = backend_for(device)
    rank = int(os.environ.get("RANK", 0)) if rank is None else rank
    world = (int(os.environ.get("WORLD_SIZE", 1)) if world_size is None
             else world_size)
    if init_method is None:
        if "MASTER_ADDR" in os.environ:
            init_method = "env://"
        elif world == 1:
            init_method = f"tcp://localhost:{_free_port()}"
        else:
            raise ValueError("a world of several processes needs torchrun's "
                             "MASTER_ADDR / MASTER_PORT or an init_method")
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world)


def make_mesh(n_devices: Optional[int] = None, n_hosts: int = 1,
              device="cuda") -> DeviceMesh:
    """The framework's mesh over the first n_devices ranks (all by
    default): 1-D ("env",), or 2-D ("dcn", "env") with n_hosts rows when
    n_hosts > 1. Starts the process group for `device` if need be. A 2-D
    mesh spans the whole world; ranks outside a smaller 1-D mesh hold no
    coordinate (`mesh_rank` is None there)."""
    initialize(device)
    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if not 1 <= n <= world:
        raise ValueError(f"{n} devices requested, the world has {world}")
    if n % n_hosts:
        raise ValueError(f"{n} devices not divisible by {n_hosts} hosts")
    kind = torch.device(device).type
    if n_hosts > 1:
        if n != world:
            raise ValueError("a (dcn, env) mesh spans the whole world")
        return init_device_mesh(kind, (n_hosts, n // n_hosts),
                                mesh_dim_names=(DCN_AXIS, ENV_AXIS))
    if n == world:
        return init_device_mesh(kind, (n,), mesh_dim_names=(ENV_AXIS,))
    return DeviceMesh(kind, torch.arange(n), mesh_dim_names=(ENV_AXIS,))


def mesh_size(mesh: DeviceMesh) -> int:
    return mesh.size()


def mesh_rank(mesh: DeviceMesh) -> Optional[int]:
    """This rank's linear mesh index, dcn · env_size + env (JAX's
    mpc.py:276-278), or None off the mesh."""
    coord = mesh.get_coordinate()
    if coord is None:
        return None
    idx = 0
    for c, n in zip(coord, mesh.mesh.shape):
        idx = idx * n + c
    return idx


def mesh_group(mesh: DeviceMesh):
    """The process group over every rank of the mesh, ranked in linear
    mesh order: the one that sums, mins and gathers over the whole mesh."""
    if mesh.ndim == 1:
        return mesh.get_group(0)
    return dist.group.WORLD          # make_mesh: a 2-D mesh is the world


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device: its current card, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def check_device(mesh: DeviceMesh, x: torch.Tensor) -> None:
    """Raise unless `x` lies on the mesh's kind of device and this rank is
    on the mesh."""
    if x.device.type != mesh.device_type:
        raise ValueError(f"a {x.device.type} tensor on a "
                         f"{mesh.device_type} mesh")
    if mesh.get_coordinate() is None:
        raise ValueError("this rank is not on the mesh")


def _tree_map(fn, tree):
    if isinstance(tree, EnvState):
        return EnvState(**{k: fn(v) for k, v in vars(tree).items()})
    return fn(tree)


def shard_batch(tree, mesh: DeviceMesh):
    """This rank's rows of a global batch (an EnvState or a tensor, batch
    leading, the same on every rank), on this rank's device: block
    `mesh_rank` of mesh_size equal blocks."""
    n, idx, dev = mesh_size(mesh), mesh_rank(mesh), mesh_device(mesh)
    if idx is None:
        raise ValueError("this rank is not on the mesh")

    def one(x):
        if x.shape[0] % n:
            raise ValueError(f"batch {x.shape[0]} does not split over {n} "
                             "devices")
        b = x.shape[0] // n
        return x[idx * b:(idx + 1) * b].to(dev)

    return _tree_map(one, tree)


def gather_batch(tree, mesh: DeviceMesh):
    """The global batch back from every rank's block (the inverse of
    shard_batch), on every rank of the mesh. A collective: for tests and
    tools, not the hot path."""
    group, n = mesh_group(mesh), mesh_size(mesh)

    def one(x):
        check_device(mesh, x)
        x = x.contiguous()
        out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(out, x, group=group)
        return out

    return _tree_map(one, tree)


def on_mesh(mesh: DeviceMesh, fn):
    """fn(states, *args) run on this rank's shard, after check_device on
    the states: the purely local compute of a sharded path."""
    def sharded(states, *args):
        check_device(mesh, states.q if isinstance(states, EnvState)
                     else states)
        return fn(states, *args)
    return sharded
