"""The process environment and the mesh: the counterparts of
``paddle_tpu/dist/env.py``'s ``init_parallel_env``, ``get_world_size``,
``get_rank``, ``ParallelEnv``, ``init_mesh``, ``get_mesh``,
``set_mesh``, ``mesh_axis_size`` and ``MeshGuard`` (``env.py:27-125``).

The JAX package is one process driving every device of a
``jax.sharding.Mesh``. Here each rank is a process, as in the reference
Paddle (``paddle/distributed/launch.py``) and in torch:
``init_parallel_env`` joins a ``torch.distributed`` process group from
the environment the launcher (``dist.launch``) sets, in the reference's
names (``PADDLE_TRAINER_ID``, ``PADDLE_TRAINERS_NUM``,
``PADDLE_TRAINER_ENDPOINTS``: the store listens on the first endpoint),
or from torch's (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT``), or from the arguments (``init_method``, ``rank``,
``world_size``). Without any, the process is a world of one
and no group is made, as the JAX package's single-host call is a no-op.

The backend follows one rule, logged when the group is made and never
switched on its own: ``nccl`` when every rank on this host has a card of
its own, ``gloo`` when ranks share a card (NCCL refuses two ranks on one
device) and ``gloo`` on the CPU. A rank's device is ``cuda:<local rank
% device count>`` (``_device.resolve_device``: without a card it raises
unless the caller chose the CPU, ``device="cpu"`` or
``set_device("cpu")``), and it becomes the current place.

The mesh is a mapping of axis names to sizes over the group's ranks
(``Mesh.shape``, as ``jax.sharding.Mesh.shape``), checked as
``init_mesh`` checks it (``env.py:76-97``: one ``-1`` takes what is
left; the product must be the rank count). Only data parallelism is
ported: an axis of another name and a size above 1 raises
``NotImplementedError`` (tensor parallelism, ROADMAP Queue 1 item 6b).
"""
from __future__ import annotations

import logging
import math
import os

import torch

from .. import _device

__all__ = [
    "init_parallel_env", "get_world_size", "get_rank", "ParallelEnv",
    "init_mesh", "get_mesh", "set_mesh", "mesh_axis_size", "MeshGuard",
    "Mesh", "get_group", "backend_for",
]

logger = logging.getLogger(__name__)

_MESH = None
# the joined group: {"group", "rank", "world", "local_rank", "device",
# "backend"}, or None before init_parallel_env
_STATE = None


def _endpoints_env(env):
    """``(rank, world, endpoints)`` from the launcher's variables, or
    None when they are not set."""
    if "PADDLE_TRAINER_ID" not in env or "PADDLE_TRAINERS_NUM" not in env:
        return None
    eps = [e for e in env.get("PADDLE_TRAINER_ENDPOINTS", "").split(",")
           if e]
    return int(env["PADDLE_TRAINER_ID"]), int(env["PADDLE_TRAINERS_NUM"]), \
        eps


def _local(rank, world, eps, env):
    """``(local rank, ranks on this host)``: torch's ``LOCAL_RANK`` and
    ``LOCAL_WORLD_SIZE`` where set, else from the endpoints that share
    this rank's host, else every rank on this host."""
    if "LOCAL_RANK" in env and "LOCAL_WORLD_SIZE" in env:
        return int(env["LOCAL_RANK"]), int(env["LOCAL_WORLD_SIZE"])
    if len(eps) == world:
        host = eps[rank].rsplit(":", 1)[0]
        same = [i for i, e in enumerate(eps) if e.rsplit(":", 1)[0] == host]
        return same.index(rank), len(same)
    return rank, world


def backend_for(device, local_world):
    """The backend the rule names for ranks on ``device`` with
    ``local_world`` ranks on this host: ``nccl`` when each has its own
    card, else ``gloo``."""
    if device.type == "cuda" and local_world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def init_parallel_env(device=None, init_method=None, rank=None,
                      world_size=None):
    """Join the process group (once; later calls return the same
    ``ParallelEnv``). ``device``: this rank's place (default the card,
    ``cuda:<local rank % device count>``); ``init_method``
    (``torch.distributed``'s: ``file://...``, ``tcp://...``), ``rank``
    and ``world_size`` override the environment. A world of one makes
    no group."""
    global _STATE
    if _STATE is not None:
        return ParallelEnv()
    import torch.distributed as dist

    env = os.environ
    eps = []
    found = _endpoints_env(env)
    if found is not None:
        r, w, eps = found
        if init_method is None and eps:
            init_method = f"tcp://{eps[0]}"
    elif "RANK" in env and "WORLD_SIZE" in env:
        r, w = int(env["RANK"]), int(env["WORLD_SIZE"])
        if init_method is None:
            init_method = "env://"
    else:
        r, w = 0, 1
    r = r if rank is None else int(rank)
    w = w if world_size is None else int(world_size)
    local_rank, local_world = _local(r, w, eps, env)
    dev = _device.resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    _device.CURRENT[0] = dev
    group = None
    chosen = None
    if w > 1:
        chosen = backend_for(dev, local_world)
        logger.info(
            "rank %d of %d on %s: backend %s (%d ranks on this host, %d "
            "cards)", r, w, dev, chosen, local_world,
            torch.cuda.device_count() if dev.type == "cuda" else 0)
        dist.init_process_group(chosen, init_method=init_method, rank=r,
                                world_size=w)
        group = dist.group.WORLD
    _STATE = {"group": group, "rank": r, "world": w,
              "local_rank": local_rank, "device": dev, "backend": chosen}
    return ParallelEnv()


def _shutdown():
    """Leave the group and forget the mesh (a rank's last call; tests)."""
    global _STATE, _MESH
    import torch.distributed as dist

    if _STATE is not None and _STATE["group"] is not None and \
            dist.is_initialized():
        dist.destroy_process_group()
    _STATE = None
    _MESH = None


def get_group():
    """The joined process group, or None in a world of one."""
    return None if _STATE is None else _STATE["group"]


def get_world_size():
    return 1 if _STATE is None else _STATE["world"]


def get_rank():
    return 0 if _STATE is None else _STATE["rank"]


class ParallelEnv:
    """ref: ``fluid/dygraph/parallel.py`` ``ParallelEnv``."""

    @property
    def world_size(self):
        return get_world_size()

    @property
    def rank(self):
        return get_rank()

    @property
    def local_rank(self):
        return 0 if _STATE is None else _STATE["local_rank"]

    @property
    def device_id(self):
        dev = None if _STATE is None else _STATE["device"]
        return dev.index if dev is not None and dev.type == "cuda" else 0

    @property
    def nranks(self):
        return get_world_size()

    @property
    def backend(self):
        """The group's backend, None in a world of one."""
        return None if _STATE is None else _STATE["backend"]


class Mesh:
    """Axis names to sizes over the group's ranks: ``shape`` (a dict in
    axis order), ``axis_names``, ``ranks``."""

    def __init__(self, shape, ranks):
        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)
        self.ranks = tuple(ranks)

    @property
    def size(self):
        return len(self.ranks)

    def __repr__(self):
        return f"Mesh({self.shape})"


def init_mesh(axes=None, devices=None):
    """Make and install the mesh over ``devices`` (ranks; default every
    rank of the group). ``axes``: names to sizes in order, or None for
    ``{"data": n}``; one ``-1`` takes what is left; the product must be
    the rank count."""
    global _MESH
    ranks = list(range(get_world_size())) if devices is None \
        else list(devices)
    n = len(ranks)
    if axes is None:
        axes = {"data": n}
    names, sizes = list(axes.keys()), list(axes.values())
    if -1 in sizes:
        known = math.prod(s for s in sizes if s != -1)
        sizes[sizes.index(-1)] = n // known
    if math.prod(sizes) != n:
        raise ValueError(f"mesh {dict(zip(names, sizes))} != {n} devices")
    other = {k: s for k, s in zip(names, sizes) if k != "data" and s > 1}
    if other:
        raise NotImplementedError(
            f"mesh axes {other}: only data parallelism is ported; tensor "
            "and sharded parallelism wait for ROADMAP Queue 1 item 6b")
    _MESH = Mesh(dict(zip(names, sizes)), ranks)
    return _MESH


def set_mesh(mesh):
    global _MESH
    _MESH = mesh


def get_mesh():
    return _MESH


def mesh_axis_size(name):
    m = get_mesh()
    if m is None or name not in m.shape:
        return 1
    return m.shape[name]


class MeshGuard:
    def __init__(self, mesh):
        self.mesh = mesh

    def __enter__(self):
        self._old = get_mesh()
        set_mesh(self.mesh)
        return self.mesh

    def __exit__(self, *a):
        set_mesh(self._old)
