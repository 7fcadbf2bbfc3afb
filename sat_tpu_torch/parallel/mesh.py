"""The process mesh and its bootstrap — the port of ``sat_tpu.parallel.mesh``.

The JAX package lays the global device set out as a named GSPMD mesh
and lets XLA insert the collectives.  Here every mesh position is a
process (a ``torchrun`` rank) with one device, and the collectives are
explicit ``torch.distributed`` calls over one process group per axis:

* ``data``  — the batch splits over it; gradients are summed over it;
* ``model`` — the vocabulary-sized leaves split over it (vocab tensor
  parallelism), or, with ``context_parallel``, the context grid.

Ranks are laid out data-major, as ``mesh_from_devices`` reshapes the
device list: rank ``r`` sits at ``(r // m, r % m)`` of a ``(d, m)``
mesh.  The data group of a rank is the ranks that share its model index,
its model group the ranks that share its data index.

**The device and backend rule** (:func:`initialize_distributed`), decided
from ``LOCAL_WORLD_SIZE`` and the visible cards *before*
``init_process_group``, never by catching an error:

* ``SAT_TORCH_DEVICE=cpu``: every rank on the CPU, gloo;
* each local rank has its own card: ``cuda:LOCAL_RANK``, NCCL;
* the host has exactly one card: every rank on ``cuda:0``, gloo (NCCL
  refuses two ranks on one device; gloo moves CUDA tensors through host
  memory);
* any other layout raises.

Collectives on device tensors are only ``all_reduce``, ``broadcast`` and
``barrier``, so both backends take the same calls.  Host values (the
fleet vectors, the decoded beam-0 results) go over one CPU gloo group
that every mesh holds (``Mesh.host_group``).
"""

from __future__ import annotations

import datetime
import itertools
import os
import sys
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from ..config import Config
from ..device import DEVICE_ENV

AXES = ("data", "model")

# How long a collective waits for a peer before it fails the run: a dead
# or wedged rank ends the others with an error instead of a hang.
COLLECTIVE_TIMEOUT_S = 300.0

# what initialize_distributed chose for this process
_BOOT: Dict[str, object] = {}
# one Mesh per (shape, axes) and process: process groups are process-wide
_MESHES: Dict[Tuple, "Mesh"] = {}


def _env_int(name: str) -> Optional[int]:
    value = os.environ.get(name)
    try:
        return int(value) if value not in (None, "") else None
    except ValueError:
        return None


def _slurm_tasks_per_node() -> Optional[int]:
    """``SLURM_STEP_TASKS_PER_NODE``/``SLURM_NTASKS_PER_NODE`` ("2" or
    "2(x3)") as an int."""
    for var in ("SLURM_STEP_TASKS_PER_NODE", "SLURM_NTASKS_PER_NODE"):
        raw = os.environ.get(var, "")
        head = raw.split("(")[0].split(",")[0]
        if head.isdigit():
            return int(head)
    return None


def launch_env() -> Optional[Dict[str, int]]:
    """(rank, world, local_rank, local_world) from the launcher's
    environment — torchrun's ``RANK``/``WORLD_SIZE``/``LOCAL_RANK``/
    ``LOCAL_WORLD_SIZE``, else SLURM's ``SLURM_PROCID``/``SLURM_STEP_NUM_TASKS``
    (or ``SLURM_NTASKS``)/``SLURM_LOCALID`` — or None for a plain single
    process (no launcher, or a launch of one)."""
    world = _env_int("WORLD_SIZE")
    if world is not None:
        if world <= 1:
            return None
        rank = _env_int("RANK")
        local_rank = _env_int("LOCAL_RANK")
        local_world = _env_int("LOCAL_WORLD_SIZE")
        if rank is None or local_rank is None or local_world is None:
            raise RuntimeError(
                "sat_tpu_torch: WORLD_SIZE is set but RANK, LOCAL_RANK or LOCAL_WORLD_SIZE is "
                "not: launch with torchrun (python -m torch.distributed.run)"
            )
        return {"rank": rank, "world": world, "local_rank": local_rank, "local_world": local_world}
    if os.environ.get("SLURM_STEP_NODELIST"):
        world = _env_int("SLURM_STEP_NUM_TASKS") or _env_int("SLURM_NTASKS")
        if not world or world <= 1:
            return None
        for var in ("MASTER_ADDR", "MASTER_PORT"):
            if not os.environ.get(var):
                raise RuntimeError(
                    f"sat_tpu_torch: a SLURM launch of {world} tasks needs {var} in the "
                    "environment (the rendezvous address of rank 0)"
                )
        return {
            "rank": _env_int("SLURM_PROCID") or 0, "world": world,
            "local_rank": _env_int("SLURM_LOCALID") or 0,
            "local_world": _slurm_tasks_per_node() or 1,
        }
    return None


def device_rule(local_rank: int, local_world: int) -> Tuple[torch.device, str]:
    """(this rank's device, the device groups' backend), from the launch
    layout and the visible cards alone (see the module docstring)."""
    wanted = os.environ.get(DEVICE_ENV) or "cuda"
    if wanted not in ("cuda", "cpu"):
        raise ValueError(f"sat_tpu_torch: {DEVICE_ENV}={wanted!r}: expected 'cuda' or 'cpu'")
    if wanted == "cpu":
        return torch.device("cpu"), "gloo"
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards == 0:
        raise RuntimeError(
            "sat_tpu_torch: no CUDA device is visible to this rank; set "
            f"{DEVICE_ENV}=cpu to run the mesh on the CPU"
        )
    if cards >= local_world:
        return torch.device("cuda", local_rank), "nccl"
    if cards == 1:
        return torch.device("cuda", 0), "gloo"
    raise RuntimeError(
        f"sat_tpu_torch: {local_world} local ranks over {cards} cards: give every rank "
        "its own card, or run on a host with exactly one card (the ranks then share it)"
    )


def initialize_distributed(timeout_s: float = COLLECTIVE_TIMEOUT_S) -> bool:
    """Join the launcher's process group; a no-op for a plain single
    process.  Call once per process before the device is resolved (the
    CLI does).  Returns True when a group was initialized.

    Sets this rank's CUDA device (so ``device.resolve_device`` names it)
    and the telemetry's process identity; rank 0 prints the choice."""
    if dist.is_available() and dist.is_initialized():
        return True
    env = launch_env()
    if env is None:
        return False
    device, backend = device_rule(env["local_rank"], env["local_world"])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    os.environ.setdefault("MASTER_ADDR", "127.0.0.1")
    dist.init_process_group(
        backend=backend, init_method="env://", rank=env["rank"], world_size=env["world"],
        timeout=datetime.timedelta(seconds=timeout_s),
    )
    _BOOT.update(device=device, backend=backend, **env)
    from .. import telemetry

    telemetry.set_process_identity(env["rank"], env["world"])
    if env["rank"] == 0:
        shared = backend == "gloo" and device.type == "cuda" and env["local_world"] > 1
        print(
            f"sat_tpu_torch: {env['world']} ranks ({env['local_world']} on this host), "
            f"backend {backend}, rank 0 on {device}"
            + (" (the host's one card, shared by every local rank)" if shared else ""),
            file=sys.stderr, flush=True,
        )
    return True


def shutdown_distributed() -> None:
    """Leave the process group at the end of a launch (no-op otherwise)."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _MESHES.clear()
    _HOST.clear()


def boot_info() -> Dict[str, object]:
    """What :func:`initialize_distributed` chose ({} for a single process)."""
    return dict(_BOOT)


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def sync_processes(tag: str) -> None:
    """A barrier over every rank (no-op in a single process).  ``tag``
    names the place in a failure's message."""
    if world_size() > 1:
        from .collectives import blocking

        try:
            with blocking():
                dist.barrier(group=_host_group())
        except RuntimeError as e:
            raise RuntimeError(f"sat_tpu_torch: barrier {tag!r} failed: {e}") from e


_HOST: Dict[str, object] = {}


def _host_group():
    """The CPU gloo group over every rank (created once, by every rank)."""
    if "group" not in _HOST:
        _HOST["group"] = dist.new_group(backend="gloo") if dist.get_backend() != "gloo" else dist.group.WORLD
    return _HOST["group"]


class Mesh:
    """This process's place in the (data, model) mesh and its groups.

    ``shape``/``axes`` as ``Config.mesh_shape``/``mesh_axes`` (a 0
    inferred); ``coords[axis]`` this rank's index on an axis;
    ``groups[axis]`` the process group of the ranks along it (None when
    the axis has size 1); ``host_group`` the CPU gloo group over every
    rank (None in a single process)."""

    def __init__(self, shape: Tuple[int, ...], axes: Tuple[str, ...], rank_: int, device, backend: str,
                 groups: Dict[str, object], host_group) -> None:
        self.shape = tuple(int(s) for s in shape)
        self.axes = tuple(axes)
        self.rank = int(rank_)
        self.world = 1
        for s in self.shape:
            self.world *= s
        self.device = device
        self.backend = backend
        self.groups = groups
        self.host_group = host_group
        self.coords = {}
        rest = self.rank
        for axis, size in reversed(list(zip(self.axes, self.shape))):
            rest, self.coords[axis] = divmod(rest, size)

    def size(self, axis: str) -> int:
        return self.shape[self.axes.index(axis)] if axis in self.axes else 1

    def index(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    def group(self, axis: str):
        return self.groups.get(axis)

    def __repr__(self) -> str:
        return (f"Mesh(shape={self.shape}, axes={self.axes}, rank={self.rank}, coords={self.coords}, "
                f"device={self.device}, backend={self.backend})")


# a single process: every axis of size 1, every group None, so each
# collective over it is the identity
SINGLE = Mesh((1, 1), AXES, 0, None, None, {}, None)


def _resolve_shape(config: Config, world: int) -> Tuple[int, ...]:
    shape = tuple(int(s) for s in config.mesh_shape)
    axes = tuple(config.mesh_axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh_shape {shape} / mesh_axes {axes} length mismatch")
    if set(axes) - set(AXES):
        raise ValueError(f"mesh_axes {axes}: the port's axes are {AXES}")
    if 0 in shape:
        fixed = 1
        for s in shape:
            fixed *= s if s else 1
        if shape.count(0) != 1 or world % fixed:
            raise ValueError(f"cannot infer mesh {shape} over {world} ranks")
        shape = tuple(world // fixed if s == 0 else s for s in shape)
    return shape


def make_mesh(config: Config) -> Mesh:
    """The mesh of ``config.mesh_shape`` over this launch's ranks.

    A 0 takes the ranks left over, as the JAX package's ``make_mesh``
    does.  The shape must hold exactly ``WORLD_SIZE`` ranks: a mesh of
    more than one position in a single process raises with the launch
    command (there is no silent one-device run)."""
    world = world_size()
    shape = _resolve_shape(config, world)
    n = 1
    for s in shape:
        n *= s
    if n != world:
        if world == 1:
            raise RuntimeError(
                f"sat_tpu_torch: mesh_shape={tuple(config.mesh_shape)} needs {n} processes, one per "
                f"mesh position; launch it with `python -m torch.distributed.run --standalone "
                f"--nproc_per_node {n} -m sat_tpu_torch.cli ...` (torchrun)"
            )
        raise ValueError(f"mesh_shape {shape} holds {n} positions, but the launch has {world} ranks")
    axes = tuple(config.mesh_axes)
    key = (shape, axes)
    if key in _MESHES:
        return _MESHES[key]
    if world == 1:
        mesh = Mesh(shape, axes, 0, None, "", {}, None)
        _MESHES[key] = mesh
        return mesh
    me = dist.get_rank()
    groups: Dict[str, object] = {}
    # every rank creates every group, in the same order
    for a, axis in enumerate(axes):
        if shape[a] == 1:
            continue
        mine = None
        others = [range(s) for i, s in enumerate(shape) if i != a]
        for fixed in itertools.product(*others):
            members = []
            for k in range(shape[a]):
                coord = list(fixed)
                coord.insert(a, k)
                r = 0
                for c, s in zip(coord, shape):
                    r = r * s + c
                members.append(r)
            g = dist.new_group(ranks=members)
            if me in members:
                mine = g
        groups[axis] = mine
    mesh = Mesh(shape, axes, me, _BOOT.get("device"), str(_BOOT.get("backend", dist.get_backend())),
                groups, _host_group())
    _MESHES[key] = mesh
    return mesh


def topology(config: Config, device) -> Dict[str, object]:
    """The topology a checkpoint is written under, as the JAX package's
    lineage sidecar records it: one device per rank (``device_count`` =
    the ranks, which may share a card), the platform, the process count
    and the configured mesh."""
    world = world_size()
    dev = torch.device(device) if device is not None else torch.device("cpu")
    return {
        "device_count": world,
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "process_count": world,
        "mesh_shape": list(config.mesh_shape),
        "mesh_axes": list(config.mesh_axes),
    }
