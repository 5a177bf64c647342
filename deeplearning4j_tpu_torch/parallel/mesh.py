"""The process mesh: which ranks train together, and over which axes.

Counterpart of ``deeplearning4j_tpu/parallel/mesh.py``. The reference's
mesh is the TPU's device torus under one program; the port runs one
process a GPU over ``torch.distributed``, so :meth:`MeshSpec.build` returns
a :class:`Mesh` of the world size, this process's rank, its local device
and the process group, with the axis sizes resolved as the reference
resolves them (the same ``ValueError`` s).

Only a ``data`` axis larger than 1 is built: a ``model``, ``seq``,
``stage`` or ``expert`` axis larger than 1 (tensor, sequence, pipeline or
expert parallelism) raises ``NotImplementedError`` (ROADMAP queue 1 item
7B).

The group: when ``torch.distributed`` is not initialized, :func:`ensure_group`
starts it from the environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` /
``MASTER_PORT``; see ``master.DistributedConfig``), or, with no
``WORLD_SIZE`` past 1 there, as a one-rank group of its own. The backend is
``nccl`` on the card and ``gloo`` only for ``device="cpu"``; a group of
another backend than the device needs raises.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"
STAGE_AXIS = "stage"
EXPERT_AXIS = "expert"

ITEM_7B = "ROADMAP queue 1 item 7B"


def backend_for(device: torch.device) -> str:
    """``nccl`` for a CUDA device, ``gloo`` for the CPU."""
    return "nccl" if device.type == "cuda" else "gloo"


def world_from_env() -> int:
    return int(os.environ.get("WORLD_SIZE", "1") or 1)


def ensure_group(device: torch.device):
    """The default process group, started if there is none (from the
    environment, or a one-rank group of its own), checked against the
    backend ``device`` needs. Returns the group."""
    import torch.distributed as dist
    want = backend_for(device)
    if not dist.is_initialized():
        if world_from_env() > 1:
            from deeplearning4j_tpu_torch.parallel.master import (
                DistributedConfig)
            DistributedConfig(device=device).initialize()
        else:
            dist.init_process_group(want, store=dist.HashStore(), rank=0,
                                    world_size=1)
    have = dist.get_backend()
    if have != want:
        raise RuntimeError(
            f"the process group runs {have!r} but a {device.type} device "
            f"needs {want!r} (no gloo on the card)")
    return dist.group.WORLD


@dataclasses.dataclass
class Mesh:
    """A data-parallel process mesh: ``axis_names`` and ``shape`` as the
    reference's mesh, ``world_size`` and ``rank`` of this process, its
    ``device`` and the process ``group``."""
    axis_names: tuple
    shape: Dict[str, int]
    world_size: int
    rank: int
    device: torch.device
    group: object = None

    @property
    def size(self) -> int:
        return self.world_size


@dataclasses.dataclass
class MeshSpec:
    """Declarative mesh: ordered {axis_name: size}; one size may be -1
    ("take the rest"), as the reference."""
    axes: Dict[str, int]

    @staticmethod
    def data_parallel(n: int = -1) -> "MeshSpec":
        return MeshSpec({DATA_AXIS: n})

    @staticmethod
    def dp_tp(data: int = -1, model: int = 1) -> "MeshSpec":
        return MeshSpec({DATA_AXIS: data, MODEL_AXIS: model})

    @staticmethod
    def dp_tp_sp(data: int = -1, model: int = 1, seq: int = 1) -> "MeshSpec":
        return MeshSpec({DATA_AXIS: data, MODEL_AXIS: model, SEQ_AXIS: seq})

    def resolve(self, n_devices: int) -> Dict[str, int]:
        sizes = dict(self.axes)
        fixed = int(np.prod([s for s in sizes.values() if s != -1]))
        wild = [k for k, s in sizes.items() if s == -1]
        if len(wild) > 1:
            raise ValueError("At most one mesh axis may be -1")
        if wild:
            if n_devices % fixed:
                raise ValueError(f"{n_devices} devices not divisible by "
                                 f"fixed axes {fixed}")
            sizes[wild[0]] = n_devices // fixed
        if int(np.prod(list(sizes.values()))) != n_devices:
            raise ValueError(f"Mesh {sizes} != {n_devices} devices")
        return sizes

    def build(self, devices: Optional[Sequence] = None,
              device=None) -> Mesh:
        """The mesh over this process group's ranks (``devices``, when
        given, must be one per rank). ``device`` is this rank's (default
        the card); the group is started if there is none."""
        from deeplearning4j_tpu_torch._device import resolve_device
        import torch.distributed as dist
        dev = resolve_device(device)
        group = ensure_group(dev)
        world = dist.get_world_size()
        if devices is not None and len(list(devices)) != world:
            raise ValueError(f"{len(list(devices))} devices for a process "
                             f"group of {world} ranks (one rank a device)")
        sizes = self.resolve(world)
        for axis, n in sizes.items():
            if axis != DATA_AXIS and n > 1:
                raise NotImplementedError(
                    f"a {axis!r} mesh axis of {n} (tensor, sequence, "
                    f"pipeline or expert parallelism) is not ported yet: "
                    f"{ITEM_7B}")
        return Mesh(tuple(sizes), sizes, world, dist.get_rank(), dev, group)


def axis_size(mesh: Mesh, name: str) -> int:
    return dict(mesh.shape).get(name, 1)
