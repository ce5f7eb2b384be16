"""Process meshes for the port (port of svi_tpu/parallel/mesh.py: the JAX
package's `jax.sharding.Mesh` axes become torch.distributed process groups).

Axes:
  'data' -- data parallel (training batches; the CFG pair at inference)
  'sp'   -- sequence parallel over the f·h·w token axis (also the tensor
            axis of `tensor_parallel`, which reuses it as the JAX package does)
  'tp'   -- the tensor axis of the 3-axis (data, tp, sp) mesh of `tp_sp`

Ranks are laid out as JAX reshapes its devices: row-major over the axes, so
rank = d·sp + s on ('data', 'sp') and (d·tp + t)·sp + s on ('data', 'tp',
'sp'). Every rank makes every axis's groups, in one order, and keeps those
it belongs to.
"""

from __future__ import annotations

import dataclasses
import datetime
import itertools
import math
import os

import torch
import torch.distributed as dist

# every process-group call fails after this long instead of hanging: a rank
# that skips a collective or calls them in another order ends the run
TIMEOUT = datetime.timedelta(seconds=600)


@dataclasses.dataclass(frozen=True)
class MeshAxis:
    """This rank's line along one mesh axis: the process group of the ranks
    that differ from it only on this axis (in axis order), the axis size,
    and this rank's index on it."""

    name: str
    size: int
    index: int
    ranks: tuple
    group: object
    backend: str


class Mesh:
    """A mesh of the torch.distributed world: `shape` maps each axis name to
    its size (as `jax.sharding.Mesh.shape`), `mesh[name]` is this rank's
    MeshAxis on it, and `world` the group of every rank of the mesh."""

    def __init__(self, names: tuple, sizes: tuple):
        if not dist.is_initialized():
            raise RuntimeError("a mesh needs torch.distributed initialised (init_distributed, "
                               "or torchrun's environment)")
        world = dist.get_world_size()
        if math.prod(sizes) != world:
            raise ValueError(f"mesh {dict(zip(names, sizes))} != {world} ranks")
        self.shape = dict(zip(names, sizes))
        self.rank = dist.get_rank()
        backend = dist.get_backend()
        coords = dict(zip(names, _coords(self.rank, sizes)))
        self._axes = {}
        for a, name in enumerate(names):
            others = [range(n) for i, n in enumerate(sizes) if i != a]
            for fixed in itertools.product(*others):
                line = []
                for i in range(sizes[a]):
                    c = list(fixed)
                    c.insert(a, i)
                    line.append(_flat(c, sizes))
                group = dist.new_group(line, timeout=TIMEOUT)  # collective: every rank
                if self.rank in line:
                    self._axes[name] = MeshAxis(name, sizes[a], coords[name], tuple(line),
                                                group, backend)
        self.world = MeshAxis("world", world, self.rank, tuple(range(world)),
                              dist.group.WORLD, backend)

    def __getitem__(self, name: str) -> MeshAxis:
        return self._axes[name]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, backend={self.world.backend})"


def _coords(rank: int, sizes) -> list:
    out = []
    for n in reversed(sizes):
        out.append(rank % n)
        rank //= n
    return out[::-1]


def _flat(coords, sizes) -> int:
    r = 0
    for c, n in zip(coords, sizes):
        r = r * n + c
    return r


def make_mesh(data: int = 1, sp: int | None = None) -> Mesh:
    n = dist.get_world_size()
    if sp is None:
        sp = n // data
    return Mesh(("data", "sp"), (data, sp))


def make_sp_mesh() -> Mesh:
    """Every rank on the sequence axis (the inference USP analog)."""
    return make_mesh(data=1, sp=None)


def make_training_mesh(strategy: str) -> Mesh | None:
    """Mesh for a --training_strategy flag (the analog of the reference's
    deepspeed_stage selection, train_svi.py:156-161):

    data_parallel: every rank on 'data' (DDP analog)
    sp:            every rank on 'sp' (sequence-parallel DiT forward)
    dataxsp:       2 x n/2
    Returns None with one rank (or no process group), as the JAX package
    does on one device: every strategy then runs the single-device path."""
    if strategy not in ("data_parallel", "sp", "dataxsp"):
        raise ValueError(f"unknown training strategy {strategy!r}")
    n = dist.get_world_size() if dist.is_initialized() else 1
    if n == 1:
        return None
    if strategy == "data_parallel":
        return make_mesh(data=n, sp=1)
    if strategy == "sp":
        return make_mesh(data=1, sp=n)
    data = 2 if n % 2 == 0 else 1
    return make_mesh(data=data, sp=n // data)


def init_distributed(device="cuda") -> torch.device:
    """Join the process group that torchrun's environment describes (RANK,
    WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR, MASTER_PORT) and
    return this rank's device. Without that environment (one process) it
    joins nothing and returns `device`.

    The backend follows the launch: NCCL when every local rank has a card of
    its own (LOCAL_WORLD_SIZE <= torch.cuda.device_count()), gloo when ranks
    share a card or run on the CPU; the choice is printed. A CUDA device
    with no index becomes cuda:(LOCAL_RANK % device_count): rank r on
    cuda:r where each has its own card."""
    device = torch.device(device)
    if "RANK" not in os.environ or int(os.environ.get("WORLD_SIZE", "1")) == 1:
        return device
    local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", os.environ["WORLD_SIZE"]))
    if device.type == "cuda":
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError("no CUDA device: the driver runs on the card (device='cpu' runs "
                               "it on the CPU)")
        if device.index is None:
            device = torch.device("cuda", local_rank % count)
        torch.cuda.set_device(device)
        backend = "nccl" if local_world <= count else "gloo"
    else:
        backend = "gloo"
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method="env://", timeout=TIMEOUT)
    if dist.get_rank() == 0:
        print(f"torch.distributed: {dist.get_world_size()} ranks, backend {backend} "
              f"({local_world} local ranks, {torch.cuda.device_count()} cards)", flush=True)
    return device


def is_main_rank() -> bool:
    """True on global rank 0, or without a process group: the rank that
    writes metrics, exports and checkpoints."""
    return not dist.is_initialized() or dist.get_rank() == 0
