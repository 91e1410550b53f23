"""The process mesh of a data-parallel run
(counterpart of joint_tensorf_tpu/parallel/mesh.py).

One process (rank) per mesh position.  The ranks are laid out row-major
over ``shape`` in the order of ``axes``, as JAX lays its devices out
(np.reshape of the device list): under ``[rays, comp]`` of shape [R, C]
rank r * C + c holds rays index r and comp index c, under ``[comp, rays]``
rank c * R + r does.  Two axes are run:

* ``rays``: every rank renders its block of the step's rays; the
  gradients meet in one all-reduce a step over the ranks that share a comp
  index (the rays group);
* ``comp``: every rank holds a contiguous block of 1/C of every factor's
  components (and of their Adam moments); the features are summed over
  the ranks that share a rays index (the comp group) inside the field's
  forward (parallel/sharding.py, models/vm.py).

Each axis has its process group: the default group when the axis spans
the world, a group of its own otherwise (every rank creates every group,
in the same order, as torch.distributed.new_group requires).  A
collective over an axis of one rank in a larger world is skipped.

The process group is torch.distributed's: NCCL for CUDA tensors, gloo for
CPU ones.  The entry points (initialize_distributed, make_mesh and
parallel/launch.spawn) run on the card unless the caller names another
device (``device="cpu"``): without a card they raise, they do not carry on
on the host.  A caller may name gloo for CUDA tensors too; that is how several
ranks share one card (each rank's device is then given explicitly, e.g.
``cuda:0``).  NCCL never falls back to gloo: asking for it with more ranks
on a host than it has cards raises.
"""
from __future__ import annotations

import dataclasses
import datetime
import math
import os
import tempfile
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

_LAUNCH = ("python -m torch.distributed.run --nproc_per_node={n} "
           "-m joint_tensorf_tpu_torch.train --yaml=<config> [--k=v ...]")


# the group of an axis of one rank in a larger world: no collective runs
ALONE = "alone"
AXES = ("rays", "comp")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A rank's view of the mesh: the axis sizes, its rank, its index on
    each axis and the world size, each axis's process group (None: the
    default group; ALONE: the axis has one rank), its device and the
    backend.  ``counts`` counts the collectives by purpose and
    ``nbytes`` the bytes their buffers hold (sharding.py adds to both), so
    a caller can read how many a step made and how much they moved."""
    axes: tuple
    shape: tuple
    rank: int
    world_size: int
    device: torch.device
    backend: str
    coords: tuple = ()
    groups: dict = dataclasses.field(default_factory=dict, compare=False)
    counts: dict = dataclasses.field(default_factory=dict, compare=False)
    nbytes: dict = dataclasses.field(default_factory=dict, compare=False)

    def size(self, axis: str) -> int:
        """The number of ranks along ``axis`` (1 for an axis the mesh
        lacks)."""
        return dict(zip(self.axes, self.shape)).get(axis, 1)

    def index(self, axis: str) -> int:
        """This rank's index along ``axis`` (0 for an axis the mesh
        lacks)."""
        return dict(zip(self.axes, self.coords)).get(axis, 0)

    @property
    def rays(self) -> int:
        """The size of the rays axis: the number of ray blocks a step's
        rays are split into."""
        return self.size("rays")

    @property
    def comp(self) -> int:
        """The size of the comp axis: the number of component blocks every
        factor is split into."""
        return self.size("comp")

    @property
    def rays_index(self) -> int:
        return self.index("rays")

    @property
    def comp_index(self) -> int:
        return self.index("comp")

    @property
    def is_main(self) -> bool:
        """Rank 0: the rank that logs and writes files."""
        return self.rank == 0


def resolve_device(device=None) -> torch.device:
    """``device``, or ``cuda`` when None; a CUDA device on a host without
    a card raises RuntimeError (no fallback to the CPU)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev}: this host has no CUDA card; pass device='cpu' "
            f"to run on the host")
    return dev


def _init_method(coordinator: str) -> str:
    """JAX's coordinator is host:port; torch wants a URL."""
    return coordinator if "://" in coordinator else f"tcp://{coordinator}"


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None, device=None,
                           timeout_s: float = 600.0) -> bool:
    """Start this process's process group; True when one is running after
    the call.  The coordinator (``host:port``, ``tcp://...`` or
    ``file://...``), the process count and this process's rank are JAX's
    arguments; without them torchrun's environment (RANK, WORLD_SIZE,
    LOCAL_RANK, MASTER_ADDR, MASTER_PORT) is read, and without that
    nothing is started (a single process, as JAX's no-op).  ``device``
    defaults to the card (resolve_device: without one this raises);
    ``backend`` to the device's: NCCL for CUDA, gloo for the CPU.  NCCL
    with more ranks on this host than cards raises."""
    if dist.is_initialized():
        return True
    env = os.environ
    local_ranks = None
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes, process_id = int(env["WORLD_SIZE"]), int(env["RANK"])
        init_method = "env://"
        local_ranks = int(env.get("LOCAL_WORLD_SIZE", num_processes))
    elif num_processes is not None:
        if coordinator is None or process_id is None:
            raise ValueError("initialize_distributed: num_processes needs "
                             "the coordinator and this process's rank")
        init_method = _init_method(coordinator)
        local_ranks = num_processes
    kind = torch.device("cuda" if device is None else device).type
    backend = backend or ("nccl" if kind == "cuda" else "gloo")
    # NCCL's card count before the device, so that a host short of cards
    # is told how to launch
    if local_ranks is not None and backend == "nccl":
        n_cards = torch.cuda.device_count()
        if local_ranks > n_cards:
            raise RuntimeError(
                f"NCCL needs one card per rank: {local_ranks} ranks on this "
                f"host, {n_cards} card(s).  Launch at most {n_cards} ranks "
                f"a host, or name backend gloo (and the device of each "
                f"rank) to share a card")
    device = resolve_device(device)
    if local_ranks is None:
        return False
    if backend == "nccl":
        torch.cuda.set_device(rank_device(device))
    dist.init_process_group(backend, init_method=init_method,
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return True


def rank_device(device) -> torch.device:
    """A rank's device: a CUDA device without an index becomes
    ``cuda:LOCAL_RANK`` (torchrun's variable, 0 without it); a device with
    an index, or the CPU, stays as given."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return dev


def make_mesh(shape, axes=("rays",), device=None) -> Mesh:
    """The mesh of this rank over the running process group, on ``device``
    (the card when None; resolve_device: without one this raises).  Raises
    ValueError, as JAX's make_mesh does, when the world has fewer ranks
    than the shape needs (and when it has more: a rank outside the mesh
    would have no share of the rays), saying how to launch them.  A shape of one rank
    without a process group starts one (a file store in a fresh temporary
    directory), so the one-rank mesh runs the collectives too."""
    device = resolve_device(device)
    axes = tuple(axes)
    world = dist.get_world_size() if dist.is_initialized() else 1
    shape = tuple(int(s) for s in shape)
    if len(axes) < len(shape):
        raise ValueError(f"mesh shape {shape} has more axes than the names "
                         f"{axes}")
    axes = axes[:len(shape)]
    need = math.prod(shape)
    if world != need:
        raise ValueError(
            f"mesh shape {shape} needs {need} ranks but {world} "
            f"{'is' if world == 1 else 'are'} running.  Launch {need}: "
            f"{_LAUNCH.format(n=need)} (parallel.launch.spawn in a "
            f"program); on one rank unset tpu.mesh_shape")
    if not dist.is_initialized():
        store = os.path.join(tempfile.mkdtemp(prefix="jtf_mesh_"), "store")
        initialize_distributed(f"file://{store}", 1, 0, device=device)
    dev = rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    rank = dist.get_rank()
    coords = tuple(int(i) for i in np.unravel_index(rank, shape))
    return Mesh(axes=axes, shape=shape, rank=rank, world_size=world,
                device=dev, backend=str(dist.get_backend()), coords=coords,
                groups={a: _axis_group(axes, shape, coords, a, world)
                        for a in AXES})


def _axis_group(axes, shape, coords, axis: str, world: int):
    """The process group of this rank's line along ``axis``: None (the
    default group) when the axis spans the world, ALONE when it has one
    rank, else the group of the ranks that share every other index.  Every
    rank creates every line's group, in the same order."""
    size = dict(zip(axes, shape)).get(axis, 1)
    if size == world:
        return None
    if size == 1:
        return ALONE
    a = axes.index(axis)
    mine = None
    for fixed in np.ndindex(*[1 if i == a else n
                              for i, n in enumerate(shape)]):
        line = [int(np.ravel_multi_index(fixed[:a] + (j,) + fixed[a + 1:],
                                         shape)) for j in range(size)]
        group = dist.new_group(line)
        if fixed[:a] + fixed[a + 1:] == coords[:a] + coords[a + 1:]:
            mine = group
    return mine


def mesh_from_options(opt, device) -> Optional[Mesh]:
    """The trainer's mesh from ``tpu.mesh_shape`` / ``tpu.mesh_axes``
    (None without a shape): the process group from torchrun's environment
    when one is there, then make_mesh."""
    tpu = opt.get("tpu") or {}
    shape = tpu.get("mesh_shape")
    if not shape:
        return None
    initialize_distributed(device=device)
    return make_mesh(shape, tpu.get("mesh_axes") or ["rays"], device=device)
