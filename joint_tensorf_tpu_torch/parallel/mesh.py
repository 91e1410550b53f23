"""The process mesh of a data-parallel run
(counterpart of joint_tensorf_tpu/parallel/mesh.py).

The port runs the ``rays`` layout of the JAX package's mesh: one process
(rank) per mesh position, each holding the whole field and the whole pose
table and rendering its block of the step's rays.  The gradients meet in
one all-reduce a step (parallel/sharding.py).  A ``comp`` axis larger than
1 (the factor components split over ranks) is not ported, and
train/trainer.check_ported refuses it by name.

The process group is torch.distributed's: NCCL for CUDA tensors, gloo for
CPU ones.  A caller may name gloo for CUDA tensors too; that is how several
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

import torch
import torch.distributed as dist

_LAUNCH = ("python -m torch.distributed.run --nproc_per_node={n} "
           "-m joint_tensorf_tpu_torch.train --yaml=<config> [--k=v ...]")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A rank's view of the mesh: the axis sizes, its rank and the world
    size, the process group (None: the default group), its device and the
    backend.  ``counts`` counts the collectives by purpose (sharding.py
    adds to it), so a caller can read how many a step made."""
    axes: tuple
    shape: tuple
    rank: int
    world_size: int
    device: torch.device
    backend: str
    group: Optional[object] = None
    counts: dict = dataclasses.field(default_factory=dict, compare=False)

    @property
    def rays(self) -> int:
        """The size of the rays axis: the number of ray blocks a step's
        rays are split into."""
        return dict(zip(self.axes, self.shape)).get("rays", 1)

    @property
    def is_main(self) -> bool:
        """Rank 0: the rank that logs and writes files."""
        return self.rank == 0


def _init_method(coordinator: str) -> str:
    """JAX's coordinator is host:port; torch wants a URL."""
    return coordinator if "://" in coordinator else f"tcp://{coordinator}"


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None, device="cpu",
                           timeout_s: float = 600.0) -> bool:
    """Start this process's process group; True when one is running after
    the call.  The coordinator (``host:port``, ``tcp://...`` or
    ``file://...``), the process count and this process's rank are JAX's
    arguments; without them torchrun's environment (RANK, WORLD_SIZE,
    LOCAL_RANK, MASTER_ADDR, MASTER_PORT) is read, and without that
    nothing is started (a single process, as JAX's no-op).  ``backend``
    defaults to the device's: NCCL for CUDA, gloo for the CPU.  NCCL with
    more ranks on this host than cards raises."""
    if dist.is_initialized():
        return True
    env = os.environ
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
    else:
        return False
    backend = backend or ("nccl" if torch.device(device).type == "cuda"
                          else "gloo")
    if backend == "nccl":
        n_cards = torch.cuda.device_count()
        if local_ranks > n_cards:
            raise RuntimeError(
                f"NCCL needs one card per rank: {local_ranks} ranks on this "
                f"host, {n_cards} card(s).  Launch at most {n_cards} ranks "
                f"a host, or name backend gloo (and the device of each "
                f"rank) to share a card")
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


def make_mesh(shape, axes=("rays",), device="cpu") -> Mesh:
    """The mesh of this rank over the running process group.  Raises
    ValueError, as JAX's make_mesh does, when the world has fewer ranks
    than the shape needs (and when it has more: a rank outside the mesh
    would have no share of the rays), saying how to launch them.  A shape of one rank
    without a process group starts one (a file store in a fresh temporary
    directory), so the one-rank mesh runs the collectives too."""
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
    return Mesh(axes=axes, shape=shape, rank=dist.get_rank(),
                world_size=world, device=dev,
                backend=str(dist.get_backend()))


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
