"""Multi-process execution: the ranks of one ``torch.distributed`` world.

The port of ``bachelors_tpu/parallel/multihost.py`` (``initialize`` :29,
``is_primary`` :60, ``local_device_count`` :65).  Every rank runs the same
driver; ``initialize`` joins them into one process group, after which a mesh
(``parallel/mesh.make_mesh``) spans the ranks: rank r owns a contiguous
range of the mesh's shards in row-major order, and the halo exchanges,
reductions and snapshot gathers that cross a rank boundary go through
``parallel/transport.py``.  A single process is a no-op, so the same entry
points work everywhere.

An ensemble's member groups take ranks too (``mesh.make_mesh(...,
batch=G)``): whole groups a rank, or a group's shards over several ranks,
whose collectives then go over a process group of their own
(``rank_group``), made once, before any run starts its clock.

Backends: NCCL for CUDA devices, gloo on the CPU.  Gloo on the card is
taken only when asked (``backend="gloo"``, ``BTPU_DIST_BACKEND=gloo``, or
the launcher's ``--backend gloo``); its exchanges are then staged through
host memory (``transport.py``).  NCCL refuses two ranks on one device, and
``initialize`` raises before it would try; it never switches backend by
itself.  The process group always gets a timeout, so a peer that is gone
ends the run with an error instead of a hang.
"""
from __future__ import annotations

import datetime
import os
from typing import Dict, Optional

import torch
import torch.distributed as dist

from ..utils.logging import get_logger

log = get_logger("multihost")

# The variables torchrun (and any launcher of its contract) sets in each rank.
TORCHRUN_VARS = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK")
BACKENDS = ("nccl", "gloo")
# Seconds a collective may wait for its peers before the run fails
# (``BTPU_DIST_TIMEOUT`` overrides).
TIMEOUT_S = 300.0
# This rank's process group among the world's contiguous groups of a size,
# by size (``rank_group``)
_GROUPS: Dict[int, object] = {}


def _ready() -> bool:
    return dist.is_available() and dist.is_initialized()


def torchrun_env() -> bool:
    """Whether torchrun's variables are all set (the ``env://`` contract)."""
    return all(v in os.environ for v in TORCHRUN_VARS)


def choose_backend(backend: Optional[str] = None, device=None) -> str:
    """``backend``, else ``BTPU_DIST_BACKEND``, else NCCL for a CUDA
    ``device`` (the default device) and gloo for the CPU."""
    backend = backend or os.environ.get("BTPU_DIST_BACKEND") or (
        "gloo" if device is not None and torch.device(device).type == "cpu" else "nccl")
    if backend not in BACKENDS:
        raise ValueError(f"unknown torch.distributed backend {backend!r}; "
                         f"one of {', '.join(BACKENDS)}")
    return backend


def _check_nccl() -> None:
    """NCCL runs one rank per device: raise when this host's ranks outnumber
    its cards, naming the way out."""
    if not torch.cuda.is_available():
        raise RuntimeError("the NCCL backend needs a CUDA device and torch sees none; "
                           "pass --backend gloo (BTPU_DIST_BACKEND=gloo) for the CPU")
    local = int(os.environ.get("LOCAL_WORLD_SIZE", "1"))
    cards = torch.cuda.device_count()
    if local > cards:
        raise RuntimeError(
            f"NCCL cannot run two ranks on one device: {local} ranks on this host share "
            f"{cards} card(s); pass --backend gloo to the launcher (BTPU_DIST_BACKEND=gloo), "
            "whose exchanges are staged through host memory")


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None, device=None) -> bool:
    """Join this process to its world; True when it is in one.

    With ``coordinator_address`` (``host:port`` or a ``tcp://`` URL),
    ``num_processes`` and ``process_id``: a ``tcp://`` rendezvous.  With
    none of them but torchrun's variables set (``TORCHRUN_VARS``):
    ``env://``, the counterpart of JAX's cluster autodetection.  With
    neither: a single process, False.  A group that already exists: True.
    ``backend`` as ``choose_backend`` picks it for ``device``.  The group's
    timeout is ``TIMEOUT_S``, or ``BTPU_DIST_TIMEOUT`` seconds where that is
    set (the launcher's ranks inherit it)."""
    if _ready():
        return True
    if coordinator_address is None and num_processes is None:
        if not torchrun_env():
            return False
        init, world, rank = "env://", int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    else:
        if coordinator_address is None or num_processes is None or process_id is None:
            raise ValueError("a tcp rendezvous takes coordinator_address, num_processes "
                             "and process_id together")
        init = (coordinator_address if "://" in coordinator_address
                else f"tcp://{coordinator_address}")
        world, rank = int(num_processes), int(process_id)
    backend = choose_backend(backend, device)
    if backend == "nccl":
        _check_nccl()
        torch.cuda.set_device(local_cuda_device())
    timeout = float(os.environ.get("BTPU_DIST_TIMEOUT") or TIMEOUT_S)
    dist.init_process_group(backend, init_method=init, world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout))
    # every rank has joined, and NCCL has made its communicator (which it
    # does at a group's first collective), before a run starts its clock
    dist.barrier()
    log.okay(f"distributed: rank {rank} of {world} ({backend}, {init.split('://')[0]}, "
             f"timeout {timeout:g} s)")
    return True


def rank() -> int:
    """This process's rank (0 outside a world)."""
    return dist.get_rank() if _ready() else 0


def world() -> int:
    """The number of ranks (1 outside a world)."""
    return dist.get_world_size() if _ready() else 1


def backend() -> Optional[str]:
    """The world's backend, None outside a world."""
    return dist.get_backend() if _ready() else None


def is_primary() -> bool:
    """Whether this process writes the run's files (rank 0)."""
    return rank() == 0


def local_rank() -> int:
    """This rank's index among the ranks of its host: torchrun's
    ``LOCAL_RANK``, which the launcher sets too."""
    return int(os.environ.get("LOCAL_RANK", rank()))


def local_device_count() -> int:
    """The CUDA devices this process sees (1 for the CPU)."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 1


def local_cuda_device() -> torch.device:
    """This rank's card: ``cuda:{LOCAL_RANK % device_count}``; every rank on
    a host of one card takes ``cuda:0``."""
    return torch.device("cuda", local_rank() % max(torch.cuda.device_count(), 1))


def rank_group(size: int):
    """This rank's process group when the world splits into contiguous
    groups of ``size`` ranks (ranks [k size, (k + 1) size), a member group
    whose shards span them): made on the first call with every rank taking
    part, each group's in order as ``dist.new_group`` needs, then a barrier
    in the group and one in the world, so that the group exists on every
    rank, and NCCL has made its communicator, before a run starts its
    clock.  Later calls return the same group.  None for the whole world
    (its default group), and outside a world."""
    if not _ready() or size == world():
        return None
    if world() % size:
        raise ValueError(f"a world of {world()} ranks does not split into groups of {size}")
    if size not in _GROUPS:
        groups = [dist.new_group(list(range(k, k + size))) for k in range(0, world(), size)]
        mine = groups[rank() // size]
        dist.barrier(group=mine)
        dist.barrier()
        _GROUPS[size] = mine
    return _GROUPS[size]


def finalize() -> None:
    """Leave the world, if in one."""
    if _ready():
        _GROUPS.clear()
        dist.destroy_process_group()
