"""The one place where tensors cross ranks.

A mesh that spans ranks (``parallel/multihost.py``) moves tensors between
them in five places, all here:

  * halo exchanges (``Topology.exchange``, ``Topology.apron``): ``swap``,
    every send and receive of a stage posted in one
    ``dist.batch_isend_irecv``, each message tagged by its place in the
    stage's global list, so every rank lists a pair's messages in one order;
  * reductions (``Topology.sum``, ``max``, ``dot``, ``allsum``, ...):
    ``all_partials``, each rank's per-shard partials all-gathered, so every
    rank combines every shard's in shard order and takes the same host
    decisions;
  * the snapshot gather (``mesh.gather_field``): ``gather_blocks``, onto one
    rank (``dist.gather``) or onto every rank (``dist.all_gather``);
  * the ranks' agreement check (``agree``): the host values each rank holds
    after a step, all-gathered and compared;
  * an ensemble's frame (``all_objects``): each rank's members' clocks and
    stats rows, all-gathered at once.

A resume needs no transfer: every rank reads the file and places its own
blocks (``parallel/mesh.shard_state``).

NCCL takes CUDA tensors directly.  Gloo takes host tensors, so on the card
each message is staged through host memory: a stage's sends are copied to
pinned host memory one after another and the stream is synchronised once,
before any is sent, and a received one is copied back to its device.  That
staging is explicit (``staged``), counted apart
(``TRANSFERS["staged_bytes"]``), and only ever taken with gloo, which a run
asks for by name (``multihost.choose_backend``).

An ensemble's member groups (``[tpu] batch_shards``) each step on their
own ranks; where a group's shards span several ranks, its exchanges and
reductions go over the group's own process group (``group``, made once by
``multihost.rank_group``), so one group's Merson retries and CG rounds
never meet another's messages.  A peer is named by its rank in that group.
At a frame the ranks meet in ``all_objects``, one packed all-gather of
every member's clock and stats rows.

``TRANSFERS`` counts, like ``ops/cuda_rhs.LAUNCHES``, the messages and
bytes this rank sent and received of each kind (``swap``'s ``kind``,
``partials``, ``gather``, ``frame``, ``agree``).
"""
from __future__ import annotations

import pickle
from typing import Any, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

TRANSFERS = {}


def reset_transfer_counts() -> None:
    TRANSFERS.clear()


def _count(kind: str, messages: int, nbytes: int, staged: bool) -> None:
    TRANSFERS[kind] = TRANSFERS.get(kind, 0) + messages
    TRANSFERS[f"{kind}_bytes"] = TRANSFERS.get(f"{kind}_bytes", 0) + nbytes
    if staged:
        TRANSFERS["staged_bytes"] = TRANSFERS.get("staged_bytes", 0) + nbytes


def staged(t: torch.Tensor) -> bool:
    """Whether ``t`` travels through host memory: a CUDA tensor under gloo."""
    return t.device.type == "cuda" and dist.get_backend() == "gloo"


def _to_wire(t: torch.Tensor) -> torch.Tensor:
    """``t`` as a contiguous tensor the backend can send: on the host under
    gloo (a copy that waits for the stream that wrote it)."""
    return t.to("cpu") if staged(t) else t.contiguous()


def _all_to_wire(ts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """``_to_wire`` of each of ``ts``: the staged ones copied into pinned
    host memory without waiting, then each stream they came from
    synchronised once."""
    wires = [t.to("cpu", non_blocking=True) if staged(t) else t.contiguous() for t in ts]
    for dev in {t.device for t in ts if staged(t)}:
        torch.cuda.current_stream(dev).synchronize()
    return wires


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


# (peer rank, tag, tensor): a message of ``swap``
Message = Tuple[int, int, torch.Tensor]


def _peer(group, rank: int) -> int:
    """The world rank of ``group``'s rank ``rank`` (None: the world)."""
    return rank if group is None else dist.get_global_rank(group, rank)


def swap(sends: Sequence[Message], recvs: Sequence[Message], kind: str, group=None) -> None:
    """Post every send of ``sends`` and every receive of ``recvs`` (into
    its tensor, which may be a view) in one ``batch_isend_irecv``, and wait
    for all of them.  The two lists hold this rank's messages of one stage,
    each in the stage's global order, with matching tags on both ends; a
    peer is its rank in ``group`` (None: the world)."""
    if not sends and not recvs:
        return
    ops, landings = [], []
    for (peer, tag, _), wire in zip(sends, _all_to_wire([t for _, _, t in sends])):
        ops.append(dist.P2POp(dist.isend, wire, _peer(group, peer), group=group, tag=tag))
    for peer, tag, out in recvs:
        # into ``out`` itself where the backend can write it, else a buffer
        if staged(out):
            wire = torch.empty(out.shape, dtype=out.dtype)
        elif out.is_contiguous():
            wire = out
        else:
            wire = torch.empty_like(out, memory_format=torch.contiguous_format)
        ops.append(dist.P2POp(dist.irecv, wire, _peer(group, peer), group=group, tag=tag))
        landings.append((out, wire))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    for out, wire in landings:
        if wire is not out:
            out.copy_(wire)
    any_staged = any(staged(t) for _, _, t in (*sends, *recvs))
    _count(kind, len(sends) + len(recvs),
           sum(_nbytes(t) for _, _, t in (*sends, *recvs)), any_staged)


def all_partials(values: Sequence[torch.Tensor], kind: str = "partials",
                 group=None) -> List[torch.Tensor]:
    """Every shard's partials in global shard order, on the device of this
    rank's first: each rank of ``group`` (None: the world) holds the same
    number of shards, its own ``values`` (one tensor of one shape per
    shard), and gets every rank's."""
    dev = values[0].device
    mine = _to_wire(torch.stack([v.to(dev) for v in values]))
    parts = [torch.empty_like(mine) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, mine, group=group)
    _count(kind, 1, _nbytes(mine) * len(parts), staged(values[0]))
    return [v.to(dev) for part in parts for v in part.unbind(0)]


def gather_blocks(blocks: Sequence[torch.Tensor], device,
                  root: Optional[int] = None) -> Optional[List[torch.Tensor]]:
    """Every shard's block in global shard order on ``device``: on every
    rank (``root`` None), or on rank ``root`` alone, the others getting
    None.  Each rank holds the same number of equal blocks (an ensemble's:
    its member groups' or its share of one group's, which join in (group,
    shard) order)."""
    mine = _to_wire(torch.stack(list(blocks)))
    world, me = dist.get_world_size(), dist.get_rank()
    if root is None:
        parts = [torch.empty_like(mine) for _ in range(world)]
        dist.all_gather(parts, mine)
    else:
        parts = [torch.empty_like(mine) for _ in range(world)] if me == root else None
        dist.gather(mine, parts, dst=root)
    _count("gather", 1, _nbytes(mine) * (world if parts is not None else 1),
           staged(blocks[0]))
    if parts is None:
        return None
    return [b.to(device) for part in parts for b in part.unbind(0)]


def all_objects(obj: Any, kind: str = "frame") -> List[Any]:
    """Every rank's ``obj`` (host values: numpy arrays, numbers, host
    tensors), in rank order, on every rank: one all-gather of the pickled objects
    (``dist.all_gather_object``), counted as one message of ``kind``."""
    parts = [None] * dist.get_world_size()
    dist.all_gather_object(parts, obj)
    _count(kind, 1, len(pickle.dumps(obj)) * len(parts), False)
    return parts


def agree(values: Sequence[float], what: str) -> None:
    """Raise unless every rank holds the same ``values`` (float64 on the
    host; NaN equals NaN): the host decisions of a step that every rank
    must take alike."""
    dev = torch.device("cuda", torch.cuda.current_device()) if (
        dist.get_backend() == "nccl") else torch.device("cpu")
    mine = torch.tensor(list(values), dtype=torch.float64, device=dev)
    parts = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, mine)
    _count("agree", 1, _nbytes(mine) * len(parts), False)
    rows = [p.cpu().tolist() for p in parts]
    same = all(len(r) == len(rows[0]) and all(a == b or (a != a and b != b)
                                               for a, b in zip(r, rows[0])) for r in rows)
    if not same:
        raise RuntimeError(f"the ranks disagree on {what}: {rows}")
