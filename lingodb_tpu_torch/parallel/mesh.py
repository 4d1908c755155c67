"""Device mesh and SPMD query primitives.

The counterpart of lingodb_tpu/parallel/mesh.py, itself the accelerator's
replacement for LingoDB's morsel-driven scheduler (worker threads over
shared memory, per-thread fragments merged across threads):

  morsel work-stealing        -> even hash/block partitioning over the mesh
  thread-local state + merge  -> per-shard partial aggregates + psum
  lock-based shared state     -> keyed repartition (all-to-all) so each key
                                 lands on exactly one shard

A `Mesh` is an ordered, host-major list of torch devices on one axis named
"dp" (a device may repeat: eight positions on one card run the sharded
operators one shard after another). A `Sharded` value is the counterpart of
a P("dp") array: one tensor per mesh position, each of `local_len` rows on
its position's device; shard s holds rows [s*local_len, (s+1)*local_len) of
the global array. The engine is single-controller, as the reference is: one
Python thread drives every shard of its process, so the collectives inside
a process are copies (`.to(device, non_blocking=True)` between devices,
indexing within one) and need no torch.distributed. A mesh that spans
processes carries a process group (parallel/multihost.py) and every process
runs the same statement over the same catalog (SPMD): `psum` and `preduce`
reduce through the group, `gather` all-gathers every process's shards, and
`all_to_all` moves the shards' rows in one `all_to_all_single` (the two
phases of multihost.ExchangePlan: the rows bound for another process leave
from this process's lead device in one stripe). Each process holds only its
own positions' shards (`Mesh.local_positions`).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .multihost import MeshDevice, host_major_order, process_span


class Mesh:
    """An ordered list of devices on one named axis. `devices` are torch
    devices (or names) of this process, or MeshDevice descriptors of every
    process for a mesh that spans processes (then `group` is the process
    group and this process holds the positions of `span`)."""

    def __init__(self, devices, axis: str = "dp", group=None):
        descs = [d if isinstance(d, MeshDevice)
                 else MeshDevice(0, i, torch.device(d))
                 for i, d in enumerate(devices)]
        if len(descs) < 1:
            raise ValueError("a mesh needs at least one device")
        self.descriptors = host_major_order(descs)
        self.devices = [d.device for d in self.descriptors]
        self.axis_names = (axis,)
        self.shape = {axis: len(descs)}
        self.group = group
        self.span = (process_span(self.descriptors) if group is not None
                     else (0, len(descs)))

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def local_positions(self) -> range:
        return range(*self.span)

    def spans_processes(self) -> bool:
        return self.span != (0, self.size)

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]}, {self.axis_names[0]!r})"


@dataclass(eq=False)
class Sharded:
    """One tensor per local mesh position, `local_len` rows each, on its
    position's device (the P("dp") layout of a global array of
    mesh.size * local_len rows)."""

    mesh: Mesh
    shards: list
    local_len: int

    def map(self, fn, *others) -> "Sharded":
        """Elementwise fn over this value's shards and the others', shard
        by shard."""
        outs = [fn(s, *[o.shards[i] for o in others])
                for i, s in enumerate(self.shards)]
        return Sharded(self.mesh, outs, int(outs[0].shape[0]))

    def __and__(self, other):
        return self.map(torch.logical_and, other)

    def __gt__(self, value):
        return self.map(lambda s: s > value)


def _as_tensor(arr) -> torch.Tensor:
    if isinstance(arr, torch.Tensor):
        return arr
    a = np.asarray(arr)
    if a.dtype == np.uint64:
        a = a.view(np.int64)  # hashes: the same bits, as the port holds them
    if not (a.flags.writeable and a.flags.c_contiguous):
        a = np.array(a)
    return torch.from_numpy(a)


def make_mesh(n_devices: int | None = None, axis: str = "dp",
              devices=None) -> Mesh:
    """A mesh over `devices` (default: every CUDA device; with none present
    it raises, as the engine never quietly runs on the CPU: pass devices),
    the first `n_devices` of them when given."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
        if not devices:
            raise RuntimeError("make_mesh: no CUDA device available: pass "
                               "devices (e.g. ['cpu'] * 4) explicitly")
    devices = list(devices)
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(devices, axis)


def shard_rows(mesh: Mesh, arr, axis: str = "dp") -> Sharded:
    """Shard a row-partitioned column across the mesh, padding with zeros
    to a multiple of the axis size (callers carry the true row count).
    A shard on the array's own device is a view of it; only a shard that
    holds padding is a copy, and no shard is the whole array. On a mesh
    that spans processes `arr` is the global array, as every process holds
    it, and only this process's positions are cut from it."""
    if isinstance(arr, Sharded):
        return arr
    t = _as_tensor(arr)
    n = mesh.shape[axis]
    rows = int(t.shape[0])
    local = -(-rows // n)
    shards = []
    for s in mesh.local_positions:
        lo, hi = min(s * local, rows), min((s + 1) * local, rows)
        piece = t[lo:hi]
        if hi - lo < local:
            piece = torch.cat([piece, piece.new_zeros(
                (local - (hi - lo),) + tuple(t.shape[1:]))])
        shards.append(piece.to(mesh.devices[s], non_blocking=True))
    return Sharded(mesh, shards, local)


def _lead(mesh: Mesh) -> torch.device:
    """This process's first position's device: where rows bound for other
    processes are staged. NCCL takes one card per rank, so a process with
    several cards sends and receives through this one (its group's
    communicator is bound to it) and copies to the others inside the
    process; gloo takes CPU tensors, which need no staging."""
    return mesh.devices[mesh.span[0]]


def _wire(t: torch.Tensor) -> torch.Tensor:
    """A tensor as the collectives carry it: bool as uint8 (neither NCCL
    nor gloo reduces or moves bool on every version)."""
    return t.view(torch.uint8) if t.dtype == torch.bool else t


def _unwire(t: torch.Tensor, dtype) -> torch.Tensor:
    return t.view(torch.bool) if dtype == torch.bool else t


def _all_gather(mesh: Mesh, local: torch.Tensor) -> torch.Tensor:
    """Every process's `local` (equal shapes), concatenated along dim 0 in
    process order, which is position order on a host-major mesh."""
    import torch.distributed as dist

    world = dist.get_world_size(mesh.group)
    t = _wire(local.contiguous())
    parts = [torch.empty_like(t) for _ in range(world)]
    dist.all_gather(parts, t, group=mesh.group)
    return _unwire(torch.cat(parts), local.dtype)


def gather(sharded: Sharded, device) -> torch.Tensor:
    """Leave the mesh: the global array (every shard in position order) as
    one tensor on `device`. On a mesh that spans processes every process
    gets the whole array: its shards are staged on its lead device and
    all-gathered through the group."""
    mesh = sharded.mesh
    device = torch.device(device)
    if mesh.spans_processes():
        lead = _lead(mesh)
        local = torch.cat([s.to(lead, non_blocking=True)
                           for s in sharded.shards])
        return _all_gather(mesh, local).to(device, non_blocking=True)
    parts = [s.to(device, non_blocking=True) for s in sharded.shards]
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def gather_ragged(mesh: Mesh, parts: list, counts, device) -> torch.Tensor:
    """The first counts[s] rows of each position's part, concatenated in
    position order on `device` (every process gets them all). `counts` is
    the global per-position count, the same array on every process; a
    part holds at least its count of rows."""
    counts = np.asarray(counts, dtype=np.int64)
    device = torch.device(device)
    if not mesh.spans_processes():
        pieces = [p[:int(counts[s])].to(device, non_blocking=True)
                  for s, p in zip(mesh.local_positions, parts)]
        return pieces[0] if len(pieces) == 1 else torch.cat(pieces)
    width = max(int(counts.max()), 1)
    lead = _lead(mesh)
    padded = []
    for s, p in zip(mesh.local_positions, parts):
        p = p[:int(counts[s])].to(lead, non_blocking=True)
        if p.shape[0] < width:
            p = torch.cat([p, p.new_zeros((width - p.shape[0],)
                                          + tuple(p.shape[1:]))])
        padded.append(p)
    whole = _all_gather(mesh, torch.cat(padded))
    keep = (np.arange(width)[None, :] < counts[:, None]).reshape(-1)
    idx = torch.from_numpy(np.flatnonzero(keep)).to(whole.device)
    return whole[idx].to(device, non_blocking=True)


def to_host(mesh: Mesh, parts: list) -> np.ndarray:
    """Small per-position tensors (equal shapes) as one host array of
    every position's, stacked in position order: the same array on every
    process, so that every process takes the same branch on it."""
    lead = _lead(mesh)
    stacked = torch.stack([p.to(lead, non_blocking=True) for p in parts])
    if mesh.spans_processes():
        stacked = _all_gather(mesh, stacked)
    return stacked.cpu().numpy()


def all_to_all(mesh: Mesh, bufs: list) -> list:
    """Shard s's (n, cap) buffer sends its row d to shard d; shard d gets
    the rows from every source in source order, flattened to n * cap (the
    counterpart of lax.all_to_all(x, axis, 0, 0) then reshape(-1)). Across
    processes: each process stacks its positions' buffers on its lead
    device, one all_to_all_single over the group with equal splits (every
    buffer holds the same cap) moves the block of each destination
    process, and the rows are copied out to the local positions."""
    n = mesh.size
    if not mesh.spans_processes():
        out = []
        for d in range(n):
            dev = mesh.devices[d]
            rows = [bufs[s][d].to(dev, non_blocking=True) for s in range(n)]
            out.append(torch.stack(rows).reshape(-1))
        return out
    import torch.distributed as dist

    world = dist.get_world_size(mesh.group)
    per = len(bufs)  # positions a process (exchange_plan: equal counts)
    lead = _lead(mesh)
    dtype = bufs[0].dtype
    # (source, destination process, destination position, cap) ->
    # destination process major: the all_to_all_single's split blocks
    send = torch.stack([_wire(b).to(lead, non_blocking=True) for b in bufs])
    cap = int(send.shape[2])
    send = send.reshape(per, world, per, cap).permute(1, 0, 2, 3).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=mesh.group)
    # recv[p, s, d]: from process p's source position s, for local d
    recv = _unwire(recv, dtype)
    out = []
    for i, d in enumerate(mesh.local_positions):
        rows = recv[:, :, i, :].reshape(-1)
        out.append(rows.to(mesh.devices[d], non_blocking=True))
    return out


def psum(mesh: Mesh, parts: list) -> list:
    """The sum of the per-position parts, replicated: one copy on each
    local position's device. Across processes through the mesh's group
    (all_reduce)."""
    local = preduce(mesh, parts, "sum")
    return [local.to(mesh.devices[s], non_blocking=True)
            for s in mesh.local_positions]


_REDUCE = {"sum": (torch.add, "SUM"), "min": (torch.minimum, "MIN"),
           "max": (torch.maximum, "MAX")}


def preduce(mesh: Mesh, parts: list, op: str = "sum") -> torch.Tensor:
    """The elementwise sum, min or max of the per-position parts (equal
    shapes), on this process's lead device: the same values on every
    process (all_reduce through the group when the mesh spans
    processes)."""
    fn, name = _REDUCE[op]
    lead = _lead(mesh)
    local = parts[0].to(lead, copy=True)
    for p in parts[1:]:
        local = fn(local, p.to(lead, non_blocking=True))
    if mesh.spans_processes():
        import torch.distributed as dist

        dtype = local.dtype
        w = local.to(torch.int32) if dtype == torch.bool else local
        dist.all_reduce(w, op=getattr(dist.ReduceOp, name), group=mesh.group)
        local = w.to(dtype) if dtype == torch.bool else w
    return local


def partial_agg_then_psum(mesh: Mesh, num_groups: int, axis: str = "dp"):
    """A sharded grouped sum: each shard segment-sums its local rows into a
    dense group vector, then psum combines across the mesh (the
    ThreadLocal + merge strategy). The function takes Sharded gids,
    weights and mask and returns the replicated sums on this process's
    first position's device."""
    from ..ops import backend as be

    def fn(gids, weights, mask):
        parts = []
        for g, w, m in zip(gids.shards, weights.shards, mask.shards):
            parts.append(be.segment_sum(torch.where(m, w, torch.zeros_like(w)),
                                        g, num_segments=num_groups))
        return psum(mesh, parts)[0]

    return fn


def repartition_by_key(mesh: Mesh, axis: str = "dp"):
    """Keyed shuffle: route each row to shard = key % n through the
    all-to-all. Rows are bucketed locally into m // n slots a destination
    (validity marks the used ones; the static-shape equivalent of the
    reference's 64-partition PreAggregationHashtable fragments) and
    exchanged in one collective. A bucket's rows past its slots are
    dropped (the reference's scatter leaves its last slot to whichever
    write lands last; here only the rows that fit are written)."""
    n = mesh.shape[axis]

    def fn(keys, *cols):
        bufs_k, bufs_v, bufs_c = [], [], [[] for _ in cols]
        for i, k_s in enumerate(keys.shards):
            m = k_s.shape[0]
            dest = torch.remainder(k_s, n).to(torch.int32)
            order = torch.sort(dest, stable=True).indices
            dest_sorted = dest[order].to(torch.int64)
            starts = torch.searchsorted(
                dest_sorted, torch.arange(n, device=k_s.device))
            slot = torch.arange(m, device=k_s.device) - starts[dest_sorted]
            percap = m // n
            ok = slot < percap
            at = (dest_sorted[ok], slot[ok])

            def bucket(c, fill=None):
                buf = c.new_zeros((n, percap))
                buf[at] = c[order][ok] if fill is None else fill
                return buf

            bufs_k.append(bucket(k_s))
            bufs_v.append(bucket(k_s.new_zeros(m, dtype=torch.bool), True))
            for j, c in enumerate(cols):
                bufs_c[j].append(bucket(c.shards[i]))
        out_k = all_to_all(mesh, bufs_k)
        out_v = all_to_all(mesh, bufs_v)
        outs = [all_to_all(mesh, b) for b in bufs_c]
        local = int(out_k[0].shape[0])
        return tuple(Sharded(mesh, x, local) for x in [out_k, out_v, *outs])

    return fn
