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
processes carries a process group (parallel/multihost.py); its `psum`
reduces through it, and its all-to-all is not ported (ROADMAP A9-rest).
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
    """A mesh over `devices` (default: every CUDA device, else the CPU),
    the first `n_devices` of them when given."""
    if devices is None:
        devices = ([torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())]
                   or [torch.device("cpu")])
    devices = list(devices)
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(devices, axis)


def shard_rows(mesh: Mesh, arr, axis: str = "dp") -> Sharded:
    """Shard a row-partitioned column across the mesh, padding with zeros
    to a multiple of the axis size (callers carry the true row count).
    A shard on the array's own device is a view of it; only a shard that
    holds padding is a copy, and no shard is the whole array."""
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


def gather(sharded: Sharded, device) -> torch.Tensor:
    """Leave the mesh: the global array (every shard in position order) as
    one tensor on `device`. Within one process only."""
    if sharded.mesh.spans_processes():
        raise NotImplementedError(
            "gather of a mesh that spans processes (ROADMAP A9-rest)")
    device = torch.device(device)
    parts = [s.to(device, non_blocking=True) for s in sharded.shards]
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def all_to_all(mesh: Mesh, bufs: list) -> list:
    """Shard s's (n, cap) buffer sends its row d to shard d; shard d gets
    the rows from every source in source order, flattened to n * cap (the
    counterpart of lax.all_to_all(x, axis, 0, 0) then reshape(-1))."""
    if mesh.spans_processes():
        raise NotImplementedError(
            "an all-to-all over a mesh that spans processes (ROADMAP A9-rest)")
    n = mesh.size
    out = []
    for d in range(n):
        dev = mesh.devices[d]
        rows = [bufs[s][d].to(dev, non_blocking=True) for s in range(n)]
        out.append(torch.stack(rows).reshape(-1))
    return out


def psum(mesh: Mesh, parts: list) -> list:
    """The sum of the per-position parts, replicated: one copy on each
    local position's device. Across processes through the mesh's group
    (all_reduce)."""
    local = parts[0].to(mesh.devices[mesh.span[0]], copy=True)
    for p in parts[1:]:
        local = local + p.to(local.device, non_blocking=True)
    if mesh.group is not None:
        import torch.distributed as dist

        dist.all_reduce(local, group=mesh.group)
    return [local.to(mesh.devices[s], non_blocking=True)
            for s in mesh.local_positions]


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
