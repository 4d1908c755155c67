"""Multi-process execution scaffold: torch.distributed wiring and a host-
major device order.

The counterpart of lingodb_tpu/parallel/multihost.py. The engine runs one
process per host; a mesh that spans processes orders its devices
host-major (each process's devices occupy a contiguous rank block), so a
keyed repartition decomposes into dense blocks inside a host plus one
stripe between hosts. Within one process the mesh's collectives are plain
copies driven from the one Python thread (parallel/mesh.py); a mesh that
spans processes runs them through its process group (all_to_all_single,
all_gather, all_reduce). Initialization is env-driven and idempotent:
LINGODB_COORDINATOR (host:port, or a tcp:// address), LINGODB_NUM_PROCESSES
and LINGODB_PROCESS_ID; with one process everything degrades to the plain
device order and no process group exists.

The order, grouping and plan functions work on any descriptor with
`process_index` and `id` (MeshDevice below, or a test's stand-in).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class MeshDevice:
    """One mesh position's device: the process that holds it, its id in
    that process's list, and the torch device it names there."""

    process_index: int
    id: int
    device: torch.device


def initialize(coordinator: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               device_type: str | None = None,
               timeout_s: float | None = None) -> bool:
    """Join (or start) a multi-process group. Parameters default from
    LINGODB_COORDINATOR / LINGODB_NUM_PROCESSES / LINGODB_PROCESS_ID. The
    backend is nccl for CUDA devices and gloo otherwise (`device_type`,
    default: cuda when a card is present). `timeout_s` bounds every
    collective's wait (None: torch's default), so that processes whose
    host decisions diverged fail instead of waiting. Returns True when
    distributed mode is active. Idempotent; a no-op in single-process runs
    (num_processes absent or <= 1)."""
    import torch.distributed as dist

    coordinator = coordinator or os.environ.get("LINGODB_COORDINATOR")
    if num_processes is None:
        num_processes = int(os.environ.get("LINGODB_NUM_PROCESSES", "0") or 0)
    if process_id is None:
        process_id = int(os.environ.get("LINGODB_PROCESS_ID", "0") or 0)
    if not coordinator or num_processes <= 1:
        return False
    if dist.is_initialized():
        return True
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    if "://" not in coordinator:
        coordinator = f"tcp://{coordinator}"
    kw = {}
    if timeout_s is not None:
        import datetime

        kw["timeout"] = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group(
        backend="nccl" if device_type == "cuda" else "gloo",
        init_method=coordinator, world_size=num_processes, rank=process_id,
        **kw)
    return True


def process_index() -> int:
    """This process's rank in the group (0 without one)."""
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def local_descriptors(devices) -> list[MeshDevice]:
    """This process's devices as mesh descriptors, in the given order."""
    pid = process_index()
    return [MeshDevice(pid, i, torch.device(d)) for i, d in enumerate(devices)]


def global_descriptors(devices) -> list[MeshDevice]:
    """Every process's devices as mesh descriptors: this process's own
    (`devices`), and with a process group the others' too (one
    all_gather_object of their names). A descriptor names a device of the
    process that holds it."""
    import torch.distributed as dist

    mine = local_descriptors(devices)
    if not dist.is_initialized():
        return mine
    parts = [None] * dist.get_world_size()
    dist.all_gather_object(parts, [(d.process_index, d.id, str(d.device))
                                   for d in mine])
    return [MeshDevice(p, i, torch.device(name))
            for part in parts for p, i, name in part]


def host_major_order(devices) -> list:
    """Global device list ordered (process_index, device id): every host's
    devices contiguous. This ordering IS the dp rank order: shard r of a
    row-sharded table lives on host r // devices_per_host."""
    return sorted(devices, key=lambda d: (d.process_index,
                                          getattr(d, "id", 0)))


def host_groups(devices) -> list[list[int]]:
    """Ranks (positions in host_major_order) grouped per host. With the
    host-major invariant each group is a contiguous range: the property
    the hierarchical exchange plan relies on."""
    ordered = host_major_order(devices)
    groups: dict[int, list[int]] = {}
    for rank, d in enumerate(ordered):
        groups.setdefault(d.process_index, []).append(rank)
    return [groups[k] for k in sorted(groups)]


@dataclass(frozen=True)
class ExchangePlan:
    """Two-phase keyed-repartition plan for a host-major mesh.

    Phase 1 (inside a host): an all-to-all among local ranks, every local
    rank gathering the rows destined for ANY rank of each remote host into
    one per-host send buffer (local combining, like the reference's
    per-worker partition buffers). Phase 2 (between hosts): one all-to-all
    moves each per-host buffer in a single stripe; rows then scatter to
    their final local rank. Every row crosses between hosts at most once.
    """

    n_hosts: int
    per_host: int

    def dest_host(self, dest_rank: int) -> int:
        return dest_rank // self.per_host

    def dcn_lanes(self) -> list[tuple[int, int]]:
        """(src_host, dst_host) pairs that cross between hosts."""
        return [(a, b) for a in range(self.n_hosts)
                for b in range(self.n_hosts) if a != b]

    def ici_lanes(self) -> int:
        """All-to-all lanes that stay inside a host (per host, both
        phases)."""
        return self.n_hosts * self.per_host * (self.per_host - 1)


def exchange_plan(devices) -> ExchangePlan:
    groups = host_groups(devices)
    sizes = {len(g) for g in groups}
    if len(sizes) != 1:
        raise ValueError(f"hosts expose unequal device counts: {groups}")
    # contiguity check: the invariant every shuffle slice depends on
    for g in groups:
        if g != list(range(g[0], g[0] + len(g))):
            raise ValueError(f"host ranks not contiguous: {g}")
    return ExchangePlan(n_hosts=len(groups), per_host=len(groups[0]))


def process_span(devices) -> tuple[int, int]:
    """This process's contiguous [start, end) rank range in the global
    host-major order (the shards whose tensors live here)."""
    ordered = host_major_order(devices)
    me = process_index()
    mine = [r for r, d in enumerate(ordered) if d.process_index == me]
    return (mine[0], mine[-1] + 1) if mine else (0, 0)
