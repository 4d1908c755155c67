"""Device placement policy + packed transfers.

Every device->host sync stalls the stream of kernels behind it, so the
executor runs large columnar work on the accelerator and *small*
intermediate results as numpy arrays on the host — the analogue of the
reference keeping small state in caches near the core while the JIT'd
pipeline streams the base data (and of classic engines not shipping 4-row
tables to an accelerator).

All bulk device->host movement goes through ONE packed transfer: every column
is widened to int64 (or float64) lanes of one matrix, fetched as one buffer,
and re-split on the host.

There is no module-level device: a VTable's tensors say where they live, and
the session's device is passed to the one place that uploads (promote).
"""

from __future__ import annotations

import numpy as np
import torch

from .vtable import SCol, VTable, is_obj

SMALL_ROWS = 8192

_MESH = None
_MESH_INIT = False


def get_mesh():
    """The data-parallel mesh of the sharded operators (parallel/mesh.py):
    every CUDA device, host-major, when there are at least two; None on
    one card, on the CPU, or when system.parallelism is OFF (the
    reference's scheduler worker count from LINGODB_PARALLELISM). With
    LINGODB_COORDINATOR and LINGODB_NUM_PROCESSES set it first joins the
    process group (parallel/multihost.py) and the mesh spans every
    process's cards. Decided once a process; tests and chip_smoke.py set
    `_MESH` (and `_MESH_INIT`) themselves, as the reference's tests do, to
    run the sharded operators over a mesh whose positions repeat one
    device."""
    global _MESH, _MESH_INIT
    if _MESH_INIT:
        return _MESH
    _MESH_INIT = True
    from ..utils.settings import get_setting

    if str(get_setting("system.parallelism")).upper() == "OFF":
        return None
    if not torch.cuda.is_available():
        return None
    from ..parallel import multihost as mh
    from ..parallel.mesh import Mesh

    spans = mh.initialize(device_type="cuda")
    local = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    descs = mh.global_descriptors(local)
    if len(descs) < 2:
        return None
    group = None
    if spans:
        import torch.distributed as dist

        group = dist.group.WORLD
    _MESH = Mesh(descs, "dp", group=group)
    return _MESH


def shard_column(arr, mesh):
    """Row-shard a column over the mesh, padded with zeros to a multiple of
    the axis size (mesh.shard_rows pads the last shards only, no copy of
    the whole column). Returns (Sharded, original_rows): the caller keeps
    the true row count. On a mesh that spans processes only this
    process's positions are uploaded."""
    from ..parallel.mesh import shard_rows

    return shard_rows(mesh, arr), int(arr.shape[0])


def is_sharded(vt: VTable) -> bool:
    """Whether a VTable holds Sharded columns (a scan of a table held on
    the mesh, or a Select / Map over one)."""
    from ..parallel.mesh import Sharded

    return isinstance(vt.row_valid, Sharded) or any(
        isinstance(c.data, Sharded) for c in vt.cols.values())


def resolve_device(device=None) -> torch.device:
    """The device a session runs on. None means CUDA and raises when no GPU
    is present: the engine never quietly carries on on the CPU. Tests pass
    "cpu" explicitly."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available: pass device='cpu' to run on the "
                "host explicitly")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is unavailable")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def vtable_device(vt: VTable):
    """Device of the first tensor column (None for a host-numpy table)."""
    for c in vt.cols.values():
        if isinstance(c.data, torch.Tensor):
            return c.data.device
    return None


# ----------------------------------------------------------- packed transfer
def fetch_arrays_np(arrays: dict) -> dict:
    """Fetch a dict of tensors (any shapes) with ONE device->host copy.
    Returns numpy arrays with the original dtypes and shapes."""
    if not arrays:
        return {}
    # host-resident planes (incl. object-dtype wide decimals) pass through;
    # only tensors ride the packed transfer
    out = {k: np.asarray(a) for k, a in arrays.items()
           if not isinstance(a, torch.Tensor)}
    tens = {k: a for k, a in arrays.items() if isinstance(a, torch.Tensor)}
    if not tens:
        return out
    if not any(t.is_cuda for t in tens.values()):
        out.update({k: t.numpy() for k, t in tens.items()})
        return out
    keys = sorted(tens.keys(), key=repr)
    ikeys = [k for k in keys if not tens[k].dtype.is_floating_point]
    fkeys = [k for k in keys if tens[k].dtype.is_floating_point]
    # every lane is flattened into one int64 vector; float lanes travel as
    # the bit patterns of their float64 values
    parts = [tens[k].reshape(-1).to(torch.int64) for k in ikeys]
    parts += [tens[k].reshape(-1).to(torch.float64).view(torch.int64)
              for k in fkeys]
    host = torch.cat(parts).cpu().numpy()
    off = 0
    for k in ikeys + fkeys:
        t = tens[k]
        seg = host[off: off + t.numel()]
        off += t.numel()
        if t.dtype.is_floating_point:
            seg = seg.view(np.float64)
        out[k] = seg.astype(_np_dtype(t)).reshape(tuple(t.shape))
    return out


def _np_dtype(t: torch.Tensor):
    from ..ops.backend import dt

    return dt(t)


def fetch_vtable_np(vt: VTable) -> dict:
    """VTable -> {('d'|'v', cid): np.ndarray} with one sync."""
    arrays = {}
    for cid, c in vt.cols.items():
        arrays[("d", cid)] = c.data
        if c.valid is not None:
            arrays[("v", cid)] = c.valid
    return fetch_arrays_np(arrays)


def demote_small(vt: VTable) -> VTable:
    """Move a small device-resident VTable onto the host numpy tier so
    downstream operators run without device round trips."""
    if vt.num_rows >= SMALL_ROWS or vt.num_rows == 0:
        return vt
    if vt.row_valid is not None:
        return vt
    if vtable_device(vt) is None:
        return vt
    host = fetch_vtable_np(vt)
    cols = {}
    for cid, c in vt.cols.items():
        cols[cid] = SCol(c.type, host[("d", cid)], host.get(("v", cid)), c.dictionary)
    return VTable(cols, vt.num_rows)


def promote(vt: VTable, device) -> VTable:
    """Move a host-resident VTable to `device` (e.g. the small side of a
    join against a device-resident table)."""
    from ..ops.backend import to_device

    cols = {}
    for cid, c in vt.cols.items():
        if is_obj(c.data):
            # wide-decimal object columns are host-only by contract
            # (vtable.dec_is_wide): they never upload
            cols[cid] = c
            continue
        cols[cid] = SCol(
            c.type, to_device(c.data, device),
            None if c.valid is None else to_device(c.valid, device),
            c.dictionary,
        )
    return VTable(cols, vt.num_rows, row_valid=vt.row_valid)


def align_devices(a: VTable, b: VTable) -> tuple[VTable, VTable]:
    """Ensure two VTables are co-located before a binary operator: when one
    side holds tensors and the other numpy arrays, the numpy side moves to
    the tensors' device."""
    da, db = vtable_device(a), vtable_device(b)
    if (da is None) == (db is None):
        return a, b
    if da is not None:
        return a, promote(b, da)
    return promote(a, db), b
