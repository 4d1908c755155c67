"""The store of captured fused programs: each fused program (the aggregate,
the chain, and the TopK epilogue folded into either) is captured once per
plan and learned capacities as a CUDA graph, then replayed.

The counterpart of lingodb_tpu/runtime/exestore.py and of the reference
executor's cache of compiled executables (`jax.jit(fn).lower(*arrays)
.compile()`, kept with the `meta` its finish reads). What differs:

  - In process only. A CUDA graph holds the device addresses it was
    captured with and cannot be serialized: nothing goes to disk, and a
    fresh process captures again. What does persist is the learned
    capacities (utils/capstore.py), so a fresh process does not calibrate
    again before it captures.
  - The calibration run is never captured (the reference stores no
    calibration executable either): the executor decides on the host that
    a run calibrates and runs it as it is called, without the store.

Keys. An entry is keyed by the stage key (`basekey`: the plan and its
table versions; `variant`: the TopK epilogue folded in, or None) and the
material that shapes the program: every learned capacity, and the shape,
dtype and DATA POINTER of every tensor the program reads that it does not
make (the scanned columns, the dimension builds): the graph reads them at
the addresses it was captured with. A materialized base (an eager result
the program takes as its input) is copied into the graph's static inputs
before each replay instead; only its shapes are in the key.

Dropping. A rebuild (an overflow of a learned capacity) drops every entry
of its basekey (`drop`). A table version change makes a basekey stale: an
entry put for a plan drops the entries of the same plan at other versions.
Session._evict_device_memory drops everything (`clear`).

Memory. The graphs of one store share ONE private memory pool: the working
memory of a fused program is large (its lanes at the scan's length) and
only one program runs at a time. The rule that makes sharing safe: a
graph's outputs hold until the next replay of ANY graph of the store. The
executor reads them right after the replay (its one packed fetch), and
copies the outputs that leave it as device tensors before anything else
replays (`meta["from_graph"]` tells the finish). Everything a graph reads
across replays lives outside the pool: its static inputs, its
compact_positions scratch (ops/pgather.py, made before the capture), and
the host arrays uploaded under capture (ops/backend.py, to_device).
`pool_memory` reads the pool's size off the allocator's own segments.

Launches. A kernel wrapper called under capture launches nothing; the
capture counts its calls (pgather.capture_scratch's tally), and every
replay adds them to pgather.LAUNCHES, where the graph launches them.

Threads. A capture runs on a side stream with capture_error_mode="relaxed":
Session.sql_many prepares the next statement on a second thread, whose
uploads (on the default stream) must not break a capture, and an upload
under the capture itself is a synchronous copy on the default stream.
Nothing inside a fused program synchronizes the captured stream; a program
that does fails its capture, which raises (no retry uncaptured).

On a CPU session the store runs the same bookkeeping around a stand-in:
its "capture" calls the program, its "replay" calls it again. The capture
and the replay are callables of the store, so a test can give others.

CAPTURE is the switch for timing captured against uncaptured on the card
(chip_smoke.py sets it); it is not a user setting. With it False every
fused program runs as it is called.
"""

from __future__ import annotations

import time

import torch

from ..ops import backend as be
from ..ops import pgather
from ..utils import compilestats
from .vtable import SCol

CAPTURE = True


class Entry:
    """A captured program: `graph` (a torch.cuda.CUDAGraph, or the stand-in's
    program), its static inputs, outputs and meta, what it keeps alive for
    its replays (uploads made under capture, its K3 scratch), and the kernel
    launches of one replay by name."""

    __slots__ = ("graph", "inputs", "outputs", "meta", "keep", "scratch",
                 "launches", "fresh")

    def __init__(self, graph, inputs, outputs, meta, *, keep=(), scratch=None,
                 launches=None, fresh=False):
        self.graph, self.inputs, self.outputs, self.meta = (
            graph, inputs, outputs, meta)
        self.keep, self.scratch = keep, scratch
        self.launches = launches or {}
        self.fresh = fresh  # the stand-in's capture ran it: no replay needed


def signature(obj) -> tuple:
    """(shape, dtype, data pointer) of every tensor in `obj` (nested dicts,
    lists, tuples and SCols), in a fixed order: the addresses a graph
    reads."""
    out = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            out.append((tuple(x.shape), str(x.dtype), x.data_ptr()))
        elif isinstance(x, dict):
            for k in sorted(x, key=repr):
                walk(x[k])
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        elif isinstance(x, SCol):
            walk(x.data)
            walk(x.valid)

    walk(obj)
    return tuple(out)


def _meta_holds_no_tensor(meta) -> None:
    """`meta` is kept for every replay: a tensor in it would be overwritten
    by other graphs' replays (the pool is shared)."""
    if signature(meta):
        raise RuntimeError("a fused program's meta holds a tensor; keep "
                           "tensors in its outputs")


def cuda_capture(store, program, inputs) -> Entry:
    """Capture program(static inputs) in a CUDA graph on the store's side
    stream and pool. Nothing runs on the card until the first replay."""
    dev = store.device
    static = [t.clone() for t in inputs]
    scratch = pgather.new_compact_scratch(dev)
    keep: list = []
    tally: dict = {}
    if store.pool is None or not store.entries:
        # a pool lives while a graph captured into it does: once the last is
        # gone the next capture takes a new one
        store.pool = torch.cuda.graph_pool_handle()
    if store.stream is None:
        store.stream = torch.cuda.Stream(dev)
    graph = torch.cuda.CUDAGraph()
    cur = torch.cuda.current_stream(dev)
    store.stream.wait_stream(cur)
    with torch.cuda.device(dev), torch.cuda.stream(store.stream), \
            pgather.capture_scratch(scratch, tally), be.capture_uploads(keep):
        graph.capture_begin(pool=store.pool, capture_error_mode="relaxed")
        try:
            res, meta = program(static)
        except BaseException:
            try:
                graph.capture_end()
            except Exception:  # the program's own error is the one to raise
                pass
            raise
        graph.capture_end()
    cur.wait_stream(store.stream)
    return Entry(graph, static, res, meta, keep=keep, scratch=scratch,
                 launches=tally)


def cuda_replay(entry) -> None:
    entry.graph.replay()


def eager_capture(store, program, inputs) -> Entry:
    """The CPU session's stand-in: the program runs now, its outputs are
    current."""
    static = [t.clone() for t in inputs]
    res, meta = program(static)
    return Entry(program, static, res, meta, fresh=True)


def eager_replay(entry) -> None:
    entry.outputs, entry.meta = entry.graph(entry.inputs)


class GraphStore:
    """One session's captured programs (see the module docstring)."""

    def __init__(self, device, capture=None, replay=None):
        self.device = torch.device(device)
        cuda = self.device.type == "cuda"
        self._capture = capture or (cuda_capture if cuda else eager_capture)
        self._replay = replay or (cuda_replay if cuda else eager_replay)
        self.entries: dict = {}
        self.pool = None
        self.stream = None

    def run(self, basekey, variant, material, program, inputs):
        """(outputs, meta) of `program` at `material`, from its graph:
        captured now if the key is new, then replayed. `program(static
        inputs)` returns (outputs, meta); `inputs` are copied into the
        graph's static inputs before each replay. The returned dicts are
        copies; meta["from_graph"] is True: the outputs hold only until the
        next replay."""
        key = (basekey, variant, material)
        e = self.entries.get(key)
        if e is None:
            e = self._put(key, program, inputs)
        else:
            for dst, src in zip(e.inputs, inputs):
                dst.copy_(src)
        if e.fresh:
            e.fresh = False
        else:
            self._replay(e)
            pgather.count_replay(e.launches)
            compilestats.add("replays")
        meta = dict(e.meta)
        meta["from_graph"] = True
        return dict(e.outputs), meta

    def _put(self, key, program, inputs) -> Entry:
        """Capture `program` and keep it under `key`."""
        t0 = time.perf_counter()
        e = self._capture(self, program, inputs)
        compilestats.add("captures")
        compilestats.add("capture_secs", time.perf_counter() - t0)
        _meta_holds_no_tensor(e.meta)
        basekey = key[0]
        for k in [k for k in self.entries
                  if k[0][:2] == basekey[:2] and k[0] != basekey]:
            del self.entries[k]  # the plan at other table versions
        self.entries[key] = e
        return e

    def drop(self, basekey) -> None:
        """Drop every entry of `basekey` (a rebuild replaces it)."""
        for k in [k for k in self.entries if k[0] == basekey]:
            del self.entries[k]

    def clear(self) -> None:
        """Drop every entry; the pool goes with the last graph."""
        self.entries.clear()
        self.pool = None

    def pool_memory(self) -> tuple[int, int]:
        """(reserved, allocated) bytes of the store's memory pool, summed
        over the allocator's segments of that pool. Its free part serves
        only the graphs' replays. What the graphs keep outside the pool
        (static inputs, K3 scratch, uploads) is ordinary allocated memory."""
        if self.pool is None or self.device.type != "cuda":
            return 0, 0
        reserved = allocated = 0
        dev = self.device.index
        dev = torch.cuda.current_device() if dev is None else dev
        for seg in torch.cuda.memory_snapshot():
            if (seg.get("device") == dev and tuple(
                    seg.get("segment_pool_id", ())) == tuple(self.pool)):
                reserved += seg["total_size"]
                allocated += seg["allocated_size"]
        return reserved, allocated
