"""Chunks of host columns streamed through the device for the out-of-core
aggregate (runtime/executor.py::_try_chunked_agg).

Each streamed column part (data, validity) has two pinned host staging
buffers and two device buffers of `m` elements, one pair per slot; chunk i
uses slot i % 2. The host copies chunk i+1 of the table into its pinned
buffer and enqueues its host -> device copy on a side copy stream while the
card computes chunk i on the compute stream:

- the compute stream waits on the event recorded after its chunk's copy;
- a pinned buffer is refilled only after the event of the copy that last
  read it has fired (the host waits on it);
- a device buffer is overwritten only after the event recorded behind the
  compute that last read it (the copy stream waits on it).

The last chunk is padded with zeros to `m` rows (the per-chunk function is
one function of static shapes, masked by the valid count). Each slot's
device buffers stay at their addresses for the stream's life, so the
chunk program is captured once per slot as a CUDA graph over them and
replayed for every chunk the slot holds (Executor._try_chunked_agg keeps
one stream a session and reuses it for any plan of the same layout, so a
later run replays too). On a CPU device the
slots are plain host tensors, filled by copies.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..ops.backend import tdtype


class ChunkStream:
    def __init__(self, parts: list[np.ndarray], rows: int, m: int, device):
        self.parts = parts
        self.rows = rows
        self.m = m
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.bytes_copied = 0
        # host seconds spent filling the staging buffers (and waiting for
        # their last copy to finish first)
        self.fill_s = 0.0
        # device bytes allocated after each chunk's compute was enqueued
        # (no sync): flat across chunks when nothing accumulates
        self.allocated_after_chunk: list[int] = []
        self._valid: list = [0, 0]
        self.layout = self.layout_of(parts, m)
        # the plans whose graphs were captured over this stream's slots
        self.plans: set = set()
        self.dev = [[torch.empty(m, dtype=tdtype(p.dtype), device=self.device)
                     for p in parts] for _slot in range(2)]
        if not self.cuda:
            return
        self.copy_stream = torch.cuda.Stream(self.device)
        self.pinned = [[torch.empty(m, dtype=tdtype(p.dtype), pin_memory=True)
                        for p in parts] for _slot in range(2)]
        # the device buffers are written on the copy stream: the allocator
        # must not hand their blocks out again before that stream is done
        for slot in self.dev:
            for t in slot:
                t.record_stream(self.copy_stream)
        self.copied: list = [None, None]
        self.consumed: list = [None, None]

    @staticmethod
    def layout_of(parts: list[np.ndarray], m: int) -> tuple:
        """What a stream's slots are made for: the chunk's rows and the
        parts' dtypes."""
        return m, tuple(np.dtype(p.dtype).str for p in parts)

    def restart(self, parts: list[np.ndarray], rows: int) -> None:
        """Stream parts of the same layout (a later run, or another plan):
        the same slots and buffers, the counters from zero."""
        self.parts = parts
        self.rows = rows
        self.bytes_copied = 0
        self.fill_s = 0.0
        self.allocated_after_chunk = []

    def bounds(self, ci: int) -> tuple[int, int]:
        lo = ci * self.m
        return lo, min(self.rows, lo + self.m)

    def stage(self, ci: int) -> None:
        """Fill chunk ci's staging buffers and start its copy (asynchronous
        on the card)."""
        lo, hi = self.bounds(ci)
        k = hi - lo
        s = ci % 2
        self._valid[s] = k
        if not self.cuda:
            for p, buf in zip(self.parts, self.dev[s]):
                buf[:k].copy_(torch.from_numpy(np.array(p[lo:hi])))
                buf[k:].zero_()
            return
        t0 = time.perf_counter()
        if self.copied[s] is not None:
            # the copy that last read these pinned buffers must be done
            self.copied[s].synchronize()
        for p, buf in zip(self.parts, self.pinned[s]):
            src = np.asarray(p[lo:hi])
            if src.flags.writeable:
                # torch's host copy runs on several threads
                buf[:k].copy_(torch.from_numpy(src))
            else:
                np.copyto(buf[:k].numpy(), src)
            if k < self.m:
                buf[k:].zero_()
        self.fill_s += time.perf_counter() - t0
        with torch.cuda.stream(self.copy_stream):
            if self.consumed[s] is not None:
                # the compute that last read these device buffers is queued
                # before this copy may overwrite them
                self.copy_stream.wait_event(self.consumed[s])
            for buf, dst in zip(self.pinned[s], self.dev[s]):
                dst.copy_(buf, non_blocking=True)
                self.bytes_copied += buf.numel() * buf.element_size()
            ev = torch.cuda.Event()
            ev.record(self.copy_stream)
        self.copied[s] = ev

    def take(self, ci: int):
        """(valid rows, the slot's tensors) of chunk ci, ready for the
        compute stream."""
        s = ci % 2
        if self.cuda:
            torch.cuda.current_stream(self.device).wait_event(self.copied[s])
        return self._valid[s], self.dev[s]

    def release(self, ci: int) -> None:
        """Mark chunk ci's device buffers as read by the work enqueued so
        far on the compute stream."""
        if not self.cuda:
            return
        s = ci % 2
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        self.consumed[s] = ev
        self.allocated_after_chunk.append(
            torch.cuda.memory_allocated(self.device))

    def finish(self) -> None:
        if self.cuda:
            self.copy_stream.synchronize()
