"""Hardware performance counters via perf_event_open.

Equivalent of the reference's PerfEvent support
(reference: include/lingodb/utility/PerfEvent.h — wraps perf_event_open to
count cycles/instructions/branch- and cache-misses around generated-code
regions). Here the counters wrap *host* phases (parse/bind/optimize, host
kernels, result fetch); device-side profiling goes through torch.profiler
instead (tools/gpu_profile.py). Pure ctypes, no dependencies; degrades to
a no-op where the kernel forbids perf events (containers often do).
"""

from __future__ import annotations

import ctypes
import os
import platform
import struct

# the syscall's number by architecture; elsewhere the counters are off
_SYS_perf_event_open = {"x86_64": 298, "aarch64": 241}.get(platform.machine())
PERF_TYPE_HARDWARE = 0
PERF_TYPE_SOFTWARE = 1
# (type, config); software twins cover VMs without a PMU
_COUNTERS = {
    "cycles": (PERF_TYPE_HARDWARE, 0),          # PERF_COUNT_HW_CPU_CYCLES
    "instructions": (PERF_TYPE_HARDWARE, 1),    # PERF_COUNT_HW_INSTRUCTIONS
    "cache-misses": (PERF_TYPE_HARDWARE, 3),    # PERF_COUNT_HW_CACHE_MISSES
    "branch-misses": (PERF_TYPE_HARDWARE, 5),   # PERF_COUNT_HW_BRANCH_MISSES
    "task-clock": (PERF_TYPE_SOFTWARE, 1),      # PERF_COUNT_SW_TASK_CLOCK (ns)
    "page-faults": (PERF_TYPE_SOFTWARE, 2),     # PERF_COUNT_SW_PAGE_FAULTS
    "context-switches": (PERF_TYPE_SOFTWARE, 3),
}
_ATTR_SIZE = 128


def _attr_bytes(etype: int, config: int) -> bytes:
    # struct perf_event_attr: type u32, size u32, config u64, sample u64,
    # sample_type u64, read_format u64, flags u64 (disabled=1, exclude_kernel
    # bit 5, exclude_hv bit 6), rest zero
    flags = 1 | (1 << 5) | (1 << 6)
    buf = struct.pack("<IIQQQQQ", etype, _ATTR_SIZE, config,
                      0, 0, 0, flags)
    return buf + b"\0" * (_ATTR_SIZE - len(buf))


_ENABLE = 0x2400  # PERF_EVENT_IOC_ENABLE
_DISABLE = 0x2401
_RESET = 0x2403


class PerfEvent:
    """Context manager counting HW events on the calling thread.

    >>> with PerfEvent() as pe: work()
    >>> pe.counters  # {"cycles": ..., "instructions": ...} ({} if unsupported)
    """

    def __init__(self, events=("cycles", "instructions", "task-clock",
                               "page-faults")):
        self.events = list(events)
        self.fds: dict[str, int] = {}
        self.counters: dict[str, int] = {}
        self._libc = None

    def _open(self, name: str) -> int | None:
        etype, config = _COUNTERS[name]
        attr = ctypes.create_string_buffer(_attr_bytes(etype, config))
        fd = self._libc.syscall(
            _SYS_perf_event_open, attr, 0, -1, -1, 0)
        return fd if fd >= 0 else None

    def __enter__(self):
        if _SYS_perf_event_open is None:
            return self
        try:
            self._libc = ctypes.CDLL(None, use_errno=True)
            import fcntl

            for name in self.events:
                if name not in _COUNTERS:
                    continue
                fd = self._open(name)
                if fd is None:
                    continue
                fcntl.ioctl(fd, _RESET, 0)
                fcntl.ioctl(fd, _ENABLE, 0)
                self.fds[name] = fd
        except OSError:
            self.fds = {}
        return self

    def __exit__(self, *exc):
        import fcntl

        for name, fd in self.fds.items():
            try:
                fcntl.ioctl(fd, _DISABLE, 0)
                self.counters[name] = struct.unpack("<Q", os.read(fd, 8))[0]
            except OSError:
                pass
            finally:
                os.close(fd)
        self.fds = {}
        return False

    @property
    def supported(self) -> bool:
        return bool(self.counters)
