"""Isolated Python-UDF execution.

Equivalent of the reference's UDF isolation layer: it runs Python
UDFs in per-worker CPython sub-interpreters (reference:
src/scheduler/Scheduler.cpp:941-954) and optionally inside a vendored
cpython-WASM runtime (src/runtime/WASM.cpp:25-60) so user code cannot crash
or block the engine. Here the same guarantee comes from a persistent worker
*process*: UDF batches ship to it as pickled numpy arrays, a crash (segfault,
os._exit, OOM-kill) surfaces as a UDFError and the worker restarts on the
next call, and the engine process never runs user bytecode.

Selected via the `system.udf_isolation` setting:
  none     (default) in-process vectorized numpy evaluation (fastest)
  process  persistent isolated worker process (this module)

The worker strips its environment, detaches into its own session, and
applies an address-space rlimit (`system.udf_memory_mb`); like the
reference's sub-interpreters (and unlike its WASM build) this is crash/hang
isolation, not a security boundary against hostile code.
"""

from __future__ import annotations

import os
import pickle
import struct
import subprocess
import sys
import threading

_WORKER_SOURCE = r"""
import os, pickle, struct, sys, resource

def _recv(f):
    hdr = f.read(8)
    if len(hdr) < 8:
        raise EOFError
    (n,) = struct.unpack("<Q", hdr)
    return pickle.loads(f.read(n))

def _send(f, obj):
    b = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    f.write(struct.pack("<Q", len(b)))
    f.write(b)
    f.flush()

def main():
    limit_mb = int(os.environ.get("LINGODB_UDF_MEMORY_MB", "0"))
    if limit_mb > 0:
        lim = limit_mb * 1024 * 1024
        try:
            resource.setrlimit(resource.RLIMIT_AS, (lim, lim))
        except (ValueError, OSError):
            pass
    try:
        os.setsid()
    except OSError:
        pass
    inp = os.fdopen(0, "rb")
    out = os.fdopen(1, "wb")
    sys.stdout = sys.stderr  # user prints must not corrupt the wire protocol
    fns = {}
    import numpy as np
    while True:
        try:
            msg = _recv(inp)
        except EOFError:
            return
        try:
            kind = msg[0]
            if kind == "def":
                _key, code, name = msg[1], msg[2], msg[3]
                ns = {"np": np}
                exec(code, ns)
                fn = ns.get(name)
                if fn is None:
                    cand = [v for v in ns.values()
                            if callable(v) and getattr(v, "__module__", None) is None]
                    if len(cand) == 1:
                        fn = cand[0]
                if fn is None:
                    raise ValueError(f"UDF body must define function {name!r}")
                fns[_key] = fn
                _send(out, ("ok", None))
            elif kind == "call":
                _key, arrays = msg[1], msg[2]
                fn = fns[_key]
                try:
                    res = fn(*arrays)
                    res = np.asarray(res)
                    if res.shape != arrays[0].shape:
                        raise TypeError
                except Exception:
                    n = len(arrays[0]) if arrays else 0
                    res = np.array([fn(*[a[i] for a in arrays]) for i in range(n)])
                _send(out, ("ok", res))
            else:
                _send(out, ("err", f"unknown message {kind!r}"))
        except BaseException as e:  # noqa: BLE001 - report, keep serving
            _send(out, ("err", f"{type(e).__name__}: {e}"))

main()
"""


class SandboxError(Exception):
    pass


class UDFWorker:
    """One persistent isolated worker process; restarted on any failure."""

    def __init__(self, memory_mb: int = 0):
        self.memory_mb = memory_mb
        self.proc: subprocess.Popen | None = None
        self.defined: set = set()
        self.lock = threading.Lock()

    def _ensure(self):
        if self.proc is not None and self.proc.poll() is None:
            return
        env = {"PATH": "/usr/bin:/bin",
               # minimal environment; module search path mirrors the parent
               # so numpy resolves, nothing else leaks
               "PYTHONPATH": os.pathsep.join(p for p in sys.path if p),
               "LINGODB_UDF_MEMORY_MB": str(self.memory_mb)}
        self.proc = subprocess.Popen(
            [sys.executable, "-c", _WORKER_SOURCE],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, env=env)
        self.defined = set()

    def _send(self, obj):
        b = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
        self.proc.stdin.write(struct.pack("<Q", len(b)))
        self.proc.stdin.write(b)
        self.proc.stdin.flush()

    def _recv(self):
        hdr = self.proc.stdout.read(8)
        if len(hdr) < 8:
            raise SandboxError("UDF worker died (crash or exit in user code)")
        (n,) = struct.unpack("<Q", hdr)
        status, payload = pickle.loads(self.proc.stdout.read(n))
        if status != "ok":
            raise SandboxError(payload)
        return payload

    def call(self, key: str, code: str, name: str, arrays: list):
        """Run fn(*arrays) in the worker; (re)defines the function there on
        first use or after a restart."""
        with self.lock:
            try:
                self._ensure()
                if key not in self.defined:
                    self._send(("def", key, code, name))
                    self._recv()
                    self.defined.add(key)
                self._send(("call", key, arrays))
                return self._recv()
            except (BrokenPipeError, EOFError, OSError) as e:
                if self.proc is not None:
                    self.proc.kill()
                    self.proc = None
                raise SandboxError(
                    f"UDF worker connection lost: {e} (worker will restart "
                    f"on the next call)")
            except SandboxError:
                if self.proc is not None and self.proc.poll() is not None:
                    self.proc = None  # crashed: force restart next call
                raise

    def close(self):
        with self.lock:
            if self.proc is not None:
                self.proc.kill()
                self.proc = None


_GLOBAL_WORKER: UDFWorker | None = None


def global_worker() -> UDFWorker:
    global _GLOBAL_WORKER
    if _GLOBAL_WORKER is None:
        from ..utils.settings import UDF_MEMORY_MB

        _GLOBAL_WORKER = UDFWorker(UDF_MEMORY_MB.get())
    return _GLOBAL_WORKER
