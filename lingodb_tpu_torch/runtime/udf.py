"""User-defined functions: native C UDFs + Python UDFs.

Equivalent of the reference's UDF implementers
(reference: src/catalog/UDFImplementer.cpp:32-120 — CREATE FUNCTION ...
LANGUAGE C writes a .c file, compiles it with `cc` into a shared object,
caches it under <db>/udf/, dlopens it and dispatches through
db.runtime_call). Here the same flow produces a *vectorized* native kernel:
the scalar body is wrapped in a loop over whole columns, compiled once, and
invoked through ctypes on host buffers — batch-at-a-time instead of the
reference's tuple-at-a-time calls.

Python UDFs evaluate with numpy vectorization on the host (the reference
runs them in per-worker CPython sub-interpreters, PythonRuntime.cpp).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile

import numpy as np

from ..sql.types import K, Type

_C_TYPES = {
    K.INT: ("int32_t", ctypes.c_int32, np.int32),
    K.BIGINT: ("int64_t", ctypes.c_int64, np.int64),
    K.FLOAT: ("float", ctypes.c_float, np.float32),
    K.DOUBLE: ("double", ctypes.c_double, np.float64),
    K.BOOL: ("bool", ctypes.c_bool, np.bool_),
    K.DATE: ("int32_t", ctypes.c_int32, np.int32),
    K.TIMESTAMP: ("int64_t", ctypes.c_int64, np.int64),
    K.DECIMAL: ("int64_t", ctypes.c_int64, np.int64),
}

# its own directory: the JAX package builds the same sources under
# "lingodb_tpu_udf", and the two packages share no built files
_CACHE_DIR = os.path.join(tempfile.gettempdir(), "lingodb_tpu_torch_udf")
_LOADED: dict[str, object] = {}


class UDFError(Exception):
    pass


def _ctype(t: Type):
    if t.kind not in _C_TYPES:
        raise UDFError(f"unsupported C UDF type {t}")
    return _C_TYPES[t.kind]


def compile_c_udf(name: str, arg_names: list[str], arg_types: list[Type],
                  ret_type: Type, body: str):
    """Compile a scalar C body into a vectorized shared object and return a
    numpy-arrays -> numpy-array callable."""
    c_args = [_ctype(t) for t in arg_types]
    c_ret = _ctype(ret_type)
    params = ", ".join(f"{ct[0]} {an}" for ct, an in zip(c_args, arg_names))
    vec_params = ", ".join(
        f"const {ct[0]}* restrict in{i}" for i, ct in enumerate(c_args)
    )
    call_args = ", ".join(f"in{i}[i]" for i in range(len(c_args)))
    src = f"""
#include <stdint.h>
#include <stdbool.h>
#include <stddef.h>
#include <math.h>
static inline {c_ret[0]} body_fn({params}) {{
{body}
}}
void udf_vec(int64_t n, {vec_params}, {c_ret[0]}* restrict out) {{
    for (int64_t i = 0; i < n; i++) out[i] = body_fn({call_args});
}}
"""
    key = hashlib.md5(src.encode()).hexdigest()[:16]
    os.makedirs(_CACHE_DIR, exist_ok=True)
    so_path = os.path.join(_CACHE_DIR, f"udf_{name}_{key}.so")
    if not os.path.exists(so_path):
        c_path = so_path[:-3] + ".c"
        with open(c_path, "w") as f:
            f.write(src)
        cc = os.environ.get("CC", "cc")
        r = subprocess.run(
            [cc, "-O2", "-march=native", "-shared", "-fPIC", c_path, "-o", so_path, "-lm"],
            capture_output=True, text=True,
        )
        if r.returncode != 0:
            raise UDFError(f"C UDF compilation failed:\n{r.stderr}")
    lib = ctypes.CDLL(so_path)
    fn = lib.udf_vec
    fn.restype = None
    fn.argtypes = (
        [ctypes.c_int64]
        + [ctypes.POINTER(ct[1]) for ct in c_args]
        + [ctypes.POINTER(c_ret[1])]
    )
    np_args = [ct[2] for ct in c_args]
    np_ret = c_ret[2]

    def call(arrays: list[np.ndarray]) -> np.ndarray:
        n = len(arrays[0]) if arrays else 0
        out = np.empty(n, dtype=np_ret)
        cargs = [ctypes.c_int64(n)]
        keep = []
        for a, dt, ct in zip(arrays, np_args, c_args):
            a = np.ascontiguousarray(a, dtype=dt)
            keep.append(a)
            cargs.append(a.ctypes.data_as(ctypes.POINTER(ct[1])))
        cargs.append(out.ctypes.data_as(ctypes.POINTER(c_ret[1])))
        fn(*cargs)
        return out

    return call


def make_python_udf(name: str, arg_names: list[str], arg_types: list[Type],
                    ret_type: Type, body: str):
    """Python UDF: the body is a function definition or expression executed
    per batch with numpy broadcasting when possible, else per row. With
    `SET udf_isolation = 'process'` the batch evaluates in a persistent
    isolated worker process instead (runtime/sandbox.py; reference:
    per-worker sub-interpreters + WASM runtime)."""
    ns: dict = {"np": np}
    code = body.strip()
    try:
        exec(code, ns)  # noqa: S102 - UDF bodies are user-supplied by design
    except SyntaxError as e:
        raise UDFError(f"python UDF body error: {e}")
    fn = ns.get(name)
    if fn is None:
        # single function defined under another name?
        fns = [v for v in ns.values() if callable(v) and getattr(v, "__module__", None) is None]
        if len(fns) == 1:
            fn = fns[0]
    if fn is None:
        raise UDFError(f"python UDF body must define function {name!r}")

    from .vtable import np_dtype

    out_dt = (np.dtype(object) if ret_type.is_string
              else np.dtype(np_dtype(ret_type)))
    key = name + ":" + hashlib.md5(code.encode()).hexdigest()[:16]

    def call(arrays: list[np.ndarray]) -> np.ndarray:
        from ..utils.settings import UDF_ISOLATION

        if UDF_ISOLATION.get() == "process":
            from .sandbox import SandboxError, global_worker

            try:
                out = global_worker().call(key, code, name, list(arrays))
            except SandboxError as e:
                raise UDFError(str(e))
            return out if out_dt == object else np.asarray(out).astype(out_dt)
        try:
            out = fn(*arrays)
            out = np.asarray(out)
            if out.shape != arrays[0].shape:
                raise TypeError
            return out if out_dt == object else out.astype(out_dt)
        except Exception:  # fall back to per-row
            n = len(arrays[0]) if arrays else 0
            out = np.empty(n, dtype=out_dt)
            for i in range(n):
                out[i] = fn(*[a[i] for a in arrays])
            return out

    return call
