"""Persistent hash-index payloads.

Analogue of the reference's file-backed hash index
(reference: src/runtime/LingoDBHashIndex.cpp — the built hashtable is
serialized next to the table data and loaded on open instead of rebuilt per
session). Here the payload IS the engine's probe structure: for a unique,
densely-spanned integer key the direct-mapped key->row LUT that the
one-gather probe consumes (runtime/executor.py _try_unique_key_join),
otherwise the sorted key image + row order. Saved as an .npz container under
the `<index>.idx` filename the catalog names (storage/refformat.py writes the
same name into reference-format directories).

String / multi-column indexes keep a metadata-only entry (`kind == "meta"`):
the executor's probe structures for those are built from per-session merged
dictionaries, which cannot be persisted stably across sessions.
"""

from __future__ import annotations

import json

import numpy as np

# builds = payload computed from table data; loads = payload read from .idx;
# saves = payload written. Tests assert reopen-a-db does loads, not builds.
STATS = {"builds": 0, "loads": 0, "saves": 0}

FORMAT_VERSION = 1
DENSE_SPAN_CAP = 1 << 26  # matches the executor's direct-LUT span bound


def build(entry, columns: list[str]) -> dict:
    """Compute the payload for an index on `entry` (TableEntry) keyed by
    `columns`. Single integer column: dense LUT when unique + dense enough,
    else sorted (keys, rids). Anything else: metadata only."""
    STATS["builds"] += 1
    st = entry.storage
    n = st.num_rows if st is not None else 0
    cols = [c if c in entry.column_names else c.lower() for c in columns]
    base = {"fmt": FORMAT_VERSION, "rows": n, "cols": cols}
    if st is None or len(cols) != 1:
        return {**base, "kind": "meta"}
    col = st.column(cols[0])
    data = np.asarray(col.data)
    if data.dtype.kind not in "iu" or col.type.is_string:
        return {**base, "kind": "meta"}
    rid = np.arange(n, dtype=np.int64)
    if col.valid is not None:
        v = np.asarray(col.valid, bool)
        keys = data[v].astype(np.int64)
        rid = rid[v]
    else:
        keys = data.astype(np.int64)
    if keys.size:
        kmin = int(keys.min())
        span = int(keys.max()) - kmin + 1
        if span <= DENSE_SPAN_CAP and np.unique(keys).size == keys.size:
            lut = np.full(span, -1, np.int32)
            lut[keys - kmin] = rid.astype(np.int32)
            return {**base, "kind": "dense", "kmin": kmin, "span": span,
                    "n_valid": int(keys.size), "lut": lut}
    order = np.argsort(keys, kind="stable")
    return {**base, "kind": "sorted", "keys": keys[order],
            "rids": rid[order]}


def save(path: str, payload: dict) -> None:
    arrs = {k: v for k, v in payload.items() if isinstance(v, np.ndarray)}
    meta = {k: v for k, v in payload.items()
            if not isinstance(v, np.ndarray) and not k.startswith("_")}
    mb = np.frombuffer(json.dumps(meta).encode(), np.uint8).copy()
    with open(path, "wb") as f:
        np.savez(f, __meta__=mb, **arrs)
    STATS["saves"] += 1


def load(path: str) -> dict | None:
    try:
        with np.load(path, allow_pickle=False) as z:
            out = json.loads(bytes(z["__meta__"]).decode())
            if out.get("fmt") != FORMAT_VERSION:
                return None
            for k in z.files:
                if k != "__meta__":
                    out[k] = z[k]
            STATS["loads"] += 1
            return out
    except Exception:
        return None


def device_lut(payload: dict, device):
    """The dense LUT as a tensor on `device` (cached on the payload)."""
    import torch

    cached = payload.get("_lut_dev")
    if cached is None or cached.device != torch.device(device):
        cached = torch.from_numpy(payload["lut"]).to(device)
        payload["_lut_dev"] = cached
    return cached
