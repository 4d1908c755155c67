"""Device-side byte-tensor string matching for high-cardinality dictionaries.

Analogue of the reference StringRuntime's byte-level matchers
(reference: src/runtime/StringRuntime.cpp -- like/starts_with/ends_with run
over raw bytes per tuple). Low-cardinality dictionaries keep the host LUT
path (ops/strings.py); at high cardinality the host loop is the bottleneck,
so the dictionary itself moves to the device ONCE as a padded (D, Lpad)
uint8 plane and every LIKE evaluates as whole-tensor byte compares.

LIKE evaluation uses greedy leftmost segment matching (equivalent to the
backtracking semantics for %-separated literal segments): for each segment
a (D, P) match matrix via shifted byte compares, then the earliest
admissible position per row advances a cursor. `_` wildcards are per-byte
holes in the compare; this is exact for ASCII and for any pattern without
`_`/ILIKE over non-ASCII data (the plane builder detects non-ASCII and
those cases return None: the caller matches on the host).

The planes live on the device of the codes that ask for them (a CPU tensor
in the tests, the card otherwise).
"""

from __future__ import annotations

import numpy as np
import torch

from . import backend as be

# dictionaries below this stay on the host LUT path: plane build + device
# dispatch costs more than a small host loop
DEVICE_DICT_MIN = 1 << 14

# (id(dictionary), device) -> (dictionary ref, planes). The strong ref to
# the dictionary keeps ids stable; bounded to the working set of a query.
_PLANE_CACHE: dict[tuple, tuple] = {}

# (id(dictionary), device, pattern, ci) -> (dictionary ref, mask): a mask
# depends only on the dictionary and the pattern.
_MASK_CACHE: dict[tuple, tuple] = {}


def _planes(dictionary: np.ndarray, device, cached: bool = True):
    """(bytes2d (D, Lpad) uint8, lens (D,) int32, ascii_only, exact) on
    `device`. Built once per dictionary object and device (with `cached`);
    exact=False flags embedded NUL bytes (S-dtype trims them -- the planes
    are then truncated and the caller must match on the host)."""
    device = torch.device(device)
    key = (id(dictionary), str(device))
    hit = _PLANE_CACHE.get(key) if cached else None
    if hit is not None and hit[0] is dictionary:
        return hit[1]
    enc = np.char.encode(dictionary.astype(str), "utf-8")
    lens = np.char.str_len(enc).astype(np.int32)
    lmax = max(1, int(lens.max()) if lens.size else 1)
    lpad = -(-lmax // 128) * 128
    buf = np.zeros((len(enc), lpad), np.uint8)
    view = enc.astype(f"S{lpad}").view(np.uint8).reshape(len(enc), lpad)
    buf[:] = view
    ascii_only = bool(buf.max(initial=0) < 128)
    # Embedded/trailing NUL detection: S-dtype element access trims trailing
    # \x00 (so both np.char.str_len(enc) and len(enc[i]) under-count), and
    # 'a\x00' would silently match as 'a' on the device while the host path
    # sees the real 2-byte string. True byte lengths must come from the
    # ORIGINAL strings, before any S-dtype conversion.
    exact = True
    if lens.size:
        true_lens = np.fromiter(
            (len(str(x).encode("utf-8")) for x in dictionary),
            np.int32, len(dictionary))
        exact = bool(np.array_equal(true_lens, lens))
    out = (be.to_device(buf, device), be.to_device(lens, device), ascii_only,
           exact)
    if not cached:
        return out
    if len(_PLANE_CACHE) >= 8:
        # evict the single oldest entry (insertion-ordered dict): each entry
        # pins a (D, Lpad) uint8 plane on its device
        _PLANE_CACHE.pop(next(iter(_PLANE_CACHE)))
    _PLANE_CACHE[key] = (dictionary, out)
    return out


def _tokenize(pattern: str, escape: str = "\\"):
    """LIKE pattern -> (segments, anchored_start, anchored_end). Each segment
    is a list of (byte, is_wildcard) for one %-free run (non-ASCII bytes
    are allowed -- only multi-byte-aware `_` needs the host path, which the
    caller decides)."""
    segs: list[list[tuple[int, bool]]] = [[]]
    i = 0
    while i < len(pattern):
        c = pattern[i]
        if c == escape and i + 1 < len(pattern):
            for b in pattern[i + 1].encode("utf-8"):
                segs[-1].append((b, False))
            i += 2
            continue
        if c == "%":
            segs.append([])
        elif c == "_":
            segs[-1].append((0, True))
        else:
            for b in c.encode("utf-8"):
                segs[-1].append((b, False))
        i += 1
    # anchors are structural: an unescaped leading/trailing % is the only
    # thing that leaves an empty first/last segment (escaped chars append)
    anchored_start = not (len(segs) > 1 and not segs[0])
    anchored_end = not (len(segs) > 1 and not segs[-1])
    # drop empty middle segments (%% == %); keep empty first/last for anchors
    mid = [s for s in segs[1:-1] if s]
    segments = [segs[0]] + mid + ([segs[-1]] if len(segs) > 1 else [])
    return segments, anchored_start, anchored_end


def _fold(x: torch.Tensor) -> torch.Tensor:
    """ASCII lowercase on a uint8 tensor."""
    up = (x >= 65) & (x <= 90)
    return torch.where(up, x + 32, x)


def device_like_mask(dictionary: np.ndarray, pattern: str,
                     case_insensitive: bool = False, device="cpu"):
    """Per-dictionary-entry LIKE mask computed on `device`, or None when
    the pattern/data needs the host path. Returns a bool (D,) tensor,
    cached per (dictionary, device, pattern, ci). Under a CUDA graph's
    capture nothing is read from or kept in the caches: a mask made there
    lives in the graph's pool, which its replays overwrite, and the graph
    must not read a cached tensor that the cache may drop."""
    if be.capturing(device):
        return _device_like_mask_uncached(dictionary, pattern,
                                          case_insensitive, device, False)
    ck = (id(dictionary), str(torch.device(device)), pattern, case_insensitive)
    hit = _MASK_CACHE.get(ck)
    if hit is not None and hit[0] is dictionary:
        return hit[1]
    mask = _device_like_mask_uncached(dictionary, pattern, case_insensitive,
                                      device)
    if len(_MASK_CACHE) >= 64:
        _MASK_CACHE.pop(next(iter(_MASK_CACHE)))
    _MASK_CACHE[ck] = (dictionary, mask)
    return mask


def _device_like_mask_uncached(dictionary: np.ndarray, pattern: str,
                               case_insensitive: bool, device,
                               cached_planes: bool = True):
    try:
        pattern.encode("ascii")
    except UnicodeEncodeError:
        return None
    b2d, lens, ascii_only, exact = _planes(dictionary, device, cached_planes)
    if not exact:
        return None  # embedded NULs: plane bytes/lengths are truncated
    segments, a_start, a_end = _tokenize(pattern)
    has_underscore = any(w for seg in segments for _, w in seg)
    if not ascii_only and (has_underscore or case_insensitive):
        return None  # `_` counts characters, folding is per-codepoint
    d, lpad = b2d.shape
    dev = b2d.device
    mmax = max((len(s) for s in segments), default=0)
    if mmax > lpad:
        return torch.zeros((d,), dtype=torch.bool, device=dev)

    b = _fold(b2d) if case_insensitive else b2d
    # pad so every window slice [p : p+m] is in bounds for p < lpad
    bp = torch.nn.functional.pad(b, (0, mmax))
    pos = torch.arange(lpad, dtype=torch.int32, device=dev)[None, :]

    def seg_matrix(seg):
        m = torch.ones((d, lpad), dtype=torch.bool, device=dev)
        for j, (byte, wild) in enumerate(seg):
            if wild:
                continue
            cb = byte + 32 if (case_insensitive and 65 <= byte <= 90) else byte
            m &= bp[:, j:j + lpad] == cb
        # window must lie inside the string
        return m & (pos + len(seg) <= lens[:, None])

    ok = torch.ones((d,), dtype=torch.bool, device=dev)
    cur = torch.zeros((d,), dtype=torch.int32, device=dev)
    for si, seg in enumerate(segments):
        m = len(seg)
        first, last = si == 0, si == len(segments) - 1
        if m == 0:
            if first and last and a_start and a_end:
                ok = ok & (lens == 0)  # pattern '' matches only ''
            continue
        mat = seg_matrix(seg)
        if first and a_start and last and a_end:
            ok = ok & mat[:, 0] & (lens == m)
        elif first and a_start:
            ok = ok & mat[:, 0]
            cur = torch.full((d,), m, dtype=torch.int32, device=dev)
        elif last and a_end:
            p = torch.clamp(lens - m, min=0).to(torch.int64)
            hit = torch.gather(mat, 1, p[:, None])[:, 0]
            ok = ok & hit & (lens - m >= cur)
        else:
            allowed = mat & (pos >= cur[:, None])
            found = allowed.any(dim=1)
            # the first admissible position (argmax of a bool row)
            p = allowed.to(torch.uint8).argmax(dim=1).to(torch.int32)
            ok = ok & found
            cur = p + m
    return ok


def device_length(dictionary: np.ndarray, device="cpu"):
    """Per-entry CHARACTER length on `device` (byte length when ASCII)."""
    b2d, lens, ascii_only, exact = _planes(dictionary, device)
    if ascii_only and exact:
        return lens
    # utf-8 continuation bytes (0b10xxxxxx) don't start a codepoint
    cont = (b2d & 0xC0) == 0x80
    return lens - cont.to(torch.int32).sum(dim=1, dtype=torch.int32)
