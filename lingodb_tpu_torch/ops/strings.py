"""String kernels via dictionary lookup tables.

Replacement for the reference StringRuntime
(reference: src/runtime/StringRuntime.cpp — like/concat/substr/upper/lower/
trim/casts, called per tuple from JIT'd code). Strings are dictionary-encoded
with *sorted* dictionaries (storage/column.py), so all per-row string work
becomes: compute a lookup table over the (small) dictionary on the host once,
then a single device gather `lut[codes]` inside the surrounding
stage. No byte processing ever happens on the device.
"""

from __future__ import annotations

import re

import numpy as np

from ..storage.column import encode_strings, merge_dictionaries


def like_to_regex(pattern: str) -> re.Pattern:
    out = []
    i = 0
    while i < len(pattern):
        c = pattern[i]
        if c == "%":
            out.append(".*")
        elif c == "_":
            out.append(".")
        elif c == "\\" and i + 1 < len(pattern):
            out.append(re.escape(pattern[i + 1]))
            i += 1
        else:
            out.append(re.escape(c))
        i += 1
    return re.compile("".join(out), re.DOTALL)


def like_lut(dictionary: np.ndarray, pattern: str, case_insensitive=False) -> np.ndarray:
    if len(dictionary) >= 2048:
        from .. import native

        m = native.like_match(dictionary, pattern, "\\", case_insensitive)
        if m is not None:
            return m
    rx = like_to_regex(pattern.lower() if case_insensitive else pattern)
    if case_insensitive:
        return np.array([rx.fullmatch(s.lower()) is not None for s in dictionary], dtype=np.bool_)
    return np.array([rx.fullmatch(s) is not None for s in dictionary], dtype=np.bool_)


def map_dictionary(dictionary: np.ndarray, fn) -> tuple[np.ndarray, np.ndarray]:
    """Apply a str->str function to every dictionary entry. Returns
    (new_sorted_dictionary, remap) with remap[old_code] = new_code."""
    mapped = [fn(s) for s in dictionary]
    new_dict, codes = encode_strings(mapped)
    return new_dict, codes.astype(np.int32)


def predicate_lut(dictionary: np.ndarray, fn) -> np.ndarray:
    return np.array([bool(fn(s)) for s in dictionary], dtype=np.bool_)


def value_lut(dictionary: np.ndarray, fn, dtype) -> np.ndarray:
    """Apply a str->scalar function (e.g. length, cast-to-int)."""
    return np.array([fn(s) for s in dictionary], dtype=dtype)


def const_code_bounds(dictionary: np.ndarray, value: str) -> tuple[int, int, bool]:
    """Position of `value` in a sorted dictionary: returns
    (left_insert, right_insert, exact_present). Because the dictionary is
    sorted, `code < left` <=> `entry < value`, `code < right` <=> `entry <=
    value`, and equality is `left <= code < right` (at most one code)."""
    left = int(np.searchsorted(dictionary, value, side="left"))
    right = int(np.searchsorted(dictionary, value, side="right"))
    return left, right, right > left


def remap_to_merged(dict_a: np.ndarray, dict_b: np.ndarray):
    """LUTs remapping two dictionaries into their sorted union (for comparing
    or concatenating two independently-encoded string columns)."""
    merged, ra, rb = merge_dictionaries(dict_a, dict_b)
    return merged, ra, rb
