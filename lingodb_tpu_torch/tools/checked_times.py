"""The checked kernel's forms (csrc/checked_arith.cu) as chip_smoke.py's
phase 3 checks and times them, for the tree it is run from; and, given two
chip_smoke.py logs, their phases 4, 4b and 10 compared line by line.

Run from the root of a checkout: the package and chip_smoke.py imported are
the ones in the current directory, so one copy of this file times two trees
in one call, in turns (parent, change, change, parent):

    python3 /path/to/checked_times.py LABEL
    python3 /path/to/checked_times.py --compare PARENT.log CHANGE.log

The first form runs chip_smoke.check_checked_arith at lineitem's length at
SF1 (every form held bit for bit against its plain version) and prints one
line a form: LABEL, then a JSON object of its call ms (CUDA events around
10 calls), card ms (torch.profiler; and, where the tree's chip_smoke.py
takes it, a CUDA graph of ten calls replayed), the plain version's and the
int64 PyTorch passes' ms and the bytes bound. Needs a CUDA device; fails
without one. The second prints the lines of each log's phases 4 (`#
query`), 4b (`# topk/chain`) and 10 (`# graphs q`) whose syncs, launches
or captures differ, with times left out, and the lines of the second log
where the checked kernel launched.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys

LINEITEM_SF1 = 5_997_593
_LINE = re.compile(
    r"# (query q\S+ \[\w+\]|topk/chain q\S+ \[\w+\]|graphs q\S+):")


def counted_lines(path: str) -> dict:
    """{line's key: its syncs, launches and captures} of a chip_smoke.py
    log's phases 4, 4b and 10."""
    out = {}
    with open(path) as f:
        for ln in f:
            m = _LINE.match(ln)
            if not m:
                continue
            syncs = re.search(r"syncs[= ]\d+( / \d+)?", ln)
            if m.group(1).startswith("graphs"):
                counts = ln.split("; wall_ms")[0]
            else:
                launches = re.search(r"launches=\{[^}]*\}", ln)
                counts = launches.group(0) if launches else ""
            out[m.group(1)] = f"{counts} {syncs.group(0) if syncs else ''}"
    return out


def compare(parent: str, change: str) -> int:
    a, b = counted_lines(parent), counted_lines(change)
    keys = sorted(set(a) | set(b))
    differ = [k for k in keys if a.get(k) != b.get(k)]
    print(f"{len(keys)} lines of phases 4, 4b and 10: "
          f"{len(keys) - len(differ)} equal in syncs, launches and "
          f"captures, {len(differ)} differ")
    for k in differ:
        print(f"parent {k}: {a.get(k)}\nchange {k}: {b.get(k)}")
    checked = [k for k in keys
               if re.search(r"checked_arith.: [1-9]", b.get(k, ""))]
    print(f"lines of the change where checked_arith launched: {checked}")
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("label", nargs="?")
    ap.add_argument("--compare", nargs=2, metavar=("PARENT", "CHANGE"))
    args = ap.parse_args()
    if args.compare:
        return compare(*args.compare)
    sys.path.insert(0, os.getcwd())
    import torch

    if not torch.cuda.is_available():
        print("checked_times: FAILED: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from lingodb_tpu_torch.ops import cuda_build

    cuda_build.build_all()
    cases: list = []
    chip_smoke.check_checked_arith(torch, LINEITEM_SF1, cases)
    for c in cases:
        print(args.label, json.dumps({"case": c["shape"], **{
            k: c.get(k) for k in ("ms", "device_ms", "graph_ms", "plain_ms",
                                  "library_ms", "library_device_ms",
                                  "library_graph_ms", "bound_ms",
                                  "marked_rows")}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
