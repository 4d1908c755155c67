"""Standalone query artifacts: optimize once, run cold without reparse,
reoptimize or recalibration.

Analogue of the reference's standalone-query tool, which compiles one SQL
query ahead of time into a self-contained executable (reference:
tools/standalone-query/). The JAX package's artifact packages serialized XLA
executables beside the optimized plan (lingodb_tpu/tools/artifact.py). The
port has nothing of the kind to package: its kernels are built from the
sources in the checkout and cached as libraries under build/kernels/, and
its fused programs run as CUDA graphs, which cannot be serialized. What a
cold process otherwise spends before its first rows is the front end, the
optimizer and the calibration runs that learn the fused programs' static
capacities. An .lqa file (a zip) carries what spares all three:

    manifest.json   format version, query text, optimized plan JSON, the
                    platform it was built on ("cuda" or "cpu"), the catalog
                    fingerprint (table -> version) it was built for, the
                    plan's learned capacities keyed as utils/capstore.py
                    keys them (plan, table versions, base rows; no data
                    pointer), and the names and source hashes of the CUDA
                    kernels its building run loaded

`run_artifact` checks the fingerprint, seeds the session's stage cache (and
the capstore, if one is set) with the capacities and runs the embedded plan
through Session.run_plan: no parse, no optimizer and no calibration run
(utils/compilestats.py counts all three). The fused programs are captured
as CUDA graphs on that first run, since graphs cannot be carried over, and
replayed after it.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile
import time
import zipfile

FORMAT_VERSION = 1


def _catalog_fingerprint(session) -> dict:
    return {name: getattr(e.storage, "version", 0)
            for name, e in sorted(session.catalog.tables.items())}


def build_artifact(session, query: str, out_path: str) -> dict:
    """Optimize `query`, run it once from an empty stage cache with the
    capstore redirected to a scratch directory (so that every capacity the
    plan needs is learned, and only those are written there), and package
    the plan and the capacities into `out_path`. Returns the manifest."""
    from ..ops import cuda_build
    from ..opt.optimizer import optimize
    from ..plan.serial import plan_to_json
    from ..sql.binder import Binder
    from ..sql.parser import parse_sql
    from ..utils.settings import CAPSTORE_DIR

    stmts = parse_sql(query)
    plan = optimize(Binder(session.catalog).bind_query(stmts[-1]),
                    session.catalog)
    # run the decoded form, the very object run_artifact executes: the
    # capacities are keyed by its plan key
    plan_json = plan_to_json(plan)
    old_dir = CAPSTORE_DIR.get()
    scratch = tempfile.mkdtemp(prefix="lqa_build_")
    try:
        CAPSTORE_DIR.set(scratch)
        session.stage_cache.clear()
        session.exestore.clear()
        session.run_plan(plan_json)
        path = os.path.join(scratch, "capacities.json")
        capacities = {}  # a plan with no fused program learns nothing
        if os.path.exists(path):
            with open(path) as f:
                capacities = json.load(f)
    finally:
        CAPSTORE_DIR.set(old_dir)
        shutil.rmtree(scratch, ignore_errors=True)
    manifest = {
        "format": FORMAT_VERSION,
        "query": query,
        "plan": plan_json,
        "platform": session.device.type,
        "catalog": _catalog_fingerprint(session),
        "capacities": capacities,
        "kernels": cuda_build.loaded(),
        "built_unix": time.time(),
    }
    with zipfile.ZipFile(out_path, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr("manifest.json", json.dumps(manifest))
    return manifest


def load_manifest(path: str) -> dict:
    with zipfile.ZipFile(path) as z:
        return json.loads(z.read("manifest.json"))


def run_artifact(session, path: str, strict: bool = True):
    """Execute a packaged query against `session`'s database: its learned
    capacities seeded, its plan run as it is (no parse, no optimizer, no
    calibration run). With `strict`, an artifact built for other table
    versions is refused (its capacities and plan key name those)."""
    from ..ops import cuda_build

    manifest = load_manifest(path)
    if manifest.get("format") != FORMAT_VERSION:
        raise ValueError(f"unsupported artifact format {manifest.get('format')}")
    if strict:
        fp = _catalog_fingerprint(session)
        stale = {t: (v, fp.get(t)) for t, v in manifest["catalog"].items()
                 if fp.get(t) != v}
        if stale:
            raise ValueError(
                f"artifact built for different table versions: {stale} "
                f"(rebuild with sql-to-artifact, or strict=False)")
    if session.device.type == "cuda":
        cuda_build.build_all()
        ours = cuda_build.loaded()
        other = {k for k, h in manifest.get("kernels", {}).items()
                 if ours.get(k) != h}
        if other:
            # the plan and capacities still hold; the kernels are this
            # checkout's, built from its sources
            print(f"# artifact: kernels {sorted(other)} differ from the "
                  f"sources it was built with", file=sys.stderr)
    session.executor.seed_capacities(manifest.get("capacities", {}))
    return session.run_plan(manifest["plan"])
