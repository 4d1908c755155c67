"""A mesh that spans processes, held against the one-process mesh.

Each of `world` processes joins one process group (gloo on the CPU, nccl on
cards) and builds the global mesh of `world * positions` positions, its own
`positions` among them (parallel/multihost.py, parallel/mesh.py). Every
process then runs:

  - each mesh and shuffle function (all_to_all, gather, gather_ragged,
    to_host, psum / preduce, exchange, dest_counts, join_pairs, probe_flags,
    single_pick, grouped_reduce, sample_sort over global and over Sharded
    operands, take_rows) on inputs made from a numpy seed, over the
    spanning mesh and over a mesh of as many positions inside this process
    alone; the shards of its own positions must be equal, bit for bit;
  - TPC-H q3, q1 and q6, three statements of the shuffle checks, a TopK
    over a filtered scan and one over a table with a wide decimal column,
    over tables generated at `--sf` (STATEMENTS; every table of at least
    64 rows held on the mesh, system.shuffle_min_rows lowered so that the
    sharded operators engage), on the spanning mesh, on the one-process
    mesh and on no mesh: the rows must be equal, and every process must
    return the same rows.

Each process writes what it found as JSON. Run one process by hand:

    python -m lingodb_tpu_torch.tools.mesh_procs --rank 0 --world 2 \\
        --port 29517 --positions 4 --device cpu --out r0.json

or all of them (what the tests and chip_smoke.py do): `launch(...)`. On
cards each process sees one card (CUDA_VISIBLE_DEVICES), since NCCL takes
one card a rank.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np

SEED = 19920601
# TPC-H q3 (the sharded joins), q1 and q6 (the fused aggregate position by
# position, its lanes reduced through the group), three statements of the
# shuffle checks over lineitem and orders (the sharded join and its
# two-round grouping, the probe side's heavy-hitter split on a hot derived
# key, the distributed sample sort), and a TopK over a filtered scan (an
# operator without a sharded form: the survivors leave the mesh in one
# gather). A number names a query of queries/tpch.
STATEMENTS = {
    "q3": 3, "q1": 1, "q6": 6,
    "inner_join_groupby": (
        "select l_orderkey, sum(l_quantity) from lineitem, orders where "
        "l_orderkey = o_orderkey and o_orderdate < date '1993-01-01' "
        "group by l_orderkey order by l_orderkey"),
    "skewed_probe": (
        "select o_custkey, count(*), max(l_shipdate) from lineitem, orders "
        "where (case when l_linenumber > 1 then 1 else l_orderkey end) = "
        "o_orderkey group by o_custkey order by o_custkey"),
    "sort_asc": (
        "select o_totalprice, o_orderkey from orders order by o_totalprice, "
        "o_orderkey"),
    "topk_gather": (
        "select l_orderkey, l_linenumber, l_quantity from lineitem where "
        "l_quantity < 3 order by l_orderkey desc, l_linenumber limit 20"),
    # a wide decimal (held on the host, whole on every process) leaving
    # the mesh through an unfiltered scan: no selection vector
    "wide_gather": (
        "select k, d from wide order by k desc limit 20"),
}
# WIDE_ROWS rows of k bigint and d decimal(38,0) beyond int64; the axis of
# every mesh here divides the count, so the scan has no pad mask
WIDE_ROWS = 128
FUNCTIONS = ("all_to_all", "gather", "gather_ragged", "to_host", "psum",
             "preduce", "exchange", "dest_counts", "join_pairs",
             "probe_flags", "single_pick", "grouped_reduce", "sample_sort",
             "sample_sort_sharded", "take_rows")


def _np(t):
    return t.detach().cpu().numpy()


def _eq(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return (a.dtype == b.dtype and a.shape == b.shape
            and bool(np.array_equal(a, b, equal_nan=a.dtype.kind == "f")))


def _same(span, x, y) -> bool:
    """Sharded x (over the spanning mesh) holds y's shards (over the
    one-process mesh) at this process's positions."""
    return x.local_len == y.local_len and all(
        _eq(_np(x.shards[i]), _np(y.shards[s]))
        for i, s in enumerate(span.local_positions))


def _hashes(rng, n, keys):
    from ..ops import hashing
    from ..runtime.vtable import SCol
    from ..sql.types import Type

    k = rng.integers(0, keys, n).astype(np.int64)
    return np.asarray(hashing.hash_columns([SCol(Type.bigint(), k, None)]))


def function_checks(span, one, dev) -> dict:
    """{function: equal} of every mesh and shuffle function, spanning
    mesh against the one-process mesh, on seeded inputs."""
    import torch

    from ..parallel import mesh as msh
    from ..parallel import shuffle as sh

    n = span.size
    local = list(span.local_positions)
    out = {}

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    rng = np.random.default_rng(1)
    ok = True
    for dt in (np.int64, np.bool_, np.float64):
        bufs = [t(rng.integers(-1000, 1000, (n, 5)).astype(dt))
                for _ in range(n)]
        a = msh.all_to_all(span, [bufs[s] for s in local])
        b = msh.all_to_all(one, bufs)
        ok &= all(_eq(_np(a[i]), _np(b[s])) for i, s in enumerate(local))
    out["all_to_all"] = ok
    col = rng.integers(-1 << 40, 1 << 40, 1003)
    flags = rng.random(1003) < 0.5
    out["gather"] = all(
        _eq(_np(msh.gather(msh.shard_rows(span, t(x)), dev)),
            _np(msh.gather(msh.shard_rows(one, t(x)), dev)))
        for x in (col, flags))
    counts = rng.integers(0, 7, n)
    parts = [t(rng.integers(0, 100, 7)) for _ in range(n)]
    out["gather_ragged"] = _eq(
        _np(msh.gather_ragged(span, [parts[s] for s in local], counts, dev)),
        _np(msh.gather_ragged(one, parts, counts, dev)))
    out["to_host"] = _eq(
        msh.to_host(span, [t(counts[s:s + 1]) for s in local]),
        msh.to_host(one, [t(counts[s:s + 1]) for s in range(n)]))
    vals = [t(rng.integers(-50, 50, 9)) for _ in range(n)]
    out["psum"] = all(
        _eq(_np(x), _np(msh.psum(one, vals)[0]))
        for x in msh.psum(span, [vals[s] for s in local]))
    out["preduce"] = all(
        _eq(_np(msh.preduce(span, [vals[s] for s in local], o)),
            _np(msh.preduce(one, vals, o))) for o in ("sum", "min", "max"))

    # the exchange (a hot destination, dead rows, four dtypes)
    rng = np.random.default_rng(3)
    rows = 3001
    dest = rng.integers(0, n, rows).astype(np.int32)
    dest[: rows // 3] = n - 1
    valid = rng.random(rows) < 0.8
    arrays = [rng.integers(-1 << 40, 1 << 40, rows), rng.standard_normal(rows),
              rng.random(rows) < 0.5, rng.integers(-100, 100, rows).astype(np.int32)]
    ex = {}
    for name, mesh in (("span", span), ("one", one)):
        ex[name] = sh.exchange(mesh, t(dest), [t(a) for a in arrays], t(valid))
    out["exchange"] = (ex["span"][2] == ex["one"][2] and all(
        _same(span, x, y) for x, y in zip([ex["span"][0], *ex["span"][1]],
                                          [ex["one"][0], *ex["one"][1]])))
    out["dest_counts"] = _eq(sh.dest_counts(span, t(dest), t(valid)),
                             sh.dest_counts(one, t(dest), t(valid)))

    # the local join over exchanged sides, its flags and single pick
    rng = np.random.default_rng(4)
    nb, np_ = 2500, 4000
    bh = _hashes(rng, nb, 700)
    bh[::37] = np.uint64(0xFFFFFFFFFFFFFFFF)
    ph = _hashes(rng, np_, 900)
    bv, pv = rng.random(nb) < 0.9, rng.random(np_) < 0.85
    bpay = [rng.integers(0, 1 << 50, nb), rng.standard_normal(nb)]
    ppay = [rng.integers(-9, 9, np_).astype(np.int32), rng.random(np_) < 0.3]
    j = {}
    for name, mesh in (("span", span), ("one", one)):
        ph_t, bh_t = t(ph.view(np.int64)), t(bh.view(np.int64))
        pvx, pouts, lp = sh.exchange(mesh, sh.hash_dest(mesh, ph_t),
                                     [ph_t] + [t(a) for a in ppay], t(pv))
        bvx, bouts, lb = sh.exchange(mesh, sh.hash_dest(mesh, bh_t),
                                     [bh_t] + [t(a) for a in bpay], t(bv))
        res = sh.join_pairs(mesh, bouts[0], bvx, pouts[0], pvx, bouts[1:],
                            pouts[1:])
        flags_p = sh.probe_flags(mesh, res[0], res[1], lp)
        flags_b = sh.probe_flags(mesh, res[0], res[2], lb)
        pick = sh.single_pick(mesh, res[0], res[1], lp, res[3])
        j[name] = (res, flags_p, flags_b, pick)
    rs, ro = j["span"][0], j["one"][0]
    out["join_pairs"] = (rs[5:] == ro[5:] and rs[6] > 0 and all(
        _same(span, x, y) for x, y in zip(list(rs[:3]) + rs[3] + rs[4],
                                          list(ro[:3]) + ro[3] + ro[4])))
    out["probe_flags"] = (_same(span, j["span"][1], j["one"][1])
                          and _same(span, j["span"][2], j["one"][2]))
    ps, po = j["span"][3], j["one"][3]
    out["single_pick"] = _same(span, ps[0], po[0]) and all(
        _same(span, x, y) for x, y in zip(ps[1], po[1]))

    # the final grouping of exchanged rows, every kind
    rng = np.random.default_rng(5)
    rows = 4000
    key = rng.integers(0, 300, rows)
    h = _hashes(np.random.default_rng(5), rows, 300)
    valid = rng.random(rows) < 0.9
    ins = [key, rng.integers(0, 1 << 40, rows), rng.integers(-50, 50, rows),
           rng.standard_normal(rows), rng.integers(-50, 50, rows).astype(np.int32),
           rng.random(rows) < 0.8, rng.integers(0, 7, rows), np.ones(rows, np.int64)]
    g = {}
    for name, mesh in (("span", span), ("one", one)):
        h_t = t(h.view(np.int64))
        ex_v, exs, _ = sh.exchange(mesh, sh.hash_dest(mesh, h_t),
                                   [t(a) for a in ins], t(valid))
        k_, rep_, iv, fv, iv32, av_, dimg_, ones_ = exs
        aggs = [("sum", [iv], av_), ("count", [ones_], av_),
                ("min", [iv32], av_), ("max", [fv], av_), ("min", [fv], av_),
                ("cdist", [dimg_], av_), ("sdist", [dimg_, iv], av_)]
        gv, reps, aouts = sh.grouped_reduce(mesh, ex_v, [k_], [rep_, k_], aggs)
        g[name] = [gv, *reps, *[x for a in aouts for x in a]]
    out["grouped_reduce"] = all(_same(span, x, y)
                                for x, y in zip(g["span"], g["one"]))

    # the sample sort, over global operands and over Sharded ones
    rng = np.random.default_rng(6)
    rows = 3000
    ops = [rng.integers(0, 4, rows), rng.integers(-1000, 1000, rows),
           np.arange(rows, dtype=np.int64)]
    pay = [rng.standard_normal(rows), rng.random(rows) < 0.5]
    live = rng.random(rows) < 0.9
    for label, sharded in (("sample_sort", False), ("sample_sort_sharded", True)):
        r = {}
        for name, mesh in (("span", span), ("one", one)):
            if sharded:
                args = ([msh.shard_rows(mesh, t(o)) for o in ops],
                        [msh.shard_rows(mesh, t(p)) for p in pay],
                        msh.shard_rows(mesh, t(live)))
            else:
                args = ([t(o) for o in ops], [t(p) for p in pay], None)
            r[name] = sh.sample_sort(mesh, *args)
        out[label] = (r["span"][2] == r["one"][2] and all(
            _same(span, x, y) for x, y in zip([r["span"][0], *r["span"][1]],
                                              [r["one"][0], *r["one"][1]])))
    idx = np.unique(rng.integers(0, rows, 200))
    out["take_rows"] = _eq(
        _np(sh.take_rows(msh.shard_rows(span, t(ops[1])), idx)),
        _np(sh.take_rows(msh.shard_rows(one, t(ops[1])), idx)))
    return {k: bool(v) for k, v in out.items()}


def _digest(rows: list) -> str:
    return hashlib.sha1(json.dumps(rows, default=str).encode()).hexdigest()


def install(s, sf: float) -> None:
    """The tables STATEMENTS read: TPC-H at `sf` and `wide`."""
    from . import tpchgen

    tpchgen.install(s, tpchgen.generate(sf, SEED))
    s.sql("create table wide (k bigint, d decimal(38, 0))")
    s.sql("insert into wide values " + ", ".join(
        f"({i}, {10 ** 20 + 7 * i})" for i in range(WIDE_ROWS)))


def sql_checks(span, one, device: str, sf: float) -> dict:
    """{statement: {"equal", "rows", "digest", "stats"}} over the spanning
    mesh, against the one-process mesh and no mesh."""
    import lingodb_tpu_torch as ldb
    from ..parallel import shuffle as sh
    from ..runtime import device as dv
    from ..utils.settings import set_setting

    qdir = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "queries", "tpch")
    old_small = dv.SMALL_ROWS
    dv.SMALL_ROWS = 64
    set_setting("system.shuffle_min_rows", 32)
    s = ldb.create_in_memory(device=device)
    install(s, sf)
    out = {}
    try:
        for name, sql in STATEMENTS.items():
            if isinstance(sql, int):
                sql = open(os.path.join(qdir, f"{sql}.sql")).read()
            got = {}
            for label, mesh in (("none", None), ("one", one), ("span", span)):
                dv._MESH, dv._MESH_INIT = mesh, True
                before = dict(sh.STATS)
                res = s.sql(sql)
                got[label] = (res.format_rows(),
                              {k: sh.STATS[k] - before[k] for k in sh.STATS})
            rows = got["span"][0]
            out[name] = {"equal": rows == got["one"][0] == got["none"][0],
                         "rows": len(rows), "digest": _digest(rows),
                         "stats": got["span"][1],
                         "stats_one": got["one"][1]}
    finally:
        dv._MESH, dv._MESH_INIT = None, False
        dv.SMALL_ROWS = old_small
        set_setting("system.shuffle_min_rows", 1 << 16)
    return out


def worker(rank: int, world: int, port: int, positions: int, device: str,
           sf: float, timeout_s: float) -> dict:
    """One process of the cluster: join, build both meshes, run every
    check. `device` is "cpu" or "cuda" (this process's one visible
    card)."""
    import torch
    import torch.distributed as dist

    from ..parallel import multihost as mh
    from ..parallel.mesh import Mesh

    t0 = time.perf_counter()
    if device == "cuda":
        torch.cuda.set_device(0)
        dev = torch.device("cuda", 0)
    else:
        dev = torch.device("cpu")
    if not mh.initialize(coordinator=f"127.0.0.1:{port}", num_processes=world,
                         process_id=rank, device_type=dev.type,
                         timeout_s=timeout_s):
        raise RuntimeError("the process group did not form")
    descs = mh.global_descriptors([dev] * positions)
    span = Mesh(descs, group=dist.group.WORLD)
    one = Mesh([dev] * span.size)
    rep = {"rank": rank, "backend": dist.get_backend(),
           "span": list(span.span), "size": span.size}
    rep["functions"] = function_checks(span, one, dev)
    rep["sql"] = sql_checks(span, one, str(dev), sf)
    dist.barrier()
    dist.destroy_process_group()
    rep["seconds"] = time.perf_counter() - t0
    return rep


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(world: int = 2, positions: int = 4, device: str = "cpu",
           sf: float = 0.005, timeout_s: float = 60.0,
           limit_s: float = 240.0, out_dir: str = ".") -> list:
    """Start `world` processes of this module, wait for them (killed after
    limit_s) and return each one's report. Raises with a process's output
    when one fails."""
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    port = free_port()
    procs, outs = [], []
    for r in range(world):
        env = dict(os.environ)
        env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
        if device == "cuda":
            env["CUDA_VISIBLE_DEVICES"] = str(r)
        else:
            env["OMP_NUM_THREADS"] = "1"  # the processes share the cores
        path = os.path.join(out_dir, f"mesh_procs_{r}.json")
        outs.append(path)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "lingodb_tpu_torch.tools.mesh_procs",
             "--rank", str(r), "--world", str(world), "--port", str(port),
             "--positions", str(positions), "--device", device,
             "--sf", str(sf), "--timeout", str(timeout_s), "--out", path],
            env=env, cwd=repo, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    texts = []
    deadline = time.monotonic() + limit_s
    try:
        for p in procs:
            texts.append(p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        raise RuntimeError(f"the cluster did not finish in {limit_s} s")
    for r, (p, text) in enumerate(zip(procs, texts)):
        if p.returncode != 0:
            raise RuntimeError(f"process {r} failed ({p.returncode}):\n"
                               f"{text[-3000:]}")
    reps = []
    for path in outs:
        with open(path) as f:
            reps.append(json.load(f))
    return reps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--positions", type=int, default=4)
    ap.add_argument("--device", default="cpu", choices=("cpu", "cuda"))
    ap.add_argument("--sf", type=float, default=0.005)
    ap.add_argument("--timeout", type=float, default=60.0)
    ap.add_argument("--out", required=True)
    a = ap.parse_args(argv)
    rep = worker(a.rank, a.world, a.port, a.positions, a.device, a.sf,
                 a.timeout)
    with open(a.out, "w") as f:
        json.dump(rep, f, indent=1)
    print(f"rank {a.rank}: {json.dumps(rep['functions'])}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
