"""The mesh across cards, on a machine with two or more of them: the mesh
that spans processes under NCCL (tools/mesh_procs.py with 2 and with 4
processes of one card each), a one-process mesh over every card against a
mesh of as many positions on card 0 and against no mesh (the statements of
mesh_procs over its tables at sf 0.5; rows, wall ms of a second run and the
shuffle.STATS moved; the fused aggregate runs on every card), and the copy
rate between cards (1 GiB, 5 copies). Run it after a change to the mesh's
code on a machine of two or more cards.

    python3 -m lingodb_tpu_torch.tools.cards_check

Writes the processes' reports under chiprun_out/ and prints one line a
check.
"""

import json
import os
import sys
import time


def main() -> int:
    sys.path.insert(0, os.getcwd())
    import torch

    print("cards", torch.cuda.device_count(), flush=True)
    from lingodb_tpu_torch.tools import mesh_procs as mp

    os.makedirs("chiprun_out", exist_ok=True)
    out = {}
    for world in (2, 4):
        t0 = time.perf_counter()
        reps = mp.launch(world=world, positions=1, device="cuda", sf=0.05,
                         timeout_s=60.0, limit_s=400.0, out_dir="chiprun_out")
        ok_f = all(all(r["functions"].values()) for r in reps)
        ok_s = all(all(g["equal"] for g in r["sql"].values()) for r in reps)
        same = all(len({r["sql"][n]["digest"] for r in reps}) == 1
                   for n in reps[0]["sql"])
        out[f"procs{world}"] = {
            "backend": reps[0]["backend"], "functions_equal": ok_f,
            "sql_equal": ok_s, "same_on_every_process": same,
            "seconds": time.perf_counter() - t0,
            "stats": {n: g["stats"] for n, g in reps[0]["sql"].items()}}
        print("procs", world, json.dumps(out[f"procs{world}"]), flush=True)
    # one process, a mesh over every card, against one card
    import lingodb_tpu_torch as ldb
    from lingodb_tpu_torch.parallel import shuffle as sh
    from lingodb_tpu_torch.parallel.mesh import Mesh
    from lingodb_tpu_torch.runtime import device as dv

    n = torch.cuda.device_count()
    s = ldb.create_in_memory(device="cuda:0")
    mp.install(s, 0.5)
    cards = Mesh([torch.device("cuda", i) for i in range(n)])
    one = Mesh([torch.device("cuda", 0)] * n)
    for name, sql in mp.STATEMENTS.items():
        if isinstance(sql, int):
            sql = open(f"queries/tpch/{sql}.sql").read()
        res = {}
        for label, mesh in (("none", None), ("one", one), ("cards", cards)):
            dv._MESH, dv._MESH_INIT = mesh, True
            s.sql(sql)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            before = dict(sh.STATS)
            rows = s.sql(sql).format_rows()
            for i in range(n):
                torch.cuda.synchronize(i)
            res[label] = (rows, (time.perf_counter() - t0) * 1e3,
                          {k: sh.STATS[k] - before[k] for k in sh.STATS})
        dv._MESH = None
        print("cards", name, "equal",
              res["cards"][0] == res["one"][0] == res["none"][0],
              "rows", len(res["none"][0]),
              "ms none/one/cards %.2f / %.2f / %.2f" % (
                  res["none"][1], res["one"][1], res["cards"][1]),
              json.dumps(res["cards"][2]), flush=True)
    print("graph stores (one a card the fused programs ran on):",
          len(s.graph_stores()), flush=True)
    # copies between cards: 1 GiB cuda:0 -> cuda:1, the reverse, and within
    x = torch.empty(1 << 30, dtype=torch.uint8, device="cuda:0")
    for src, dst in ((0, 1), (1, 0), (0, 0)):
        a = x.to(f"cuda:{src}")
        b = torch.empty_like(a, device=f"cuda:{dst}")
        b.copy_(a)
        torch.cuda.synchronize(src)
        torch.cuda.synchronize(dst)
        t0 = time.perf_counter()
        for _ in range(5):
            b.copy_(a)
        torch.cuda.synchronize(src)
        torch.cuda.synchronize(dst)
        dt = (time.perf_counter() - t0) / 5
        print(f"copy cuda:{src} -> cuda:{dst}: {dt * 1e3:.3f} ms for 1 GiB, "
              f"{(1 << 30) / dt / 1e9:.1f} GB/s", flush=True)
    print("peer access 0->1", torch.cuda.can_device_access_peer(0, 1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
