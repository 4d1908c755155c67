"""The port's multi-process scaffold (lingodb_tpu_torch/parallel/
multihost.py): the host-major order and the exchange plan against the JAX
package's on the same fake device descriptors, the single-process no-op,
and (marked slow: it spawns processes) a real two-process group over gloo,
4 CPU positions each, that builds the 8-position mesh and runs the global
psum of the JAX package's tests/test_multihost.py."""

import os
import socket
import subprocess
import sys
import textwrap

import pytest

from lingodb_tpu.parallel import multihost as ref_mh

from lingodb_tpu_torch.parallel import multihost as mh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _Dev:
    def __init__(self, pid, did):
        self.process_index = pid
        self.id = did

    def __repr__(self):
        return f"d{self.process_index}.{self.id}"


def test_host_major_order_and_groups():
    # devices reported interleaved -> host-major
    devs = [_Dev(1, 0), _Dev(0, 1), _Dev(1, 1), _Dev(0, 0)]
    ordered = mh.host_major_order(devs)
    assert [(d.process_index, d.id) for d in ordered] == [
        (0, 0), (0, 1), (1, 0), (1, 1)]
    assert ordered == ref_mh.host_major_order(devs)
    assert mh.host_groups(devs) == ref_mh.host_groups(devs) == [[0, 1], [2, 3]]


def test_exchange_plan_math():
    devs = [_Dev(p, d) for p in range(2) for d in range(4)]
    plan = mh.exchange_plan(devs)
    ref = ref_mh.exchange_plan(devs)
    assert (plan.n_hosts, plan.per_host) == (ref.n_hosts, ref.per_host) == (2, 4)
    assert plan.dest_host(0) == 0 and plan.dest_host(5) == 1
    assert [plan.dest_host(r) for r in range(8)] == \
        [ref.dest_host(r) for r in range(8)]
    assert plan.dcn_lanes() == ref.dcn_lanes() == [(0, 1), (1, 0)]
    # 2 hosts x 4 ranks x 3 peers: lanes that stay inside a host
    assert plan.ici_lanes() == ref.ici_lanes() == 24


def test_exchange_plan_rejects_ragged_hosts():
    devs = [_Dev(0, 0), _Dev(0, 1), _Dev(1, 0)]
    with pytest.raises(ValueError):
        mh.exchange_plan(devs)
    with pytest.raises(ValueError):
        ref_mh.exchange_plan(devs)


def test_initialize_noop_single_process(monkeypatch):
    monkeypatch.delenv("LINGODB_COORDINATOR", raising=False)
    assert mh.initialize() is False
    assert mh.initialize(num_processes=1, coordinator="x:1") is False
    assert ref_mh.initialize(num_processes=1, coordinator="x:1") is False
    assert mh.process_index() == 0
    assert mh.process_span([_Dev(0, 0), _Dev(0, 1)]) == (0, 2)


_WORKER = textwrap.dedent("""
    import sys
    import torch
    import torch.distributed as dist
    from lingodb_tpu_torch.parallel import multihost as mh
    from lingodb_tpu_torch.parallel.mesh import Mesh, psum, shard_rows

    pid, port = int(sys.argv[1]), sys.argv[2]
    ok = mh.initialize(coordinator=f"127.0.0.1:{port}", num_processes=2,
                       process_id=pid, device_type="cpu")
    assert ok, "distributed init failed"
    assert dist.get_world_size() == 2 and dist.get_backend() == "gloo"
    assert mh.initialize(coordinator=f"127.0.0.1:{port}", num_processes=2,
                         process_id=pid) is True  # idempotent
    descs = mh.global_descriptors(["cpu"] * 4)
    assert len(descs) == 8, descs
    plan = mh.exchange_plan(descs)
    assert plan.n_hosts == 2 and plan.per_host == 4
    mesh = Mesh(descs, group=dist.group.WORLD)
    assert mesh.span == (4 * pid, 4 * pid + 4) and mesh.spans_processes()
    # every process holds its own 4 shards of an 8 * 1024 row column; the
    # global sum is one psum through the process group
    rows = 8 * 1024
    col = shard_rows(mesh, torch.arange(rows, dtype=torch.int64))
    assert len(col.shards) == 4 and col.local_len == 1024
    assert int(col.shards[0][0]) == 4 * pid * 1024
    total = psum(mesh, [s.sum() for s in col.shards])
    assert len(total) == 4
    assert all(int(t) == rows * (rows - 1) // 2 for t in total), total
    print(f"proc {pid} OK total={int(total[0])}")
    dist.destroy_process_group()
""")


@pytest.mark.slow
def test_two_process_cpu_cluster(tmp_path):
    """Spawn 2 processes x 4 CPU positions; build the global mesh and run a
    sharded reduction through torch.distributed (gloo)."""
    w = tmp_path / "worker.py"
    w.write_text(_WORKER)
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = str(s.getsockname()[1])
    s.close()
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    procs = [subprocess.Popen([sys.executable, str(w), str(i), port],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for i in range(2)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("multi-process cluster timed out")
        outs.append(out)
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {i} failed:\n{out[-2000:]}"
        assert f"proc {i} OK" in out
