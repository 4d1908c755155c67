"""The port's mesh across processes (lingodb_tpu_torch/parallel/mesh.py,
shuffle.py and the executor over a mesh whose group spans processes), on
the CPU: two spawned processes of 4 positions each under gloo, every
collective bounded by a 60 s timeout, each process killed by its own
communicate(timeout=...).

Each process runs lingodb_tpu_torch/tools/mesh_procs.py: every mesh and
shuffle function over the spanning mesh against the one-process mesh of
8 positions (which tests/test_torch_shuffle.py holds against the JAX
package's), shard for shard; then TPC-H q3, q1, q6, three of the shuffle
checks and a TopK over a filtered scan at sf 0.005, whose rows must equal
the one-process mesh's and the one-card session's, and be the same on
both processes. One cluster serves every test of the module (about 15 s);
the run at sf 0.02 is marked slow.
"""

import pytest

from lingodb_tpu_torch.tools import mesh_procs as mp

LIMIT_S = 240.0


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh_procs")
    reps = mp.launch(world=2, positions=4, device="cpu", sf=0.005,
                     timeout_s=60.0, limit_s=LIMIT_S, out_dir=str(out))
    assert [r["rank"] for r in reps] == [0, 1]
    return reps


def test_the_group_and_the_spans(cluster):
    for r, rep in enumerate(cluster):
        assert rep["backend"] == "gloo"
        assert rep["size"] == 8
        assert rep["span"] == [4 * r, 4 * r + 4]


@pytest.mark.parametrize("name", mp.FUNCTIONS)
def test_function_equals_the_one_process_mesh(cluster, name):
    for rep in cluster:
        assert rep["functions"][name] is True, (rep["rank"], name)


@pytest.mark.parametrize("name", list(mp.STATEMENTS))
def test_statement_rows_equal_on_every_process(cluster, name):
    """The spanning mesh's rows equal the one-process mesh's and the
    one-card session's on each process, and both processes return the same
    rows; the strategies that ran are those of the one-process mesh."""
    got = [rep["sql"][name] for rep in cluster]
    for g in got:
        assert g["equal"], (name, g)
        assert g["rows"] > 0
        assert g["stats"] == g["stats_one"], g
    assert got[0]["digest"] == got[1]["digest"]
    assert got[0]["stats"] == got[1]["stats"]


def test_every_strategy_crossed_the_processes(cluster):
    """Over the statements the exchange, the sharded join, both groupings'
    rounds, the skew split, the sample sort and a gather at an operator's
    input all ran across the two processes."""
    moved = {}
    for g in cluster[0]["sql"].values():
        for k, v in g["stats"].items():
            moved[k] = moved.get(k, 0) + v
    assert all(moved[k] > 0 for k in ("exchanges", "joins", "groupbys",
                                       "skew_splits", "sorts", "gathers")), moved


@pytest.mark.slow
def test_larger_cluster_run(tmp_path):
    """The same at sf 0.02 (lineitem about 120,000 rows)."""
    reps = mp.launch(world=2, positions=4, device="cpu", sf=0.02,
                     timeout_s=60.0, limit_s=600.0, out_dir=str(tmp_path))
    for name in mp.STATEMENTS:
        assert all(rep["sql"][name]["equal"] for rep in reps), name
        assert reps[0]["sql"][name]["digest"] == reps[1]["sql"][name]["digest"]
    assert all(all(rep["functions"].values()) for rep in reps)
