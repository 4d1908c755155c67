"""lingodb_tpu_torch: the PyTorch/CUDA port of the lingodb_tpu SQL engine.

SQL text in, rows out, on one NVIDIA GPU: parse -> bind -> optimize ->
execute as whole-column torch operators, with hand-written CUDA kernels
(csrc/) for the gathers and the stream compaction on the hot path. The
package imports torch and never jax, and nothing of the JAX package it was
ported from.

    import lingodb_tpu_torch as ldb
    s = ldb.create_in_memory()              # the CUDA card; raises without one
    s = ldb.create_in_memory(device="cpu")  # explicit host run (tests)
    s.sql_stmt("CREATE TABLE t(a INT)"); s.sql_stmt("INSERT INTO t VALUES (1)")
    s.sql("SELECT * FROM t").format_rows()
"""

from .session import Session, connect_to_db, create_in_memory  # noqa: F401

__all__ = ["Session", "connect_to_db", "create_in_memory"]
