"""The two-phase baseline the fused analytics lane is compared with
(``roaringbitmap_tpu.analytics.two_phase``).

Without the fused lane, a filter-then-aggregate request runs as two
dispatches with a host round trip between them: (1) the filter expression
through the engine as a bitmap-form root, its rows read back and unpacked
on the host, then (2) that bitmap densified again over the column's keys
and the aggregate run as its own dispatch (``Column.device_agg``).  The
fused path does without the readback, the second upload and the second
dispatch.
"""

from __future__ import annotations


def two_phase_execute(engine, queries, engine_rung: str = "auto"):
    """Run aggregate-rooted ExprQuerys the two-dispatch way; the results
    equal the fused path's, only the launches and round trips differ."""
    from ..parallel import expr as expr_mod
    from ..parallel.batch_engine import BatchResult

    out = []
    for q in queries:
        if not isinstance(q, expr_mod.ExprQuery):
            raise ValueError("two_phase_execute takes ExprQuerys")
        e = expr_mod.canonicalize(q.expr)
        if not isinstance(e, expr_mod.Agg):
            raise ValueError(
                "two_phase_execute models filter-then-aggregate: the "
                "root must be sum_/top_k")
        col = engine._column(e.col)
        if e.found is None:
            found = col.host_filter("ge", 0)    # the whole stored domain
        else:
            found = engine.execute(
                [expr_mod.ExprQuery(e.found, form="bitmap")],
                engine=engine_rung)[0].bitmap
        if e.kind == "sum":
            total, count = col.device_agg("sum", found)
            out.append(BatchResult(cardinality=count, value=total))
        else:
            bm = col.device_agg("topk", found, k=e.k)
            out.append(BatchResult(
                cardinality=bm.cardinality,
                bitmap=bm if q.form == "bitmap" else None))
    return out
