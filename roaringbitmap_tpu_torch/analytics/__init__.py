"""The analytics lane: BSI and RangeBitmap value columns as engine ops,
fused with the expression DAG.

Attach a column to a resident set (``DeviceBitmapSet.attach_column``), then
filter and aggregate in one batch on any rung::

    from roaringbitmap_tpu_torch.analytics import BsiColumn
    from roaringbitmap_tpu_torch.parallel import expr

    ds.attach_column(BsiColumn("price", row_ids, prices, device=ds.device))
    eng.execute([expr.ExprQuery(
        expr.sum_("price",
                  found=expr.and_(expr.or_(0, 1),
                                  expr.range_("price", lo, hi))))])
"""

from .column import BsiColumn, RangeColumn
from .two_phase import two_phase_execute

__all__ = ["BsiColumn", "RangeColumn", "two_phase_execute"]
