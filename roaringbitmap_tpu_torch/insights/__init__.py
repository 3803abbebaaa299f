from .analysis import ROW_BYTES, choose_layout, dense_rows_bytes

__all__ = ["ROW_BYTES", "choose_layout", "dense_rows_bytes"]
