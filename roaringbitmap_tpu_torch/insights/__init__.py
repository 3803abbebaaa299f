"""Insights: container-mix analysis and writer advice, the resident layout
choice and the dispatch footprint model."""

from .analysis import (
    ROW_BYTES,
    BitmapAnalyser,
    BitmapStatistics,
    NaiveWriterRecommender,
    analyse,
    choose_layout,
    dense_rows_bytes,
)

__all__ = ["BitmapAnalyser", "BitmapStatistics", "NaiveWriterRecommender",
           "analyse", "ROW_BYTES", "choose_layout", "dense_rows_bytes"]
