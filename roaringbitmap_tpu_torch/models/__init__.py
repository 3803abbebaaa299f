"""The flagship wide-aggregation "model" (``models.flagship``)."""

from . import flagship

__all__ = ["flagship"]
