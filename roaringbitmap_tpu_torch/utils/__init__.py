from . import datasets

__all__ = ["datasets"]
