from . import errors, faults, guard
from .cache import LRUCache

__all__ = ["LRUCache", "errors", "faults", "guard"]
