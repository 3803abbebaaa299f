from .cache import LRUCache

__all__ = ["LRUCache"]
