from . import build, dense, kernels, packing, words

__all__ = ["build", "dense", "kernels", "packing", "words"]
