from . import spec
from .spec import InvalidRoaringFormat, SerializedView, deserialize, serialize

__all__ = ["spec", "InvalidRoaringFormat", "SerializedView", "deserialize",
           "serialize"]
