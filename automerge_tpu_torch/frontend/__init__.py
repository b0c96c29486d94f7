from .text import Text
from .snapshots import FrozenMap, FrozenList, DocState

__all__ = ["Text", "FrozenMap", "FrozenList", "DocState"]
