from .docset import DocSet
from .watchable import WatchableDoc
from .connection import Connection
from .service import EngineDocSet
from .logarchive import LogArchive
from .audit import ConvergenceAuditor

__all__ = ["DocSet", "WatchableDoc", "Connection", "EngineDocSet",
           "LogArchive", "ConvergenceAuditor"]
