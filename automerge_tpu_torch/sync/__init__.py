from .docset import DocSet
from .watchable import WatchableDoc
from .connection import Connection
from .service import EngineDocSet
from .sharded_service import ShardedEngineDocSet
from .logarchive import LogArchive
from .audit import ConvergenceAuditor

__all__ = ["DocSet", "WatchableDoc", "Connection", "EngineDocSet",
           "ShardedEngineDocSet", "LogArchive", "ConvergenceAuditor"]
