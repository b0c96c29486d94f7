"""UUID source with a swappable factory for deterministic tests.

Mirrors the behavior of Automerge's src/uuid.js:1-12: `make_uuid()` returns
a fresh v4 UUID string; `set_factory` swaps the generator (used by tests to get
deterministic object IDs); `reset` restores the default.
"""

from __future__ import annotations

import uuid as _uuid
from typing import Callable


def _default_factory() -> str:
    return str(_uuid.uuid4())


_factory: Callable[[], str] = _default_factory


def make_uuid() -> str:
    return _factory()


def set_factory(factory: Callable[[], str]) -> None:
    global _factory
    _factory = factory


def reset() -> None:
    global _factory
    _factory = _default_factory
