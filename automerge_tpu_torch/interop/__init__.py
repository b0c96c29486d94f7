"""Interop with Automerge's on-disk formats."""

from .transit import (changes_from_transit, changes_to_transit, dumps, loads)

__all__ = ["changes_from_transit", "changes_to_transit", "dumps", "loads"]
