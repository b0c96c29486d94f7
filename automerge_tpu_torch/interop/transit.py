"""Transit-format interop with Automerge's save files (the port of
`automerge_tpu/interop/transit.py`, whole).

Automerge persists a document as the transit-JSON serialization of its
full change history: ``save = transit.toJSON(opSet.history)`` where
history is an Immutable.List of Immutable.Map change records (Automerge's
src/automerge.js:209-226, package.json's ``transit-immutable-js``
dependency). This module implements enough of the transit JSON format
(github.com/cognitect/transit-format) plus the transit-immutable-js
handlers to round-trip those saves, so documents saved by Automerge (or
by the reference package) load here and the other way round. It is host
code: no tensor, no device.

Format facts this codec implements:

- Composite forms (non-verbose JSON mode): JS arrays are JSON arrays; maps
  are ``["^ ", k1, v1, ...]``; tagged values are ``["~#tag", rep]``; a
  scalar at the top level is quoted as ``["~#'", scalar]``.
- transit-immutable-js writes Immutable.Map as tag ``iM`` with rep = a plain
  array of alternating key/value, Immutable.List as tag ``iL`` with rep = a
  plain array of items (plus ``iS``/``iOM``/``iOS`` for Set/OrderedMap/
  OrderedSet, accepted on read here).
- String escaping: a plain string starting with ``~``, ``^`` or a backtick
  is written with a ``~`` prefix; ``~:kw`` keywords, ``~$sym`` symbols,
  ``~i<digits>`` 64-bit ints, ``~d<float>`` doubles, ``~z{NaN,INF,-INF}``
  special floats are decoded to natural Python values.
- Caching: map keys and ``~:``/``~$``/``~#`` strings longer than 3 chars
  enter a write-order cache; later occurrences are emitted as ``"^<c>"``
  codes (index 0-43 -> ``^`` + chr(48+i); larger -> two base-44 digits;
  the cache resets when 44*44 entries fill). The reader mirrors the same
  rule, so codes assigned by transit-js resolve identically.

In an Automerge save the only cacheable strings are the ``~#iL``/``~#iM``
tags themselves (change fields live in iM rep *arrays*, where they are plain
strings, not map keys), so caching interops correctly as long as both sides
apply the spec rule — which this codec does in full generality anyway.
"""

from __future__ import annotations

import json
import math
from typing import Any

from ..core.change import Change

_CACHE_CODE_DIGITS = 44
_MAX_CACHE_ENTRIES = _CACHE_CODE_DIGITS * _CACHE_CODE_DIGITS
_BASE_CHAR_IDX = 48
# 2^53: beyond this transit-js writes "~i" strings to keep integer precision
_MAX_JSON_INT = 1 << 53


def _is_cacheable(s: str, as_map_key: bool) -> bool:
    if len(s) <= 3:
        return False
    return as_map_key or s[:2] in ("~:", "~$", "~#")


def _index_to_code(i: int) -> str:
    if i < _CACHE_CODE_DIGITS:
        return "^" + chr(i + _BASE_CHAR_IDX)
    hi, lo = divmod(i, _CACHE_CODE_DIGITS)
    return "^" + chr(hi + _BASE_CHAR_IDX) + chr(lo + _BASE_CHAR_IDX)


def _code_to_index(code: str) -> int:
    if len(code) == 2:
        return ord(code[1]) - _BASE_CHAR_IDX
    return ((ord(code[1]) - _BASE_CHAR_IDX) * _CACHE_CODE_DIGITS
            + (ord(code[2]) - _BASE_CHAR_IDX))


class _WriteCache:
    def __init__(self):
        self._codes: dict[str, str] = {}

    def encode(self, s: str, as_map_key: bool) -> str:
        """Return the cache code for a repeat occurrence, else record s."""
        if not _is_cacheable(s, as_map_key):
            return s
        code = self._codes.get(s)
        if code is not None:
            return code
        if len(self._codes) >= _MAX_CACHE_ENTRIES:
            self._codes.clear()
        self._codes[s] = _index_to_code(len(self._codes))
        return s


class _ReadCache:
    def __init__(self):
        self._entries: list[str] = []

    def note(self, s: str, as_map_key: bool) -> None:
        if _is_cacheable(s, as_map_key):
            if len(self._entries) >= _MAX_CACHE_ENTRIES:
                self._entries.clear()
            self._entries.append(s)

    def lookup(self, code: str) -> str:
        idx = _code_to_index(code)
        if idx >= len(self._entries):
            raise ValueError(f"transit: cache code {code!r} out of range")
        return self._entries[idx]


# ---------------------------------------------------------------------------
# Writer


def _escape(s: str) -> str:
    if s and s[0] in ("~", "^", "`"):
        return "~" + s
    return s


def _emit(value: Any, cache: _WriteCache, as_map_key: bool = False):
    if isinstance(value, str):
        return cache.encode(_escape(value), as_map_key)
    if value is None or isinstance(value, bool):
        if as_map_key:
            return cache.encode(
                "~?t" if value is True else ("~?f" if value is False else "~_"),
                as_map_key)
        return value
    if isinstance(value, int):
        if -_MAX_JSON_INT < value < _MAX_JSON_INT and not as_map_key:
            return value
        return cache.encode(f"~i{value}", as_map_key)
    if isinstance(value, float):
        if math.isnan(value):
            return "~zNaN"
        if math.isinf(value):
            return "~zINF" if value > 0 else "~z-INF"
        if as_map_key:
            return cache.encode(f"~d{value!r}", as_map_key)
        return value
    if isinstance(value, dict):
        # Immutable.Map the way transit-immutable-js writes it: tag iM with
        # an alternating key/value *array* rep (keys are array elements, so
        # they are not map-key-cacheable — matching the reference output).
        tag = cache.encode("~#iM", False)   # tag precedes the rep on the
        rep: list[Any] = []                 # wire, so it must be cached first
        for k, v in value.items():
            rep.append(_emit(k, cache))
            rep.append(_emit(v, cache))
        return [tag, rep]
    if isinstance(value, (list, tuple)):
        tag = cache.encode("~#iL", False)
        return [tag, [_emit(v, cache) for v in value]]
    raise TypeError(f"transit: cannot serialize {type(value).__name__}")


def dumps(value: Any) -> str:
    """Serialize a Python value in transit-immutable-js JSON form.

    dicts become Immutable.Map (tag iM), lists Immutable.List (tag iL);
    a scalar top level is quoted with the ``'`` tag as transit requires.
    """
    cache = _WriteCache()
    encoded = _emit(value, cache)
    if not isinstance(encoded, list):
        encoded = [cache.encode("~#'", False), encoded]
    return json.dumps(encoded, separators=(",", ":"))


# ---------------------------------------------------------------------------
# Reader


def _decode_string(s: str, cache: _ReadCache, as_map_key: bool) -> Any:
    if s.startswith("^") and s != "^ ":
        s = cache.lookup(s)
        return _parse_marked(s)
    cache.note(s, as_map_key)
    return _parse_marked(s)


def _parse_marked(s: str) -> Any:
    if not s.startswith("~"):
        return s
    if len(s) >= 2 and s[1] in ("~", "^", "`"):
        return s[1:]
    tag = s[1:2]
    rest = s[2:]
    if tag == ":" or tag == "$":
        return rest            # keywords/symbols surface as plain strings
    if tag == "i":
        return int(rest)
    if tag == "d":
        return float(rest)
    if tag == "z":
        return {"NaN": math.nan, "INF": math.inf, "-INF": -math.inf}[rest]
    if tag == "?":
        return rest == "t"
    if tag == "_":
        return None
    if tag == "u" or tag == "r":
        return rest            # uuid / URI as string
    if tag == "#":
        raise ValueError(f"transit: bare tag {s!r} outside tagged array")
    return s                   # unknown scalar tag: surface verbatim


def _decode(j: Any, cache: _ReadCache, as_map_key: bool = False) -> Any:
    if isinstance(j, str):
        return _decode_string(j, cache, as_map_key)
    if j is None or isinstance(j, (bool, int, float)):
        return j
    if isinstance(j, list):
        if not j:
            return []
        head = j[0]
        if isinstance(head, str):
            if head == "^ ":
                out: dict[Any, Any] = {}
                for i in range(1, len(j) - 1, 2):
                    k = _decode(j[i], cache, as_map_key=True)
                    out[k] = _decode(j[i + 1], cache)
                return out
            if head.startswith("^"):
                head = cache.lookup(head)
            elif _is_cacheable(head, False):
                cache.note(head, False)
            if head.startswith("~#") and len(j) == 2:
                return _decode_tagged(head[2:], j[1], cache)
            # not a tag: fall through to a plain array (head already
            # resolved/cached above; decode remaining elements)
            return [_parse_marked(head) if isinstance(head, str) else head] + [
                _decode(x, cache) for x in j[1:]]
        return [_decode(x, cache) for x in j]
    if isinstance(j, dict):   # verbose-mode map
        return {_decode(k, cache, as_map_key=True): _decode(v, cache)
                for k, v in j.items()}
    raise ValueError(f"transit: cannot decode {type(j).__name__}")


def _decode_tagged(tag: str, rep: Any, cache: _ReadCache) -> Any:
    if tag == "'":
        return _decode(rep, cache)
    if tag == "iL" or tag == "iStk":
        return [_decode(x, cache) for x in rep]
    if tag in ("iM", "iOM"):
        rep = [_decode(x, cache) for x in rep]
        return {rep[i]: rep[i + 1] for i in range(0, len(rep) - 1, 2)}
    if tag in ("iS", "iOS"):
        return [_decode(x, cache) for x in rep]
    if tag == "list" or tag == "set":     # core transit composite tags
        return _decode(rep, cache)
    if tag == "cmap":
        rep = _decode(rep, cache)
        return {rep[i]: rep[i + 1] for i in range(0, len(rep) - 1, 2)}
    raise ValueError(f"transit: unknown tag {tag!r}")


def loads(data: str | bytes) -> Any:
    """Parse transit-immutable-js JSON into plain Python values."""
    if isinstance(data, bytes):
        data = data.decode("utf-8")
    return _decode(json.loads(data), _ReadCache())


# ---------------------------------------------------------------------------
# Change-history (de)serialization — the reference save format


def changes_to_transit(changes) -> str:
    """Serialize a change list the way ``Automerge.save`` does: the history
    as an Immutable List of change Maps (automerge.js:223-226)."""
    return dumps([c.to_dict() for c in changes])


def changes_from_transit(data: str | bytes) -> list[Change]:
    """Parse a transit-serialized change history (a reference save file)."""
    decoded = loads(data)
    if not isinstance(decoded, list):
        raise ValueError("transit save: expected a List of changes")
    for rec in decoded:
        if not isinstance(rec, dict):
            raise ValueError("transit save: change record is not a Map")
    return [Change.from_dict(rec) for rec in decoded]
