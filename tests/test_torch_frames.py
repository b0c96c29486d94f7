"""The port's wire frames (`automerge_tpu_torch/sync/frames.py`) against
the reference's: AMW1 and AMR1 frames of the same changes are byte-equal,
each package decodes the other's frames to the same changes, and the codec
cases of tests/test_frames.py (every value type, relay re-encode, empty
lists, the magic and trailing-byte checks, messages and deps) hold.
Tolerance: exact (bytes and changes)."""

import numpy as np
import pytest

import automerge_tpu as am
from automerge_tpu.sync import frames as ref_frames

from automerge_tpu_torch.core.change import Change, Op
from automerge_tpu_torch.core.ids import ROOT_ID
from automerge_tpu_torch.native.wire import changes_to_columns
from automerge_tpu_torch.sync.frames import (
    FRAME_MAGIC, ROUND_MAGIC, RoundColumns, bytes_to_columns,
    columns_to_bytes, decode_frame, decode_round_frame, encode_frame,
    encode_round_frame, round_from_columns, round_from_parts)

from torch_port_helpers import to_port


def trace_changes():
    d = am.change(am.init("A"), lambda d: am.assign(d, {
        "i": 7, "f": 3.25, "b": True, "s": "héllo\ud800x", "big": 2 ** 70,
        "neg": -(2 ** 63), "null": None,
        "nest": {"deep": [1, "two", False]}}))
    d = am.change(d, lambda doc: doc.__delitem__("i"))
    d = am.change(d, lambda doc: doc.__setitem__("t", am.Text()))
    d = am.change(d, "a message", lambda doc: doc["t"].insert_at(0, *"ab"))
    e = am.merge(am.init("B"), d)
    e = am.change(e, lambda doc: doc["t"].delete_at(0))
    m = am.merge(d, e)
    return m._doc.opset.get_missing_changes({})


def unicode_changes():
    s = am.change(am.init("actor-ü"), 'msg "q" \\ ☃',
                  lambda d: d.__setitem__("k", "héllo\n\t☃ \"x\" 𝄞"))
    return s._doc.opset.get_missing_changes({})


CASES = {"trace": trace_changes, "unicode": unicode_changes,
         "empty": lambda: []}


@pytest.mark.parametrize("name", list(CASES))
def test_frames_are_byte_equal_and_cross_decode(name):
    ref_chs = CASES[name]()
    chs = to_port(ref_chs)
    data = encode_frame(chs)
    assert data == ref_frames.encode_frame(ref_chs)
    assert data.startswith(FRAME_MAGIC)
    assert decode_frame(ref_frames.encode_frame(ref_chs)).to_changes() == chs
    assert [c.to_dict() for c in ref_frames.decode_frame(data).to_changes()] \
        == [c.to_dict() for c in ref_chs]
    cols = decode_frame(data)
    assert cols.frame_bytes == data
    assert columns_to_bytes(cols) == data      # relay: no per-op work


@pytest.mark.parametrize("name", list(CASES))
def test_round_frames_are_byte_equal_and_cross_decode(name):
    ref_chs = CASES[name]()
    half = len(ref_chs) // 2
    ref_round = {"doc-ü": ref_chs[:half], "d2": ref_chs[half:], "d3": []}
    rnd = {d: to_port(c) for d, c in ref_round.items()}
    data = encode_round_frame(rnd)
    assert data == ref_frames.encode_round_frame(ref_round)
    assert data.startswith(ROUND_MAGIC)
    rc = decode_round_frame(data)
    assert rc.doc_ids == list(rnd)
    assert rc.to_dict() == rnd
    theirs = ref_frames.decode_round_frame(data)
    assert theirs.doc_ids == rc.doc_ids
    np.testing.assert_array_equal(np.asarray(theirs.change_off),
                                  np.asarray(rc.change_off))
    assert rc.cols.frame_bytes == ref_frames.encode_frame(ref_chs)
    ours_of_theirs = decode_round_frame(
        ref_frames.encode_round_frame(ref_round))
    assert ours_of_theirs.to_dict() == rnd


def test_round_from_columns_matches_the_reference():
    """A round coalesced from per-doc columns: the same merged frame
    bytes and doc table as the reference builds from the same parts."""
    ref_chs = trace_changes()
    parts = {"a": ref_chs[:2], "b": ref_chs[2:]}
    rc = round_from_columns({d: changes_to_columns(to_port(c))
                             for d, c in parts.items()})
    want = ref_frames.round_from_columns(
        {d: ref_frames.changes_to_columns(c) for d, c in parts.items()})
    assert rc.cols.frame_bytes == want.cols.frame_bytes
    assert rc.doc_ids == want.doc_ids
    np.testing.assert_array_equal(rc.change_off, want.change_off)
    multi = round_from_parts({"a": [changes_to_columns(to_port(c))
                                    for c in (ref_chs[:1], ref_chs[1:2])]})
    assert isinstance(multi, RoundColumns)
    assert multi.to_dict() == {"a": to_port(ref_chs[:2])}


def test_round_trip_all_value_types():
    chs = to_port(trace_changes())
    assert decode_frame(encode_frame(chs)).to_changes() == chs


def test_empty_change_list():
    assert decode_frame(encode_frame([])).to_changes() == []
    assert decode_round_frame(encode_round_frame({})).to_dict() == {}


def test_magic_check():
    with pytest.raises(ValueError, match="magic"):
        decode_frame(b"JUNKJUNKJUNK")
    with pytest.raises(ValueError, match="magic"):
        decode_round_frame(b"JUNKJUNKJUNK")


def test_trailing_bytes_rejected():
    with pytest.raises(ValueError, match="trailing"):
        bytes_to_columns(encode_frame(to_port(trace_changes())) + b"x")


def test_type_fidelity_beats_json():
    """int, float and bool stay apart (JSON would blur 1 and 1.0)."""
    chs = [Change("A", 1, {}, [Op("set", ROOT_ID, key="a", value=1),
                               Op("set", ROOT_ID, key="b", value=1.0),
                               Op("set", ROOT_ID, key="c", value=True)])]
    vals = [op.value for op in decode_frame(encode_frame(chs))
            .to_changes()[0].ops]
    assert vals == [1, 1.0, True]
    assert [type(v) for v in vals] == [int, float, bool]


def test_message_and_deps_preserved():
    chs = [Change("A", 3, {"B": 2, "C": 9},
                  [Op("set", ROOT_ID, key="k", value="v")], "why not")]
    assert decode_frame(encode_frame(chs)).to_changes() == chs
