"""`ResidentRowsDocSet.materialize` of the port: a replay of the doc's log
through the interpretive frontend (`api.init` + `apply_changes_to_doc`),
as the reference's (`automerge_tpu/engine/resident_rows.py:2118-2170`).

Held to the reference's rows `materialize` and to a replay of the full
original log, on the CPU: a plain instance, after `archive_log_prefix`
(archive + RAM tail), and snapshot-booted (image + `remap_tail`, with and
without a post-boot archive folded into the tail). Tolerance: exact.
"""

import numpy as np
import pytest

from automerge_tpu.core.ids import ROOT_ID as REF_ROOT
from automerge_tpu.core.change import Change as RefChange, Op as RefOp
from automerge_tpu.engine.resident_rows import (
    ResidentRowsDocSet as RefRows)
from automerge_tpu.sync import snapshots as ref_snap
from automerge_tpu.sync.logarchive import LogArchive as RefArchive

from automerge_tpu_torch import api
from automerge_tpu_torch.core.change import Change, Op
from automerge_tpu_torch.core.ids import ROOT_ID
from automerge_tpu_torch.engine.batchdoc import oracle_state
from automerge_tpu_torch.engine.resident_rows import ResidentRowsDocSet
from automerge_tpu_torch.frontend.materialize import apply_changes_to_doc
from automerge_tpu_torch.sync import snapshots as snap
from automerge_tpu_torch.sync.logarchive import LogArchive

from test_torch_rows import history as concurrent_history
from test_torch_snapshots import move_history
from torch_port_helpers import build_history, changes_of, to_port


HISTORIES = {
    "text_and_map": lambda: changes_of(build_history()),
    "concurrent": lambda: concurrent_history(3),
    "moves": move_history,
}


def replay(changes) -> dict:
    """The port's interpretive replay of a whole log, as oracle_state."""
    doc = api.init("replay", device="cpu")
    return oracle_state(apply_changes_to_doc(
        doc, doc._doc.opset, to_port(changes), incremental=False,
        emit_diffs=False))


def test_the_sequence_that_raised_now_materializes():
    """One change to a fresh rows instance: materialize used to reach the
    docs-major decode and raise KeyError('ins_mask')."""
    port = ResidentRowsDocSet(["d"], device="cpu")
    port.apply_rounds([{"d": [Change("A", 1, {}, [
        Op("set", ROOT_ID, key="k", value=1)])]}])
    ref = RefRows(["d"])
    ref.apply_rounds([{"d": [RefChange("A", 1, {}, [
        RefOp("set", REF_ROOT, key="k", value=1)])]}])
    assert port.hashes().tolist() == ref.hashes().tolist() == [3591320333]
    assert port.materialize("d") == ref.materialize("d") == {
        "data": {"k": 1}, "conflicts": {}}


@pytest.mark.parametrize("native", [True, False])
def test_plain_instance_equals_the_reference(native):
    ids = list(HISTORIES)
    logs = {d: make() for d, make in HISTORIES.items()}
    ref = RefRows(ids, native=native)
    port = ResidentRowsDocSet(ids, device="cpu", native=native)
    ref.apply_rounds([logs])
    port.apply_rounds([{d: to_port(c) for d, c in logs.items()}])
    np.testing.assert_array_equal(port.hashes(), ref.hashes())
    for d in ids:
        got = port.materialize(d)
        assert got == ref.materialize(d) == replay(logs[d])


def test_archived_prefix_plus_tail_equals_the_reference(tmp_path):
    chs = changes_of(build_history())
    ref = RefRows(["doc"])
    port = ResidentRowsDocSet(["doc"], device="cpu")
    ref.log_archive = RefArchive(str(tmp_path / "ref"))
    port.log_archive = LogArchive(str(tmp_path / "port"))
    ref.apply_rounds([{"doc": chs}])
    port.apply_rounds([{"doc": to_port(chs)}])
    want = replay(chs)
    assert port.materialize("doc") == want
    floor = {"alice": chs[-8].seq}
    assert port.archive_log_prefix("doc", floor) \
        == ref.archive_log_prefix("doc", floor) > 0
    assert 0 < len(port.change_log[0]) < len(chs)
    assert port.materialize("doc") == ref.materialize("doc") == want


def _boot(pkg: str, tmp_path, chs, cut: int, archive_floor=None):
    """A snapshot-booted instance of one package: the image of chs[:cut]
    applied and seeded, its log emptied below the image's clock, then the
    rest of the log; optionally a post-boot archive pass."""
    conv = list if pkg == "ref" else to_port
    store = (ref_snap.SnapshotStore if pkg == "ref"
             else snap.SnapshotStore)(str(tmp_path / pkg / "snap"))
    comp = ref_snap.compact_prefix if pkg == "ref" else snap.compact_prefix
    store.write("doc", comp(conv(chs[:cut])))
    rset = RefRows(["doc"]) if pkg == "ref" \
        else ResidentRowsDocSet(["doc"], device="cpu")
    rset.snapshot_store = store
    img = store.load("doc")
    rset.apply_rounds([{"doc": img.columns().to_changes()}])
    rset.seed_clock("doc", img.clock, img.heads)
    rset.change_log[0] = []
    rset.log_horizon[0] = dict(img.clock)
    rset.apply_rounds([{"doc": conv(chs[cut:])}])
    if archive_floor is not None:
        rset.log_archive = (RefArchive if pkg == "ref" else LogArchive)(
            str(tmp_path / pkg / "arch"))
        rset.archive_log_prefix("doc", archive_floor)
    return rset


@pytest.mark.parametrize("archived", [False, True],
                         ids=["image+tail", "image+archived tail+tail"])
def test_snapshot_booted_equals_the_full_log(tmp_path, archived):
    chs = changes_of(build_history())
    cut = len(chs) - 6
    floor = {"alice": chs[-3].seq} if archived else None
    ref = _boot("ref", tmp_path, chs, cut, floor)
    port = _boot("port", tmp_path, chs, cut, floor)
    assert port.tables[0].snap_floor == ref.tables[0].snap_floor
    if archived:
        assert port.log_horizon == ref.log_horizon
        assert len(port.change_log[0]) == 2
    want = replay(chs)
    assert port.materialize("doc") == ref.materialize("doc") == want


def test_snapshot_booted_without_an_image_raises_as_the_reference(tmp_path):
    chs = changes_of(build_history())
    ref = _boot("ref", tmp_path, chs, len(chs) - 6)
    port = _boot("port", tmp_path, chs, len(chs) - 6)
    ref.snapshot_store = None
    port.snapshot_store = None
    with pytest.raises(RuntimeError, match="no local snapshot image"):
        ref.materialize("doc")
    with pytest.raises(RuntimeError, match="no local snapshot image"):
        port.materialize("doc")


def test_replay_runs_on_the_engines_device(monkeypatch):
    """The replay's OpSet is made on the instance's device."""
    want = replay(move_history())
    seen = []
    init = api.init

    def spy(actor_id=None, device="cuda"):
        seen.append(device)
        return init(actor_id, device)
    monkeypatch.setattr(api, "init", spy)
    port = ResidentRowsDocSet(["d"], device="cpu")
    port.apply_rounds([{"d": to_port(move_history())}])
    assert port.materialize("d") == want
    assert seen == [port.device]
