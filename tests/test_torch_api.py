"""The port's document API (`automerge_tpu_torch.api`, the frontend, the
plain DocSet and WatchableDoc) held to the reference's, on the CPU.

Every case of the reference's API test modules runs twice through
`torch_twin_helpers.run_twin`: on `automerge_tpu`, then with the names it
uses rebound to the port (`device="cpu"`). Its own assertions must hold on
the port, and every document it makes must match the reference's
(`save()` text and `save_binary` bytes equal, equal `oracle_state`, equal
diff records on a replay, each package loading the other's output).
Tolerance: exact.
"""

import pytest

from torch_twin_helpers import collect, run_twin

CASES = (
    collect("test_sequential")
    + collect("test_concurrent")
    + collect("test_proxies")
    + collect("test_transaction")
    + collect("test_text")
    + collect("test_undo_redo")
    + collect("test_immutable_frontend")
    + collect("test_docset_watchable_uuid")
)


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.id)
def test_reference_case_on_both_packages(case, tmp_path, monkeypatch):
    run_twin(case, tmp_path, monkeypatch)
