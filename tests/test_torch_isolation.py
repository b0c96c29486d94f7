"""The port imports neither jax nor the JAX package, and its entry points
run on the card unless the caller asks for the CPU."""

import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import automerge_tpu_torch

REPO = Path(__file__).resolve().parent.parent


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        automerge_tpu_torch.__path__, "automerge_tpu_torch."))


def test_every_module_imports_with_jax_and_reference_blocked():
    mods = _modules()
    for m in ("engine.resident_rows", "engine.cuda_kernels",
              "engine.span_kernels", "engine.move_kernels",
              "engine.dispatch", "core.moves", "core.textspans",
              "workloads", "engine.resident", "engine.diffs",
              "engine.batchdoc",
              "engine.kernels", "engine.pack", "native.wire",
              "native.delta", "native.linearize", "sync.frames",
              "utils.gcpause", "storage", "linearize_schedule",
              "move_schedule", "compare_kernels", "engine.dispatchledger",
              "utils.metrics", "engine.compaction", "sync.logarchive",
              "sync.snapshots", "utils.lockprof", "utils.chaos", "api",
              "core.opset", "core.clock", "core.elems", "core.bulkload",
              "frontend.context", "frontend.proxies", "frontend.array_ops",
              "frontend.text", "frontend.cursors", "frontend.snapshots",
              "frontend.materialize", "frontend.immutable_view",
              "sync.docset", "sync.watchable", "utils.persist",
              "utils.uuid"):
        assert f"automerge_tpu_torch.{m}" in mods, m
    code = "\n".join([
        "import importlib, sys",
        "for name in ('jax', 'jaxlib', 'automerge_tpu'):",
        "    sys.modules[name] = None",
        f"for m in {mods!r}:",
        "    importlib.import_module(m)",
        "bad = [m for m in sys.modules if sys.modules[m] is not None",
        "       and m.split('.')[0] in ('jax', 'jaxlib', 'automerge_tpu')]",
        "assert not bad, bad",
        "from automerge_tpu_torch.engine.resident_rows import "
        "ResidentRowsDocSet",
        "ResidentRowsDocSet(['a', 'b'], device='cpu').hashes()",
        "from automerge_tpu_torch.engine.resident import ResidentDocSet",
        "from automerge_tpu_torch.engine.batchdoc import apply_batch",
        "from automerge_tpu_torch.workloads import docset_fleet",
        "ids, initial, rounds = docset_fleet(n_docs=3, rounds=1)",
        "ds = ResidentDocSet(ids, device='cpu')",
        "ds.apply_and_reconcile(initial)",
        "ds.apply_changes(rounds[0])",
        "ds.hashes_for([0]); ds.materialize(ids[0])",
        "_, recs = ResidentDocSet(ids, device='cpu').apply_and_reconcile(",
        "    initial, diffs=True)",
        "from automerge_tpu_torch.engine.diffs import MirrorDoc",
        "m = MirrorDoc(); m.apply(recs[ids[0]])",
        "apply_batch([initial[i] for i in ids], device='cpu')",
        "from automerge_tpu_torch.sync.frames import (decode_frame,",
        "    encode_frame, encode_round_frame)",
        "rows = ResidentRowsDocSet(ids, device='cpu')",
        "h = rows.apply_round_frames([encode_round_frame(initial),",
        "                             encode_round_frame(rounds[0])])",
        "cds = ResidentDocSet(ids, device='cpu')",
        "cds.apply_and_reconcile_columns(",
        "    {d: decode_frame(encode_frame(c)) for d, c in initial.items()})",
        "got = cds.apply_and_reconcile_columns(",
        "    {d: decode_frame(encode_frame(c)) for d, c in rounds[0].items()})",
        "from automerge_tpu_torch.engine.cuda_kernels import hashes_to_numpy",
        "assert (hashes_to_numpy(h)[:len(ids)] == got).all()",
        "from automerge_tpu_torch.engine.dispatch import (",
        "    merge_spans_adaptive, resolve_moves_adaptive)",
        "from automerge_tpu_torch.engine.pack import pack_moves",
        "from automerge_tpu_torch.workloads import move_storm, span_fleet",
        "merge_spans_adaptive(span_fleet(n_docs=3)[0], device='cpu')",
        "resolve_moves_adaptive(pack_moves([move_storm(n_objs=90, "
        "n_moves=80)]), device='cpu')",
        "from automerge_tpu_torch import api",
        "a = api.init('A', device='cpu')",
        "a = api.change(a, lambda d: d.__setitem__('k', [1, 2]))",
        "b = api.change(api.merge(api.init('B', device='cpu'), a),",
        "               lambda d: d['k'].append(3))",
        "m = api.merge(a, b)",
        "assert api.inspect(api.load(api.save(m), device='cpu')) == "
        "{'k': [1, 2, 3]}",
        "print('ok')",
    ])
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_no_source_mentions_the_reference_or_jax():
    for path in Path(automerge_tpu_torch.__file__).parent.rglob("*.py"):
        for line in path.read_text().splitlines():
            s = line.strip()
            if s.startswith(("import ", "from ")):
                assert "jax" not in s and "automerge_tpu." not in s \
                    and s != "import automerge_tpu", (path, s)


def test_default_device_without_a_card_raises():
    from automerge_tpu_torch.device import resolve_device
    from automerge_tpu_torch.engine.resident_rows import ResidentRowsDocSet
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    from automerge_tpu_torch import api
    from automerge_tpu_torch.core.opset import OpSet
    for make in (lambda: ResidentRowsDocSet(["a"]),
                 lambda: ResidentRowsDocSet(["a"], device="cuda:0"),
                 resolve_device, api.init, lambda: api.init("A"),
                 api.init_immutable, OpSet.init,
                 lambda: api.load(api.save(api.init("A", device="cpu")))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    assert ResidentRowsDocSet(["a"], device="cpu").device.type == "cpu"
    assert api.init("A", device="cpu")._doc.opset.device.type == "cpu"
    assert OpSet.init("cpu").device.type == "cpu"


def test_docs_major_entry_points_default_to_the_card():
    """ResidentDocSet, apply_batch and BatchedDocSet run on the card
    unless the caller asks for the CPU; without a card the default raises."""
    from automerge_tpu_torch.engine.batchdoc import BatchedDocSet, apply_batch
    from automerge_tpu_torch.engine.resident import ResidentDocSet
    if torch.cuda.is_available():
        assert ResidentDocSet(["a"]).device.type == "cuda"
        return
    for make in (lambda: ResidentDocSet(["a"]), lambda: apply_batch([[]]),
                 BatchedDocSet):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    ds = ResidentDocSet(["a"], device="cpu")
    assert ds.device.type == "cpu"
    assert {t.device.type for t in ds.state.values()} == {"cpu"}
