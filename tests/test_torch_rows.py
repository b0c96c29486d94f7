"""The slice as a whole: the same seeded change streams go through the
reference's ResidentRowsDocSet (pure-Python ingress, Pallas kernel in
interpret mode) and the port's (device="cpu", the kernel's plain PyTorch
version). Tolerance: exact, bit-equal uint32 hashes.

Both engines get identical rounds, so every row of apply_rounds is under
the same actor universe in both and all rows are compared."""

import numpy as np
import pytest

import automerge_tpu as am
from automerge_tpu.core.change import Change, Op
from automerge_tpu.core.ids import ROOT_ID
from automerge_tpu.engine.resident_rows import (
    DeviceDispatchError as RefDispatchError, ResidentRowsDocSet as RefRows,
    RowsBudgetError as RefBudgetError)

from automerge_tpu_torch.engine import cuda_kernels, dispatch, resident_rows
from automerge_tpu_torch.engine.resident_rows import (
    DeviceDispatchError, ResidentRowsDocSet, RowsBudgetError)

from automerge_tpu_torch.workloads import reference_streams

from torch_port_helpers import load_reference_script, rounds_to_port


def history(seed, actors=("A", "B", "C"), steps=24, lists=True):
    """All changes of one document edited concurrently by `actors`: map
    sets and deletes on a few shared keys (LWW conflicts), and list and
    text inserts and deletes, with random merges between replicas."""
    rng = np.random.default_rng(seed)

    def setup(d):
        d["k0"] = 0
        if lists:
            d["xs"] = [1, 2]
            d["t"] = am.Text()
            d["t"].insert_at(0, *"ab")
    reps = {actors[0]: am.change(am.init(actors[0]), setup)}
    for a in actors[1:]:
        reps[a] = am.merge(am.init(a), reps[actors[0]])
    for _ in range(steps):
        a = actors[int(rng.integers(len(actors)))]
        d = reps[a]
        kind = int(rng.integers(6 if lists else 2))
        key = f"k{int(rng.integers(3))}"
        if kind == 1 and key in d:
            fn = (lambda x, key=key: x.__delitem__(key))
        elif kind == 2:
            n = len(d["xs"])
            fn = (lambda x, p=int(rng.integers(n + 1)), v=int(
                rng.integers(100)): x["xs"].insert_at(p, v))
        elif kind == 3 and len(d["xs"]):
            fn = (lambda x, p=int(rng.integers(len(d["xs"]))):
                  x["xs"].delete_at(p))
        elif kind == 4:
            n = len(d["t"])
            fn = (lambda x, p=int(rng.integers(n + 1)),
                  c="xyz"[int(rng.integers(3))]: x["t"].insert_at(p, c))
        elif kind == 5 and len(d["t"]):
            fn = (lambda x, p=int(rng.integers(len(d["t"]))):
                  x["t"].delete_at(p))
        else:
            fn = (lambda x, key=key, v=int(rng.integers(1000)):
                  x.__setitem__(key, v))
        reps[a] = am.change(d, fn)
        if rng.random() < 0.3:
            b = actors[int(rng.integers(len(actors)))]
            if b != a:
                reps[a] = am.merge(reps[a], reps[b])
    final = reps[actors[0]]
    for a in actors[1:]:
        final = am.merge(final, reps[a])
    return list(final._doc.opset.get_missing_changes({}))


def split_rounds(per_doc, n_rounds, rng=None):
    """One micro-batch: doc d's changes cut into n_rounds consecutive
    chunks; with `rng`, each doc's delivery order is shuffled first, so
    changes arrive before their dependencies and wait in the queue."""
    rounds = [dict() for _ in range(n_rounds)]
    for doc, chs in per_doc.items():
        chs = list(chs)
        if rng is not None:
            chs = [chs[i] for i in rng.permutation(len(chs))]
        for k, part in enumerate(np.array_split(np.arange(len(chs)),
                                                n_rounds)):
            if len(part):
                rounds[k][doc] = [chs[i] for i in part]
    return rounds


def engines(ids, actors=()):
    """Both packages' engines on their pure-Python encoders, so their row
    buffers grow alike (the native encoder's exact growth lays them out
    differently; tests/test_torch_ingress.py holds that path)."""
    return (RefRows(ids, actors=actors, native=False),
            ResidentRowsDocSet(ids, actors=actors, device="cpu",
                               native=False))


def apply_both(ref, port, rounds):
    want = ref.apply_rounds(rounds)
    got = port.apply_rounds(rounds_to_port(rounds))
    assert got.dtype == np.uint32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    return got


def assert_same_state(ref, port):
    np.testing.assert_array_equal(port.hashes(), ref.hashes())
    np.testing.assert_array_equal(port.rows_host, ref.rows_host)
    assert port.dims() == ref.dims()


@pytest.mark.parametrize("seed", [0, 1])
def test_map_and_list_streams(seed):
    ids = [f"doc{i}" for i in range(4)]
    per_doc = {d: history(seed * 10 + i, lists=(i % 2 == 0))
               for i, d in enumerate(ids)}
    ref, port = engines(ids)
    apply_both(ref, port, split_rounds(per_doc, 3))
    assert_same_state(ref, port)


def test_out_of_order_delivery_queues_then_converges():
    ids = ["p", "q", "r"]
    per_doc = {d: history(40 + i) for i, d in enumerate(ids)}
    rng = np.random.default_rng(3)
    ref, port = engines(ids)
    rounds = split_rounds(per_doc, 4, rng)
    first, rest = rounds[:2], rounds[2:]
    apply_both(ref, port, first)
    # something is waiting on a dependency after the first half
    assert port._queued_docs and port._queued_docs == ref._queued_docs
    apply_both(ref, port, rest)
    assert not port._queued_docs
    assert_same_state(ref, port)


def test_new_actor_mid_stream_remaps_ranks():
    """A later micro-batch brings actors that sort before and between the
    known ones: ranks are remapped and cap_actors grows."""
    ids = ["m", "n"]
    ref, port = engines(ids)
    apply_both(ref, port, split_rounds(
        {d: history(60 + i, actors=("M", "Q")) for i, d in enumerate(ids)},
        2))
    rounds = [{"m": [Change("0first", 1, {"M": 1}, [
                Op("set", ROOT_ID, key="k0", value="zero")])],
               "n": [Change("N", 1, {"Q": 1}, [
                   Op("set", ROOT_ID, key="k9", value=9)])]},
              {"m": [Change("P", 1, {"0first": 1}, [
                  Op("del", ROOT_ID, key="k0")])]}]
    apply_both(ref, port, rounds)
    assert port.actors == ref.actors and port.cap_actors == ref.cap_actors
    assert port.cap_actors > 2
    assert_same_state(ref, port)


def test_capacity_growth_past_cap_ops_and_cap_elems():
    ids = ["g0", "g1", "g2"]
    ref, port = engines(ids)
    caps = (port.cap_ops, port.cap_elems)
    for b in range(3):
        chs = []
        for s in range(4):
            seq = b * 4 + s + 1
            ops = [Op("set", ROOT_ID, key=f"k{seq}_{j}", value=j)
                   for j in range(3)]
            if seq == 1:
                ops = [Op("makeText", "T1"),
                       Op("link", ROOT_ID, key="t", value="T1")] + ops
            prev = "_head" if seq == 1 else f"w:{seq - 1}"
            ops += [Op("ins", "T1", key=prev, elem=seq),
                    Op("set", "T1", key=f"w:{seq}", value="c")]
            chs.append(Change("w", seq, {}, ops))
        apply_both(ref, port, [{"g1": chs[:2]}, {"g1": chs[2:]}])
    assert port.cap_ops > caps[0] and port.cap_elems > caps[1]
    assert_same_state(ref, port)


def _two_batches(ids):
    per_doc = {d: history(80 + i, steps=10) for i, d in enumerate(ids)}
    ref, port = engines(ids)
    apply_both(ref, port, split_rounds(per_doc, 2))
    return ref, port


def _record_widths(monkeypatch):
    """The lane width of every reconcile launch, from the engine's classic
    paths and from the megabatch route's buckets."""
    widths = []
    real = resident_rows.reconcile_rows_hash

    def spy(rows, dims, force_xl=False):
        widths.append(rows.shape[1])
        return real(rows, dims, force_xl)
    monkeypatch.setattr(resident_rows, "reconcile_rows_hash", spy)
    monkeypatch.setattr(dispatch, "reconcile_rows_hash", spy)
    return widths


def test_hashes_for_minority_dirty_gathers_lanes(monkeypatch):
    ids = [f"h{i}" for i in range(200)]       # two lanes of 128
    ref, port = _two_batches(ids)
    widths = _record_widths(monkeypatch)
    for e in (ref, port):
        e._mark_hash_dirty([3, 150])
    want = ref.hashes_for([3, 7, 150])
    got = port.hashes_for([3, 7, 150])
    np.testing.assert_array_equal(got, want)
    # a narrow gather or one megabatch bucket, not n_pad
    assert widths == [128]
    assert not port._doc_dirty
    assert_same_state(ref, port)


def test_hashes_majority_dirty_reconciles_full_buffer(monkeypatch):
    ids = [f"h{i}" for i in range(200)]
    ref, port = _two_batches(ids)
    widths = _record_widths(monkeypatch)
    for e in (ref, port):
        e._mark_all_hash_dirty()
        e._hash_mirror[:] = 0
    np.testing.assert_array_equal(port.hashes(), ref.hashes())
    assert widths == [port.n_pad]
    assert port.rows_dev is not None and not port._dirty
    np.testing.assert_array_equal(port.rows_dev.numpy(), port.rows_host)


def test_add_docs_grows_lanes_and_reads_fresh_docs():
    ref, port = _two_batches(["a0", "a1"])
    new = [f"z{i}" for i in range(130)]
    for e in (ref, port):
        e.add_docs(new)
    assert port.n_pad == ref.n_pad == 256
    np.testing.assert_array_equal(port.hashes_for([0, 5, 131]),
                                  ref.hashes_for([0, 5, 131]))
    apply_both(ref, port, [{"z7": [Change("A", 1, {}, [
        Op("set", ROOT_ID, key="x", value=1)])]}])
    assert_same_state(ref, port)


def test_merged_batch_apply_and_handle_readback():
    """_dispatch_final (one scatter + one launch for a whole batch; on a
    fresh instance, whose device copy is stale, the upload of the mirror
    that already holds the batch) leaves a device handle that the next
    hashes() consumes without a launch."""
    ids = ["f0", "f1", "f2"]
    per_doc = {d: history(90 + i, steps=8) for i, d in enumerate(ids)}
    ref, port = engines(ids)
    rounds = split_rounds(per_doc, 2)
    want = ref.apply_rounds(rounds)[-1]
    port_rounds = rounds_to_port(rounds)
    for r in port_rounds:
        port._register_actors(r)
    port._reserve_for(port_rounds)
    trips = [port._round_triplets(r) for r in port_rounds]
    port._dispatch_final(trips)
    assert port._hash_handle is not None
    before = cuda_kernels.LAUNCHES["reconcile_rows_hash"]
    np.testing.assert_array_equal(port.hashes(), want)
    assert port._hash_handle is None and not port._doc_dirty
    assert cuda_kernels.LAUNCHES["reconcile_rows_hash"] == before
    np.testing.assert_array_equal(port.rows_dev.numpy(), port.rows_host)


def test_first_actor_after_upload_refreshes_the_device_copy():
    """A read before any change uploads the buffer; the first actor then
    fills the actor-hash band, which must reach the device copy. (The
    reference keeps a stale band here; the port matches the reference's
    fresh instance.)"""
    ids = ["s0", "s1", "s2"]
    rnd = {"s0": [Change("x", 1, {}, [Op("set", ROOT_ID, key="k",
                                         value=1)])]}
    fresh = RefRows(ids, native=False).apply_rounds([rnd])
    port = ResidentRowsDocSet(ids, device="cpu")
    port.hashes()
    assert port.rows_dev is not None
    np.testing.assert_array_equal(
        port.apply_rounds(rounds_to_port([rnd])), fresh)


def test_oversized_batch_raises_budget_error_in_both():
    ids = ["big", "small"]
    ref, port = engines(ids)
    huge = [{"big": [Change("A", 1, {}, [
        Op("set", ROOT_ID, key=f"k{j}", value=j) for j in range(1100)])]}]
    with pytest.raises(RefBudgetError):
        ref.apply_rounds(huge)
    with pytest.raises(RowsBudgetError):
        port.apply_rounds(rounds_to_port(huge))
    # the rejected batch left both instances usable
    apply_both(ref, port, [{"small": [Change("A", 1, {}, [
        Op("set", ROOT_ID, key="k", value=1)])]}])
    assert_same_state(ref, port)


def test_dispatch_failure_keeps_host_truth(monkeypatch):
    ids = ["e0", "e1"]
    ref, port = engines(ids)
    rnd = [{"e0": [Change("A", 1, {}, [Op("set", ROOT_ID, key="k",
                                          value=1)])]}]
    want = ref.apply_rounds(rnd)

    def boom(rows, dims, force_xl=False):
        raise RuntimeError("launch refused")
    monkeypatch.setattr(resident_rows, "reconcile_rows_hash", boom)
    with pytest.raises(DeviceDispatchError) as err:
        port.apply_rounds(rounds_to_port(rnd))
    assert err.value.admission_complete
    assert port.rows_dev is None and port._dirty
    monkeypatch.undo()
    np.testing.assert_array_equal(port.hashes(), want[-1])


def test_admission_failure_after_admitting_poisons(monkeypatch):
    """A failure after part of a batch was admitted rebuilds the instance
    from its log and raises DeviceDispatchError(admission_complete=False),
    as the reference does; the hashes then equal the reference's under the
    same fault, and replaying the batch is a duplicate-drop. Only a fault
    that also strikes the rebuild's replay poisons, in both packages."""
    ids = ["e0", "e1"]

    def text_change(actor):
        return Change(actor, 1, {}, [
            Op("makeText", f"T{actor}"),
            Op("link", ROOT_ID, key="t", value=f"T{actor}"),
            Op("ins", f"T{actor}", key="_head", elem=1)])
    batch = [{"e0": [text_change("A")], "e1": [text_change("B")]}]

    def faulty(cls, fail_from, fail_to):
        real = cls._linearized_pos_rows
        calls = []

        def flaky(self, doc_idx, lrow):
            calls.append(doc_idx)
            if fail_from <= len(calls) <= fail_to:
                raise MemoryError("host out of memory")
            return real(self, doc_idx, lrow)
        monkeypatch.setattr(cls, "_linearized_pos_rows", flaky)

    # the second list's re-linearization fails once: both packages rebuild
    ref = RefRows(ids)
    port = ResidentRowsDocSet(ids, device="cpu")
    faulty(RefRows, 2, 2)
    faulty(ResidentRowsDocSet, 2, 2)
    with pytest.raises(RefDispatchError) as ref_err:
        ref.apply_rounds(batch)
    with pytest.raises(DeviceDispatchError) as err:
        port.apply_rounds(rounds_to_port(batch))
    assert not ref_err.value.admission_complete
    assert not err.value.admission_complete
    assert isinstance(err.value.__cause__, MemoryError)
    assert port._rebuild_gen == 1 and port._poisoned is None
    assert [len(log) for log in port.change_log] == [1, 1]
    np.testing.assert_array_equal(port.hashes(), ref.hashes())
    again = port.apply_rounds(rounds_to_port(batch))[-1]
    np.testing.assert_array_equal(again, ref.apply_rounds(batch)[-1])
    assert [len(log) for log in port.change_log] == [1, 1]
    monkeypatch.undo()

    # every call from the second on fails: the rebuild's replay fails too,
    # and both packages poison
    ref = RefRows(ids)
    port = ResidentRowsDocSet(ids, device="cpu")
    faulty(RefRows, 2, 1 << 30)
    faulty(ResidentRowsDocSet, 2, 1 << 30)
    with pytest.raises(MemoryError):
        ref.apply_rounds(batch)
    with pytest.raises(MemoryError):
        port.apply_rounds(rounds_to_port(batch))
    with pytest.raises(RuntimeError, match="no longer reflects"):
        ref.hashes()
    with pytest.raises(RuntimeError, match="no longer reflects"):
        port.hashes()


def test_resident_bytes_counts_host_and_device():
    ref, port = _two_batches(["r0", "r1"])
    assert port.resident_bytes() == ref.resident_bytes()


def test_committed_reference_hashes_hold_in_both_packages():
    """The .npz that chip_smoke.py holds the card to is what the reference
    computes today, and the port on the CPU reproduces it."""
    mod = load_reference_script()
    committed = np.load(mod.OUT)
    ref = mod.reference_hashes()
    for name, ids, batches in reference_streams():
        port = ResidentRowsDocSet(ids, device="cpu")
        for batch in batches:
            port.apply_rounds(batch)
        np.testing.assert_array_equal(committed[name], ref[name])
        np.testing.assert_array_equal(port.hashes(), committed[name])
