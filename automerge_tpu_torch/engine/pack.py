"""The batch wire formats of `automerge_tpu/engine/pack.py`.

The packed docs-major format (`pack_batch`): a whole stacked batch
(encode.stack_docs) flattened into ONE int32 buffer plus a static meta
header, so a batch crosses to the device in one copy and `apply_packed`
unpacks it there as views.

The docs-minor row format (`pack_rows`): one int32 [ROWS, D_pad] buffer
holds a whole batch, documents on the minor (lane) axis, every logical
column a static row range. It is the native layout of the fused reconcile
kernel (`cuda_kernels.reconcile_rows_hash`) and of the resident rows
engine.

The compact row wires (`pack_rows_compact`, `pack_rows_bytes`): the row
buffer with each group at the narrowest dtype that holds it, widened to
int32 on the device (`widen_rows`, `widen_bytes`) before the kernel. Field
sharding (`select_field_sharding`, `shard_batch_by_fields`,
`recombine_hashes`): a document too wide for the envelope split into
field-disjoint virtual documents whose hashes sum back to its own.

All are byte-for-byte the reference's formats, so a buffer packed by
either package feeds the other.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .encode import A_DEL, A_SET

# Field order of the packed docs-major buffer: the wire contract.
FIELDS = ("op_mask", "action", "fid", "actor", "seq", "change_idx", "value",
          "fid_hash", "value_hash", "clock", "ins_mask", "ins_elem",
          "ins_actor", "ins_parent", "ins_fid", "ins_pos", "list_obj",
          "list_obj_hash", "actor_hash")


def pack_batch(batch: dict) -> tuple[np.ndarray, tuple]:
    """Flatten a stacked batch into (flat int32 buffer, static meta). meta
    is a hashable tuple of (name, offset, shape, is_bool) entries."""
    parts = []
    meta = []
    offset = 0
    for name in FIELDS:
        arr = np.asarray(batch[name])
        flat = arr.astype(np.int32).ravel()
        meta.append((name, offset, arr.shape, arr.dtype == np.bool_))
        parts.append(flat)
        offset += flat.size
    return np.concatenate(parts), tuple(meta)


def unpack_batch(flat: torch.Tensor, meta: tuple) -> dict:
    """The batch dict of a packed buffer (a 1-D int32 tensor): each field a
    view of `flat` in its shape, bool fields converted."""
    out = {}
    for name, offset, shape, is_bool in meta:
        size = int(np.prod(shape))
        arr = flat[offset:offset + size].view(shape)
        out[name] = arr.bool() if is_bool else arr
    return out


def apply_packed(flat: torch.Tensor, meta: tuple, max_fids: int,
                 host_order: bool = True) -> dict:
    """Full reconcile over a packed batch (every output of
    kernels.apply_doc), on the device of `flat`, the packed buffer as a
    1-D int32 tensor."""
    from .kernels import apply_doc
    return apply_doc(unpack_batch(flat, meta), max_fids, host_order)


def apply_packed_hash(flat: torch.Tensor, meta: tuple, max_fids: int,
                      host_order: bool = True) -> torch.Tensor:
    """One reconcile pass over a packed batch, returning only the per-doc
    state hashes ([D] int32 holding the uint32 bits)."""
    return apply_packed(flat, meta, max_fids, host_order)["hash"]


# The docs axis of every docs-minor layout pads to a multiple of this (the
# reference's TPU lane width; kept so both packages agree on buffer shapes).
LANE = 128


def pad_to_lanes(n: int) -> int:
    """Round a doc count up to the lane width (docs-minor layouts)."""
    return ((n + LANE - 1) // LANE) * LANE


# Row-buffer column groups, in wire order. `clock_op` is each op's own
# change-clock row (actor-major), so the kernel never indexes by change id;
# `elem_list` is the owning-list row per element slot (a static pattern).
ROW_FIELDS = ("op_mask", "action", "fid", "actor", "seq", "change_idx",
              "fid_hash", "value_hash", "clock_op", "ins_mask", "ins_fid",
              "ins_pos", "elem_objhash", "elem_list", "actor_hash")

# The reference's per-doc dims envelope, kept numerically identical so that
# RowsBudgetError fires for exactly the batches the reference rejects. The
# numbers model the TPU kernel's on-chip working set (in units of 128-lane
# int32 rows); the CUDA kernel has no such limit, and re-deriving the
# envelope for the GPU is later work (ROADMAP.md).
ROWS_MAX_OPS = 1024
ROWS_MAX_ELEMS = 1024
ROWS_VMEM_BUDGET = 22528


def rows_count(i: int, a: int, le: int) -> int:
    """Row count of the docs-minor layout (the buffer holds
    rows_count * d_pad int32 values)."""
    return 8 * i + a * i + 5 * le + a


def row_bases(i: int, a: int, le: int) -> dict:
    """Row offsets of each ROW_FIELDS group — the one definition of the
    layout, shared by the kernel wrappers and the resident rows mirror. The
    trailing "ah" band is the rank -> actor content hash table the state
    hash mixes."""
    co = 8 * i
    return {
        "om": 0, "ac": i, "fid": 2 * i, "act": 3 * i, "seq": 4 * i,
        "chg": 5 * i, "fh": 6 * i, "vh": 7 * i, "co": co,
        "im": co + a * i, "if": co + a * i + le, "ip": co + a * i + 2 * le,
        "io": co + a * i + 3 * le, "il": co + a * i + 4 * le,
        "ah": co + a * i + 5 * le,
        "rows": co + a * i + 5 * le + a,
    }


def rows_dims_eligible(i: int, a: int, le: int) -> bool:
    """Whether per-doc dims (ops, actors, list-element slots) sit inside the
    base envelope. I and LE must be multiples of 8 — encode._pad_to
    guarantees this for in-repo producers; external callers must pad."""
    working = rows_count(i, a, le) + 24 * max(i, le) + 3 * i + 2 * le
    return (i % 8 == 0 and le % 8 == 0
            and i <= ROWS_MAX_OPS and le <= ROWS_MAX_ELEMS
            and working <= ROWS_VMEM_BUDGET)


def rows_eligible(batch: dict, max_fids: int) -> bool:
    """Whether a stacked batch fits the base envelope or, past it, the XL
    envelope (`cuda_kernels.rows_dims_eligible_xl`): the batches the row
    wires and the mesh's row reconcile take."""
    i = batch["op_mask"].shape[1]
    a = batch["clock"].shape[2]
    l, e = batch["ins_mask"].shape[1:]
    if rows_dims_eligible(i, a, l * e):
        return True
    from .cuda_kernels import rows_dims_eligible_xl
    return rows_dims_eligible_xl(i, a, l * e)


def pack_rows(batch: dict, max_fids: int) -> tuple[np.ndarray, tuple, int]:
    """Repack a stacked batch (docs-major dict of encode.stack_docs) into
    the docs-minor [ROWS, D_pad] int32 row buffer + static dims.

    Returns (rows, dims, n_docs). D_pad rounds the doc count up to a
    multiple of LANE; padded docs hash to garbage and are sliced off.
    `max_fids` is accepted for the reference's signature: field ids are
    joined by equality, so the field count never shapes the buffer.
    """
    d, i = batch["op_mask"].shape
    c, a = batch["clock"].shape[1:]
    l, e = batch["ins_mask"].shape[1:]
    d_pad = pad_to_lanes(d)

    def rowify(arr, fill=0):
        """[d, ...] -> [prod(...), d_pad] int32, docs minor."""
        arr = np.asarray(arr).astype(np.int32)
        flat = arr.reshape(d, -1).T
        if d_pad > d:
            flat = np.pad(flat, ((0, 0), (0, d_pad - d)),
                          constant_values=fill)
        return flat

    # per-op clock rows: clock_op[d, i, a] = clock[d, change_idx[d, i], a],
    # then actor-major [d, a, i] so each actor's band is a contiguous range
    chg = np.clip(np.asarray(batch["change_idx"]), 0, c - 1)
    clock_op = np.take_along_axis(
        np.asarray(batch["clock"]),
        chg[:, :, None].astype(np.int64), axis=1)          # [d, i, a]
    clock_op_am = np.moveaxis(clock_op, 2, 1)              # [d, a, i]

    elem_objhash = np.broadcast_to(
        np.asarray(batch["list_obj_hash"])[:, :, None], (d, l, e))
    elem_list = np.broadcast_to(
        np.arange(l, dtype=np.int32)[None, :, None], (d, l, e))
    parts = [
        rowify(batch["op_mask"]), rowify(batch["action"], -1),
        rowify(batch["fid"], -1), rowify(batch["actor"]),
        rowify(batch["seq"]), rowify(batch["change_idx"]),
        rowify(batch["fid_hash"]), rowify(batch["value_hash"]),
        rowify(clock_op_am), rowify(batch["ins_mask"]),
        rowify(batch["ins_fid"], -1), rowify(batch["ins_pos"]),
        rowify(elem_objhash, -1), rowify(elem_list, -1),
        rowify(batch["actor_hash"]),
    ]
    rows = np.concatenate(parts, axis=0)
    dims = (i, a, l * e, int(A_SET), int(A_DEL))
    return rows, dims, d


def rows_from_numpy(rows: np.ndarray, dims: tuple,
                    device="cuda") -> torch.Tensor:
    """A row buffer packed by either package (numpy [ROWS, D_pad] int32) as
    the port's device state: a contiguous int32 tensor on `device` (a copy;
    the caller's array is never aliased)."""
    i, a, le = dims[:3]
    rows = np.asarray(rows)
    if rows.dtype != np.int32 or rows.ndim != 2:
        raise ValueError(f"row buffer must be 2-D int32, got "
                         f"{rows.dtype} {rows.shape}")
    if rows.shape[0] != rows_count(i, a, le) or rows.shape[1] % LANE:
        raise ValueError(f"row buffer shape {rows.shape} does not match dims "
                         f"{dims} (rows {rows_count(i, a, le)}, lanes a "
                         f"multiple of {LANE})")
    return torch.from_numpy(np.ascontiguousarray(rows)).to(
        resolve_device(device), copy=True)


def apply_rows_hash(rows: torch.Tensor, dims: tuple,
                    n_docs: int) -> torch.Tensor:
    """Per-doc state hashes of a row buffer ([n_docs] int32 holding the
    uint32 bits), through the CUDA kernel for a CUDA tensor or its plain
    version for a CPU one."""
    from .cuda_kernels import reconcile_rows_hash
    return reconcile_rows_hash(rows, dims)[:n_docs]


# ---------------------------------------------------------------------------
# Compact wire: the row buffer at narrow dtypes
#
# The row buffer is int32 on the device, but most of its groups hold small
# integers (masks, action codes, field ids, actor ranks, clock entries);
# only the content-hash groups need 32 bits. The compact wire sends each
# group at the narrowest dtype that holds it and widens on the device, so
# fewer bytes cross to the card. Each group's width class comes from a
# batch-stable policy (classify_row_groups), and the wire (bytes and meta)
# is the reference's byte for byte.

_DTYPES = (np.int8, np.int16, np.int32)
_TORCH_DTYPES = (torch.int8, torch.int16, torch.int32)
# Groups whose width is declared from a capacity bound with no look at the
# data: the only ones a narrow cast could wrap, so the only ones
# pack_rows_compact range-checks.
_CAP_FIELDS = frozenset((
    "op_mask", "action", "fid", "actor", "ins_mask", "ins_fid", "ins_pos"))
_CAP_GROUPS = frozenset(ROW_FIELDS.index(f) for f in _CAP_FIELDS)
# The content-hash groups: always int32.
_HASH_GROUPS = frozenset((ROW_FIELDS.index("actor_hash"),
                          ROW_FIELDS.index("fid_hash"),
                          ROW_FIELDS.index("value_hash"),
                          ROW_FIELDS.index("elem_objhash")))


def _narrow_dtype(part: np.ndarray):
    """(width class, dtype) of the narrowest dtype holding `part`."""
    lo, hi = (int(part.min()), int(part.max())) if part.size else (0, 0)
    idx = _width_of_bound(lo, hi)
    return idx, _DTYPES[idx]


def _width_of_bound(lo: int, hi: int) -> int:
    if -128 <= lo and hi <= 127:
        return 0
    if -32768 <= lo and hi <= 32767:
        return 1
    return 2


def _group_rows(dims: tuple) -> tuple:
    """Rows of each ROW_FIELDS group, in wire order."""
    i, a, le = dims[0], dims[1], dims[2]
    return (i, i, i, i, i, i, i, i, a * i, le, le, le, le, le, a)


def classify_row_groups(rows, dims: tuple, max_fids: int) -> tuple:
    """The width class (0 int8, 1 int16, 2 int32) of each ROW_FIELDS group,
    stable across the batches of a stream:

    - from the layout's capacity where it bounds the values (masks 0/1,
      the action enum, fid < max_fids, actor rank < A, ins_pos < LE): no
      look at the data;
    - int32 for the content-hash groups;
    - from the observed range with 2x headroom for the data-dependent
      counters (seq, change_idx, clock_op, elem_list): the class changes
      only when a counter crosses half a dtype's bound."""
    i, a, le = dims[0], dims[1], dims[2]
    cap_bound = {
        "op_mask": 1,
        "action": 32,
        "fid": max(max_fids, 1),
        "actor": max(a, 1),
        "ins_mask": 1,
        "ins_fid": max(max_fids, 1),
        "ins_pos": max(le, 1),
    }
    assert set(cap_bound) == _CAP_FIELDS
    cap_hi = {ROW_FIELDS.index(f): v for f, v in cap_bound.items()}
    widths = []
    off = 0
    for g, r in enumerate(_group_rows(dims)):
        part = rows[off:off + r]
        off += r
        if g in _HASH_GROUPS:
            widths.append(2)
        elif g in cap_hi:
            widths.append(_width_of_bound(-1, cap_hi[g]))
        else:
            lo, hi = ((int(part.min()), int(part.max())) if part.size
                      else (0, 0))
            widths.append(_width_of_bound(min(lo, -1), max(2 * hi, 1)))
    return tuple(widths)


def pack_rows_compact(batch: dict, max_fids: int):
    """The row wire with a narrow dtype per group.

    Returns ((b8, b16, b32), meta, dims, n_docs): three [rows_dt, D_pad]
    numpy buffers (any may have 0 rows) holding the groups of their width
    class in wire order, and meta = ((width class, n_rows), ...) per
    ROW_FIELDS group, which widen_rows needs to rebuild the int32 buffer.
    Raises ValueError where a capacity-declared group holds a value its
    dtype cannot."""
    rows, dims, d = pack_rows(batch, max_fids)
    widths = classify_row_groups(rows, dims, max_fids)
    parts: tuple[list, list, list] = ([], [], [])
    meta = []
    off = 0
    for g, (r, idx) in enumerate(zip(_group_rows(dims), widths)):
        part = rows[off:off + r]
        off += r
        if idx < 2 and part.size and g in _CAP_GROUPS:
            info = np.iinfo(_DTYPES[idx])
            lo, hi = int(part.min()), int(part.max())
            if lo < info.min or hi > info.max:
                raise ValueError(
                    f"row group {g} [{lo}, {hi}] exceeds its declared "
                    f"{_DTYPES[idx].__name__} capacity — layout invariant "
                    f"violated (classify_row_groups)")
        parts[idx].append(part.astype(_DTYPES[idx]))
        meta.append((idx, r))
    d_pad = rows.shape[1]
    bufs = tuple(np.concatenate(p, axis=0) if p else np.zeros((0, d_pad), dt)
                 for p, dt in zip(parts, _DTYPES))
    return bufs, tuple(meta), dims, d


def widen_rows(b8: torch.Tensor, b16: torch.Tensor, b32: torch.Tensor,
               meta: tuple) -> torch.Tensor:
    """The [ROWS, D_pad] int32 row buffer of a compact wire, on the wire's
    device: each group a slice of its dtype's buffer cast to int32, then
    one concatenation."""
    bufs = (b8, b16, b32)
    offs = [0, 0, 0]
    parts = []
    for idx, r in meta:
        parts.append(bufs[idx].narrow(0, offs[idx], r).to(torch.int32))
        offs[idx] += r
    return torch.cat(parts, 0)


def _wire_tensor(x, dev: torch.device) -> torch.Tensor:
    """A wire buffer (numpy or tensor) as a tensor on `dev`."""
    if isinstance(x, np.ndarray):
        x = np.ascontiguousarray(x)
        x = torch.from_numpy(x if x.flags.writeable else x.copy())
    return x.to(dev)


def apply_rows_hash_compact(b8, b16, b32, meta: tuple, dims: tuple,
                            device="cuda") -> torch.Tensor:
    """Per-lane state hashes of a compact wire ([D_pad] int32 holding the
    uint32 bits): the narrow buffers (numpy or tensors) go to `device` as
    they are, are widened there, and the reconcile kernel runs on the
    widened buffer (cuda_kernels.reconcile_rows_hash; the plain version on
    the CPU)."""
    from .cuda_kernels import reconcile_rows_hash
    dev = resolve_device(device)
    rows = widen_rows(*(_wire_tensor(b, dev) for b in (b8, b16, b32)), meta)
    return reconcile_rows_hash(rows, dims)


def pack_rows_bytes(batch: dict, max_fids: int):
    """The compact wire as one contiguous uint8 buffer (the three dtype
    buffers back to back, row-major, little-endian). Returns (wire_u8
    [n_bytes], bmeta, dims, n_docs); bmeta = (meta, (r8, r16, r32),
    d_pad)."""
    (b8, b16, b32), meta, dims, n = pack_rows_compact(batch, max_fids)
    wire = np.concatenate(
        [np.ascontiguousarray(b).view(np.uint8).ravel()
         for b in (b8, b16, b32)])
    bmeta = (meta, (b8.shape[0], b16.shape[0], b32.shape[0]), b8.shape[1])
    return wire, bmeta, dims, n


def narrow_groups(g8: torch.Tensor, g16: torch.Tensor,
                  g32: torch.Tensor) -> tuple:
    """The (b8, b16, b32) buffers of the byte wire's dtype groups, each a
    little-endian uint8 tensor [rows_dt, lanes, itemsize], viewed as their
    dtype ([rows_dt, lanes]) without a copy."""
    out = []
    for g, dt in zip((g8, g16, g32), _TORCH_DTYPES):
        if not g.is_contiguous():
            g = g.contiguous()
        out.append(g.view(dt).squeeze(-1) if g.shape[0]
                   else torch.zeros((0, g.shape[1]), dtype=dt,
                                    device=g.device))
    return tuple(out)


def widen_bytes(wire_u8: torch.Tensor, bmeta: tuple) -> torch.Tensor:
    """[n_bytes] uint8 tensor -> [ROWS, D_pad] int32, on its device: each
    dtype group a [r, d_pad, itemsize] slice viewed as its dtype."""
    meta, (r8, r16, r32), d_pad = bmeta
    o8 = r8 * d_pad
    o16 = o8 + r16 * d_pad * 2
    end = o16 + r32 * d_pad * 4
    groups = (wire_u8[:o8].view(r8, d_pad, 1),
              wire_u8[o8:o16].view(r16, d_pad, 2),
              wire_u8[o16:end].view(r32, d_pad, 4))
    return widen_rows(*narrow_groups(*groups), meta)


def apply_rows_hash_bytes(wire_u8, bmeta: tuple, dims: tuple,
                          device="cuda") -> torch.Tensor:
    """apply_rows_hash_compact over the single-buffer byte wire: the uint8
    wire (numpy or tensor) goes to `device`, is widened there, and the
    reconcile kernel runs on the widened buffer."""
    from .cuda_kernels import reconcile_rows_hash
    dev = resolve_device(device)
    return reconcile_rows_hash(widen_bytes(_wire_tensor(wire_u8, dev),
                                           bmeta), dims)


# ---------------------------------------------------------------------------
# Field sharding: a wide document split into field-disjoint virtual docs
#
# Survivor analysis joins only ops that share a field id, and the state
# hash is a uint32 sum over surviving assigns, so a wide document
# partitioned by field into virtual documents has hashes that add back to
# the real document's exactly. List objects are atomic (their elements'
# rank join spans the list), so every list field rides virtual doc 0 with
# the document's insertion tables; make and ins op rows carry no kernel
# state and are dropped.

def select_field_sharding(batch: dict, max_fids: int):
    """Try a field split at each op target of the ladder (512, 256, 128;
    the largest first, so the fewest virtual docs that fit win) and return
    (sharded_batch, owner, target_ops) for the first that fits the row
    envelopes, or (None, None, None) where the actors or elements, which a
    split by field cannot shrink, keep every split out."""
    a0 = batch["clock"].shape[2]
    le0 = batch["ins_mask"].shape[1] * batch["ins_mask"].shape[2]
    for target in (512, 256, 128):
        if not rows_dims_eligible(target, a0, le0):
            continue
        cand, owner = shard_batch_by_fields(batch, max_fids, target)
        if rows_eligible(cand, max_fids):
            return cand, owner, target
    return None, None, None


def _field_bins(om, action, fid, ins_mask, ins_fid, target_ops: int) -> list:
    """One document's virtual docs as lists of op index arrays: the list
    fields' assigns in bin 0, then the map fields' groups, largest first,
    each into the first bin with room (a new bin where none has)."""
    assigns = np.nonzero(om & (action >= A_SET))[0]
    list_fids = set(ins_fid[ins_mask].tolist())
    list_fids.discard(-1)
    f_of = fid[assigns]
    is_list_op = (np.isin(f_of, list(list_fids)) if list_fids
                  else np.zeros(len(assigns), bool))
    bins = [[assigns[is_list_op]]]
    sizes = [int(is_list_op.sum())]
    map_ops = assigns[~is_list_op]
    if len(map_ops):
        mf = fid[map_ops]
        order = np.argsort(mf, kind="stable")
        srt = map_ops[order]
        fs = mf[order]
        bounds = np.nonzero(np.r_[True, fs[1:] != fs[:-1]])[0]
        groups = [srt[lo:hi] for lo, hi in
                  zip(bounds, np.r_[bounds[1:], len(srt)])]
        groups.sort(key=len, reverse=True)
        for g in groups:
            for b in range(len(bins)):
                if sizes[b] + len(g) <= target_ops:
                    bins[b].append(g)
                    sizes[b] += len(g)
                    break
            else:
                bins.append([g])
                sizes.append(len(g))
    return bins


def shard_batch_by_fields(batch: dict, max_fids: int, target_ops: int = 512):
    """Split the docs of more than `target_ops` assigns into field-disjoint
    virtual docs of at most `target_ops` assigns each.

    Returns (sharded_batch, owner): owner[v] is the real doc of virtual
    doc v, and a real doc's hash is the uint32 sum of its virtual docs'
    (recombine_hashes)."""
    d = batch["op_mask"].shape[0]
    om = np.asarray(batch["op_mask"])
    action = np.asarray(batch["action"])
    fid = np.asarray(batch["fid"])
    ins_mask = np.asarray(batch["ins_mask"])
    ins_fid = np.asarray(batch["ins_fid"])

    virtuals: list[tuple[int, np.ndarray, bool]] = []  # (owner, ops, ins)
    max_bin = 1
    for dd in range(d):
        assigns = np.nonzero(om[dd] & (action[dd] >= A_SET))[0]
        if len(assigns) <= target_ops:
            virtuals.append((dd, assigns, True))
            max_bin = max(max_bin, len(assigns))
            continue
        bins = _field_bins(om[dd], action[dd], fid[dd], ins_mask[dd],
                           ins_fid[dd], target_ops)
        for b, parts in enumerate(bins):
            idx = np.concatenate(parts) if parts else np.zeros(0, np.int64)
            virtuals.append((dd, idx, b == 0))
            max_bin = max(max_bin, len(idx))

    i_t = 8
    while i_t < max_bin:
        i_t *= 2
    owner = np.fromiter((v[0] for v in virtuals), np.int64, len(virtuals))
    n_v = len(virtuals)

    out = {}
    fills = {"op_mask": False, "action": -1, "fid": -1, "value": -1}
    for name in ("op_mask", "action", "fid", "actor", "seq", "change_idx",
                 "value", "fid_hash", "value_hash"):
        src = np.asarray(batch[name])
        arr = np.full((n_v, i_t), fills.get(name, 0), dtype=src.dtype)
        for v, (dd, idx, _ins) in enumerate(virtuals):
            arr[v, :len(idx)] = src[dd, idx]
        out[name] = arr
    out["clock"] = np.asarray(batch["clock"])[owner]
    out["actor_hash"] = np.asarray(batch["actor_hash"])[owner]
    for name in ("ins_mask", "ins_elem", "ins_actor", "ins_parent",
                 "ins_fid", "ins_pos", "list_obj", "list_obj_hash"):
        src = np.asarray(batch[name])
        fill = {"ins_mask": False, "ins_elem": 0, "ins_actor": 0}.get(
            name, -1)
        arr = np.full((n_v,) + src.shape[1:], fill, dtype=src.dtype)
        for v, (dd, _idx, takes_ins) in enumerate(virtuals):
            if takes_ins:
                arr[v] = src[dd]
        out[name] = arr
    return out, owner


def recombine_hashes(virtual_hashes, owner: np.ndarray,
                     n_docs: int) -> np.ndarray:
    """real_hash[d] = uint32 wraparound sum of its virtual docs' hashes.
    `virtual_hashes` is np.uint32, or a tensor of the uint32 bits."""
    if isinstance(virtual_hashes, torch.Tensor):
        virtual_hashes = virtual_hashes.cpu().numpy().view(np.uint32)
    out = np.zeros(n_docs, np.uint32)
    np.add.at(out, owner, np.asarray(virtual_hashes)[:len(owner)]
              .astype(np.uint32))
    return out


# ---------------------------------------------------------------------------
# Megabatch buckets: a round's dirty documents reconciled at smaller dims
#
# Documents share lanes in the docs-minor buffer but not shape: one 16-op
# doc in a fleet grown to I = 1,024 pays the whole 1,024-row band. A
# smaller-dims (I', A, L'*E) layout is a pure ROW-INDEX SUBSET of the full
# (I, A, L*E) layout for the same lanes, provided the elem-slot stride E is
# kept (whole lists only):
#
#   op bands        rows g + [0, I')           per op group g
#   clock band      rows co + a*I + [0, I')    per actor a (strided)
#   elem bands      rows g + [0, L'*E)         per elem group g
#   ah band         all A rows
#
# Every band is lane-independent in the kernel (cuda_kernels.
# reconcile_rows_hash: one output per lane), op and elem rows join only
# within their own band ranges, and unused rows (op_mask = 0, ins_mask = 0)
# add nothing to the hash. So hashing the subset buffer at dims
# (I', A, L'*E) is BIT-IDENTICAL to hashing the full buffer, for any
# I' >= ops used and L' >= lists used of every selected lane. Ragged
# per-doc sizes are bucketed onto a power-of-two ladder, so a round runs at
# most MEGA_MAX_BUCKETS kernel shapes; each bucket carries its doc-position
# table, so unpacking the per-doc hashes is exact.

#: distinct bucket shapes a megabatched round may have (the cap on its
#: launches)
MEGA_MAX_BUCKETS = 4
#: smallest quantized op / list band (the kernel's join block height)
MEGA_MIN_DIM = 8


def mega_quantize(n: int, cap: int) -> int:
    """Power-of-two ladder from MEGA_MIN_DIM up to (and clamped at) cap.
    cap need not be a power of two: the top rung is the fleet dimension."""
    q = MEGA_MIN_DIM
    while q < n:
        q *= 2
    return min(q, cap)


def mega_bucket_dims(i_used: int, l_used: int, caps: tuple,
                     e: int) -> tuple:
    """Quantized (i_b, le_b) bucket dims of one doc's used sizes under the
    fleet caps (I, A, LE). Elem slots subset at LIST granularity only
    (le_b = l_b * e keeps the slot stride), and both dims stay multiples of
    the join block height; where that cannot be met the dimension is the
    fleet's."""
    i_cap, _a, le_cap = caps
    i_b = mega_quantize(max(int(i_used), 1), i_cap)
    if i_b % 8:
        i_b = i_cap
    if le_cap == 0 or e == 0:
        return i_b, 0
    l_cap = le_cap // e
    l_b = mega_quantize(max(int(l_used), 1), l_cap) if l_used else 0
    while l_b < l_cap and (l_b * e) % 8:
        l_b *= 2
    le_b = min(l_b * e, le_cap)
    if le_b % 8:
        le_b = le_cap
    return i_b, le_b


def mega_row_map(i: int, a: int, le: int, i_b: int,
                 le_b: int) -> np.ndarray:
    """Row indices into the full (i, a, le) docs-minor buffer that gather a
    valid (i_b, a, le_b) buffer of the SAME doc lanes (the subset property
    above). Its length is rows_count(i_b, a, le_b); row_bases is the one
    layout definition on both sides."""
    src = row_bases(i, a, le)
    ops = np.arange(i_b, dtype=np.int64)
    elems = np.arange(le_b, dtype=np.int64)
    parts = [src[g] + ops
             for g in ("om", "ac", "fid", "act", "seq", "chg", "fh", "vh")]
    parts.extend(src["co"] + aa * i + ops for aa in range(a))
    parts.extend(src[g] + elems for g in ("im", "if", "ip", "io", "il"))
    parts.append(src["ah"] + np.arange(a, dtype=np.int64))
    out = np.concatenate(parts)
    assert len(out) == rows_count(i_b, a, le_b)
    return out


def plan_megabuckets(i_used, l_used, caps: tuple, e: int) -> list[dict]:
    """Bucket a round's docs by quantized shape: positions p group under
    mega_bucket_dims(i_used[p], l_used[p]). Past MEGA_MAX_BUCKETS distinct
    shapes, the smallest padded volume merges into its cheapest superset
    (a doc hashes identically at any dims >= its used sizes, so merging
    adds padding, never error).

    Returns [{"dims": (i_b, le_b), "docs": int64 positions}], largest
    bucket first. The shapes are keyed in the order of their first doc, as
    the reference's per-doc loop keys them (ties in size keep that order);
    the dims are computed once per distinct (i_used, l_used) pair."""
    i_used = np.asarray(i_used, np.int64)
    l_used = np.asarray(l_used, np.int64)
    groups: dict[tuple, np.ndarray] = {}
    if len(i_used):
        uniq, first, inv = np.unique((i_used << 32) | l_used,
                                     return_index=True, return_inverse=True)
        key_of = [mega_bucket_dims(int(u >> 32), int(u & 0xFFFFFFFF), caps,
                                   e) for u in uniq]
        key_id: dict[tuple, int] = {}
        pos_key = np.asarray([key_id.setdefault(k, len(key_id))
                              for k in key_of])[inv.reshape(-1)]
        for u in np.argsort(first, kind="stable"):
            key = key_of[u]
            if key not in groups:
                groups[key] = np.flatnonzero(pos_key == key_id[key])
    a_rows = caps[1]
    while len(groups) > MEGA_MAX_BUCKETS:
        small = min(groups, key=lambda k: (rows_count(k[0], a_rows, k[1])
                                           * len(groups[k])))
        members = groups.pop(small)
        best = min(groups,
                   key=lambda k: rows_count(max(k[0], small[0]), a_rows,
                                            max(k[1], small[1])))
        merged = (max(best[0], small[0]), max(best[1], small[1]))
        members = np.concatenate([members, groups.pop(best)])
        groups[merged] = (np.concatenate([groups[merged], members])
                          if merged in groups else members)
    out = [{"dims": k, "docs": np.sort(v)} for k, v in groups.items()]
    out.sort(key=lambda b: -len(b["docs"]))
    return out


# ---------------------------------------------------------------------------
# Span-table lane layout (the batched text-merge plane's wire shape)
#
# Per document, one int32 [len(SPAN_FIELDS), S_pad] block with the span
# axis minor, so a fleet of divergent documents merges as one
# [D, F, S_pad] dispatch. Merge-order encoding (span_kernels sorts by it):
#   slot       2*i for the i-th span of the base (common-history) table,
#              2*g+1 for a concurrent span anchored in the gap after base
#              span g (-1 for the head gap);
#   prio_elem/prio_actor  RGA sibling priority of the span's head element,
#              concurrent spans in one gap order by it DESCENDING;
#   block_seq  ascending tiebreak keeping one side's flattened subtree
#              block contiguous and in its side-local order.

SPAN_FIELDS = ("span_mask", "origin_hash", "start_id", "vis_len", "slot",
               "prio_elem", "prio_actor", "block_seq")


def pack_spans(doc_spans: list) -> np.ndarray:
    """Pack per-document span tables into [D, len(SPAN_FIELDS), S_pad]
    int32 lanes. Each span is an (origin_hash, start_id, vis_len, slot,
    prio_elem, prio_actor, block_seq) tuple; the mask row is synthesized.
    The span axis pads to the lane width (pad_to_lanes); padded slots are
    all zero and mask out."""
    d = len(doc_spans)
    s_max = max((len(sp) for sp in doc_spans), default=0)
    s_pad = pad_to_lanes(max(s_max, 1))
    out = np.zeros((d, len(SPAN_FIELDS), s_pad), np.int32)
    for i, spans in enumerate(doc_spans):
        if not spans:
            continue
        arr = np.asarray(spans, np.int64).T  # [7, s]
        if arr.shape[0] != len(SPAN_FIELDS) - 1:
            raise ValueError(
                f"span tuples must have {len(SPAN_FIELDS) - 1} columns "
                f"({SPAN_FIELDS[1:]}), got {arr.shape[0]}")
        out[i, 0, :arr.shape[1]] = 1
        out[i, 1:, :arr.shape[1]] = arr.astype(np.int32)
    return out


# ---------------------------------------------------------------------------
# Move-resolution tables: one realm (core/moves.MoveProblem) packs into two
# lane blocks,
#
#   nodes [D, 4, N_pad]:  mask, base_parent_slot (-1 root), cand_off,
#                         cand_cnt
#   cands [D, 3, K_pad]:  parent_slot, prio_hi, prio_lo
#
# Candidates are sorted per node by priority DESCENDING and concatenated in
# node-slot order (cand_off/cand_cnt index the runs), so a node's current
# winner is one gather at cand_off + ptr. Both priority components are
# RANK-compressed within the realm: integer compares reproduce the host
# tuple order exactly, priorities stay unique (the cycle-drop rule needs
# it), and no rank can reach the MOVE_PRIO_PAD sentinel.

MOVE_NODE_FIELDS = ("node_mask", "base_parent", "cand_off", "cand_cnt")
MOVE_CAND_FIELDS = ("cand_parent", "cand_hi", "cand_lo")
MOVE_PRIO_PAD = np.iinfo(np.int32).max


def pack_moves(problems: list) -> dict:
    """Pack MoveProblems into the move-resolution lane layout. Returns
    {"nodes": [D, 4, N_pad] int32, "cands": [D, 3, K_pad] int32}."""
    d = len(problems)
    n_max = max((len(p.nodes) for p in problems), default=0)
    k_max = max((sum(len(c) for c in p.cands) for p in problems), default=0)
    n_pad = pad_to_lanes(max(n_max, 1))
    k_pad = pad_to_lanes(max(k_max, 1))
    nodes = np.zeros((d, len(MOVE_NODE_FIELDS), n_pad), np.int32)
    nodes[:, 1, :] = -1
    cands = np.zeros((d, len(MOVE_CAND_FIELDS), k_pad), np.int32)
    cands[:, 0, :] = -1
    cands[:, 1:, :] = MOVE_PRIO_PAD
    for i, p in enumerate(problems):
        n = len(p.nodes)
        if n == 0:
            continue
        # raw lamport sums can exceed int32 and a local unstamped preview
        # op carries a 2^62 sentinel: ranks are order-isomorphic and
        # bounded by the candidate count
        hi_rank = {v: r for r, v in enumerate(
            sorted({c[0] for cl in p.cands for c in cl}))}
        lo_rank = {v: r for r, v in enumerate(
            sorted({c[1] for cl in p.cands for c in cl}))}
        nodes[i, 0, :n] = 1
        nodes[i, 1, :n] = np.asarray(p.base[:n], np.int32) if p.base else -1
        cnt = np.fromiter((len(cl) for cl in p.cands[:n]), np.int64, n)
        nodes[i, 3, :n] = cnt
        nodes[i, 2, :n] = np.cumsum(cnt) - cnt
        flat = [c for cl in p.cands[:n] for c in cl]
        k = len(flat)
        cands[i, 0, :k] = [-1 if c[2] is None else c[2] for c in flat]
        cands[i, 1, :k] = [hi_rank[c[0]] for c in flat]
        cands[i, 2, :k] = [lo_rank[c[1]] for c in flat]
    return {"nodes": nodes, "cands": cands}
