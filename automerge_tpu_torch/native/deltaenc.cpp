// Native columnar delta encoder for the device-resident DocSet.
//
// Replaces the per-op Python loop of ResidentDocSet._encode_delta
// (automerge_tpu/engine/resident.py): given the columnar decode of wire
// frames (native/wire.py WireColumns — the shared representation of JSON and
// binary-frame ingress) and the host's causal-admission verdict, produce the
// delta rows the engine scatters into device state:
//
//   op rows      [k, 9]  (doc, action, fid, arank, seq, change_idx, value, fh, vh)
//   ins rows     [k, 7]  (doc, list_row, slot, elem, arank, parent_slot, fid)
//   newlist rows [k, 4]  (doc, list_row, obj_idx, obj_hash)
//
// plus doc-tagged additions to the per-document interning tables (objects,
// fields, values), which the Python side mirrors so materialize() can decode
// device state without ever having seen per-op Python objects.
//
// The interface is BATCHED: one begin/apply*/collect sequence covers every
// document of a sync round (admitted changes carry a doc column), so the
// ctypes marshalling cost is per round, not per document — per-doc calls
// measured ~200us/doc in ctypes overhead alone, which would swamp the
// encode win for small deltas.
//
// Hashes are bit-identical to the Python encoder's:
//   content_hash(s)  = crc32(utf8(s)) & 0x7fffffff        (encode.py:45)
//   value_hash_of(v) = crc32(value_bytes(v)) & 0x7fffffff (encode.py:60-86)
// so a docset ingested natively reconciles to the same state hash as one
// ingested through the Python path.
//
// Division of labor (kept in Python because it is per-CHANGE, not per-op):
// causal admission / duplicate drop, actor-rank bookkeeping, transitive
// clock rows. This module owns all per-OP work: string interning, field/
// value/element id assignment, crc32 hashing, row building. State is
// persistent per (encoder handle, doc) across calls — arrival-ordered ids,
// exactly like DocTables.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// crc32 (zlib polynomial, matches Python's zlib.crc32)

struct Crc32Table {
  uint32_t t[256];
  Crc32Table() {
    for (uint32_t i = 0; i < 256; i++) {
      uint32_t c = i;
      for (int k = 0; k < 8; k++)
        c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
      t[i] = c;
    }
  }
};
const Crc32Table kCrc;

uint32_t crc32(const char* data, size_t len) {
  uint32_t c = 0xFFFFFFFFu;
  for (size_t i = 0; i < len; i++)
    c = kCrc.t[(c ^ static_cast<uint8_t>(data[i])) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

int32_t content_hash(const std::string& s) {
  return static_cast<int32_t>(crc32(s.data(), s.size()) & 0x7FFFFFFFu);
}

// ---------------------------------------------------------------------------
// wire value tags (native/wire.py)

enum VTag : int8_t {
  V_NONE = 0, V_NULL = 1, V_FALSE = 2, V_TRUE = 3,
  V_INT = 4, V_DOUBLE = 5, V_STR = 6, V_BIGINT = 7,
};

// action codes (engine/encode.py == storage._ACTIONS order)
enum Action : int8_t {
  A_MAKE_MAP = 0, A_MAKE_LIST = 1, A_MAKE_TEXT = 2, A_INS = 3,
  A_SET = 4, A_DEL = 5, A_LINK = 6, A_MOVE = 7,
};

const char kRootId[] = "00000000-0000-0000-0000-000000000000";

// ---------------------------------------------------------------------------
// value identity — the arrival-ordered interning key. Mirrors
// ValueTable._key distinctions: 1 / 1.0 / True / "1" / link("1") all differ.
// kind: 0 null, 1 false, 2 true, 3 int, 4 double, 5 str, 6 bigint, 7 link,
// 8 move destination (str = dest_obj + '\0' + dest_key, bits = dest elem
// or -1 — mirrors engine/encode.py's ("__move__", obj, key, elem) key).

struct ValueKey {
  int8_t kind;
  int64_t bits;      // int value or double bit pattern
  std::string str;   // str / bigint token / link target
  bool operator==(const ValueKey& o) const {
    return kind == o.kind && bits == o.bits && str == o.str;
  }
};

struct ValueKeyHash {
  size_t operator()(const ValueKey& k) const {
    size_t h = std::hash<std::string>()(k.str);
    h ^= std::hash<int64_t>()(k.bits) + 0x9E3779B9u + (h << 6) + (h >> 2);
    return h * 31 + static_cast<size_t>(k.kind);
  }
};

// value_bytes(v) (encode.py:60-81) for hashing
std::string value_bytes(const ValueKey& k) {
  char buf[32];
  switch (k.kind) {
    case 0: return "n";
    case 1: return "b:0";
    case 2: return "b:1";
    case 3:
      snprintf(buf, sizeof buf, "i:%lld", static_cast<long long>(k.bits));
      return buf;
    case 4: {
      std::string out("d:");
      char raw[8];
      std::memcpy(raw, &k.bits, 8);  // little-endian hosts only (x86/arm)
      out.append(raw, 8);
      return out;
    }
    case 5: return "s:" + k.str;
    case 6: return "i:" + k.str;  // bigint: decimal token, same "i:" prefix
    case 7: return "l:" + k.str;
    case 8: {
      snprintf(buf, sizeof buf, ":%lld", static_cast<long long>(k.bits));
      return "m:" + k.str + buf;  // encode.py value_bytes __move__ branch
    }
    default: return "";
  }
}

// ---------------------------------------------------------------------------
// per-document persistent interning state (DocTables' hot half)

struct PairHash {
  size_t operator()(const std::pair<int32_t, std::string>& p) const {
    return std::hash<std::string>()(p.second) * 31 + p.first;
  }
};

struct NewValue {
  int8_t tag;  // ValueKey.kind
  int64_t bits;
  std::string str;
};

struct DocState {
  std::unordered_map<std::string, int32_t> obj_index;
  std::unordered_map<std::pair<int32_t, std::string>, int32_t, PairHash>
      fid_index;
  int32_t n_fields = 0;
  std::unordered_map<ValueKey, int32_t, ValueKeyHash> value_ids;
  std::unordered_map<int32_t, int32_t> list_rows;  // obj idx -> list row
  std::unordered_map<int32_t,
                     std::unordered_map<std::string, int32_t>> elem_slots;
  int32_t max_elems = 0;

  DocState() { obj_index.emplace(kRootId, 0); }
};

// Batch output accumulators: one set per begin/collect cycle, doc-tagged.
struct Encoder {
  std::vector<DocState> docs;

  std::vector<int32_t> op_rows;       // k*9
  std::vector<int32_t> ins_rows;      // k*7
  std::vector<int32_t> newlist_rows;  // k*4
  std::vector<int32_t> new_obj_doc;
  std::vector<int8_t> new_obj_kind;
  std::vector<std::string> new_obj_str;
  std::vector<int32_t> new_fld_doc;
  std::vector<int32_t> new_fld_oi;
  std::vector<std::string> new_fld_key;
  std::vector<int32_t> new_val_doc;
  std::vector<NewValue> new_vals;

  void clear_outputs() {
    op_rows.clear(); ins_rows.clear(); newlist_rows.clear();
    new_obj_doc.clear(); new_obj_kind.clear(); new_obj_str.clear();
    new_fld_doc.clear(); new_fld_oi.clear(); new_fld_key.clear();
    new_val_doc.clear(); new_vals.clear();
  }

  int32_t fid_of(int32_t doc, DocState& t, int32_t oi,
                 const std::string& key) {
    auto it = t.fid_index.find({oi, key});
    if (it != t.fid_index.end()) return it->second;
    int32_t fid = t.n_fields++;
    t.fid_index.emplace(std::make_pair(oi, key), fid);
    new_fld_doc.push_back(doc);
    new_fld_oi.push_back(oi);
    new_fld_key.push_back(key);
    return fid;
  }
};

std::string table_get(const char* blob, const int32_t* off, int32_t i) {
  return std::string(blob + off[i], blob + off[i + 1]);
}

// ---------------------------------------------------------------------------
// AMW1 frame view — pointer math over the binary columnar wire frame
// (sync/frames.py layout). The wire format IS this encoder's input: no
// Python-side decode, blob rebuild, or frame merging is needed for ingest.

struct FrameView {
  int32_t n_changes, n_ops, n_deps;
  const int32_t* op_off;
  const int8_t* op_action;
  const int32_t* op_obj;
  const int32_t* op_key;
  const int32_t* op_elem;
  const int8_t* op_vtag;
  const int64_t* op_vint;
  const double* op_vdbl;
  const int32_t* op_vstr;
  const int32_t* change_actor;
  // string tables: (offsets, blob) pairs
  const int32_t *objects_off, *keys_off, *strings_off, *actors_off;
  const char *objects_blob, *keys_blob, *strings_blob, *actors_blob;
};

bool parse_frame(const char* data, int64_t len, FrameView& v, char* errbuf,
                 int64_t errlen) {
  if (len < 36 || std::memcmp(data, "AMW1", 4) != 0) {
    snprintf(errbuf, errlen, "bad frame magic/size");
    return false;
  }
  uint32_t counts[8];
  std::memcpy(counts, data + 4, 32);
  const int32_t n_changes = static_cast<int32_t>(counts[0]);
  const int32_t n_ops = static_cast<int32_t>(counts[1]);
  const int32_t n_deps = static_cast<int32_t>(counts[2]);
  const int32_t n_actors = static_cast<int32_t>(counts[3]);
  const int32_t n_objects = static_cast<int32_t>(counts[4]);
  const int32_t n_keys = static_cast<int32_t>(counts[5]);
  const int32_t n_messages = static_cast<int32_t>(counts[6]);
  const int32_t n_strings = static_cast<int32_t>(counts[7]);
  v.n_changes = n_changes;
  v.n_ops = n_ops;
  v.n_deps = n_deps;
  const char* p = data + 36;
  const char* end = data + len;
  auto take = [&](int64_t nbytes) {
    const char* out = p;
    p += nbytes;
    return out;
  };
  v.change_actor = reinterpret_cast<const int32_t*>(take(4 * n_changes));
  take(4 * n_changes);  // change_seq (admission metadata, host-side)
  take(4 * n_changes);  // change_msg
  take(4 * (n_changes + 1));  // deps_off
  take(4 * n_deps);           // deps_actor
  take(4 * n_deps);           // deps_seq
  v.op_off = reinterpret_cast<const int32_t*>(take(4 * (n_changes + 1)));
  v.op_action = reinterpret_cast<const int8_t*>(take(n_ops));
  v.op_obj = reinterpret_cast<const int32_t*>(take(4 * n_ops));
  v.op_key = reinterpret_cast<const int32_t*>(take(4 * n_ops));
  v.op_elem = reinterpret_cast<const int32_t*>(take(4 * n_ops));
  v.op_vtag = reinterpret_cast<const int8_t*>(take(n_ops));
  v.op_vint = reinterpret_cast<const int64_t*>(take(8 * n_ops));
  v.op_vdbl = reinterpret_cast<const double*>(take(8 * n_ops));
  v.op_vstr = reinterpret_cast<const int32_t*>(take(4 * n_ops));
  auto table = [&](int32_t n, const int32_t*& off, const char*& blob) {
    off = reinterpret_cast<const int32_t*>(take(4 * (n + 1)));
    blob = take(n ? off[n] : 0);
  };
  table(n_actors, v.actors_off, v.actors_blob);
  table(n_objects, v.objects_off, v.objects_blob);
  table(n_keys, v.keys_off, v.keys_blob);
  {
    const int32_t* moff;
    const char* mblob;
    table(n_messages, moff, mblob);  // messages: host-side only
  }
  table(n_strings, v.strings_off, v.strings_blob);
  if (p > end) {
    snprintf(errbuf, errlen, "frame truncated");
    return false;
  }
  return true;
}

}  // namespace

extern "C" {

void* amtpu_denc_new() { return new Encoder(); }

void amtpu_denc_free(void* h) { delete static_cast<Encoder*>(h); }

int32_t amtpu_denc_add_docs(void* h, int32_t n) {
  auto* e = static_cast<Encoder*>(h);
  for (int32_t i = 0; i < n; i++) e->docs.emplace_back();
  return static_cast<int32_t>(e->docs.size());
}

// Start a new batch: clears the output accumulators. One batch may span
// several apply calls (admission can interleave changes queued from earlier
// frames, grouped into consecutive runs per source columns batch); outputs
// accumulate across them in admission order.
void amtpu_denc_begin(void* h) {
  static_cast<Encoder*>(h)->clear_outputs();
}

// Apply admitted changes (possibly across many docs, many frames) directly
// from raw wire-frame bytes. Per-admitted metadata comes from the host's
// causal admission:
//   adm_frame[j]      which frame the change lives in
//   adm_idx[j]        change index within that frame
//   adm_doc[j]        document slot
//   adm_arank[j]      global actor rank (LWW tie-break order)
//   adm_seq[j]        change seq
//   adm_change_idx[j] running per-doc change counter
// Returns 0, or -1 with errbuf filled.
int32_t amtpu_denc_apply_frames(
    void* h, const char** frames, const int64_t* frame_lens, int32_t n_frames,
    const int32_t* adm_frame, const int32_t* adm_idx, const int32_t* adm_doc,
    const int32_t* adm_arank, const int32_t* adm_seq,
    const int32_t* adm_change_idx,
    int32_t n_admitted, char* errbuf, int64_t errlen) {
  auto* e = static_cast<Encoder*>(h);
  std::vector<FrameView> views(n_frames);
  for (int32_t f = 0; f < n_frames; f++) {
    if (!parse_frame(frames[f], frame_lens[f], views[f], errbuf, errlen))
      return -1;
  }

  for (int32_t j = 0; j < n_admitted; j++) {
    const FrameView& v = views[adm_frame[j]];
    const int32_t ci = adm_idx[j];
    const int32_t doc = adm_doc[j];
    if (doc < 0 || doc >= static_cast<int32_t>(e->docs.size())) {
      snprintf(errbuf, errlen, "doc %d out of range", doc);
      return -1;
    }
    if (ci < 0 || ci >= v.n_changes) {
      snprintf(errbuf, errlen, "change %d out of range", ci);
      return -1;
    }
    DocState& t = e->docs[doc];
    const int32_t arank = adm_arank[j];
    const int32_t seq = adm_seq[j];
    const int32_t change_idx = adm_change_idx[j];
    const std::string actor =
        table_get(v.actors_blob, v.actors_off, v.change_actor[ci]);

    for (int32_t op = v.op_off[ci]; op < v.op_off[ci + 1]; op++) {
      const int8_t code = v.op_action[op];
      int32_t fid = -1, value = -1, fh = 0, vh = 0;

      if (code == A_MAKE_MAP || code == A_MAKE_LIST || code == A_MAKE_TEXT) {
        std::string obj = table_get(v.objects_blob, v.objects_off,
                                    v.op_obj[op]);
        auto it = t.obj_index.find(obj);
        if (it == t.obj_index.end()) {
          int32_t oi = static_cast<int32_t>(t.obj_index.size());
          t.obj_index.emplace(obj, oi);
          e->new_obj_doc.push_back(doc);
          e->new_obj_kind.push_back(code);
          e->new_obj_str.push_back(obj);
          if (code == A_MAKE_LIST || code == A_MAKE_TEXT) {
            int32_t row = static_cast<int32_t>(t.list_rows.size());
            t.list_rows.emplace(oi, row);
            t.elem_slots.emplace(oi,
                                 std::unordered_map<std::string, int32_t>());
            e->newlist_rows.push_back(doc);
            e->newlist_rows.push_back(row);
            e->newlist_rows.push_back(oi);
            e->newlist_rows.push_back(content_hash(obj));
          }
        }
      } else if (code == A_INS) {
        std::string obj = table_get(v.objects_blob, v.objects_off,
                                    v.op_obj[op]);
        auto oit = t.obj_index.find(obj);
        if (oit == t.obj_index.end()) {
          snprintf(errbuf, errlen, "ins into unknown object");
          return -1;
        }
        const int32_t oi = oit->second;
        std::string eid = actor + ":" + std::to_string(v.op_elem[op]);
        auto& slots = t.elem_slots[oi];
        if (slots.find(eid) == slots.end()) {
          int32_t slot = static_cast<int32_t>(slots.size());
          slots.emplace(eid, slot);
          if (slot + 1 > t.max_elems) t.max_elems = slot + 1;
          int32_t parent_slot = -1;
          std::string key = v.op_key[op] >= 0
              ? table_get(v.keys_blob, v.keys_off, v.op_key[op])
              : std::string();
          if (key != "_head") {
            auto pit = slots.find(key);
            if (pit == slots.end()) {
              snprintf(errbuf, errlen, "ins after unknown element");
              return -1;
            }
            parent_slot = pit->second;
          }
          int32_t efid = e->fid_of(doc, t, oi, eid);
          e->ins_rows.push_back(doc);
          e->ins_rows.push_back(t.list_rows[oi]);
          e->ins_rows.push_back(slot);
          e->ins_rows.push_back(v.op_elem[op]);
          e->ins_rows.push_back(arank);
          e->ins_rows.push_back(parent_slot);
          e->ins_rows.push_back(efid);
        }
      } else if (code == A_MOVE) {
        // a move's field is the moved target's LOCATION field on the
        // root object ("\0loc\0" + moved id): location ops of one target
        // dominate each other there regardless of destination, exactly
        // matching the host compactor's move-chain join and keeping the
        // state hash replica-independent (engine/resident.py twin)
        std::string obj = table_get(v.objects_blob, v.objects_off,
                                    v.op_obj[op]);
        auto oit = t.obj_index.find(obj);
        if (oit == t.obj_index.end()) {
          snprintf(errbuf, errlen, "move into unknown object");
          return -1;
        }
        std::string moved = v.op_vstr[op] >= 0
            ? table_get(v.strings_blob, v.strings_off, v.op_vstr[op])
            : std::string();
        std::string lockey("\0loc\0", 5);
        if (v.op_elem[op] >= 0) {
          // list move: element ids are list-scoped, key by (list, elem id)
          // — encode.py move_loc_key twin
          lockey += obj;
          lockey.push_back('\0');
        }
        lockey += moved;
        fid = e->fid_of(doc, t, 0, lockey);
        std::string fk = kRootId;
        fk.push_back('\0');
        fk += lockey;
        fh = content_hash(fk);
        ValueKey vk;
        vk.kind = 8;
        vk.bits = v.op_elem[op];
        std::string key = v.op_key[op] >= 0
            ? table_get(v.keys_blob, v.keys_off, v.op_key[op])
            : std::string();
        vk.str = obj;
        vk.str.push_back('\0');
        vk.str += key;
        auto vit = t.value_ids.find(vk);
        if (vit != t.value_ids.end()) {
          value = vit->second;
        } else {
          value = static_cast<int32_t>(t.value_ids.size());
          t.value_ids.emplace(vk, value);
          e->new_val_doc.push_back(doc);
          e->new_vals.push_back({vk.kind, vk.bits, vk.str});
        }
        std::string vb = value_bytes(vk);
        vh = static_cast<int32_t>(crc32(vb.data(), vb.size()) & 0x7FFFFFFFu);
      } else {  // set / del / link
        std::string obj = table_get(v.objects_blob, v.objects_off,
                                    v.op_obj[op]);
        auto oit = t.obj_index.find(obj);
        if (oit == t.obj_index.end()) {
          snprintf(errbuf, errlen, "assign into unknown object");
          return -1;
        }
        const int32_t oi = oit->second;
        std::string key = v.op_key[op] >= 0
            ? table_get(v.keys_blob, v.keys_off, v.op_key[op])
            : std::string();
        fid = e->fid_of(doc, t, oi, key);
        std::string fk = obj;
        fk.push_back('\0');
        fk += key;
        fh = content_hash(fk);
        if (code == A_SET || code == A_LINK) {
          ValueKey vk;
          if (code == A_LINK) {
            // link value rides the wire as a string (the target object id)
            vk.kind = 7; vk.bits = 0;
            vk.str = v.op_vstr[op] >= 0
                ? table_get(v.strings_blob, v.strings_off, v.op_vstr[op])
                : std::string();
          } else {
            switch (v.op_vtag[op]) {
              case V_NULL: case V_NONE: vk.kind = 0; vk.bits = 0; break;
              case V_FALSE: vk.kind = 1; vk.bits = 0; break;
              case V_TRUE: vk.kind = 2; vk.bits = 0; break;
              case V_INT: vk.kind = 3; vk.bits = v.op_vint[op]; break;
              case V_DOUBLE: {
                vk.kind = 4;
                std::memcpy(&vk.bits, &v.op_vdbl[op], 8);
                break;
              }
              case V_STR:
                vk.kind = 5; vk.bits = 0;
                vk.str = table_get(v.strings_blob, v.strings_off,
                                   v.op_vstr[op]);
                break;
              case V_BIGINT:
                vk.kind = 6; vk.bits = 0;
                vk.str = table_get(v.strings_blob, v.strings_off,
                                   v.op_vstr[op]);
                break;
              default:
                snprintf(errbuf, errlen, "bad value tag %d", v.op_vtag[op]);
                return -1;
            }
          }
          auto vit = t.value_ids.find(vk);
          if (vit != t.value_ids.end()) {
            value = vit->second;
          } else {
            value = static_cast<int32_t>(t.value_ids.size());
            t.value_ids.emplace(vk, value);
            e->new_val_doc.push_back(doc);
            e->new_vals.push_back({vk.kind, vk.bits, vk.str});
          }
          std::string vb = value_bytes(vk);
          vh = static_cast<int32_t>(crc32(vb.data(), vb.size()) & 0x7FFFFFFFu);
        }
      }
      e->op_rows.push_back(doc);
      e->op_rows.push_back(code);
      e->op_rows.push_back(fid);
      e->op_rows.push_back(arank);
      e->op_rows.push_back(seq);
      e->op_rows.push_back(change_idx);
      e->op_rows.push_back(value);
      e->op_rows.push_back(fh);
      e->op_rows.push_back(vh);
    }
  }
  return 0;
}

// Sizes of the batch accumulated since begin():
// [0] n_op_rows  [1] n_ins  [2] n_newlists
// [3] n_new_objects [4] bytes_new_objects
// [5] n_new_fields  [6] bytes_new_fields
// [7] n_new_values  [8] bytes_new_values
void amtpu_denc_sizes(void* h, int64_t* out) {
  auto* e = static_cast<Encoder*>(h);
  out[0] = static_cast<int64_t>(e->op_rows.size() / 9);
  out[1] = static_cast<int64_t>(e->ins_rows.size() / 7);
  out[2] = static_cast<int64_t>(e->newlist_rows.size() / 4);
  out[3] = static_cast<int64_t>(e->new_obj_str.size());
  int64_t b = 0;
  for (auto& s : e->new_obj_str) b += static_cast<int64_t>(s.size());
  out[4] = b;
  out[5] = static_cast<int64_t>(e->new_fld_key.size());
  b = 0;
  for (auto& s : e->new_fld_key) b += static_cast<int64_t>(s.size());
  out[6] = b;
  out[7] = static_cast<int64_t>(e->new_vals.size());
  b = 0;
  for (auto& v : e->new_vals) b += static_cast<int64_t>(v.str.size());
  out[8] = b;
}

// Replace one document's element-slot maps with the compacted view
// (engine/compaction.py): clear every list's eid->slot map, re-add the
// retained entries with their renumbered slots, reset max_elems. The
// next-slot rule (slot = elem_slots[obj].size()) and insert-anchor
// resolution then continue seamlessly from the compacted numbering.
void amtpu_denc_reset_elem_slots(void* h, int32_t doc,
                                 const int32_t* obj_idx,
                                 const int32_t* slots,
                                 const char* eid_blob,
                                 const int32_t* eid_off, int32_t n,
                                 int32_t max_elems) {
  auto* e = static_cast<Encoder*>(h);
  if (doc < 0 || doc >= static_cast<int32_t>(e->docs.size())) return;
  DocState& t = e->docs[doc];
  for (auto& kv : t.elem_slots) kv.second.clear();
  for (int32_t k = 0; k < n; k++) {
    std::string eid(eid_blob + eid_off[k], eid_blob + eid_off[k + 1]);
    t.elem_slots[obj_idx[k]].emplace(std::move(eid), slots[k]);
  }
  t.max_elems = max_elems;
}

// Per-doc capacity stats into out[n_docs*3]: (n_lists, max_elems, n_fields).
void amtpu_denc_stats(void* h, int64_t* out) {
  auto* e = static_cast<Encoder*>(h);
  for (size_t i = 0; i < e->docs.size(); i++) {
    DocState& t = e->docs[i];
    out[i * 3 + 0] = static_cast<int64_t>(t.list_rows.size());
    out[i * 3 + 1] = static_cast<int64_t>(t.max_elems);
    out[i * 3 + 2] = static_cast<int64_t>(t.n_fields);
  }
}

void amtpu_denc_copy(void* h, int32_t* op_rows, int32_t* ins_rows,
                     int32_t* newlist_rows,
                     int32_t* obj_doc, int8_t* obj_kinds, int32_t* obj_off,
                     char* obj_blob,
                     int32_t* field_doc, int32_t* field_obj,
                     int32_t* field_off, char* field_blob,
                     int32_t* val_doc, int8_t* val_tag, int64_t* val_int,
                     double* val_dbl, int32_t* val_off, char* val_blob) {
  auto* e = static_cast<Encoder*>(h);
  std::memcpy(op_rows, e->op_rows.data(), e->op_rows.size() * 4);
  std::memcpy(ins_rows, e->ins_rows.data(), e->ins_rows.size() * 4);
  std::memcpy(newlist_rows, e->newlist_rows.data(),
              e->newlist_rows.size() * 4);

  int32_t pos = 0;
  for (size_t i = 0; i < e->new_obj_str.size(); i++) {
    obj_doc[i] = e->new_obj_doc[i];
    obj_kinds[i] = e->new_obj_kind[i];
    obj_off[i] = pos;
    std::memcpy(obj_blob + pos, e->new_obj_str[i].data(),
                e->new_obj_str[i].size());
    pos += static_cast<int32_t>(e->new_obj_str[i].size());
  }
  obj_off[e->new_obj_str.size()] = pos;

  pos = 0;
  for (size_t i = 0; i < e->new_fld_key.size(); i++) {
    field_doc[i] = e->new_fld_doc[i];
    field_obj[i] = e->new_fld_oi[i];
    field_off[i] = pos;
    std::memcpy(field_blob + pos, e->new_fld_key[i].data(),
                e->new_fld_key[i].size());
    pos += static_cast<int32_t>(e->new_fld_key[i].size());
  }
  field_off[e->new_fld_key.size()] = pos;

  pos = 0;
  for (size_t i = 0; i < e->new_vals.size(); i++) {
    val_doc[i] = e->new_val_doc[i];
    val_tag[i] = e->new_vals[i].tag;
    val_int[i] = e->new_vals[i].bits;
    double d = 0;
    if (e->new_vals[i].tag == 4) std::memcpy(&d, &e->new_vals[i].bits, 8);
    val_dbl[i] = d;
    val_off[i] = pos;
    std::memcpy(val_blob + pos, e->new_vals[i].str.data(),
                e->new_vals[i].str.size());
    pos += static_cast<int32_t>(e->new_vals[i].str.size());
  }
  val_off[e->new_vals.size()] = pos;
}

}  // extern "C"
