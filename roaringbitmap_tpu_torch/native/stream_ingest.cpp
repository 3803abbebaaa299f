// Native ingest engine: serialized RoaringFormatSpec blobs -> blocked
// compact device streams, in one pass over the wire bytes.
//
// This is the C++ runtime tier of the host->device ingest path: the
// group-by-key rotation (the reference Java library's
// ParallelAggregation.groupByKey, ParallelAggregation.java:136-152) fused
// with the zero-copy serialized parse
// (buffer/ImmutableRoaringArray.java:43-53,166-194) and the stream
// classification of ops/packing._emit_container_streams.  Semantics are
// bit-identical to ops.packing.pack_blocked_compact (the NumPy reference
// implementation, which remains the test oracle) —
// including every hostile-input guard: cookie/bounds validation, strictly
// increasing keys, array sortedness, run bounds/overlap/cardinality.
//
// Exposed as a C ABI consumed via ctypes.
// Protocol: rb_ingest() parses + rotates + classifies into an opaque
// result; the caller reads sizes, allocates NumPy arrays, and calls
// rb_export() to fill them; rb_free() releases the handle.

#include <cstdint>
#include <cstring>
#include <cstdio>
#include <string>
#include <vector>
#include <algorithm>

namespace {

constexpr int WORDS32 = 2048;               // u32 words per container image
constexpr int ARRAY_MAX = 4096;             // array/bitmap promotion bound
constexpr uint32_t COOKIE_RUN = 12347;      // SERIAL_COOKIE
constexpr uint32_t COOKIE_NORUN = 12346;    // SERIAL_COOKIE_NO_RUNCONTAINER
constexpr int NO_OFFSET_THRESHOLD = 4;      // RoaringArray.java:25

struct ContainerRec {
  const uint8_t* payload;   // start of payload bytes
  int64_t payload_len;
  int32_t card;             // declared cardinality
  uint16_t key;
  uint8_t kind;             // 0=array 1=bitmap 2=run
};

struct Err {
  char msg[256];
  bool set = false;
  void fail(const char* fmt, long a = 0, long b = 0) {
    if (!set) std::snprintf(msg, sizeof msg, fmt, a, b);
    set = true;
  }
};

inline uint16_t rd16(const uint8_t* p) {
  uint16_t v; std::memcpy(&v, p, 2); return v;   // little-endian host
}
inline uint32_t rd32(const uint8_t* p) {
  uint32_t v; std::memcpy(&v, p, 4); return v;
}

// Parse one serialized bitmap; append its container records.  Mirrors
// format.spec.SerializedView (validation included).
bool parse_source(const uint8_t* buf, int64_t len,
                  std::vector<ContainerRec>& out, Err& err) {
  if (len < 8) { err.fail("buffer too small for a cookie"); return false; }
  uint32_t cookie = rd32(buf);
  int64_t size, pos;
  bool hasrun;
  if ((cookie & 0xFFFF) == COOKIE_RUN) {
    size = (cookie >> 16) + 1; hasrun = true; pos = 4;
  } else if (cookie == COOKIE_NORUN) {
    size = rd32(buf + 4); hasrun = false; pos = 8;
  } else {
    err.fail("I failed to find a valid cookie."); return false;
  }
  if (size > (1 << 16)) { err.fail("Size too large"); return false; }
  const uint8_t* marker = nullptr;
  if (hasrun) {
    int64_t nmarker = (size + 7) / 8;
    if (pos + nmarker > len) { err.fail("truncated run marker"); return false; }
    marker = buf + pos;
    pos += nmarker;
  }
  if (pos + 4 * size > len) { err.fail("truncated descriptive header"); return false; }
  const uint8_t* desc = buf + pos;
  pos += 4 * size;
  if (hasrun ? size >= NO_OFFSET_THRESHOLD : true) pos += 4 * size;  // skip offsets

  uint16_t prev_key = 0;
  size_t base = out.size();
  out.reserve(base + size);
  for (int64_t i = 0; i < size; i++) {
    uint16_t key = rd16(desc + 4 * i);
    int32_t card = (int32_t)rd16(desc + 4 * i + 2) + 1;
    if (i > 0 && key <= prev_key) {
      err.fail("keys not strictly increasing"); return false;
    }
    prev_key = key;
    bool is_run = marker && (marker[i >> 3] >> (i & 7) & 1);
    bool is_bitmap = !is_run && card > ARRAY_MAX;
    ContainerRec r;
    r.key = key; r.card = card;
    r.kind = is_run ? 2 : (is_bitmap ? 1 : 0);
    int64_t psize;
    if (is_run) {
      if (pos + 2 > len) { err.fail("truncated run container"); return false; }
      int64_t nruns = rd16(buf + pos);
      psize = 2 + 4 * nruns;
    } else {
      psize = is_bitmap ? 8192 : 2 * (int64_t)card;
    }
    if (pos + psize > len) { err.fail("payload overruns buffer"); return false; }
    r.payload = buf + pos;
    r.payload_len = psize;
    pos += psize;
    out.push_back(r);
  }
  return true;
}

// The two transfer streams of ops.packing.CompactStreams: dense wire
// images (bitmap / big-run) and raw u16 member values (array / small-run).
struct StreamSet {
  std::vector<uint32_t> dense_words;   // [Md * 2048]
  std::vector<int32_t> dense_dest;     // [Md]
  std::vector<uint16_t> values;        // [V]
  std::vector<int32_t> val_counts;     // [Mv]
  std::vector<int32_t> val_dest;       // [Mv]
};

// Classify one container record into the stream set at destination `row`
// (the emission half of ops.packing._emit_container_streams, validation
// included).  Returns false with err set on hostile input.
bool emit_container(const ContainerRec& r, int64_t row, int64_t pos,
                    StreamSet& S, Err& err) {
  if (r.kind == 1) {                       // bitmap: wire image as-is
    if (r.payload_len != 8192) {
      err.fail("container %ld: truncated bitmap payload", pos);
      return false;
    }
    size_t at = S.dense_words.size();
    S.dense_words.resize(at + WORDS32);
    std::memcpy(S.dense_words.data() + at, r.payload, 8192);
    S.dense_dest.push_back((int32_t)row);
    return true;
  }
  if (r.kind == 2) {                       // run container
    int64_t nruns = rd16(r.payload);
    if (r.payload_len != 2 + 4 * nruns) {
      err.fail("container %ld: truncated run payload", pos);
      return false;
    }
    int64_t total = 0, prev_end = -1;
    for (int64_t j = 0; j < nruns; j++) {
      int64_t start = rd16(r.payload + 2 + 4 * j);
      int64_t end = start + rd16(r.payload + 2 + 4 * j + 2);
      if (end > 0xFFFF) {
        err.fail("container %ld: run extends past 65535", pos);
        return false;
      }
      if (start <= prev_end) {
        err.fail("container %ld: overlapping/unsorted runs", pos);
        return false;
      }
      prev_end = end;
      total += end - start + 1;
    }
    if (total != r.card) {
      err.fail("container %ld: run cardinality mismatch", pos);
      return false;
    }
    if (total > ARRAY_MAX) {               // big run: densify to words
      size_t at = S.dense_words.size();
      S.dense_words.resize(at + WORDS32, 0);
      uint32_t* w = S.dense_words.data() + at;
      for (int64_t j = 0; j < nruns; j++) {
        int64_t start = rd16(r.payload + 2 + 4 * j);
        int64_t end = start + rd16(r.payload + 2 + 4 * j + 2);
        for (int64_t v = start; v <= end; v++)
          w[v >> 5] |= (uint32_t)1 << (v & 31);
      }
      S.dense_dest.push_back((int32_t)row);
    } else if (total) {                    // small run: value stream
      for (int64_t j = 0; j < nruns; j++) {
        int64_t start = rd16(r.payload + 2 + 4 * j);
        int64_t end = start + rd16(r.payload + 2 + 4 * j + 2);
        for (int64_t v = start; v <= end; v++)
          S.values.push_back((uint16_t)v);
      }
      S.val_counts.push_back((int32_t)total);
      S.val_dest.push_back((int32_t)row);
    }
    return true;
  }
  // array container: sorted u16 values, shipped raw
  int64_t n = r.payload_len / 2;
  for (int64_t j = 1; j < n; j++) {
    uint16_t a, b2;
    std::memcpy(&a, r.payload + 2 * (j - 1), 2);
    std::memcpy(&b2, r.payload + 2 * j, 2);
    if (b2 <= a) {
      err.fail("container %ld: array values not strictly increasing", pos);
      return false;
    }
  }
  if (n) {
    size_t at = S.values.size();
    S.values.resize(at + n);
    std::memcpy(S.values.data() + at, r.payload, 2 * n);
    S.val_counts.push_back((int32_t)n);
    S.val_dest.push_back((int32_t)row);
  }
  return true;
}

}  // namespace

struct IngestResult {
  std::vector<uint16_t> keys;          // [K] distinct, sorted
  std::vector<int32_t> blk_seg;        // [nb_pad]
  std::vector<int64_t> seg_sizes;      // [K] true rows per segment
  std::vector<int64_t> seg_offsets;    // [K] first padded row
  StreamSet s;
  int64_t n_blocks = 0, nb_pad = 0, carry_row = -1;
  int block = 8;
  Err err;
};

extern "C" {

// bufs: per-source pointers into the caller's blob objects (no concat copy);
// lens: per-source byte lengths.  block<=0 selects adaptively
// (packing.choose_block rule).  On error returns the handle with
// rb_error() set (caller must still rb_free).
IngestResult* rb_ingest(const uint8_t* const* bufs, const int64_t* lens,
                        int64_t n_sources, int block, int round_blocks,
                        int carry_slot) {
  auto* R = new IngestResult();
  std::vector<ContainerRec> recs;
  for (int64_t s = 0; s < n_sources; s++) {
    if (!parse_source(bufs[s], lens[s], recs, R->err))
      return R;
  }
  const int64_t m = (int64_t)recs.size();

  // stable counting sort of rows by key (the group-by-key rotation)
  std::vector<int64_t> count(1 << 16, 0);
  for (auto& r : recs) count[r.key]++;
  std::vector<uint16_t>& keys = R->keys;
  std::vector<int64_t> g;  // segment sizes
  for (int64_t k = 0; k < (1 << 16); k++)
    if (count[k]) { keys.push_back((uint16_t)k); g.push_back(count[k]); }
  const int64_t K = (int64_t)keys.size();
  std::vector<int64_t> seg_of_key(1 << 16, -1);
  for (int64_t i = 0; i < K; i++) seg_of_key[keys[i]] = i;

  // block selection: median of g (choose_block ladder: >=32 -> 32,
  // >=16 -> 16, else 8)
  if (block <= 0) {
    if (g.empty()) block = 8;
    else {
      std::vector<int64_t> tmp = g;
      std::nth_element(tmp.begin(), tmp.begin() + tmp.size() / 2, tmp.end());
      int64_t med_hi = tmp[tmp.size() / 2];
      double median;
      if (tmp.size() % 2) median = (double)med_hi;
      else {
        auto lo_it = std::max_element(tmp.begin(), tmp.begin() + tmp.size() / 2);
        median = 0.5 * ((double)*lo_it + (double)med_hi);
      }
      block = median >= 32.0 ? 32 : median >= 16.0 ? 16 : 8;
    }
  }
  R->block = block;

  // padded segment extents (+ reserved carry slot in segment 0)
  std::vector<int64_t> gp(K);
  for (int64_t i = 0; i < K; i++) gp[i] = (g[i] + block - 1) / block * block;
  if (carry_slot && K && gp[0] == g[0]) gp[0] += block;
  R->seg_sizes = g;
  R->seg_offsets.resize(K);
  int64_t off = 0;
  for (int64_t i = 0; i < K; i++) { R->seg_offsets[i] = off; off += gp[i]; }
  R->n_blocks = off / block;
  R->nb_pad = (R->n_blocks + round_blocks - 1) / round_blocks * round_blocks;
  R->blk_seg.assign(R->nb_pad, (int32_t)K);
  {
    int64_t b = 0;
    for (int64_t i = 0; i < K; i++)
      for (int64_t j = 0; j < gp[i] / block; j++) R->blk_seg[b++] = (int32_t)i;
  }
  R->carry_row = (carry_slot && K) ? g[0] : -1;

  // emission in sorted-stable order: walk sources/containers in input
  // order per key bucket via a second counting pass
  std::vector<int64_t> next_in_seg(K, 0);
  for (int64_t pos = 0; pos < m; pos++) {
    // rows arrive in input order; their slot is seg_offsets[seg] + seen
    const ContainerRec& r = recs[pos];
    int64_t seg = seg_of_key[r.key];
    int64_t row = R->seg_offsets[seg] + next_in_seg[seg]++;
    if (!emit_container(r, row, pos, R->s, R->err)) return R;
  }
  return R;
}

const char* rb_error(IngestResult* R) { return R->err.set ? R->err.msg : nullptr; }
int64_t rb_num_keys(IngestResult* R) { return (int64_t)R->keys.size(); }
int rb_block(IngestResult* R) { return R->block; }
int64_t rb_n_blocks(IngestResult* R) { return R->n_blocks; }
int64_t rb_nb_pad(IngestResult* R) { return R->nb_pad; }
int64_t rb_carry_row(IngestResult* R) { return R->carry_row; }
int64_t rb_md(IngestResult* R) { return (int64_t)R->s.dense_dest.size(); }
int64_t rb_total_values(IngestResult* R) { return (int64_t)R->s.values.size(); }
int64_t rb_mv(IngestResult* R) { return (int64_t)R->s.val_counts.size(); }

namespace {
void export_streams(StreamSet& S, uint32_t* dense_words, int32_t* dense_dest,
                    uint16_t* values, int32_t* val_counts, int32_t* val_dest) {
  auto cp = [](auto& v, auto* dst) {
    if (!v.empty()) std::memcpy(dst, v.data(), v.size() * sizeof(v[0]));
  };
  cp(S.dense_words, dense_words); cp(S.dense_dest, dense_dest);
  cp(S.values, values); cp(S.val_counts, val_counts);
  cp(S.val_dest, val_dest);
}
}  // namespace

void rb_export(IngestResult* R, uint16_t* keys, int32_t* blk_seg,
               int64_t* seg_sizes, int64_t* seg_offsets,
               uint32_t* dense_words, int32_t* dense_dest, uint16_t* values,
               int32_t* val_counts, int32_t* val_dest) {
  auto cp = [](auto& v, auto* dst) {
    if (!v.empty()) std::memcpy(dst, v.data(), v.size() * sizeof(v[0]));
  };
  cp(R->keys, keys); cp(R->blk_seg, blk_seg);
  cp(R->seg_sizes, seg_sizes); cp(R->seg_offsets, seg_offsets);
  export_streams(R->s, dense_words, dense_dest, values, val_counts, val_dest);
}

void rb_free(IngestResult* R) { delete R; }

// ------------------------------------------------------------ pairwise mode
//
// P serialized pairs -> per-pair union-key alignment + two stream sets
// (the native half of ops.packing.pack_pairwise: RoaringBitmap.or's
// two-pointer key merge, RoaringBitmap.java:864-894, batched).  Each pair's
// a/b containers land at row = pair base + index of their key in the pair's
// key union; the caller densifies both sides on device.

struct PairwiseResult {
  std::vector<uint16_t> keys;   // [M] per-pair union keys, concatenated
  std::vector<int64_t> heads;   // [P+1] row bounds per pair
  StreamSet a, b;
  Err err;
};

PairwiseResult* rb_ingest_pairwise(const uint8_t* const* a_bufs,
                                   const int64_t* a_lens,
                                   const uint8_t* const* b_bufs,
                                   const int64_t* b_lens, int64_t n_pairs) {
  auto* R = new PairwiseResult();
  R->heads.push_back(0);
  std::vector<ContainerRec> ra, rb;
  for (int64_t p = 0; p < n_pairs; p++) {
    ra.clear(); rb.clear();
    if (!parse_source(a_bufs[p], a_lens[p], ra, R->err)) return R;
    if (!parse_source(b_bufs[p], b_lens[p], rb, R->err)) return R;
    // two-pointer merge of the (strictly increasing) key lists
    size_t i = 0, j = 0;
    while (i < ra.size() || j < rb.size()) {
      int64_t row = (int64_t)R->keys.size();
      bool take_a, take_b;
      uint16_t key;
      if (i < ra.size() && j < rb.size()) {
        take_a = ra[i].key <= rb[j].key;
        take_b = rb[j].key <= ra[i].key;
        key = take_a ? ra[i].key : rb[j].key;
      } else if (i < ra.size()) {
        take_a = true; take_b = false; key = ra[i].key;
      } else {
        take_a = false; take_b = true; key = rb[j].key;
      }
      if (take_a) {
        if (!emit_container(ra[i], row, (int64_t)i, R->a, R->err)) return R;
        i++;
      }
      if (take_b) {
        if (!emit_container(rb[j], row, (int64_t)j, R->b, R->err)) return R;
        j++;
      }
      R->keys.push_back(key);
    }
    R->heads.push_back((int64_t)R->keys.size());
  }
  return R;
}

const char* rbp_error(PairwiseResult* R) {
  return R->err.set ? R->err.msg : nullptr;
}
int64_t rbp_m(PairwiseResult* R) { return (int64_t)R->keys.size(); }
int64_t rbp_md_a(PairwiseResult* R) { return (int64_t)R->a.dense_dest.size(); }
int64_t rbp_v_a(PairwiseResult* R) { return (int64_t)R->a.values.size(); }
int64_t rbp_mv_a(PairwiseResult* R) { return (int64_t)R->a.val_counts.size(); }
int64_t rbp_md_b(PairwiseResult* R) { return (int64_t)R->b.dense_dest.size(); }
int64_t rbp_v_b(PairwiseResult* R) { return (int64_t)R->b.values.size(); }
int64_t rbp_mv_b(PairwiseResult* R) { return (int64_t)R->b.val_counts.size(); }

void rbp_export(PairwiseResult* R, uint16_t* keys, int64_t* heads,
                uint32_t* a_dense_words, int32_t* a_dense_dest,
                uint16_t* a_values, int32_t* a_val_counts, int32_t* a_val_dest,
                uint32_t* b_dense_words, int32_t* b_dense_dest,
                uint16_t* b_values, int32_t* b_val_counts,
                int32_t* b_val_dest) {
  auto cp = [](auto& v, auto* dst) {
    if (!v.empty()) std::memcpy(dst, v.data(), v.size() * sizeof(v[0]));
  };
  cp(R->keys, keys); cp(R->heads, heads);
  export_streams(R->a, a_dense_words, a_dense_dest, a_values, a_val_counts,
                 a_val_dest);
  export_streams(R->b, b_dense_words, b_dense_dest, b_values, b_val_counts,
                 b_val_dest);
}

void rbp_free(PairwiseResult* R) { delete R; }

}  // extern "C"
