// slimm_jax native runtime: streaming SAM/BAM/BGZF decoder + single-core
// baseline.
//
// Native data plane (SURVEY.md §2.4 "Native decode"): decodes alignment
// files into fixed-width int32 arrays (read_id, rid, pos) with the read-name
// dictionary (qname + ".1"/".2" pair suffix, reference slimm.hpp:204-209)
// applied in C++, ready for zero-copy device transfer.  Exposed through a
// plain C ABI consumed via ctypes (slimm_jax/io/native.py).
//
// Unlike the reference's SeqAn stream (one record at a time,
// misc.hpp:498-522) the decoder is CHUNK-streaming with bounded raw memory:
// the compressed file is read in fixed-size chunks, BGZF blocks are inflated
// block-parallel across worker threads (each gzip member is independently
// inflatable), and the parsers consume decompressed chunks with carry-over
// buffers.  Peak memory is O(decoded target arrays + read-name dictionary);
// the raw file bytes and the inflated stream are never resident — a SAM/BAM
// larger than RAM profiles with flat memory.
//
// Robustness (reference: SeqAn throws on malformed input, global handler in
// src/CMakeLists.txt:150): truncated/corrupt BGZF or BAM input raises an
// error with byte-offset context instead of silently truncating; malformed
// SAM lines are counted and surfaced as a warning; BGZF CRC32/ISIZE are
// verified per block; a missing BGZF EOF marker is reported as a warning
// (possible truncation at a block boundary).
//
// Also contains a faithful single-threaded C++ implementation of the
// profiler hot loops (reference slimm.hpp:191-303, 351-392, 516-611
// semantics, re-written from the spec in slimm_jax/oracle.py) used as the
// single-core baseline that bench.py compares the device engine against.
//
// Build: make -C native  (g++ -O3 -march=native, links zlib + pthread).

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <chrono>
#include <deque>
#include <memory>
#include <mutex>
#include <numeric>
#include <set>
#include <stdexcept>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

#include <zlib.h>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#if defined(__SSE2__)
#include <emmintrin.h>
#endif
#if defined(__AVX2__)
#include <immintrin.h>
#endif

namespace {

constexpr uint16_t FLAG_UNMAPPED = 0x4;
constexpr uint16_t FLAG_FIRST = 0x40;
constexpr uint16_t FLAG_LAST = 0x80;
constexpr int LINEAGE_LENGTH = 8;

struct DecodeError : std::runtime_error {
  using std::runtime_error::runtime_error;
};

// ---------------------------------------------------------------------------
// byte sources: pull-based decompressed chunk streams (bounded raw memory)
// ---------------------------------------------------------------------------

struct ByteSource {
  virtual ~ByteSource() = default;
  // Replace `out` with the next decompressed chunk; false at clean EOF.
  // Throws DecodeError on corrupt input.
  virtual bool next(std::vector<uint8_t>& out) = 0;
  // Zero-copy variant: a view valid until the next call.  The default
  // forwards to next() via an owned scratch buffer; mmap-backed sources
  // override it to hand out file windows without the copy.
  virtual bool next_view(const uint8_t** p, size_t* n) {
    if (!next(scratch_)) return false;
    *p = scratch_.data();
    *n = scratch_.size();
    return true;
  }
  // true when next_view windows stay valid for the source's LIFETIME
  // (mmap), not just until the next call — required by the pipelined SAM
  // decode, whose tokenizer runs ahead of the consumer.
  virtual bool stable_views() const { return false; }
  // total decompressed size when knowable up front (mmap), else 0 —
  // lets whole-file decodes pre-reserve the target arrays
  virtual size_t size_hint() const { return 0; }
  virtual std::string warning() const { return ""; }

 private:
  std::vector<uint8_t> scratch_;
};

constexpr size_t RAW_CHUNK = 1 << 20;  // compressed-side read granularity

struct FileReader {
  FILE* f = nullptr;
  size_t offset = 0;  // bytes consumed from the file (for error context)

  explicit FileReader(const char* path) { f = std::fopen(path, "rb"); }
  ~FileReader() {
    if (f) std::fclose(f);
  }
  bool ok() const { return f != nullptr; }
  size_t read(uint8_t* dst, size_t n) {
    size_t got = std::fread(dst, 1, n, f);
    offset += got;
    return got;
  }
};

// Uncompressed file (plain SAM text or raw BAM stream).  Regular files are
// memory-mapped and handed out as zero-copy windows (the parse is then one
// pass over the page cache instead of read-copy + parse); pipes and
// map-failures fall back to buffered reads.
struct RawSource : ByteSource {
  FileReader rd;
  const uint8_t* map = nullptr;
  size_t map_size = 0;
  size_t map_pos = 0;

  explicit RawSource(const char* path) : rd(path) {
    if (!rd.ok()) return;
    int fd = fileno(rd.f);
    struct stat st;
    if (fstat(fd, &st) == 0 && S_ISREG(st.st_mode) && st.st_size > 0) {
      void* m = mmap(nullptr, static_cast<size_t>(st.st_size), PROT_READ,
                     MAP_PRIVATE, fd, 0);
      if (m != MAP_FAILED) {
        map = static_cast<const uint8_t*>(m);
        map_size = static_cast<size_t>(st.st_size);
        madvise(const_cast<uint8_t*>(map), map_size, MADV_SEQUENTIAL);
      }
    }
  }
  ~RawSource() override {
    if (map) munmap(const_cast<uint8_t*>(map), map_size);
  }

  bool next_view(const uint8_t** p, size_t* n) override {
    if (!map) return ByteSource::next_view(p, n);
    if (map_pos >= map_size) return false;
    size_t take = std::min(map_size - map_pos, static_cast<size_t>(8) << 20);
    *p = map + map_pos;
    *n = take;
    map_pos += take;
    return true;
  }

  bool stable_views() const override { return map != nullptr; }
  size_t size_hint() const override { return map_size; }

  bool next(std::vector<uint8_t>& out) override {
    if (map) {
      const uint8_t* p;
      size_t n;
      if (!next_view(&p, &n)) {
        out.clear();
        return false;
      }
      out.assign(p, p + n);
      return true;
    }
    out.resize(RAW_CHUNK);
    size_t got = rd.read(out.data(), RAW_CHUNK);
    out.resize(got);
    return got > 0;
  }
};

// Arbitrary (non-BGZF) gzip stream, streaming inflate, multi-member aware.
struct GzipSource : ByteSource {
  FileReader rd;
  z_stream zs{};
  std::vector<uint8_t> in;
  bool in_eof = false;
  bool stream_end = false;

  explicit GzipSource(const char* path) : rd(path) {
    if (inflateInit2(&zs, 15 + 32) != Z_OK)
      throw DecodeError("zlib init failed");
    in.reserve(RAW_CHUNK);
  }
  ~GzipSource() override { inflateEnd(&zs); }

  void refill() {
    in.resize(RAW_CHUNK);
    size_t got = rd.read(in.data(), RAW_CHUNK);
    in.resize(got);
    in_eof = got == 0;
    zs.next_in = in.data();
    zs.avail_in = static_cast<uInt>(got);
  }

  bool next(std::vector<uint8_t>& out) override {
    out.resize(RAW_CHUNK);
    zs.next_out = out.data();
    zs.avail_out = static_cast<uInt>(out.size());
    while (zs.avail_out > 0) {
      if (zs.avail_in == 0 && !in_eof) refill();
      if (zs.avail_in == 0) {  // in_eof
        if (!stream_end)
          throw DecodeError("truncated gzip stream at compressed offset " +
                            std::to_string(rd.offset));
        break;
      }
      int rc = inflate(&zs, Z_NO_FLUSH);
      if (rc == Z_STREAM_END) {
        stream_end = true;
        if (zs.avail_in == 0 && !in_eof) refill();
        if (zs.avail_in == 0) break;  // clean end of the last member
        // another gzip member follows (multi-member concatenation)
        if (inflateReset2(&zs, 15 + 32) != Z_OK)
          throw DecodeError("zlib reset failed");
        stream_end = false;
      } else if (rc != Z_OK && rc != Z_BUF_ERROR) {
        throw DecodeError(std::string("corrupt gzip stream (") +
                          (zs.msg ? zs.msg : "data error") +
                          ") near compressed offset " +
                          std::to_string(rd.offset));
      } else if (rc == Z_BUF_ERROR && zs.avail_in == 0 && in_eof) {
        throw DecodeError("truncated gzip stream at compressed offset " +
                          std::to_string(rd.offset));
      }
    }
    out.resize(out.size() - zs.avail_out);
    return !out.empty();
  }
};

// BGZF: gzip members with a BC extra subfield carrying the block size.
// Blocks are independently inflatable -> batch block-parallel inflate.
struct BgzfSource : ByteSource {
  FileReader rd;
  std::vector<uint8_t> pending;  // compressed bytes not yet consumed
  size_t pending_pos = 0;
  size_t block_start_offset = 0;  // file offset of the current block
  bool raw_eof = false;
  bool saw_eof_marker = false;
  unsigned n_threads;

  explicit BgzfSource(const char* path, unsigned threads)
      : rd(path), n_threads(threads ? threads : 1) {}

  std::string warning() const override {
    if (!saw_eof_marker)
      return "missing BGZF EOF marker (file may be truncated)";
    return "";
  }

  // Ensure >= n bytes available at pending_pos (or raw EOF).
  bool ensure(size_t n) {
    while (pending.size() - pending_pos < n && !raw_eof) {
      size_t old = pending.size();
      if (pending_pos > (1 << 22)) {  // compact periodically
        pending.erase(pending.begin(), pending.begin() + pending_pos);
        old = pending.size();
        pending_pos = 0;
      }
      pending.resize(old + RAW_CHUNK);
      size_t got = rd.read(pending.data() + old, RAW_CHUNK);
      pending.resize(old + got);
      raw_eof = got == 0;
    }
    return pending.size() - pending_pos >= n;
  }

  struct Block {
    std::vector<uint8_t> cdata;  // owned copy of the deflate payload
    uint32_t isize = 0;
    uint32_t crc = 0;
    size_t file_offset = 0;
  };

  // Parse the next BGZF block at pending_pos into an OWNED Block (the copy
  // makes it immune to `pending` compaction/reallocation, and the batch can
  // be inflated on worker threads without touching `pending`).  Returns
  // false at clean EOF on a block boundary.
  bool next_block(Block& b) {
    if (!ensure(1)) return false;
    b.file_offset = block_start_offset;
    if (!ensure(18))
      throw DecodeError("truncated BGZF block header at offset " +
                        std::to_string(b.file_offset));
    const uint8_t* p = pending.data() + pending_pos;
    if (!(p[0] == 0x1f && p[1] == 0x8b && p[2] == 8 && (p[3] & 4)))
      throw DecodeError("corrupt BGZF block magic at offset " +
                        std::to_string(b.file_offset));
    uint16_t xlen;
    memcpy(&xlen, p + 10, 2);
    if (!ensure(12 + static_cast<size_t>(xlen)))
      throw DecodeError("truncated BGZF extra field at offset " +
                        std::to_string(b.file_offset));
    p = pending.data() + pending_pos;  // ensure() may have moved the buffer
    uint32_t bsize = 0;
    bool found_bc = false;
    for (size_t e = 0; e + 4 <= xlen;) {
      const uint8_t* sf = p + 12 + e;
      uint16_t slen;
      memcpy(&slen, sf + 2, 2);
      if (sf[0] == 66 && sf[1] == 67 && slen == 2) {
        uint16_t bs;
        memcpy(&bs, sf + 4, 2);
        bsize = static_cast<uint32_t>(bs) + 1;
        found_bc = true;
        break;
      }
      e += 4 + slen;
    }
    if (!found_bc)
      throw DecodeError("BGZF block without BC subfield at offset " +
                        std::to_string(b.file_offset));
    if (bsize < 12 + static_cast<uint32_t>(xlen) + 8)
      throw DecodeError("corrupt BGZF block size at offset " +
                        std::to_string(b.file_offset));
    if (!ensure(bsize))
      throw DecodeError("truncated BGZF block at offset " +
                        std::to_string(b.file_offset) + " (need " +
                        std::to_string(bsize) + " bytes, have " +
                        std::to_string(pending.size() - pending_pos) + ")");
    p = pending.data() + pending_pos;
    size_t csize = bsize - 12 - xlen - 8;
    b.cdata.assign(p + 12 + xlen, p + 12 + xlen + csize);
    memcpy(&b.crc, p + bsize - 8, 4);
    memcpy(&b.isize, p + bsize - 4, 4);
    pending_pos += bsize;
    block_start_offset += bsize;
    // the EOF sentinel must be the LAST block (28-byte empty member)
    saw_eof_marker = (b.isize == 0 && csize <= 2);
    return true;
  }

  static void inflate_block(const Block& b, std::vector<uint8_t>& out) {
    out.resize(b.isize);
    if (b.isize == 0) return;  // EOF marker / empty block
    z_stream zs{};
    if (inflateInit2(&zs, -15) != Z_OK) throw DecodeError("zlib init failed");
    zs.next_in = const_cast<uint8_t*>(b.cdata.data());
    zs.avail_in = static_cast<uInt>(b.cdata.size());
    zs.next_out = out.data();
    zs.avail_out = static_cast<uInt>(out.size());
    int rc = inflate(&zs, Z_FINISH);
    bool ok = rc == Z_STREAM_END && zs.avail_out == 0;
    inflateEnd(&zs);
    if (!ok)
      throw DecodeError("corrupt BGZF block payload at offset " +
                        std::to_string(b.file_offset));
    uint32_t crc = crc32(0, out.data(), static_cast<uInt>(out.size()));
    if (crc != b.crc)
      throw DecodeError("BGZF CRC mismatch at offset " +
                        std::to_string(b.file_offset));
  }

  bool next(std::vector<uint8_t>& out) override {
    // batch up to K blocks, inflate them in parallel, concatenate
    constexpr size_t K = 64;
    std::vector<Block> blocks;
    blocks.reserve(K);
    Block b;
    while (blocks.size() < K) {
      if (!next_block(b)) break;
      blocks.push_back(std::move(b));
    }
    if (blocks.empty()) return false;

    std::vector<std::vector<uint8_t>> parts(blocks.size());
    unsigned T = static_cast<unsigned>(
        std::min<size_t>(n_threads, blocks.size()));
    if (T <= 1) {
      for (size_t i = 0; i < blocks.size(); ++i)
        inflate_block(blocks[i], parts[i]);
    } else {
      std::vector<std::thread> ws;
      std::vector<std::string> errs(T);
      for (unsigned t = 0; t < T; ++t) {
        ws.emplace_back([&, t]() {
          try {
            for (size_t i = t; i < blocks.size(); i += T)
              inflate_block(blocks[i], parts[i]);
          } catch (const std::exception& e) {
            errs[t] = e.what();
          }
        });
      }
      for (auto& w : ws) w.join();
      for (auto& e : errs)
        if (!e.empty()) throw DecodeError(e);
    }
    size_t total = 0;
    for (auto& pt : parts) total += pt.size();
    out.clear();
    out.reserve(total);
    for (auto& pt : parts) out.insert(out.end(), pt.begin(), pt.end());
    return true;  // possibly-empty chunk (EOF marker only) still signals ok
  }
};

// Background-prefetch wrapper: a producer thread pulls inflated chunks
// from the inner source ahead of the consumer (bounded by a byte budget),
// overlapping BGZF inflate + CRC with the record parse on the other core.
// The BAM parser is a serial consumer (unlike the SAM tokenize/consume
// thread pipeline), so without this wrapper inflate and parse serialize —
// measured 0.61 s -> ~0.42 s on a 2M-record BAM (2-vCPU host).
struct PrefetchSource : ByteSource {
  std::unique_ptr<ByteSource> inner;
  std::mutex m;
  std::condition_variable cv;
  std::deque<std::vector<uint8_t>> q;
  size_t q_bytes = 0;
  bool done = false, stop = false;
  std::string err;
  std::thread th;
  static constexpr size_t BUDGET = 48 << 20;  // decompressed bytes ahead

  explicit PrefetchSource(std::unique_ptr<ByteSource> in)
      : inner(std::move(in)) {
    th = std::thread([this] {
      std::vector<uint8_t> c;
      for (;;) {
        bool ok = false;
        try {
          ok = inner->next(c);
        } catch (const std::exception& e) {
          std::lock_guard<std::mutex> lk(m);
          err = e.what();
          done = true;
          cv.notify_all();
          return;
        }
        std::unique_lock<std::mutex> lk(m);
        if (!ok) {
          done = true;
          cv.notify_all();
          return;
        }
        cv.wait(lk, [&] { return q_bytes < BUDGET || stop; });
        if (stop) {
          done = true;
          cv.notify_all();
          return;
        }
        q_bytes += c.size();
        q.push_back(std::move(c));
        cv.notify_all();
        c = {};
      }
    });
  }

  ~PrefetchSource() override {
    {
      std::lock_guard<std::mutex> lk(m);
      stop = true;
      cv.notify_all();
    }
    th.join();
  }

  bool next(std::vector<uint8_t>& out) override {
    std::unique_lock<std::mutex> lk(m);
    cv.wait(lk, [&] { return !q.empty() || done; });
    if (q.empty()) {
      if (!err.empty()) throw DecodeError(err);
      return false;
    }
    out = std::move(q.front());
    q.pop_front();
    q_bytes -= out.size();
    cv.notify_all();
    return true;
  }

  // consumers call these only after the parse drained the stream (the
  // producer is done by then, so the inner reads are quiescent)
  std::string warning() const override { return inner->warning(); }
  size_t size_hint() const override { return inner->size_hint(); }
};

// ---------------------------------------------------------------------------
// decoded file state
// ---------------------------------------------------------------------------

struct StpuFile {
  std::vector<std::string> ref_names;
  std::vector<int64_t> ref_lens;
  // dedup'd targets: one entry per distinct (read, contig), first hit wins
  // (read_stat::add_target semantics, reference read_stat.hpp:116-135)
  std::vector<int32_t> read_id;
  std::vector<int32_t> rid;
  std::vector<int32_t> pos;
  int64_t n_reads = 0;
  int64_t hits = 0;  // all mapped records, including dropped duplicates
  int64_t avg_read_len = 0;
  int64_t malformed = 0;  // skipped malformed SAM lines
  bool grouped_input = false;  // decoder fast path held: arrays pre-grouped
  int64_t max_targets = 0;     // longest per-read target run (grouped only)
  std::string error;
  std::string warning;
};

// open-addressing set of packed (read_id, rid) keys for first-hit dedup
struct PairSet {
  std::vector<uint64_t> slots;
  size_t mask = 0;
  size_t count = 0;

  PairSet() { rehash(1 << 16); }

  explicit PairSet(size_t expected) {
    size_t n = 1 << 16;
    while (n * 7 < expected * 10) n *= 2;  // keep load factor under 0.7
    rehash(n);
  }

  void rehash(size_t n) {
    std::vector<uint64_t> old = std::move(slots);
    slots.assign(n, UINT64_MAX);
    mask = n - 1;
    count = 0;
    for (uint64_t k : old)
      if (k != UINT64_MAX) insert(k);
  }

  // splitmix64 finalizer: a multiplicative hash alone leaves the bucket
  // bits dependent only on the low key half (read ids live in the high
  // half), which collapses the table into per-contig clusters
  static uint64_t mix(uint64_t h) {
    h ^= h >> 33;
    h *= 0xFF51AFD7ED558CCDull;
    h ^= h >> 33;
    h *= 0xC4CEB9FE1A85EC53ull;
    h ^= h >> 33;
    return h;
  }

  // returns true if newly inserted
  bool insert(uint64_t key) {
    // grow 4x: rehash is all cache misses, so fewer, bigger rehashes win
    if (count * 10 >= slots.size() * 7) rehash(slots.size() * 4);
    size_t i = mix(key) & mask;
    while (true) {
      uint64_t cur = slots[i];
      if (cur == UINT64_MAX) {
        slots[i] = key;
        ++count;
        return true;
      }
      if (cur == key) return false;
      i = (i + 1) & mask;
    }
  }
};

// Arena-backed open-addressing string -> dense-id interner.  ~40B/key vs
// ~150B for unordered_map<string, int32>, and find-or-insert hashes the key
// parts in place (no per-record string construction) — the read-name
// dictionary is the decoder's hottest structure (slimm.hpp:204-211 at
// billions of reads, SURVEY.md §7 hard-part 4).
// Zero-initialized array for hash-table slots.  Large tables (>= 4 MB)
// come from anonymous mmap with MADV_HUGEPAGE: the kernel hands out
// zero-filled 2 MB pages on first touch, so a 2^24-slot reserve costs
// neither an upfront 128-192 MB memset (added ~100 ms to every per-file
// stream open) nor the ~100k random 4 KB fault storm plain calloc pays
// under the intern map's uniform access pattern.  Small tables calloc.
template <typename T>
struct ZeroArr {
  T* p = nullptr;
  size_t n = 0;
  bool mapped = false;
  static constexpr size_t kMmapMin = size_t(4) << 20;

  ZeroArr() = default;
  explicit ZeroArr(size_t count) { alloc(count); }
  ZeroArr(const ZeroArr& o) { copy_from(o); }
  ZeroArr& operator=(const ZeroArr& o) {
    if (this != &o) copy_from(o);
    return *this;
  }
  ZeroArr(ZeroArr&& o) noexcept : p(o.p), n(o.n), mapped(o.mapped) {
    o.p = nullptr;
    o.n = 0;
  }
  ZeroArr& operator=(ZeroArr&& o) noexcept {
    if (this != &o) {
      release();
      p = o.p;
      n = o.n;
      mapped = o.mapped;
      o.p = nullptr;
      o.n = 0;
    }
    return *this;
  }
  ~ZeroArr() { release(); }
  void release() {
    if (!p) return;
    if (mapped)
      munmap(p, n * sizeof(T));
    else
      std::free(p);
    p = nullptr;
    n = 0;
  }
  void alloc(size_t count) {
    release();
    size_t bytes = count * sizeof(T);
    if (bytes >= kMmapMin) {
      void* m = mmap(nullptr, bytes, PROT_READ | PROT_WRITE,
                     MAP_PRIVATE | MAP_ANONYMOUS, -1, 0);
      if (m != MAP_FAILED) {
#ifdef MADV_HUGEPAGE
        madvise(m, bytes, MADV_HUGEPAGE);
#endif
        p = static_cast<T*>(m);
        mapped = true;
        n = count;
        return;
      }
    }
    p = count ? static_cast<T*>(std::calloc(count, sizeof(T))) : nullptr;
    if (!p && count) throw std::bad_alloc();
    mapped = false;
    n = count;
  }
  void copy_from(const ZeroArr& o) {
    alloc(o.n);
    if (o.n) memcpy(p, o.p, o.n * sizeof(T));
  }
  size_t size() const { return n; }
  T& operator[](size_t i) { return p[i]; }
  const T& operator[](size_t i) const { return p[i]; }
  void swap(ZeroArr& o) {
    std::swap(p, o.p);
    std::swap(n, o.n);
    std::swap(mapped, o.mapped);
  }
};

struct StrMap {
  std::vector<char> arena;     // concatenated key bytes
  std::vector<uint64_t> meta;  // (start << 24) | len per id
  // slot = (hash_lo32 << 32) | (id + 1); 0 = empty.  The 32-bit hash tag
  // lives IN the slot so a probe is one cache line; meta/arena are touched
  // only on a tag match (true hit or rare collision).
  ZeroArr<uint64_t> slots;
  size_t mask;

  StrMap() : slots(1 << 16), mask((1 << 16) - 1) {}

  size_t size() const { return meta.size(); }

  // Pre-size for ~est keys (empty maps only): skips the incremental 4x
  // rehashes — each one a random-write pass over the new table — when the
  // key count is predictable from the input size.  Capped at 2^24 slots
  // (128 MB); beyond that the amortized growth cost is negligible.
  void reserve_keys(size_t est) {
    size_t want = slots.size();
    size_t target = est + est / 2;  // keep fill factor under ~0.7
    while (want < target && want < (size_t(1) << 24)) want <<= 1;
    if (want > slots.size() && meta.empty()) {
      slots.alloc(want);
      mask = want - 1;
    }
    meta.reserve(est);
    arena.reserve(est * 16);  // read names run ~8-20 B; skip realloc copies
  }

  // 8-byte-chunked multiply-mix over a ++ b.  Hash VALUES are internal
  // (ids come from intern order; collisions only cost a verify probe, and
  // the 64-bit hash_names mode already accepts the 2^-64 merge risk), so
  // the function only needs speed + dispersion: ~2 multiplies per 8 bytes
  // vs FNV-1a's per-byte multiply (~3x the consume-thread hash cost on
  // 13-15 byte read names).
  static uint64_t hash_chunk(uint64_t h, uint64_t block) {
    h = (h ^ block) * 0x9E3779B97F4A7C15ull;
    return (h ^ (h >> 29)) * 0xBF58476D1CE4E5B9ull;
  }

  static uint64_t hash2_64(const char* a, size_t n, const char* b,
                           size_t m) {
    uint64_t h = 1469598103934665603ull ^ (n + m);
    if (n + m <= 56) {  // read names; one stack copy, then 8B blocks
      char buf[64];
      memcpy(buf, a, n);
      if (m) memcpy(buf + n, b, m);
      size_t total = n + m;
      memset(buf + total, 0, 8);  // zero-pad the tail block
      for (size_t i = 0; i < total; i += 8) {
        uint64_t w;
        memcpy(&w, buf + i, 8);
        h = hash_chunk(h, w);
      }
      return PairSet::mix(h);
    }
    for (size_t i = 0; i < n; ++i) {
      h ^= static_cast<unsigned char>(a[i]);
      h *= 1099511628211ull;
    }
    for (size_t i = 0; i < m; ++i) {
      h ^= static_cast<unsigned char>(b[i]);
      h *= 1099511628211ull;
    }
    return PairSet::mix(h);
  }

  static uint32_t hash2(const char* a, size_t n, const char* b, size_t m) {
    return static_cast<uint32_t>(hash2_64(a, n, b, m));
  }

  void grow() {
    size_t n = slots.size() * 4;  // fewer, bigger rehashes
    ZeroArr<uint64_t> ns(n);
    size_t nm = n - 1;
    for (size_t k = 0; k < slots.size(); ++k) {
      uint64_t s = slots[k];
      if (!s) continue;
      size_t i = static_cast<uint32_t>(s >> 32) & nm;
      while (ns[i]) i = (i + 1) & nm;
      ns[i] = s;
    }
    slots.swap(ns);
    mask = nm;
  }

  bool verify(int32_t id, const char* a, size_t n, const char* b,
              size_t m) const {
    uint64_t mt = meta[id];
    size_t s = mt >> 24, l = mt & 0xFFFFFF;
    return l == n + m && memcmp(arena.data() + s, a, n) == 0 &&
           (m == 0 || memcmp(arena.data() + s + n, b, m) == 0);
  }

  void prefetch(uint32_t h) const {
    __builtin_prefetch(&slots[h & mask]);
  }

  // find-or-insert of the concatenated key a ++ b
  int32_t intern(const char* a, size_t n, const char* b, size_t m) {
    return intern_hashed(a, n, b, m, hash2(a, n, b, m));
  }

  int32_t intern_hashed(const char* a, size_t n, const char* b, size_t m,
                        uint32_t h) {
    if ((meta.size() + 1) * 10 >= slots.size() * 7) grow();
    size_t i = h & mask;
    while (uint64_t s = slots[i]) {
      if (static_cast<uint32_t>(s >> 32) == h) {
        int32_t id = static_cast<int32_t>(s & 0xFFFFFFFF) - 1;
        if (verify(id, a, n, b, m)) return id;
      }
      i = (i + 1) & mask;
    }
    int32_t id = static_cast<int32_t>(meta.size());
    size_t s = arena.size();
    arena.insert(arena.end(), a, a + n);
    arena.insert(arena.end(), b, b + m);
    meta.push_back((static_cast<uint64_t>(s) << 24) | (n + m));
    slots[i] = (static_cast<uint64_t>(h) << 32) |
               static_cast<uint64_t>(static_cast<uint32_t>(id) + 1);
    return id;
  }

  // find-only; -1 if absent
  int32_t find(const char* a, size_t n) const {
    uint32_t h = hash2(a, n, nullptr, 0);
    size_t i = h & mask;
    while (uint64_t s = slots[i]) {
      if (static_cast<uint32_t>(s >> 32) == h) {
        int32_t id = static_cast<int32_t>(s & 0xFFFFFFFF) - 1;
        if (verify(id, a, n, nullptr, 0)) return id;
      }
      i = (i + 1) & mask;
    }
    return -1;
  }

  // key bytes of an interned id (valid for the map's lifetime)
  std::pair<const char*, size_t> key(int32_t id) const {
    uint64_t mt = meta[id];
    return {arena.data() + (mt >> 24), mt & 0xFFFFFF};
  }
};

// 64-bit-hash -> dense read id map: the scale mode for billion-read inputs
// where the full read-name arena (~40+ B/read) exceeds host RAM
// (SURVEY.md §7 hard-part 4).  12 B/read; distinct names colliding on the
// same 64-bit hash merge into one read (birthday bound: ~3% chance of a
// single merged pair at 1e9 reads) — opt-in, trades bit-parity certainty
// for memory.
struct Hash64Map {
  // ids[] is only read at slots where keys[] is nonzero, so calloc's
  // zero-fill is a safe "empty" for both arrays
  ZeroArr<uint64_t> keys;  // mixed hash, 0 = empty (0 remaps below)
  ZeroArr<int32_t> ids;
  size_t mask;
  size_t count = 0;

  Hash64Map() : keys(1 << 16), ids(1 << 16), mask((1 << 16) - 1) {}

  size_t size() const { return count; }

  void reserve_keys(size_t est) {  // see StrMap::reserve_keys
    size_t want = keys.size();
    size_t target = est + est / 2;
    while (want < target && want < (size_t(1) << 24)) want <<= 1;
    if (want > keys.size() && count == 0) {
      keys.alloc(want);
      ids.alloc(want);
      mask = want - 1;
    }
  }

  void grow() {
    size_t n = keys.size() * 4;
    ZeroArr<uint64_t> nk(n);
    ZeroArr<int32_t> ni(n);
    size_t nm = n - 1;
    for (size_t s = 0; s < keys.size(); ++s) {
      if (!keys[s]) continue;
      size_t i = keys[s] & nm;
      while (nk[i]) i = (i + 1) & nm;
      nk[i] = keys[s];
      ni[i] = ids[s];
    }
    keys.swap(nk);
    ids.swap(ni);
    mask = nm;
  }

  void prefetch(uint64_t h) const {
    __builtin_prefetch(&keys[(h ? h : 1) & mask]);
  }

  int32_t intern(uint64_t h) {
    if (h == 0) h = 0x9E3779B97F4A7C15ull;  // reserve 0 as the empty slot
    if ((count + 1) * 10 >= keys.size() * 7) grow();
    size_t i = h & mask;
    while (keys[i]) {
      if (keys[i] == h) return ids[i];
      i = (i + 1) & mask;
    }
    keys[i] = h;
    ids[i] = static_cast<int32_t>(count++);
    return ids[i];
  }

  bool contains(uint64_t h) const {
    if (h == 0) h = 0x9E3779B97F4A7C15ull;
    size_t i = h & mask;
    while (keys[i]) {
      if (keys[i] == h) return true;
      i = (i + 1) & mask;
    }
    return false;
  }
};

struct Decoder {
  StrMap key_to_id;
  bool hash_names = false;  // scale mode: 64-bit hash keys, no name arena
  // BAM sets copy_keys: Stream::take invalidates record pointers across
  // refills, so pending qname bytes must be owned.  The SAM paths keep
  // every record's bytes valid through the per-chunk flush (mmap windows
  // are source-lifetime stable; transient chunks outlive their consume),
  // so they run pointer-mode with no per-record copy.
  bool copy_keys = false;
  Hash64Map hkey_to_id;
  // parallel shard decode: mixed 64-bit key hash per NEW read id, in id
  // order (drives the cross-shard duplicate bloom check + boundary stitch)
  std::vector<uint64_t>* h64_log = nullptr;
  PairSet seen;  // (read, contig) first-hit dedup — fallback path only
  // Fast path for qname-grouped inputs (mapper output order): while every
  // reappearance of a read is consecutive, dedup is a linear scan of the
  // current read's few targets and the hash set is never touched.  The
  // first NON-consecutive reappearance (e.g. coordinate-sorted BAM) builds
  // the pair set from the kept targets once and switches over.
  bool grouped = true;
  int32_t last_id = -1;
  std::vector<int32_t> cur;  // contigs kept for the current read run
  // index (into the target arrays) of the current run's first target —
  // targets before run_start belong to COMPLETED reads and are safe to
  // ship as a streaming chunk (read-boundary cut)
  size_t run_start = 0;
  int64_t sample_count = 0;
  int64_t sample_total = 0;

  // first <=100k records with nonempty seq (reference misc.hpp:509-522)
  void sample_len(int64_t seq_len) {
    if (sample_count < 100000 && seq_len > 0) {
      sample_total += seq_len;
      ++sample_count;
    }
  }

  static uint64_t pack(int32_t id, int32_t rid) {
    return (static_cast<uint64_t>(static_cast<uint32_t>(id)) << 32) |
           static_cast<uint32_t>(rid);
  }

  void emit(StpuFile* f, int32_t id, int32_t rid, int32_t pos) {
    f->read_id.push_back(id);
    f->rid.push_back(rid);
    f->pos.push_back(pos);
  }

  // -- prefetch batching --------------------------------------------------
  // The interner probe is a random HBM/L3 miss per record; batching ~16
  // records lets the hash be computed (and the slot line prefetched) while
  // the bytes are still hot, hiding the miss latency behind parsing.
  static constexpr int BATCH = 16;
  struct Pending {
    const char* q;  // pointer mode; nullptr -> pbuf offset qoff (copy mode)
    uint32_t qoff;
    uint32_t qlen;
    uint16_t flag;
    int32_t rid;
    int32_t pos;
    uint64_t h64;
  };
  Pending pend[BATCH];
  int npend = 0;
  std::vector<char> pbuf;  // copied qname bytes (copy_keys mode only)

  size_t n_keys() const {
    return hash_names ? hkey_to_id.size() : key_to_id.size();
  }

  void reserve_keys(size_t est) {
    if (hash_names) hkey_to_id.reserve_keys(est);
    else key_to_id.reserve_keys(est);
  }

  void add_record(StpuFile* f, const char* qname, size_t qlen, uint16_t flag,
                  int32_t rid, int32_t pos) {
    const char* suffix = "";
    size_t sn = 0;
    if (flag & FLAG_FIRST) { suffix = ".1"; sn = 2; }
    else if (flag & FLAG_LAST) { suffix = ".2"; sn = 2; }
    uint64_t h64 = StrMap::hash2_64(qname, qlen, suffix, sn);
    if (hash_names) hkey_to_id.prefetch(h64);
    else key_to_id.prefetch(static_cast<uint32_t>(h64));
    Pending& p = pend[npend++];
    p.qlen = static_cast<uint32_t>(qlen);
    p.flag = flag;
    p.rid = rid;
    p.pos = pos;
    p.h64 = h64;
    if (copy_keys && !hash_names) {  // hash-key mode never stores bytes
      p.q = nullptr;
      p.qoff = static_cast<uint32_t>(pbuf.size());
      pbuf.insert(pbuf.end(), qname, qname + qlen);
    } else {
      p.q = qname;
      p.qoff = 0;
    }
    if (npend == BATCH) flush(f);
  }

  void flush(StpuFile* f) {
    for (int k = 0; k < npend; ++k) {
      const Pending& p = pend[k];
      const char* key = p.q ? p.q : pbuf.data() + p.qoff;
      const char* sfx = (p.flag & FLAG_FIRST) ? ".1" : ".2";
      size_t sn = (p.flag & (FLAG_FIRST | FLAG_LAST)) ? 2 : 0;
      add_one(f, key, p.qlen, sn ? sfx : "", sn, p.h64, p.rid, p.pos);
    }
    npend = 0;
    pbuf.clear();
  }

  // add a mapped record: intern the read and emit a target unless the
  // (read, contig) pair was already seen (first hit wins,
  // read_stat.hpp:116-135)
  void add_one(StpuFile* f, const char* a, size_t n, const char* b, size_t m,
               uint64_t h64, int32_t rid, int32_t pos) {
    size_t before = n_keys();
    int32_t id = hash_names
        ? hkey_to_id.intern(h64)
        : key_to_id.intern_hashed(a, n, b, m, static_cast<uint32_t>(h64));
    if (h64_log && n_keys() > before) h64_log->push_back(h64);
    ++f->hits;
    if (grouped) {
      if (id == last_id) {
        for (int32_t c : cur)
          if (c == rid) return;  // duplicate within the read: first wins
        cur.push_back(rid);
        if (static_cast<int64_t>(cur.size()) > f->max_targets)
          f->max_targets = static_cast<int64_t>(cur.size());
        emit(f, id, rid, pos);
        return;
      }
      if (n_keys() > before) {  // brand-new read: new run
        last_id = id;
        cur.clear();
        cur.push_back(rid);
        if (f->max_targets < 1) f->max_targets = 1;
        run_start = f->read_id.size();
        emit(f, id, rid, pos);
        return;
      }
      // an old read reappeared non-consecutively: rebuild the pair set
      // from everything kept so far and take the hash path from here on
      // (duplicates dropped earlier kept their first instance, which is
      // in the arrays, so the rebuilt set is complete)
      grouped = false;
      f->max_targets = 0;  // run tracking stops; callers re-measure
      seen = PairSet(f->read_id.size() * 2 + (1 << 16));
      for (size_t i = 0; i < f->read_id.size(); ++i)
        seen.insert(pack(f->read_id[i], f->rid[i]));
    }
    if (seen.insert(pack(id, rid))) emit(f, id, rid, pos);
  }
};

// -- SAM text (chunk-streaming with carry-over) ------------------------------

// First '\t' or '\n' in [p, end) — the tokenizer's single scan over the
// line (AVX2 32-wide / SSE2 16-wide when available).  The wide path pays
// off on the ~read-length seq field; short fields exit on iteration one.
static inline const char* find_delim(const char* p, const char* end);

// Rolling delimiter scanner: one 32-byte block mask amortized across the
// many short fields of a SAM line (mapq..tlen is typically "60\t100M\t*\t0\t0\t"
// — one block covers five fields where per-field find_delim would issue
// five loads+compares).  Monotone: next(from) with from anywhere at or
// after the previous result.
struct DelimCursor {
  const char* end;
#if defined(__AVX2__)
  const char* blk = nullptr;  // base of the cached mask block
  uint32_t mask = 0;
#endif

  explicit DelimCursor(const char* e) : end(e) {}

  inline const char* next(const char* from) {
#if defined(__AVX2__)
    if (blk && from >= blk && from < blk + 32) {
      uint32_t drop = static_cast<uint32_t>(from - blk);
      uint32_t m = mask & (~0u << drop);
      if (m) return blk + __builtin_ctz(m);
      from = blk + 32;
    }
    const char* p = from;
    const __m256i wt = _mm256_set1_epi8('\t');
    const __m256i wn = _mm256_set1_epi8('\n');
    while (p + 32 <= end) {
      __m256i v = _mm256_loadu_si256(reinterpret_cast<const __m256i*>(p));
      uint32_t m = static_cast<uint32_t>(_mm256_movemask_epi8(
          _mm256_or_si256(_mm256_cmpeq_epi8(v, wt),
                          _mm256_cmpeq_epi8(v, wn))));
      if (m) {
        blk = p;
        mask = m;
        return p + __builtin_ctz(m);
      }
      p += 32;
    }
    blk = nullptr;
    while (p < end && *p != '\t' && *p != '\n') ++p;
    return p;
#else
    return find_delim(from, end);
#endif
  }
};

static inline const char* find_delim(const char* p, const char* end) {
#if defined(__AVX2__)
  const __m256i wt = _mm256_set1_epi8('\t');
  const __m256i wn = _mm256_set1_epi8('\n');
  while (p + 32 <= end) {
    __m256i v = _mm256_loadu_si256(reinterpret_cast<const __m256i*>(p));
    int m = _mm256_movemask_epi8(
        _mm256_or_si256(_mm256_cmpeq_epi8(v, wt), _mm256_cmpeq_epi8(v, wn)));
    if (m) return p + __builtin_ctz(static_cast<unsigned>(m));
    p += 32;
  }
#endif
#if defined(__SSE2__)
  const __m128i vt = _mm_set1_epi8('\t');
  const __m128i vn = _mm_set1_epi8('\n');
  while (p + 16 <= end) {
    __m128i v = _mm_loadu_si128(reinterpret_cast<const __m128i*>(p));
    int m = _mm_movemask_epi8(
        _mm_or_si128(_mm_cmpeq_epi8(v, vt), _mm_cmpeq_epi8(v, vn)));
    if (m) return p + __builtin_ctz(static_cast<unsigned>(m));
    p += 16;
  }
#endif
  while (p < end && *p != '\t' && *p != '\n') ++p;
  return p;
}

// Non-negative decimal parse; stops at the first non-digit (every SAM
// numeric field is delimiter-terminated within the buffer).  atoi/atoll
// pay locale + sign handling per call — this is the per-record hot path.
static inline int64_t parse_uint(const char* p) {
  int64_t v = 0;
  while (*p >= '0' && *p <= '9') {
    v = v * 10 + (*p - '0');
    ++p;
  }
  return v;
}

// One tokenized alignment record; qname bytes point into the source's
// stable window, or into the batch arena for carried lines.
struct SamRec {
  const char* q;        // nullptr -> arena_off into SamBatch::arena
  uint32_t arena_off;
  uint32_t qlen;
  uint16_t flag;
  int32_t rid;
  int32_t pos;          // 0-based (pos field - 1)
  int32_t seq_len;
};

struct SamBatch {
  std::vector<SamRec> recs;
  std::string arena;    // qname bytes of chunk-spanning (carried) lines
  void clear() {
    recs.clear();
    arena.clear();
  }
};

// Bounded SPSC hand-off between the tokenizer thread and the consumer
// (interner/dedup) thread of the pipelined SAM decode.
struct BatchQueue {
  std::mutex m;
  std::condition_variable cv_push, cv_pop;
  std::deque<SamBatch> q;
  bool closed = false;
  bool abandoned = false;  // consumer went away: producer must exit
  std::string err;
  static constexpr size_t CAP = 3;

  void push(SamBatch&& b) {
    std::unique_lock<std::mutex> l(m);
    cv_push.wait(l, [&] { return q.size() < CAP || abandoned; });
    if (abandoned) return;
    q.push_back(std::move(b));
    cv_pop.notify_one();
  }
  bool pop(SamBatch& b) {
    std::unique_lock<std::mutex> l(m);
    cv_pop.wait(l, [&] { return !q.empty() || closed; });
    if (q.empty()) return false;
    b = std::move(q.front());
    q.pop_front();
    cv_push.notify_one();
    return true;
  }
  void close(const std::string& e = "") {
    std::lock_guard<std::mutex> l(m);
    closed = true;
    if (!e.empty()) err = e;
    cv_pop.notify_all();
  }
  void abandon() {
    std::lock_guard<std::mutex> l(m);
    abandoned = true;
    cv_push.notify_all();
  }
};

struct SamParser {
  Decoder dec;
  StrMap rid_of;  // contig name -> header index (intern order == index)
  std::string carry;
  int64_t line_no = 0;
  int64_t data_lines = 0;  // non-header lines seen (header-complete signal)
  SamBatch scratch;        // single-thread feed() reuse

  // The parse is split into TOKENIZE (line/field scan, rid lookup,
  // numeric fields — touches only tokenizer state) and CONSUME (read-name
  // interning, first-hit dedup, target emit — touches only the Decoder
  // and the output arrays), so the two halves can run pipelined on two
  // threads (tokenize chunk k+1 while consuming chunk k).

  void emit_rec(const char* const field[11], SamBatch& b, bool arena_copy) {
    SamRec r;
    r.qlen = static_cast<uint32_t>((field[1] - 1) - field[0]);
    r.flag = static_cast<uint16_t>(parse_uint(field[1]));
    r.pos = static_cast<int32_t>(parse_uint(field[3]) - 1);
    const char* seq = field[9];
    int64_t seq_len = (field[10] - 1) - field[9];
    if (seq_len == 1 && seq[0] == '*') seq_len = 0;
    r.seq_len = static_cast<int32_t>(seq_len);
    r.rid = rid_of.find(field[2], (field[3] - 1) - field[2]);
    if (arena_copy) {  // transient bytes (carry buffer): own them
      r.q = nullptr;
      r.arena_off = static_cast<uint32_t>(b.arena.size());
      b.arena.append(field[0], r.qlen);
    } else {
      r.q = field[0];
      r.arena_off = 0;
    }
    b.recs.push_back(r);
  }

  void handle_header(StpuFile* f, const char* p, const char* line_end) {
    if (line_end - p >= 3 && p[1] == 'S' && p[2] == 'Q') {
      std::string sn;
      int64_t ln = 0;
      const char* q = p;
      while (q < line_end) {
        const char* tab =
            static_cast<const char*>(memchr(q, '\t', line_end - q));
        const char* fe = tab ? tab : line_end;
        if (fe - q > 3 && q[2] == ':') {
          if (q[0] == 'S' && q[1] == 'N') sn.assign(q + 3, fe - q - 3);
          else if (q[0] == 'L' && q[1] == 'N')
            ln = atoll(std::string(q + 3, fe - q - 3).c_str());
        }
        q = fe + 1;
      }
      if (!sn.empty() && rid_of.find(sn.data(), sn.size()) < 0) {
        rid_of.intern(sn.data(), sn.size(), nullptr, 0);
        f->ref_names.push_back(sn);
        f->ref_lens.push_back(ln);
      }
    }
  }

  // slow path for complete lines held in transient memory (carry buffer)
  void tokenize_line_slow(StpuFile* f, const char* p, const char* line_end,
                          SamBatch& b) {
    ++line_no;
    if (p == line_end) return;
    if (*p == '@') {
      handle_header(f, p, line_end);
      return;
    }
    ++data_lines;
    // fields: qname flag rname pos mapq cigar rnext pnext tlen seq qual
    const char* field[11];
    int nf = 0;
    const char* q = p;
    field[nf++] = q;
    while (nf < 11 && q < line_end) {
      const char* tab =
          static_cast<const char*>(memchr(q, '\t', line_end - q));
      if (!tab) break;
      q = tab + 1;
      field[nf++] = q;
    }
    if (nf < 11) {  // malformed alignment line: count + skip (SeqAn throws)
      ++f->malformed;
      return;
    }
    emit_rec(field, b, /*arena_copy=*/true);
  }

  void tokenize(StpuFile* f, const uint8_t* data, size_t n, SamBatch& b) {
    const char* p = reinterpret_cast<const char*>(data);
    const char* end = p + n;
    if (!carry.empty()) {
      const char* nl = static_cast<const char*>(memchr(p, '\n', n));
      if (!nl) {
        carry.append(p, n);
        return;
      }
      carry.append(p, nl - p);
      tokenize_line_slow(f, carry.data(), carry.data() + carry.size(), b);
      carry.clear();
      p = nl + 1;
    }
    // Alignment lines tokenize in ONE scan: the delimiter cursor yields
    // the next '\t' OR '\n', so field splitting and line termination
    // share the same pass, and one 32-byte block mask serves all the
    // short fields it covers (per-field find_delim re-loaded the same
    // bytes up to five times across mapq..tlen).
    DelimCursor cursor(end);
    while (p < end) {
      if (*p == '@') {
        const char* nl = static_cast<const char*>(memchr(p, '\n', end - p));
        if (!nl) {
          carry.assign(p, end - p);
          return;
        }
        ++line_no;
        handle_header(f, p, nl);
        p = nl + 1;
        continue;
      }
      if (*p == '\n') {  // empty line
        ++line_no;
        ++p;
        continue;
      }
      const char* field[11];
      int nf = 0;
      const char* q = p;
      const char* d = nullptr;
      field[nf++] = q;
      while (nf < 11) {
        d = cursor.next(q);
        if (d == end) {  // line spans the chunk boundary
          carry.assign(p, end - p);
          return;
        }
        if (*d == '\n') break;
        q = d + 1;
        field[nf++] = q;
      }
      if (nf < 11) {  // malformed alignment line (fewer than 11 columns)
        ++line_no;
        ++data_lines;
        ++f->malformed;
        p = d + 1;
        continue;
      }
      // qual is exactly as long as seq in well-formed SAM (or the single
      // char '*'), so the newline usually sits at field[10] + seq_len —
      // probing there first skips scanning the qual bytes (~40% of the
      // file).  '*' quals and tag-carrying lines miss the probe and take
      // the memchr path.
      const char* nl = nullptr;
      ptrdiff_t slen = (field[10] - 1) - field[9];
      if (slen > 1 && *field[10] != '*' && field[10] + slen < end
          && field[10][slen] == '\n') {
        nl = field[10] + slen;
      } else {
        nl = static_cast<const char*>(
            memchr(field[10], '\n', end - field[10]));
        if (!nl) {
          carry.assign(p, end - p);
          return;
        }
      }
      ++line_no;
      ++data_lines;
      emit_rec(field, b, /*arena_copy=*/false);
      p = nl + 1;
    }
  }

  void tokenize_finish(StpuFile* f, SamBatch& b) {
    if (!carry.empty()) {
      tokenize_line_slow(f, carry.data(), carry.data() + carry.size(), b);
      carry.clear();
    }
  }

  void consume(StpuFile* f, const SamBatch& b) {
    for (const SamRec& r : b.recs) {
      dec.sample_len(r.seq_len);
      if (!(r.flag & FLAG_UNMAPPED) && r.rid >= 0) {
        const char* q = r.q ? r.q : b.arena.data() + r.arena_off;
        dec.add_record(f, q, r.qlen, r.flag, r.rid, r.pos);
      }
    }
    dec.flush(f);  // chunk boundary: expose progress to the stream API
  }

  void feed(StpuFile* f, const uint8_t* data, size_t n) {
    scratch.clear();
    tokenize(f, data, n, scratch);
    consume(f, scratch);
  }

  void finish_consume(StpuFile* f) {
    dec.flush(f);
    f->n_reads = static_cast<int64_t>(dec.n_keys());
    f->grouped_input = dec.grouped;
    if (dec.sample_count == 0) throw DecodeError("no records with sequences");
    f->avg_read_len = dec.sample_total / dec.sample_count;
  }

  void finish(StpuFile* f) {
    scratch.clear();
    tokenize_finish(f, scratch);
    consume(f, scratch);
    finish_consume(f);
  }
};

// -- BAM binary (chunk-streaming) ---------------------------------------------

// Buffered view over a ByteSource for fixed-width binary parsing.
struct Stream {
  ByteSource* src;
  std::vector<uint8_t> buf;
  size_t pos = 0;
  size_t consumed = 0;  // total uncompressed bytes consumed (error context)
  bool eof = false;

  explicit Stream(ByteSource* s) : src(s) {}

  size_t avail() const { return buf.size() - pos; }

  bool ensure(size_t n) {
    const uint8_t* p;
    size_t m;
    while (avail() < n && !eof) {
      if (pos > (1 << 22)) {
        buf.erase(buf.begin(), buf.begin() + pos);
        pos = 0;
      }
      if (!src->next_view(&p, &m)) {
        eof = true;
        break;
      }
      buf.insert(buf.end(), p, p + m);
    }
    return avail() >= n;
  }

  const uint8_t* take(size_t n, const char* what) {
    if (!ensure(n))
      throw DecodeError(std::string("truncated BAM stream: ") + what +
                        " at uncompressed offset " + std::to_string(consumed) +
                        " (need " + std::to_string(n) + " bytes, have " +
                        std::to_string(avail()) + ")");
    const uint8_t* p = buf.data() + pos;
    pos += n;
    consumed += n;
    return p;
  }

  bool at_end() { return !ensure(1); }
};

int32_t rd_i32(const uint8_t* p) {
  int32_t v;
  memcpy(&v, p, 4);
  return v;
}

// Resumable BAM record parser over a buffered Stream: header in init(),
// records in parse_until() which stops once the target arrays reach
// `target_cap` entries (streaming) or the source is exhausted.
struct BamParser {
  Decoder dec;
  int32_t n_ref = 0;
  int64_t rec_no = 0;

  BamParser() { dec.copy_keys = true; }  // Stream::take recycles its buffer

  void init(Stream& st, StpuFile* f) {
    const uint8_t* p = st.take(4, "magic");
    if (memcmp(p, "BAM\1", 4) != 0) throw DecodeError("not a BAM stream");
    int32_t l_text = rd_i32(st.take(4, "l_text"));
    if (l_text < 0 || l_text > (1 << 30))
      throw DecodeError("corrupt BAM header length " +
                        std::to_string(l_text));
    st.take(static_cast<size_t>(l_text), "header text");
    n_ref = rd_i32(st.take(4, "n_ref"));
    if (n_ref < 0 || n_ref > (1 << 28))
      throw DecodeError("corrupt BAM n_ref " + std::to_string(n_ref));
    for (int32_t i = 0; i < n_ref; ++i) {
      int32_t l_name = rd_i32(st.take(4, "ref name length"));
      if (l_name <= 0 || l_name > (1 << 20))
        throw DecodeError("corrupt BAM reference name length at ref " +
                          std::to_string(i));
      p = st.take(static_cast<size_t>(l_name), "ref name");
      f->ref_names.emplace_back(reinterpret_cast<const char*>(p),
                                l_name - 1);
      f->ref_lens.push_back(rd_i32(st.take(4, "ref length")));
    }
  }

  // returns true when the source is exhausted
  bool parse_until(Stream& st, StpuFile* f, size_t target_cap) {
    while (f->read_id.size() < target_cap) {
      if (st.at_end()) {
        dec.flush(f);
        return true;
      }
      size_t rec_off = st.consumed;
      int32_t block_size = rd_i32(st.take(4, "record block_size"));
      if (block_size < 32 || block_size > (1 << 28))
        throw DecodeError("corrupt BAM record size " +
                          std::to_string(block_size) + " at record " +
                          std::to_string(rec_no) + ", uncompressed offset " +
                          std::to_string(rec_off));
      const uint8_t* p = st.take(static_cast<size_t>(block_size),
                                 "record body");
      int32_t ref_id = rd_i32(p);
      int32_t pos = rd_i32(p + 4);
      uint8_t l_read_name = p[8];
      uint16_t flag;
      memcpy(&flag, p + 14, 2);
      int32_t l_seq = rd_i32(p + 16);
      if (l_read_name < 1 ||
          32 + static_cast<int64_t>(l_read_name) > block_size)
        throw DecodeError("corrupt BAM read name length at record " +
                          std::to_string(rec_no) + ", uncompressed offset " +
                          std::to_string(rec_off));
      if (ref_id < -1 || ref_id >= n_ref)
        throw DecodeError("BAM refID " + std::to_string(ref_id) +
                          " out of range at record " +
                          std::to_string(rec_no));
      const char* qname = reinterpret_cast<const char*>(p + 32);
      dec.sample_len(l_seq);
      if (!(flag & FLAG_UNMAPPED) && ref_id >= 0) {
        dec.add_record(f, qname, l_read_name - 1, flag, ref_id, pos);
      }
      ++rec_no;
    }
    dec.flush(f);
    return false;
  }

  void finish(StpuFile* f) {
    f->n_reads = static_cast<int64_t>(dec.n_keys());
    f->grouped_input = dec.grouped;
    if (dec.sample_count == 0)
      throw DecodeError("no records with sequences");
    f->avg_read_len = dec.sample_total / dec.sample_count;
  }
};

void parse_bam_stream(Stream& st, StpuFile* f, bool hash_names) {
  BamParser parser;
  parser.dec.hash_names = hash_names;
  parser.init(st, f);
  parser.parse_until(st, f, SIZE_MAX);
  parser.finish(f);
}

void parse_sam_stream(ByteSource* src, StpuFile* f,
                      std::vector<uint8_t>& first_chunk, bool have_first,
                      bool hash_names, bool single_thread) {
  SamParser parser;
  parser.dec.hash_names = hash_names;
  if (size_t hint = src->size_hint()) {
    // pre-reserve the target arrays (~1 record per ~200 input bytes is a
    // safe overestimate for alignment SAM) so growth never re-copies MBs
    size_t est = hint / 200 + 1024;
    f->read_id.reserve(est);
    f->rid.reserve(est);
    f->pos.reserve(est);
    parser.dec.reserve_keys(est);  // one read per record is the worst case
  }
  if (!single_thread && src->stable_views()) {
    // pipelined: tokenize (scan + field parse + rid lookup) on a worker
    // thread, intern/dedup/emit on this thread — the two halves of the
    // per-record cost overlap.  Window views are mmap-stable, so record
    // qname pointers stay valid across the hand-off.
    BatchQueue bq;
    std::thread tok([&] {
      try {
        if (have_first) {
          SamBatch b;
          parser.tokenize(f, first_chunk.data(), first_chunk.size(), b);
          bq.push(std::move(b));
        }
        const uint8_t* p;
        size_t n;
        while (src->next_view(&p, &n)) {
          SamBatch b;
          parser.tokenize(f, p, n, b);
          bq.push(std::move(b));
        }
        SamBatch tail;
        parser.tokenize_finish(f, tail);
        bq.push(std::move(tail));
        bq.close();
      } catch (const std::exception& e) {
        bq.close(e.what());
      }
    });
    SamBatch b;
    while (bq.pop(b)) parser.consume(f, b);
    tok.join();
    if (!bq.err.empty()) throw DecodeError(bq.err);
    parser.finish_consume(f);
    return;
  }
  const uint8_t* p;
  size_t n;
  if (have_first) parser.feed(f, first_chunk.data(), first_chunk.size());
  while (src->next_view(&p, &n)) parser.feed(f, p, n);
  parser.finish(f);
}

// Sniff the container: returns a ByteSource positioned at the start of the
// DEcompressed stream, plus the first decompressed chunk (for format sniff).
std::unique_ptr<ByteSource> open_source(const char* path) {
  FILE* probe = std::fopen(path, "rb");
  if (!probe) throw DecodeError("cannot open file");
  uint8_t head[18];
  size_t got = std::fread(head, 1, sizeof head, probe);
  std::fclose(probe);
  if (got >= 2 && head[0] == 0x1f && head[1] == 0x8b) {
    // gzip: BGZF iff FEXTRA set and a BC subfield exists in the first member
    bool bgzf = false;
    if (got >= 18 && head[2] == 8 && (head[3] & 4)) {
      uint16_t xlen;
      memcpy(&xlen, head + 10, 2);
      // minimal check: the standard BGZF layout has the BC subfield first
      if (xlen >= 6 && head[12] == 66 && head[13] == 67) bgzf = true;
    }
    unsigned threads = std::max(1u, std::thread::hardware_concurrency());
    if (bgzf) return std::make_unique<BgzfSource>(path, threads);
    return std::make_unique<GzipSource>(path);
  }
  return std::make_unique<RawSource>(path);
}

void group_targets(StpuFile* f) {
  // group targets by read id (stable counting sort) — the device pipeline
  // turns per-read reductions into neighbor compares and segmented scans
  // on contiguous groups
  const size_t n = f->read_id.size();
  std::vector<int64_t> offs(static_cast<size_t>(f->n_reads) + 1, 0);
  for (size_t i = 0; i < n; ++i) ++offs[f->read_id[i] + 1];
  for (size_t r = 1; r < offs.size(); ++r) offs[r] += offs[r - 1];
  std::vector<int32_t> gr(n), gc(n), gp(n);
  for (size_t i = 0; i < n; ++i) {
    int64_t o = offs[f->read_id[i]]++;
    gr[o] = f->read_id[i];
    gc[o] = f->rid[i];
    gp[o] = f->pos[i];
  }
  f->read_id.swap(gr);
  f->rid.swap(gc);
  f->pos.swap(gp);
}

}  // namespace

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------

extern "C" {

// -- acc2taxid resolve (slimm_build.cpp:175-278 semantics) -------------------
//
// Streams an accession2taxid TSV (plain, gzip or BGZF via open_source) and
// resolves the given accession list against it, replicating the
// reference's batched flow exactly: col 1 = accession, col 3 = taxid
// (failed integer parse -> 0, like C++ stream extraction); every
// non-empty line counts toward the batch; WITHIN a batch of `batch`
// mappings the last occurrence of an accession wins, and an accession is
// frozen (resolved) at its batch's end, after which later lines are
// ignored; early exit once every accession resolved.  The Python builder
// keeps this loop as the fallback — at RefSeq scale the mapping files
// are ~50 GB and the line loop is the build bottleneck.
//
// accs/offs: concatenated accession bytes + n+1 offsets.  out_idx /
// out_taxid (capacity n_accs) receive the resolved (index, taxid) pairs;
// returns the number resolved, or -1 with `err` filled.
int64_t stpu_acc2taxid_scan(const char* path, const char* accs,
                            const int64_t* offs, int64_t n_accs,
                            int64_t batch, int64_t* out_idx,
                            uint32_t* out_taxid, char* err, int errcap) {
  try {
    StrMap map;
    map.reserve_keys(static_cast<size_t>(n_accs));
    for (int64_t i = 0; i < n_accs; ++i)
      map.intern(accs + offs[i], static_cast<size_t>(offs[i + 1] - offs[i]),
                 nullptr, 0);  // intern order == index

    std::vector<uint8_t> resolved(static_cast<size_t>(n_accs), 0);
    std::vector<uint32_t> taxid(static_cast<size_t>(n_accs), 0);
    std::vector<uint8_t> touched(static_cast<size_t>(n_accs), 0);
    std::vector<int64_t> batch_idx;
    int64_t n_resolved = 0;
    int64_t in_batch = 0;
    if (batch <= 0) batch = 1000000;

    auto flush_batch = [&]() {
      for (int64_t i : batch_idx) {
        touched[i] = 0;
        if (!resolved[i]) {
          resolved[i] = 1;
          ++n_resolved;
        }
      }
      batch_idx.clear();
      in_batch = 0;
    };

    auto line = [&](const char* p, const char* e) {
      const char* t1 = static_cast<const char*>(memchr(p, '\t', e - p));
      const char* a_end = t1 ? t1 : e;
      if (a_end == p) return;  // empty accession column: skipped, uncounted
      ++in_batch;
      int32_t idx = map.find(p, static_cast<size_t>(a_end - p));
      if (idx >= 0 && !resolved[idx]) {
        // taxid = int(col3.split()[0]) with 0 on any parse failure
        // (python semantics in database.stream_acc2taxid_batches, itself
        // matching C++11 stream extraction in slimm_build.cpp:183-193)
        uint32_t t = 0;
        if (t1) {
          const char* t2 =
              static_cast<const char*>(memchr(t1 + 1, '\t', e - t1 - 1));
          if (t2) {
            const char* q = t2 + 1;
            const char* ce =
                static_cast<const char*>(memchr(q, '\t', e - q));
            if (!ce) ce = e;
            auto is_ws = [](char c) {
              return c == ' ' || c == '\r' || c == '\v' || c == '\f';
            };
            while (q < ce && is_ws(*q)) ++q;
            const char* te = q;
            uint64_t v = 0;
            bool ok = false;
            while (te < ce && !is_ws(*te)) {
              if (*te < '0' || *te > '9') {
                ok = false;
                te = ce;
                break;
              }
              v = v * 10 + static_cast<uint64_t>(*te - '0');
              ok = true;
              ++te;
            }
            if (ok) t = static_cast<uint32_t>(v);
          }
        }
        taxid[idx] = t;  // last occurrence within the batch wins
        if (!touched[idx]) {
          touched[idx] = 1;
          batch_idx.push_back(idx);
        }
      }
      if (in_batch >= batch) flush_batch();
    };

    auto src = open_source(path);
    std::string carry;
    const uint8_t* p;
    size_t n;
    bool done = false;
    while (!done && src->next_view(&p, &n)) {
      const char* s = reinterpret_cast<const char*>(p);
      const char* e = s + n;
      if (!carry.empty()) {
        const char* nl = static_cast<const char*>(memchr(s, '\n', n));
        if (!nl) {
          carry.append(s, n);
          continue;
        }
        carry.append(s, nl - s);
        line(carry.data(), carry.data() + carry.size());
        carry.clear();
        s = nl + 1;
      }
      while (s < e) {
        const char* nl = static_cast<const char*>(memchr(s, '\n', e - s));
        if (!nl) {
          carry.assign(s, e - s);
          break;
        }
        line(s, nl);
        s = nl + 1;
        if (n_resolved == n_accs) {
          done = true;
          break;
        }
      }
    }
    if (!carry.empty()) line(carry.data(), carry.data() + carry.size());
    flush_batch();

    int64_t k = 0;
    for (int64_t i = 0; i < n_accs; ++i)
      if (resolved[i]) {
        out_idx[k] = i;
        out_taxid[k] = taxid[i];
        ++k;
      }
    return k;
  } catch (const std::exception& e) {
    snprintf(err, static_cast<size_t>(errcap), "%s", e.what());
    return -1;
  }
}

// flags: bit 0 = hash read names (64-bit-hash keys, no name arena - the
// billion-read scale mode; distinct colliding names merge); bit 1 =
// single-thread decode (the honest single-core baseline configuration —
// default SAM decode pipelines tokenize/consume on two threads)
void* stpu_open2(const char* path, int flags) {
  auto* f = new StpuFile();
  bool hash_names = (flags & 1) != 0;
  bool single_thread = (flags & 2) != 0;
  try {
    auto src = open_source(path);
    // sniff the decompressed head: "BAM\1" -> binary BAM, else SAM text
    std::vector<uint8_t> first;
    bool have_first = src->next(first);
    // skip possibly-empty leading chunks (e.g. BGZF EOF-only batch)
    while (have_first && first.empty()) have_first = src->next(first);
    if (have_first && first.size() >= 4 &&
        memcmp(first.data(), "BAM\1", 4) == 0) {
      if (!single_thread)  // overlap inflate+CRC with the record parse
        src = std::make_unique<PrefetchSource>(std::move(src));
      Stream st(src.get());
      st.buf = std::move(first);
      parse_bam_stream(st, f, hash_names);
    } else {
      parse_sam_stream(src.get(), f, first, have_first, hash_names,
                       single_thread);
    }
    f->warning = src->warning();
    // grouped inputs come out of the decoder already in read-id order
    if (f->n_reads > 0 && !f->grouped_input) group_targets(f);
  } catch (const std::exception& e) {
    f->error = e.what();
  }
  return f;
}

void* stpu_open(const char* path) { return stpu_open2(path, 0); }

const char* stpu_error(void* h) {
  return static_cast<StpuFile*>(h)->error.c_str();
}

const char* stpu_warning(void* h) {
  return static_cast<StpuFile*>(h)->warning.c_str();
}

int64_t stpu_n_malformed(void* h) {
  return static_cast<StpuFile*>(h)->malformed;
}

int64_t stpu_n_refs(void* h) {
  return static_cast<int64_t>(static_cast<StpuFile*>(h)->ref_names.size());
}

const char* stpu_ref_name(void* h, int64_t i) {
  return static_cast<StpuFile*>(h)->ref_names[i].c_str();
}

int64_t stpu_ref_len(void* h, int64_t i) {
  return static_cast<StpuFile*>(h)->ref_lens[i];
}

int64_t stpu_hits(void* h) { return static_cast<StpuFile*>(h)->hits; }
int64_t stpu_n_targets(void* h) {
  return static_cast<int64_t>(static_cast<StpuFile*>(h)->read_id.size());
}
int64_t stpu_n_reads(void* h) { return static_cast<StpuFile*>(h)->n_reads; }
int64_t stpu_avg_read_len(void* h) {
  return static_cast<StpuFile*>(h)->avg_read_len;
}

// longest per-read target run (0 = unknown: input was not qname-grouped)
int64_t stpu_max_targets(void* h) {
  auto* f = static_cast<StpuFile*>(h);
  return f->grouped_input ? f->max_targets : 0;
}

void stpu_fill(void* h, int32_t* read_id, int32_t* rid, int32_t* pos) {
  auto* f = static_cast<StpuFile*>(h);
  memcpy(read_id, f->read_id.data(), f->read_id.size() * 4);
  memcpy(rid, f->rid.data(), f->rid.size() * 4);
  memcpy(pos, f->pos.data(), f->pos.size() * 4);
}

void stpu_close(void* h) { delete static_cast<StpuFile*>(h); }

// ---------------------------------------------------------------------------
// chunk-streaming decode API
// ---------------------------------------------------------------------------
//
// Emits dedup'd targets in READ-COMPLETE chunks (a chunk never splits a
// read's targets), so the engine can run its per-read segment reductions
// per chunk and overlap decode with device dispatch.  Requires
// qname-grouped input (mapper output order) — stpu_stream_grouped() turns 0
// the moment a read reappears non-consecutively, and the caller falls back
// to the whole-file decode.  Shipped targets are compacted away, keeping
// decoder memory flat regardless of file size.

namespace {

// -- parallel sharded SAM decode (raw mmap sources) --------------------------
//
// The serial SAM pipeline caps at two threads (tokenizer + consumer); on
// multi-core hosts the decode — not the device — is the end-to-end
// bottleneck (the fused device pipeline outruns one core).  For
// memory-mapped plain-text SAM the file splits at line boundaries into N
// byte ranges decoded by independent workers (each with its own
// tokenizer, interner and first-hit dedup — the multi-host host-sharded
// decode layout of parallel/multihost.py, in one process).  The serving
// side appends worker output IN FILE ORDER, remapping shard-local read
// ids to global ones and stitching the one read that can straddle each
// cut (first-hit-wins dedup across the seam).  Per-shard groupedness
// does not imply global qname-groupedness, so every shard logs the
// 64-bit key hash of each read and a bloom-backed cross-shard duplicate
// check runs as shards finish (exact verification on bloom hits; the
// legal seam chain excepted).  Any violation errors the stream with the
// "not qname-grouped" marker and callers fall back, exactly like the
// serial mid-stream edge.

// Minimum mapped-file size for the parallel decode (env-overridable so
// tests can exercise it on small files).
size_t parallel_min_bytes() {
  if (const char* v = std::getenv("SLIMM_PARALLEL_MIN_BYTES")) {
    long n = std::atol(v);
    if (n > 0) return static_cast<size_t>(n);
  }
  return size_t(32) << 20;
}

struct TargetBatch {
  std::vector<int32_t> read_id, rid, pos;
};

// SPSC batch queue; finish() publishes completion or a worker error,
// rethrown by pop() once drained
struct TargetQueue {
  std::mutex m;
  std::condition_variable cv;
  std::deque<TargetBatch> q;
  bool done = false;
  std::string err;

  void push(TargetBatch&& b) {
    {
      std::lock_guard<std::mutex> l(m);
      q.push_back(std::move(b));
    }
    cv.notify_one();
  }
  void finish(const std::string& e = "") {
    {
      std::lock_guard<std::mutex> l(m);
      done = true;
      if (!e.empty()) err = e;
    }
    cv.notify_one();
  }
  bool pop(TargetBatch& b) {
    std::unique_lock<std::mutex> l(m);
    cv.wait(l, [&] { return !q.empty() || done; });
    if (!q.empty()) {
      b = std::move(q.front());
      q.pop_front();
      return true;
    }
    if (!err.empty()) throw DecodeError(err);
    return false;
  }
};

// double-probe bloom over mixed 64-bit key hashes (~1% false positives at
// 16 bits/key; false positives only cost an exact hash-map probe)
struct KeyBloom {
  std::vector<uint64_t> words;
  size_t mask = 0;

  void init(size_t expected_keys) {
    size_t bits = 1 << 16;
    while (bits < expected_keys * 16 && bits < (size_t(1) << 31)) bits <<= 1;
    words.assign(bits / 64, 0);
    mask = bits - 1;
  }
  void add(uint64_t h) {
    size_t a = h & mask, b = (h >> 32) & mask;
    words[a >> 6] |= uint64_t(1) << (a & 63);
    words[b >> 6] |= uint64_t(1) << (b & 63);
  }
  bool maybe(uint64_t h) const {
    size_t a = h & mask, b = (h >> 32) & mask;
    return ((words[a >> 6] >> (a & 63)) & 1) != 0 &&
           ((words[b >> 6] >> (b & 63)) & 1) != 0;
  }
};

struct SamShard {
  const uint8_t* base = nullptr;
  size_t begin_ = 0, end_ = 0;
  SamParser parser;
  StpuFile local;                // per-shard targets + counters
  TargetQueue out;
  std::vector<uint64_t> id_h64;  // key hash per local read id (id order)
  KeyBloom bloom;
  size_t bloom_added = 0;
  // seam inputs, published (release) before the first batch
  std::string first_key;         // key bytes (empty in hash mode)
  uint64_t first_h64 = 0;
  std::atomic<bool> first_ready{false};
  std::atomic<bool> done{false};
  size_t published = 0;          // targets moved to `out` (post-chop base)
  std::thread th;

  void start(bool hash_names) {
    parser.dec.hash_names = hash_names;
    parser.dec.h64_log = &id_h64;
    size_t est = (end_ - begin_) / 250 + 1024;
    parser.dec.reserve_keys(est);
    id_h64.reserve(est);
    bloom.init(est);
    local.read_id.reserve(std::min(est, size_t(1) << 22));
    local.rid.reserve(std::min(est, size_t(1) << 22));
    local.pos.reserve(std::min(est, size_t(1) << 22));
    th = std::thread([this] { run(); });
  }

  void capture_first() {
    if (first_ready.load(std::memory_order_relaxed)) return;
    if (parser.dec.n_keys() == 0) return;
    first_h64 = id_h64[0];
    if (!parser.dec.hash_names) {
      auto kv = parser.dec.key_to_id.key(0);
      first_key.assign(kv.first, kv.second);
    }
    first_ready.store(true, std::memory_order_release);
  }

  void publish(bool final_flush) {
    capture_first();
    for (size_t k = bloom_added; k < id_h64.size(); ++k)
      bloom.add(id_h64[k]);
    bloom_added = id_h64.size();
    size_t upto = final_flush ? local.read_id.size() : parser.dec.run_start;
    if (upto > published) {
      TargetBatch b;
      b.read_id.assign(local.read_id.begin() + published,
                       local.read_id.begin() + upto);
      b.rid.assign(local.rid.begin() + published,
                   local.rid.begin() + upto);
      b.pos.assign(local.pos.begin() + published,
                   local.pos.begin() + upto);
      published = upto;
      out.push(std::move(b));
    }
    if (published >= (size_t(1) << 22)) {  // cap shard-local residency
      auto chop = [&](std::vector<int32_t>& v) {
        v.erase(v.begin(), v.begin() + published);
      };
      chop(local.read_id);
      chop(local.rid);
      chop(local.pos);
      parser.dec.run_start -= published;
      published = 0;
    }
  }

  void run() {
    try {
      SamBatch b;
      size_t pos = begin_;
      while (pos < end_) {
        size_t n = std::min(end_ - pos, static_cast<size_t>(8) << 20);
        b.clear();
        parser.tokenize(&local, base + pos, n, b);
        parser.consume(&local, b);
        pos += n;
        if (!parser.dec.grouped)
          throw DecodeError("input is not qname-grouped (read reappeared "
                            "within a decode shard)");
        publish(false);
      }
      b.clear();
      parser.tokenize_finish(&local, b);
      parser.consume(&local, b);
      if (!parser.dec.grouped)
        throw DecodeError("input is not qname-grouped (read reappeared "
                          "within a decode shard)");
      local.n_reads = static_cast<int64_t>(parser.dec.n_keys());
      publish(true);
      done.store(true, std::memory_order_release);
      out.finish();
    } catch (const std::exception& e) {
      done.store(true, std::memory_order_release);
      out.finish(e.what());
    }
  }
};

struct StpuStream {
  std::unique_ptr<ByteSource> src;
  StpuFile file;
  std::unique_ptr<SamParser> sam;
  std::unique_ptr<BamParser> bam;
  std::unique_ptr<Stream> bam_st;   // buffered view (BAM only)
  int64_t consumed = 0;             // targets already taken by the caller
  bool eof = false;
  // non-grouped (e.g. coordinate-sorted) input, regrouped at EOF: the
  // caller-visible arrays are read-grouped from here on
  bool regrouped = false;
  std::string error;
  // pipelined SAM decode (mmap sources): tokenizer thread runs ahead,
  // pull() consumes one batch per call on the caller's thread
  std::unique_ptr<BatchQueue> bq;
  std::thread tok;

  // -- parallel sharded decode state (raw mmap SAM) -------------------------
  bool parallel = false;
  std::vector<std::unique_ptr<SamShard>> shards;
  size_t serve = 0;               // shard currently being appended
  bool serve_begun = false;       // first batch of `serve` processed
  bool serve_stitched = false;    // `serve`'s first read continues the prev
  int64_t gid_offset = 0;         // local id -> global id for `serve`
  int64_t greads = 0;             // distinct global reads through `serve`-1
  int64_t last_gid = -1;
  std::vector<int32_t> tail_rids;  // rids of the last appended read's run
  int64_t tail_len = 0;
  std::string last_key;           // last appended shard's final read key
  uint64_t last_h64 = 0;
  bool have_tail = false;
  size_t shards_checked = 1;      // cross-dup checks done for shards [0, x)
  int64_t psample_count = 0, psample_total = 0;  // probe avg-length sample
  int64_t pmax_targets = 0;

  ~StpuStream() {
    if (tok.joinable()) {
      bq->abandon();
      tok.join();
    }
    for (auto& sh : shards)
      if (sh->th.joinable()) sh->th.join();
  }

  Decoder& dec() { return sam ? sam->dec : bam->dec; }

  void start_pipeline() {
    bq = std::make_unique<BatchQueue>();
    tok = std::thread([this] {
      try {
        const uint8_t* p;
        size_t n;
        while (src->next_view(&p, &n)) {
          SamBatch b;
          sam->tokenize(&file, p, n, b);
          bq->push(std::move(b));
          if (bq->abandoned) return;
        }
        SamBatch tail;
        sam->tokenize_finish(&file, tail);
        bq->push(std::move(tail));
        bq->close();
      } catch (const std::exception& e) {
        bq->close(e.what());
      }
    });
  }

  // targets safe to hand out: everything before the current run
  int64_t completed() {
    if (parallel) {
      int64_t sz = static_cast<int64_t>(file.read_id.size());
      if (eof) return sz - consumed;
      // the tail run may still extend across the next shard seam
      return sz - tail_len - consumed;
    }
    if (eof && (dec().grouped || regrouped))
      return static_cast<int64_t>(file.read_id.size()) - consumed;
    if (!dec().grouped) return 0;  // awaiting the EOF regroup
    return static_cast<int64_t>(dec().run_start) - consumed;
  }

  // Non-qname-grouped input (samtools' default coordinate sort): the
  // grouped fast path is gone, but the Decoder keeps first-hit-dedup'ing
  // through its pair set — reads can reappear anywhere, so no read is
  // provably complete before EOF.  Decode the remainder, counting-sort
  // the full target arrays by read id ONCE (the reference's hash-map loop
  // is record-order-insensitive, slimm.hpp:194-213), and serve chunks
  // from the grouped result.  Host memory is O(targets) — what the
  // whole-file fallback cost anyway, minus its SECOND decode of the
  // input.  Only valid while nothing was consumed: shipped targets
  // cannot be regrouped (and the rebuilt pair set would be incomplete).
  void regroup_at_eof() {
    if (consumed > 0)
      throw DecodeError(
          "input is not qname-grouped past the first shipped chunk; "
          "rerun with the whole-file decoder");
    while (!eof) {
      size_t have = file.read_id.size();
      pull(have + have / 2 + (1 << 20));
    }
    group_targets(&file);  // file.n_reads was set by the EOF finish
    // re-measure the longest per-read run for the device segment plan
    int64_t mt = 0, run = 0;
    int32_t last = -1;
    for (size_t i = 0; i < file.read_id.size(); ++i) {
      run = (file.read_id[i] == last) ? run + 1 : 1;
      last = file.read_id[i];
      if (run > mt) mt = run;
    }
    file.max_targets = mt;
    file.grouped_input = true;  // the OUTPUT arrays are grouped now
    regrouped = true;
  }

  // parse more input; for BAM stop once the target arrays reach
  // cap_targets (SAM granularity is one decompressed source chunk)
  void pull(size_t cap_targets) {
    if (sam && bq) {  // pipelined: consume one tokenized batch
      SamBatch b;
      if (!bq->pop(b)) {
        tok.join();
        if (!bq->err.empty()) throw DecodeError(bq->err);
        sam->finish_consume(&file);
        file.warning = src->warning();
        eof = true;
        bq.reset();
        return;
      }
      sam->consume(&file, b);
      return;
    }
    if (sam) {
      const uint8_t* p;
      size_t n;
      if (!src->next_view(&p, &n)) {
        sam->finish(&file);
        file.warning = src->warning();
        eof = true;
        return;
      }
      sam->feed(&file, p, n);
    } else {
      if (bam->parse_until(*bam_st, &file, cap_targets)) {
        bam->finish(&file);
        file.warning = src->warning();
        eof = true;
      }
    }
  }

  void compact() {
    if (consumed < (1 << 22)) return;
    auto erase_front = [&](std::vector<int32_t>& v) {
      v.erase(v.begin(), v.begin() + consumed);
    };
    erase_front(file.read_id);
    erase_front(file.rid);
    erase_front(file.pos);
    if (!parallel) dec().run_start -= static_cast<size_t>(consumed);
    consumed = 0;
  }

  // -- parallel sharded decode (see the section comment above) --------------

  // Tokenize-only probe of the file head: the exact average-read-length
  // sample (first <=100k nonempty-seq records in file order,
  // misc.hpp:509-522) plus a grouped-input hint — a key reappearing
  // non-consecutively within the probe means coordinate-sorted input, for
  // which the serial path (and its EOF regroup) is the right mode.
  bool probe_head(const uint8_t* map, size_t map_size, size_t header_end,
                  const StrMap& rid_of) {
    SamParser pp;
    pp.rid_of = rid_of;
    StpuFile scratch;
    Hash64Map seen;
    seen.reserve_keys(1 << 17);
    uint64_t prev_h = 0;
    bool have_prev = false;
    bool grouped_hint = true;

    auto eat = [&](const SamBatch& bb) {
      for (const SamRec& r : bb.recs) {
        if (psample_count < 100000 && r.seq_len > 0) {
          psample_total += r.seq_len;
          ++psample_count;
        }
        const char* q = r.q ? r.q : bb.arena.data() + r.arena_off;
        const char* sfx = (r.flag & FLAG_FIRST) ? ".1" : ".2";
        size_t sn = (r.flag & (FLAG_FIRST | FLAG_LAST)) ? 2 : 0;
        uint64_t h = StrMap::hash2_64(q, r.qlen, sfx, sn);
        if (!have_prev || h != prev_h) {
          if (seen.contains(h)) {
            grouped_hint = false;
            return false;
          }
          seen.intern(h);
          prev_h = h;
          have_prev = true;
        }
      }
      return true;
    };

    size_t pos = header_end;
    SamBatch b;
    while (pos < map_size && psample_count < 100000 && grouped_hint) {
      size_t n = std::min(map_size - pos, static_cast<size_t>(4) << 20);
      b.clear();
      pp.tokenize(&scratch, map + pos, n, b);
      pos += n;
      if (pos >= map_size) pp.tokenize_finish(&scratch, b);
      if (!eat(b)) break;
    }
    return grouped_hint;
  }

  // Returns true when parallel mode is fully initialized (header parsed,
  // sample complete, workers running); false -> caller takes the serial
  // path (small file, coordinate-sorted hint, no sample).
  bool init_parallel(const uint8_t* map, size_t map_size, bool hash_names) {
    SamParser hp;  // header parse on the main thread (workers need rid_of)
    size_t pos = 0;
    while (pos < map_size && map[pos] == '@') {
      const void* nl = memchr(map + pos, '\n', map_size - pos);
      size_t e = nl ? static_cast<size_t>(
                          static_cast<const uint8_t*>(nl) - map)
                    : map_size;
      ++hp.line_no;
      hp.handle_header(&file, reinterpret_cast<const char*>(map) + pos,
                       reinterpret_cast<const char*>(map) + e);
      pos = e + (nl ? 1 : 0);
    }
    size_t header_end = pos;
    // Worker count: on a 2-core host the serial tokenizer/consumer
    // pipeline is already 2-thread optimal and sharding only adds
    // oversubscription (measured 0.71s vs 0.64s on the 4M-record bench
    // SAM), so parallel mode needs >= 3 cores; one core is left for the
    // consumer/upload thread.  SLIMM_DECODE_THREADS overrides (tests,
    // tuning).  Checked BEFORE probe_head: the ~100k-record probe scan
    // costs ~100 ms and is pure waste when parallel mode declines anyway.
    unsigned hw = std::max(1u, std::thread::hardware_concurrency());
    unsigned workers = hw >= 3 ? hw - 1 : 0;
    if (const char* t = std::getenv("SLIMM_DECODE_THREADS")) {
      long v = std::atol(t);
      if (v > 0) workers = static_cast<unsigned>(v);
    }
    if (workers < 2) return false;
    size_t span = parallel_min_bytes() / 2;
    if (span < 65536) span = 65536;
    size_t n_sh = std::min<size_t>(workers,
                                   (map_size - header_end) / span);
    if (n_sh < 2) return false;
    if (!probe_head(map, map_size, header_end, hp.rid_of)) return false;
    if (psample_count == 0) return false;  // serial path raises properly

    std::vector<size_t> cuts(n_sh + 1);
    cuts[0] = header_end;
    cuts[n_sh] = map_size;
    size_t stride = (map_size - header_end) / n_sh;
    for (size_t k = 1; k < n_sh; ++k) {
      size_t c = header_end + k * stride;
      const void* nl = memchr(map + c, '\n', map_size - c);
      c = nl ? static_cast<size_t>(static_cast<const uint8_t*>(nl) - map) + 1
             : map_size;
      cuts[k] = std::max(c, cuts[k - 1]);
    }
    for (size_t k = 0; k < n_sh; ++k) {
      auto sh = std::make_unique<SamShard>();
      sh->base = map;
      sh->begin_ = cuts[k];
      sh->end_ = cuts[k + 1];
      sh->parser.rid_of = hp.rid_of;  // copy: contig name -> header index
      shards.push_back(std::move(sh));
    }
    for (auto& sh : shards) sh->start(hash_names);
    parallel = true;
    return true;
  }

  static bool exact_contains(SamShard& si, SamShard& sj, int32_t k) {
    if (sj.parser.dec.hash_names)
      return si.parser.dec.hkey_to_id.contains(sj.id_h64[k]);
    auto kv = sj.parser.dec.key_to_id.key(k);
    return si.parser.dec.key_to_id.find(kv.first, kv.second) >= 0;
  }

  // A key may legally appear in shards i and j>i only as the seam chain:
  // local id 0 of shard j, shard i's LAST read, with every shard between
  // holding exactly that one read.
  bool seam_allowed(size_t i, size_t j, int32_t k) {
    if (k != 0) return false;
    SamShard& sj = *shards[j];
    uint64_t h = sj.id_h64[0];
    auto matches = [&](SamShard& s, int64_t id) {
      if (id < 0 || static_cast<size_t>(id) >= s.id_h64.size()) return false;
      if (s.id_h64[id] != h) return false;
      if (s.parser.dec.hash_names) return true;
      auto a = s.parser.dec.key_to_id.key(static_cast<int32_t>(id));
      auto b = sj.parser.dec.key_to_id.key(0);
      return a.second == b.second &&
             memcmp(a.first, b.first, a.second) == 0;
    };
    if (!matches(*shards[i],
                 static_cast<int64_t>(shards[i]->id_h64.size()) - 1))
      return false;
    for (size_t m = i + 1; m < j; ++m) {
      if (shards[m]->id_h64.size() != 1) return false;
      if (!matches(*shards[m], 0)) return false;
    }
    return true;
  }

  // Cross-shard duplicate detection: runs for shard j once shards [0, j]
  // are all done (their intern maps and blooms are then immutable).
  // All checks complete before eof is reported.
  void run_dup_checks() {
    while (shards_checked < shards.size()) {
      size_t j = shards_checked;
      for (size_t i = 0; i <= j; ++i)
        if (!shards[i]->done.load(std::memory_order_acquire)) return;
      SamShard& sj = *shards[j];
      for (size_t k = 0; k < sj.id_h64.size(); ++k) {
        uint64_t h = sj.id_h64[k];
        for (size_t i = 0; i < j; ++i) {
          if (!shards[i]->bloom.maybe(h)) continue;
          if (!exact_contains(*shards[i], sj, static_cast<int32_t>(k)))
            continue;
          if (!seam_allowed(i, j, static_cast<int32_t>(k)))
            throw DecodeError(
                "input is not qname-grouped (a read reappears across "
                "decode shards); use the whole-file decoder");
        }
      }
      ++shards_checked;
    }
  }

  // rids of the current last run in the caller-visible arrays (lazily
  // collected only when a seam has to be dedup'd)
  void collect_tail_rids() {
    tail_rids.clear();
    size_t e = file.read_id.size();
    if (e == 0) return;
    int32_t lastv = file.read_id[e - 1];
    size_t t = e;
    while (t > 0 && file.read_id[t - 1] == lastv) --t;
    for (size_t i = t; i < e; ++i) tail_rids.push_back(file.rid[i]);
  }

  // Append one worker batch to the caller-visible arrays: bulk memcpy +
  // vectorizable id remap, with per-record work only on the seam prefix
  // (the continuation of the previous shard's last read, dedup'd
  // first-hit-wins across the cut — read_stat.hpp:116-135 semantics).
  // This runs on the consumer thread and must stay cheap: it competes
  // with the decode workers for cores.
  void append_batch(SamShard& sh, TargetBatch& b) {
    size_t start = 0;
    size_t n = b.read_id.size();
    if (!serve_begun) {
      serve_begun = true;
      bool st = false;
      if (have_tail && sh.first_ready.load(std::memory_order_acquire)) {
        st = sh.first_h64 == last_h64 &&
             (sh.parser.dec.hash_names || sh.first_key == last_key);
      }
      serve_stitched = st;
      gid_offset = greads - (st ? 1 : 0);
      if (st) {
        // seam prefix: all local-id-0 records sit in this first batch
        // (worker batches end at run boundaries)
        collect_tail_rids();
        while (start < n && b.read_id[start] == 0) {
          int32_t r = b.rid[start];
          bool dup = false;
          for (int32_t t : tail_rids)
            if (t == r) {
              dup = true;
              break;
            }
          if (!dup) {
            tail_rids.push_back(r);
            ++tail_len;
            file.read_id.push_back(static_cast<int32_t>(gid_offset));
            file.rid.push_back(r);
            file.pos.push_back(b.pos[start]);
          }
          ++start;
        }
        if (tail_len > pmax_targets) pmax_targets = tail_len;
      }
    }
    size_t m = n - start;
    if (m == 0) return;
    size_t base_sz = file.read_id.size();
    file.read_id.resize(base_sz + m);
    const int32_t off = static_cast<int32_t>(gid_offset);
    const int32_t* src_id = b.read_id.data() + start;
    int32_t* dst = file.read_id.data() + base_sz;
    for (size_t i = 0; i < m; ++i) dst[i] = src_id[i] + off;
    file.rid.insert(file.rid.end(), b.rid.begin() + start, b.rid.end());
    file.pos.insert(file.pos.end(), b.pos.begin() + start, b.pos.end());
    // track the current tail run (completed() withholds it until the
    // seam with the next shard resolves); per-shard run maxima come from
    // the workers' own counters at finish_shard
    size_t e = file.read_id.size();
    int32_t lastv = file.read_id[e - 1];
    size_t t = e - 1;
    while (t > 0 && file.read_id[t - 1] == lastv) --t;
    tail_len = static_cast<int64_t>(e - t);
    last_gid = lastv;
    tail_rids.clear();  // re-collected lazily at the next seam
  }

  void finish_shard(size_t j) {
    SamShard& sh = *shards[j];
    file.hits += sh.local.hits;
    file.malformed += sh.local.malformed;
    if (sh.local.max_targets > pmax_targets)
      pmax_targets = sh.local.max_targets;
    int64_t nk = static_cast<int64_t>(sh.parser.dec.n_keys());
    greads += nk - (serve_begun && serve_stitched ? 1 : 0);
    if (nk > 0) {
      last_h64 = sh.id_h64.back();
      if (!sh.parser.dec.hash_names) {
        auto kv = sh.parser.dec.key_to_id.key(static_cast<int32_t>(nk - 1));
        last_key.assign(kv.first, kv.second);
      }
      have_tail = true;
    }
  }

  // one unit of progress: append one batch, or transition shards, or
  // finalize at EOF (mirrors pull()'s contract for the serial modes)
  void pull_parallel() {
    run_dup_checks();
    while (serve < shards.size()) {
      TargetBatch b;
      if (shards[serve]->out.pop(b)) {  // rethrows worker errors
        append_batch(*shards[serve], b);
        return;
      }
      finish_shard(serve);
      ++serve;
      serve_begun = false;
      serve_stitched = false;
    }
    run_dup_checks();  // all shards done here; must pass before eof
    file.n_reads = greads;
    file.max_targets = pmax_targets;
    file.grouped_input = true;
    file.warning = src->warning();
    eof = true;
  }
};

}  // namespace

void* stpu_stream_open2(const char* path, int flags) {
  auto* s = new StpuStream();
  bool hash_names = (flags & 1) != 0;
  try {
    s->src = open_source(path);
    std::vector<uint8_t> first;
    bool have_first = s->src->next(first);
    while (have_first && first.empty()) have_first = s->src->next(first);
    if (have_first && first.size() >= 4 &&
        memcmp(first.data(), "BAM\1", 4) == 0) {
      if (!(flags & 2))  // overlap inflate+CRC with the record parse
        s->src = std::make_unique<PrefetchSource>(std::move(s->src));
      s->bam = std::make_unique<BamParser>();
      s->bam->dec.hash_names = hash_names;
      s->bam_st = std::make_unique<Stream>(s->src.get());
      s->bam_st->buf = std::move(first);
      s->bam->init(*s->bam_st, &s->file);  // header + refs complete
    } else {
      // Parallel sharded decode for big memory-mapped plain SAM (see the
      // SamShard section): N workers over line-aligned byte ranges; the
      // probe inside init_parallel completes the avg-read-length sample
      // and routes coordinate-sorted input to the serial path (whose EOF
      // regroup handles it with flat worker count).  Capped at 4 GB maps:
      // parallel mode buffers out-of-order shards, so the truly huge
      // files keep the flat-memory serial pipeline.
      auto* raw = dynamic_cast<RawSource*>(s->src.get());
      bool can_par = raw && raw->map && !(flags & 2) &&
                     raw->map_size >= parallel_min_bytes() &&
                     raw->map_size <= (size_t(4) << 30) &&
                     std::thread::hardware_concurrency() >= 2;
      if (!(can_par &&
            s->init_parallel(raw->map, raw->map_size, hash_names))) {
        s->sam = std::make_unique<SamParser>();
        s->sam->dec.hash_names = hash_names;
        if (size_t hint = s->src->size_hint())
          s->sam->dec.reserve_keys(hint / 200 + 1024);
        if (have_first) s->sam->feed(&s->file, first.data(), first.size());
        // pull until the header is provably complete (first data line)
        while (!s->eof && s->sam->data_lines == 0) s->pull(1);
      }
    }
    // pipelined tokenize/consume for the rest of the stream (SAM + mmap);
    // started before the sampling pulls below so they too overlap
    if (s->sam && !s->eof && s->src->stable_views() && !(flags & 2))
      s->start_pipeline();
    // Complete the average-read-length sample BEFORE handing out chunks:
    // bin_width derives from it (slimm.hpp:412-413) and the reference
    // samples the file head (misc.hpp:509-522), so a small first chunk
    // must not freeze a partial running average.  Buffers at most ~100k
    // records' targets (~1.2 MB) — decoder memory stays flat.  (Parallel
    // mode sampled inside init_parallel's probe.)
    while (!s->parallel && !s->eof && s->dec().sample_count < 100000)
      s->pull(s->file.read_id.size() + 4096);
  } catch (const std::exception& e) {
    s->error = e.what();
  }
  return s;
}

void* stpu_stream_open(const char* path) {
  return stpu_stream_open2(path, 0);
}

const char* stpu_stream_error(void* h) {
  return static_cast<StpuStream*>(h)->error.c_str();
}

// inner StpuFile: reuse stpu_n_refs/stpu_ref_name/stpu_ref_len/stpu_hits/
// stpu_n_reads/stpu_warning/stpu_n_malformed accessors on this pointer
// (do NOT stpu_close it)
void* stpu_stream_file(void* h) { return &static_cast<StpuStream*>(h)->file; }

int stpu_stream_grouped(void* h) {
  // "the arrays handed out are read-grouped": native fast path held, the
  // EOF counting-sort regroup ran (coordinate-sorted input), or the
  // parallel sharded decode is serving (errors out otherwise)
  auto* s = static_cast<StpuStream*>(h);
  if (s->error.size()) return 0;
  if (s->parallel) return 1;
  return (s->dec().grouped || s->regrouped) ? 1 : 0;
}

int stpu_stream_eof(void* h) {
  return static_cast<StpuStream*>(h)->eof ? 1 : 0;
}

// average read length over the (<=100k) sampled records — final and
// reference-identical from the moment the stream opens (stpu_stream_open2
// completes the sample before handing out chunks)
int64_t stpu_stream_avg_len(void* h) {
  auto* s = static_cast<StpuStream*>(h);
  if (s->parallel)
    return s->psample_count ? s->psample_total / s->psample_count : 0;
  if (!s->sam && !s->bam) return 0;
  auto& d = s->dec();
  return d.sample_count ? d.sample_total / d.sample_count : 0;
}

// Parse until >= min_targets read-complete targets are available (or EOF);
// returns the available count, or -1 on decode error.
int64_t stpu_stream_next(void* h, int64_t min_targets) {
  auto* s = static_cast<StpuStream*>(h);
  if (!s->error.empty()) return -1;
  try {
    if (s->parallel) {
      while (!s->eof && s->completed() < min_targets) s->pull_parallel();
      return s->completed();
    }
    while (!s->eof && s->completed() < min_targets &&
           s->dec().grouped) {
      // slack past min so the run boundary usually lands inside; the cap
      // always exceeds the current size (progress even on giant runs)
      int64_t cap = s->consumed + min_targets;
      int64_t have = static_cast<int64_t>(s->file.read_id.size());
      s->pull(static_cast<size_t>(std::max(cap, have)) + 4096);
    }
    if (!s->dec().grouped && !s->regrouped) s->regroup_at_eof();
  } catch (const std::exception& e) {
    s->error = e.what();
    return -1;
  }
  return s->completed();
}

// Copy out n targets (n <= last stpu_stream_next return) and release them.
void stpu_stream_take(void* h, int64_t n, int32_t* read_id, int32_t* rid,
                      int32_t* pos) {
  auto* s = static_cast<StpuStream*>(h);
  memcpy(read_id, s->file.read_id.data() + s->consumed, n * 4);
  memcpy(rid, s->file.rid.data() + s->consumed, n * 4);
  memcpy(pos, s->file.pos.data() + s->consumed, n * 4);
  s->consumed += n;
  s->compact();
}

// Parse until >= cap read-complete targets are available (or EOF) and
// return the length of the next piece: the largest read-boundary cut
// <= cap.  0 at EOF, -1 on decode error, -2 when one read's targets alone
// exceed cap (callers fall back to the whole-file path).
int64_t stpu_stream_next_piece(void* h, int64_t cap) {
  auto* s = static_cast<StpuStream*>(h);
  int64_t avail = stpu_stream_next(h, cap);
  if (avail < 0) return -1;
  if (avail <= cap) return avail;  // EOF tail or an exact boundary fit
  const int32_t* r = s->file.read_id.data() + s->consumed;
  int64_t cut = cap;
  while (cut > 0 && r[cut] == r[cut - 1]) --cut;
  return cut > 0 ? cut : -2;
}

// v2-encode n targets (n <= last next_piece return) into zero-padded
// n_pad-sized piece arrays and release them: bitpacked read boundaries
// (little-endian bit order, bit 0 of the piece always set), rid cast to
// rid_dtype (0=uint8, 1=int16, 2=int32), and the reference's exact
// uint32-wrap center binning (slimm.hpp:200-201) as a uint16 local bin.
// This is the engine's compact transfer format computed inside the decode
// pipeline — the Python host never touches per-record data.
void stpu_stream_take_v2(void* h, int64_t n, int64_t n_pad,
                         const uint32_t* lengths, uint32_t half,
                         uint32_t bin_width, uint8_t* bnd, void* rid_out,
                         int rid_dtype, uint16_t* bin_out) {
  auto* s = static_cast<StpuStream*>(h);
  const int32_t* read_id = s->file.read_id.data() + s->consumed;
  const int32_t* rid = s->file.rid.data() + s->consumed;
  const int32_t* pos = s->file.pos.data() + s->consumed;
  memset(bnd, 0, static_cast<size_t>(n_pad / 8));
  int64_t i0 = 0;
#if defined(__AVX2__)
  // boundary byte per 8 records: movemask of read_id[i] == read_id[i-1],
  // inverted (the scalar loop's byte RMW has a loop-carried dependency
  // gcc cannot vectorize)
  if (n >= 9) {
    for (int64_t i = 8; i + 8 <= n; i += 8) {
      __m256i cur = _mm256_loadu_si256(
          reinterpret_cast<const __m256i*>(read_id + i));
      __m256i prv = _mm256_loadu_si256(
          reinterpret_cast<const __m256i*>(read_id + i - 1));
      int eq = _mm256_movemask_ps(
          _mm256_castsi256_ps(_mm256_cmpeq_epi32(cur, prv)));
      bnd[i >> 3] = static_cast<uint8_t>(~eq & 0xFF);
    }
    bnd[0] = 0;
    for (int64_t i = 0; i < 8; ++i) {
      bool b = (i == 0) || (read_id[i] != read_id[i - 1]);
      bnd[0] |= static_cast<uint8_t>(b) << i;
    }
    for (int64_t i = ((n - 8) / 8) * 8 + 8; i < n; ++i) {  // block tail
      bool b = read_id[i] != read_id[i - 1];
      bnd[i >> 3] |= static_cast<uint8_t>(b) << (i & 7);
    }
    i0 = n;
  }
#endif
  for (int64_t i = i0; i < n; ++i) {
    bool b = (i == 0) || (read_id[i] != read_id[i - 1]);
    bnd[i >> 3] |= static_cast<uint8_t>(b) << (i & 7);
  }
  if (rid_dtype == 0) {
    auto* o = static_cast<uint8_t*>(rid_out);
    for (int64_t i = 0; i < n; ++i) o[i] = static_cast<uint8_t>(rid[i]);
    memset(o + n, 0, static_cast<size_t>(n_pad - n));
  } else if (rid_dtype == 1) {
    auto* o = static_cast<int16_t*>(rid_out);
    for (int64_t i = 0; i < n; ++i) o[i] = static_cast<int16_t>(rid[i]);
    memset(o + n, 0, static_cast<size_t>(n_pad - n) * 2);
  } else {
    auto* o = static_cast<int32_t*>(rid_out);
    memcpy(o, rid, static_cast<size_t>(n) * 4);
    memset(o + n, 0, static_cast<size_t>(n_pad - n) * 4);
  }
  // division by invariant multiplication: M = ceil(2^64 / bw) makes
  // floor((center * M) >> 64) == center / bw exact for ALL center < 2^32
  // (error term center/2^64 < 2^-32 <= 1/bw) — a hardware udiv per record
  // cost ~30% of this loop
  const uint64_t magic =
      bin_width > 1
          ? ~0ull / bin_width + 1  // == ceil(2^64 / bw) for bw not a power
          : 0;                     // dividing 2^64... exact either way; see below
  for (int64_t i = 0; i < n; ++i) {
    uint32_t center = static_cast<uint32_t>(pos[i]) + half;
    uint32_t len = lengths[rid[i]];
    if (center > len) center = len;
    uint32_t q =
        bin_width > 1
            ? static_cast<uint32_t>(
                  (static_cast<unsigned __int128>(center) * magic) >> 64)
            : center;
    bin_out[i] = static_cast<uint16_t>(q);
  }
  memset(bin_out + n, 0, static_cast<size_t>(n_pad - n) * 2);
  s->consumed += n;
  s->compact();
}

// take_v2 plus the piece's read count and longest per-read target run
// (from the boundary bits, one popcount/ctz pass) — the overlap path
// derives its per-piece segment plan and global read-id offsets from
// these; computing them host-side cost ~1 ms/piece of numpy on the
// caller thread that also feeds the decoder.
void stpu_stream_take_v2x(void* h, int64_t n, int64_t n_pad,
                          const uint32_t* lengths, uint32_t half,
                          uint32_t bin_width, uint8_t* bnd, void* rid_out,
                          int rid_dtype, uint16_t* bin_out,
                          int64_t* out_n_reads, int64_t* out_max_run) {
  stpu_stream_take_v2(h, n, n_pad, lengths, half, bin_width, bnd, rid_out,
                      rid_dtype, bin_out);
  int64_t n_reads = 0;
  int64_t max_run = 0;
  int64_t prev = -1;  // position of the previous boundary bit
  const int64_t words = (n + 63) >> 6;
  // the caller's bnd buffer holds n_pad/8 bytes; when n_pad is not a
  // multiple of 64 the final word is short — bound its read
  const int64_t bnd_bytes = (n_pad + 7) >> 3;
  for (int64_t w = 0; w < words; ++w) {
    uint64_t v = 0;
    const int64_t off = w * 8;
    const int64_t take = bnd_bytes - off < 8 ? bnd_bytes - off : 8;
    memcpy(&v, bnd + off, static_cast<size_t>(take));
    if (w == words - 1 && (n & 63))
      v &= (~0ull) >> (64 - (n & 63));  // mask pad bits
    while (v) {
      int64_t p = (w << 6) + __builtin_ctzll(v);
      v &= v - 1;
      ++n_reads;
      if (prev >= 0 && p - prev > max_run) max_run = p - prev;
      prev = p;
    }
  }
  if (prev >= 0 && n - prev > max_run) max_run = n - prev;
  *out_n_reads = n_reads;
  *out_max_run = max_run;
}

void stpu_stream_close(void* h) { delete static_cast<StpuStream*>(h); }

// Timed first-hit dedup of raw (read, contig) records — the host-side stage
// of the device pipeline, exposed so benchmarks can charge its cost to the
// end-to-end number.  Fills out arrays (sized >= n_records); returns the
// number of targets kept, with *out_secs set to the wall time.
int64_t stpu_dedup_targets(int64_t n_records, const int32_t* read_id,
                           const int32_t* rid, const int32_t* pos,
                           int32_t* out_read, int32_t* out_rid,
                           int32_t* out_pos, double* out_secs) {
  auto t0 = std::chrono::high_resolution_clock::now();
  PairSet seen(static_cast<size_t>(n_records));
  int64_t kept = 0;
  for (int64_t i = 0; i < n_records; ++i) {
    uint64_t key =
        (static_cast<uint64_t>(static_cast<uint32_t>(read_id[i])) << 32) |
        static_cast<uint32_t>(rid[i]);
    if (seen.insert(key)) {
      out_read[kept] = read_id[i];
      out_rid[kept] = rid[i];
      out_pos[kept] = pos[i];
      ++kept;
    }
  }
  auto t1 = std::chrono::high_resolution_clock::now();
  if (out_secs) *out_secs = std::chrono::duration<double>(t1 - t0).count();
  return kept;
}

// ---------------------------------------------------------------------------
// .sldb cereal-binary roundtrip (independent implementation cross-check)
// ---------------------------------------------------------------------------
//
// The reference persists `slimm_database` with cereal's BinaryOutputArchive
// (misc.hpp:77-100, 178-195).  Real cereal cannot be vendored here (the
// reference pins it as an empty submodule and this environment is offline),
// so this is an INDEPENDENT C++ implementation of the cereal 1.x binary
// layout for the exact reference types, derived from the cereal spec:
//   unordered_map      -> size_type(uint64 LE) count, then (key, value)*
//                         (types/concepts/pair_associative_container.hpp)
//   std::string        -> size_type + raw bytes        (types/string.hpp)
//   vector<arithmetic> -> size_type + raw data         (types/vector.hpp)
//   tuple<enum,string> -> elements in order 0..N-1     (types/tuple.hpp);
//                         enums as their underlying int (types/common.hpp)
// stpu_sldb_roundtrip parses an .sldb with strict bounds checks and
// re-serializes it preserving entry order; byte-equality against the
// Python writer (slimm_jax/database.py) cross-validates both
// implementations (tests/test_database.py).

namespace {

struct SldbCursor {
  const uint8_t* p;
  size_t n;
  size_t off = 0;

  uint64_t u64(const char* what) {
    if (off + 8 > n) throw DecodeError(std::string("sldb: truncated ") + what);
    uint64_t v;
    memcpy(&v, p + off, 8);
    off += 8;
    return v;
  }
  uint32_t u32(const char* what) {
    if (off + 4 > n) throw DecodeError(std::string("sldb: truncated ") + what);
    uint32_t v;
    memcpy(&v, p + off, 4);
    off += 4;
    return v;
  }
  const uint8_t* bytes(size_t k, const char* what) {
    if (off + k > n) throw DecodeError(std::string("sldb: truncated ") + what);
    const uint8_t* q = p + off;
    off += k;
    return q;
  }
};

}  // namespace

int stpu_sldb_roundtrip(const char* in_path, const char* out_path,
                        char* errbuf, int errlen) {
  auto fail = [&](const std::string& msg) {
    snprintf(errbuf, errlen, "%s", msg.c_str());
    return 1;
  };
  std::vector<uint8_t> data;
  {
    FILE* f = std::fopen(in_path, "rb");
    if (!f) return fail("cannot open input");
    std::fseek(f, 0, SEEK_END);
    long sz = std::ftell(f);
    std::fseek(f, 0, SEEK_SET);
    data.resize(static_cast<size_t>(sz));
    size_t got = sz ? std::fread(data.data(), 1, data.size(), f) : 0;
    std::fclose(f);
    if (got != data.size()) return fail("short read");
  }
  std::vector<uint8_t> out;
  out.reserve(data.size());
  auto put_u64 = [&](uint64_t v) {
    out.insert(out.end(), reinterpret_cast<uint8_t*>(&v),
               reinterpret_cast<uint8_t*>(&v) + 8);
  };
  try {
    SldbCursor c{data.data(), data.size()};
    // ac__taxid : unordered_map<string, vector<uint32>>
    uint64_t n_acc = c.u64("ac__taxid count");
    put_u64(n_acc);
    for (uint64_t i = 0; i < n_acc; ++i) {
      uint64_t sl = c.u64("accession length");
      if (sl > (1u << 20)) throw DecodeError("sldb: implausible accession");
      const uint8_t* s = c.bytes(sl, "accession bytes");
      put_u64(sl);
      out.insert(out.end(), s, s + sl);
      uint64_t vl = c.u64("lineage length");
      if (vl != LINEAGE_LENGTH)
        throw DecodeError("sldb: lineage length " + std::to_string(vl) +
                          " != 8");
      const uint8_t* v = c.bytes(vl * 4, "lineage data");
      put_u64(vl);
      out.insert(out.end(), v, v + vl * 4);
    }
    // taxid__name : unordered_map<uint32, tuple<taxa_ranks, string>>
    uint64_t n_names = c.u64("taxid__name count");
    put_u64(n_names);
    for (uint64_t i = 0; i < n_names; ++i) {
      uint32_t tid = c.u32("taxid");
      uint32_t rank = c.u32("rank enum");  // int32 underlying
      uint64_t sl = c.u64("name length");
      if (sl > (1u << 20)) throw DecodeError("sldb: implausible name");
      const uint8_t* s = c.bytes(sl, "name bytes");
      out.insert(out.end(), reinterpret_cast<uint8_t*>(&tid),
                 reinterpret_cast<uint8_t*>(&tid) + 4);
      out.insert(out.end(), reinterpret_cast<uint8_t*>(&rank),
                 reinterpret_cast<uint8_t*>(&rank) + 4);
      put_u64(sl);
      out.insert(out.end(), s, s + sl);
    }
    if (c.off != data.size())
      throw DecodeError("sldb: " + std::to_string(data.size() - c.off) +
                        " trailing bytes");
  } catch (const std::exception& e) {
    return fail(e.what());
  }
  FILE* f = std::fopen(out_path, "wb");
  if (!f) return fail("cannot open output");
  size_t put = out.empty() ? 0 : std::fwrite(out.data(), 1, out.size(), f);
  std::fclose(f);
  if (put != out.size()) return fail("short write");
  return 0;
}

// ---------------------------------------------------------------------------
// single-core baseline profiler (bench comparison target)
// ---------------------------------------------------------------------------
//
// Faithful reimplementation of the reference hot-loop semantics on
// pre-decoded arrays: per-read target lists with first-hit-wins dedup,
// coverage histograms, mass-quantile cutoffs, validity filter, re-dedup,
// and per-read LCA over the lineage matrix.  Single thread, like the
// reference binary.  Returns wall seconds; fills out_counters:
//   [0]=hits [1]=matches [2]=uniq_matches [3]=uniq_matches2
//   [4]=n_valid_refs [5]=sum(lca_counts) [6]=cov_mass [7]=uniq_cov2_mass

double stpu_baseline_profile(
    int64_t n_records, const int32_t* read_id, const int32_t* rid,
    const int32_t* pos, int64_t n_reads, int32_t n_contigs,
    const uint32_t* lengths, const int32_t* lineage, uint32_t avg_read_len,
    uint32_t bin_width, float cov_cut_off_q, int64_t* out_counters) {
  auto t0 = std::chrono::high_resolution_clock::now();

  std::vector<uint32_t> nbins(n_contigs);
  std::vector<uint64_t> bin_offset(n_contigs);
  uint64_t total_bins = 0;
  for (int32_t c = 0; c < n_contigs; ++c) {
    nbins[c] = lengths[c] / bin_width + 1;
    bin_offset[c] = total_bins;
    total_bins += nbins[c];
  }
  std::vector<uint32_t> cov(total_bins, 0), uniq_cov(total_bins, 0),
      uniq_cov2(total_bins, 0);

  // per-read target lists (read_stat semantics)
  struct Target { int32_t rid; uint32_t bin; };
  std::vector<std::vector<Target>> reads(n_reads);
  uint32_t half = avg_read_len / 2;
  for (int64_t i = 0; i < n_records; ++i) {
    int32_t r = rid[i];
    uint32_t center = std::min(
        static_cast<uint32_t>(pos[i]) + half, lengths[r]);
    uint32_t bin = center / bin_width;
    auto& tl = reads[read_id[i]];
    bool seen = false;
    for (const auto& t : tl)
      if (t.rid == r) { seen = true; break; }
    if (!seen) tl.push_back({r, bin});
  }

  std::vector<uint32_t> reads_count(n_contigs, 0), uniq_reads_count(n_contigs, 0),
      uniq_reads_count2(n_contigs, 0);
  int64_t uniq_matches = 0;
  for (auto& tl : reads) {
    if (tl.size() == 1) {
      ++uniq_matches;
      reads_count[tl[0].rid] += 1;
      uint64_t g = bin_offset[tl[0].rid] + tl[0].bin;
      ++cov[g];
      ++uniq_cov[g];
      uniq_reads_count[tl[0].rid] += 1;
    } else {
      for (const auto& t : tl) {
        reads_count[t.rid] += 1;
        ++cov[bin_offset[t.rid] + t.bin];
      }
    }
  }

  // mass-quantile cutoffs over cov percents (misc.hpp:197-216 semantics)
  auto quantile = [&](std::vector<float> v) -> float {
    if (v.empty()) return 0.0f;
    float total = std::accumulate(v.begin(), v.end(), 0.0f);
    std::sort(v.begin(), v.end());
    float sub = 0.0f;
    size_t i = v.size() - 1;
    while (i > 0 && (sub / total) < cov_cut_off_q) { sub += v[i]; --i; }
    return v[i];
  };
  std::vector<float> covp(n_contigs), ucovp(n_contigs);
  for (int32_t c = 0; c < n_contigs; ++c) {
    uint32_t nz = 0, nzu = 0;
    for (uint32_t b = 0; b < nbins[c]; ++b) {
      nz += cov[bin_offset[c] + b] != 0;
      nzu += uniq_cov[bin_offset[c] + b] != 0;
    }
    covp[c] = static_cast<float>(nz) / nbins[c];
    ucovp[c] = static_cast<float>(nzu) / nbins[c];
  }
  std::vector<float> qv, qvu;
  for (int32_t c = 0; c < n_contigs; ++c)
    if (uniq_reads_count[c] > 0) { qv.push_back(covp[c]); qvu.push_back(ucovp[c]); }
  float cc = (cov_cut_off_q < 1.0f) ? quantile(qv) : 0.0f;
  float ucc = (cov_cut_off_q < 1.0f) ? quantile(qvu) : 0.0f;

  std::vector<uint8_t> valid(n_contigs, 0);
  int64_t n_valid = 0;
  for (int32_t c = 0; c < n_contigs; ++c) {
    if (reads_count[c] > 0 && covp[c] >= cc && ucovp[c] >= ucc) {
      valid[c] = 1;
      ++n_valid;
    }
  }

  // re-dedup + LCA (slimm.hpp:380-390, 516-557)
  int64_t uniq_matches2 = 0, lca_total = 0;
  std::unordered_map<int32_t, int64_t> lca_counts;
  std::vector<int32_t> kept;
  for (auto& tl : reads) {
    kept.clear();
    const Target* only = nullptr;
    for (const auto& t : tl) {
      if (valid[t.rid]) { kept.push_back(t.rid); only = &t; }
    }
    if (kept.size() == 1) {
      ++uniq_matches2;
      uniq_reads_count2[only->rid] += 1;
      ++uniq_cov2[bin_offset[only->rid] + only->bin];
    } else if (kept.size() > 1) {
      std::sort(kept.begin(), kept.end());
      int32_t taxa = 1;
      for (int lvl = 0; lvl < LINEAGE_LENGTH; ++lvl) {
        std::set<int32_t> s;
        for (int32_t r : kept) {
          taxa = lineage[static_cast<int64_t>(r) * LINEAGE_LENGTH + lvl];
          s.insert(taxa);
        }
        if (s.size() == 1) break;
      }
      ++lca_counts[taxa];
      ++lca_total;
    }
  }

  auto t1 = std::chrono::high_resolution_clock::now();
  uint64_t cov_mass = 0, u2_mass = 0;
  for (uint64_t b = 0; b < total_bins; ++b) { cov_mass += cov[b]; u2_mass += uniq_cov2[b]; }
  if (out_counters) {
    out_counters[0] = n_records;
    out_counters[1] = n_reads;
    out_counters[2] = uniq_matches;
    out_counters[3] = uniq_matches2;
    out_counters[4] = n_valid;
    out_counters[5] = lca_total;
    out_counters[6] = static_cast<int64_t>(cov_mass);
    out_counters[7] = static_cast<int64_t>(u2_mass);
  }
  return std::chrono::duration<double>(t1 - t0).count();
}

}  // extern "C"

// -- ancestor propagation (state.propagate_counts, slimm.hpp:559-610) --------
//
// The Python host finalize walks dict-of-set children structures taxid by
// taxid; at full-RefSeq cardinality (tens of thousands of LCA taxids x
// thousands of contigs) the set unions dominate the host tail (~7 s
// measured at 50k contigs / 62k taxids).  This native path replicates the
// EXACT sequential semantics of ProfileState.propagate_counts — pass 1 in
// ascending-taxid order over the snapshot with live mutation of the
// children map, pass 2 in ascending contig order — with children sets as
// sorted small-vectors that promote to contig-bitsets past 256 elements.
// The Python loop stays as the spec and fallback; parity is locked by
// tests/test_state.py on a large synthetic state.

namespace {

struct TaxSet {
  // small: sorted unique contig ids; past kSmallMax promotes to a bitset.
  std::vector<int32_t> small;
  std::vector<uint64_t> bits;  // non-empty => promoted
  static constexpr size_t kSmallMax = 256;

  bool promoted() const { return !bits.empty(); }
  bool empty() const { return small.empty() && bits.empty(); }

  void promote(size_t words) {
    bits.assign(words, 0);
    for (int32_t e : small)
      bits[static_cast<uint32_t>(e) >> 6] |= 1ull << (e & 63);
    small.clear();
    small.shrink_to_fit();
  }
  void add(int32_t e, size_t words) {
    if (promoted()) {
      bits[static_cast<uint32_t>(e) >> 6] |= 1ull << (e & 63);
      return;
    }
    auto it = std::lower_bound(small.begin(), small.end(), e);
    if (it != small.end() && *it == e) return;
    small.insert(it, e);
    if (small.size() > kSmallMax) promote(words);
  }
  void merge_from(const TaxSet& src, size_t words) {
    if (src.empty()) return;
    if (!promoted() && !src.promoted()) {
      std::vector<int32_t> out;
      out.reserve(small.size() + src.small.size());
      std::set_union(small.begin(), small.end(), src.small.begin(),
                     src.small.end(), std::back_inserter(out));
      small.swap(out);
      if (small.size() > kSmallMax) promote(words);
      return;
    }
    if (!promoted()) promote(words);
    if (src.promoted()) {
      for (size_t w = 0; w < words; ++w) bits[w] |= src.bits[w];
    } else {
      for (int32_t e : src.small)
        bits[static_cast<uint32_t>(e) >> 6] |= 1ull << (e & 63);
    }
  }
  // smallest element; -1 when empty
  int32_t min_elem() const {
    if (promoted()) {
      for (size_t w = 0; w < bits.size(); ++w)
        if (bits[w]) return static_cast<int32_t>((w << 6) +
                         __builtin_ctzll(bits[w]));
      return -1;
    }
    return small.empty() ? -1 : small[0];
  }
  size_t count() const {
    if (!promoted()) return small.size();
    size_t n = 0;
    for (uint64_t w : bits) n += static_cast<size_t>(__builtin_popcountll(w));
    return n;
  }
  // append elements ascending
  void emit(std::vector<int32_t>& out) const {
    if (!promoted()) {
      out.insert(out.end(), small.begin(), small.end());
      return;
    }
    for (size_t w = 0; w < bits.size(); ++w) {
      uint64_t v = bits[w];
      while (v) {
        out.push_back(static_cast<int32_t>((w << 6) + __builtin_ctzll(v)));
        v &= v - 1;
      }
    }
  }
};

struct PropSlot {
  int64_t count = 0;
  uint8_t flags = 0;  // bit0: in taxon_id__read_count, bit1: in children map
  TaxSet set;
};

struct PropagateResult {
  std::vector<int64_t> taxids;
  std::vector<int64_t> counts;
  std::vector<uint8_t> flags;
  std::vector<int64_t> choff;  // per-slot children CSR offsets (k_out + 1)
  std::vector<int32_t> cch;    // flattened children, ascending per slot
};

}  // namespace

extern "C" {

// Computes the propagation; on success returns a handle and fills
// out_slots / out_elems with the output CSR sizes.  Inputs:
//   lineage:    int64[n_contigs * 8], level 0 (strain) .. 7 (superkingdom)
//   tax/cnt/rnk: the read-count snapshot, ascending taxid order (k entries)
//   ctax/coff/cch: the initial children map as CSR (kc keys, any order;
//                  elements need not be sorted)
//   c2idx/c2cnt: pass-2 contigs (ascending index) and uniq_reads_count2
// Returns nullptr on semantic errors the Python loop would raise on
// (missing/empty children for a snapshot taxid) — callers fall back.
void* stpu_propagate_run(int32_t n_contigs, const int64_t* lineage,
                         int64_t k, const int64_t* tax, const int64_t* cnt,
                         const int32_t* rnk, int64_t kc, const int64_t* ctax,
                         const int64_t* coff, const int32_t* cch,
                         int64_t m, const int32_t* c2idx,
                         const int64_t* c2cnt, int64_t* out_slots,
                         int64_t* out_elems) {
  const size_t words = (static_cast<size_t>(n_contigs) + 63) >> 6;
  std::unordered_map<int64_t, PropSlot> slots;
  slots.reserve(static_cast<size_t>(k + kc) * 2 + 16);

  for (int64_t i = 0; i < kc; ++i) {
    PropSlot& s = slots[ctax[i]];
    s.flags |= 2;
    for (int64_t j = coff[i]; j < coff[i + 1]; ++j)
      s.set.add(cch[j], words);
  }
  for (int64_t i = 0; i < k; ++i) {
    PropSlot& s = slots[tax[i]];
    s.flags |= 1;
    s.count += cnt[i];
  }

  // pass 1: snapshot order (ascending taxid), live children mutation
  for (int64_t i = 0; i < k; ++i) {
    auto it = slots.find(tax[i]);
    // children[t_id] raises in Python when missing/empty (min of empty set)
    if (it == slots.end() || !(it->second.flags & 2) ||
        it->second.set.empty())
      return nullptr;
    const int32_t first_child = it->second.set.min_elem();
    if (first_child < 0 || first_child >= n_contigs) return nullptr;
    TaxSet ref_ids = it->second.set;  // copy, like `set(children)`
    const int64_t* lin = lineage + static_cast<int64_t>(first_child) * 8;
    for (int32_t j = rnk[i] + 1; j < 8; ++j) {
      PropSlot& r = slots[lin[j]];
      r.flags |= 3;
      r.count += cnt[i];
      r.set.merge_from(ref_ids, words);
    }
  }

  // pass 2: ascending contig order
  for (int64_t i = 0; i < m; ++i) {
    const int32_t c = c2idx[i];
    if (c < 0 || c >= n_contigs) return nullptr;
    const int64_t* lin = lineage + static_cast<int64_t>(c) * 8;
    PropSlot& s0 = slots[lin[0]];  // setdefault side effect
    s0.flags |= 2;
    TaxSet ref_ids = s0.set;  // copy BEFORE the pushes
    for (int32_t j = 1; j < 8; ++j) {
      PropSlot& r = slots[lin[j]];
      r.flags |= 3;
      r.count += c2cnt[i];
      r.set.add(c, words);
      r.set.merge_from(ref_ids, words);
    }
  }

  auto* res = new PropagateResult();
  res->taxids.reserve(slots.size());
  res->counts.reserve(slots.size());
  res->flags.reserve(slots.size());
  res->choff.reserve(slots.size() + 1);
  res->choff.push_back(0);
  size_t total = 0;
  for (auto& kv : slots) total += kv.second.set.count();
  res->cch.reserve(total);
  for (auto& kv : slots) {
    res->taxids.push_back(kv.first);
    res->counts.push_back(kv.second.count);
    res->flags.push_back(kv.second.flags);
    kv.second.set.emit(res->cch);
    res->choff.push_back(static_cast<int64_t>(res->cch.size()));
  }
  *out_slots = static_cast<int64_t>(res->taxids.size());
  *out_elems = static_cast<int64_t>(res->cch.size());
  return res;
}

void stpu_propagate_take(void* handle, int64_t* taxids, int64_t* counts,
                         uint8_t* flags, int64_t* choff, int32_t* cch) {
  auto* res = static_cast<PropagateResult*>(handle);
  memcpy(taxids, res->taxids.data(), res->taxids.size() * 8);
  memcpy(counts, res->counts.data(), res->counts.size() * 8);
  memcpy(flags, res->flags.data(), res->flags.size());
  memcpy(choff, res->choff.data(), res->choff.size() * 8);
  if (!res->cch.empty()) memcpy(cch, res->cch.data(), res->cch.size() * 4);
  delete res;
}

}  // extern "C"
