// Native BAM scanner: BGZF inflate + record field extraction in bulk.
//
// Replaces the per-record Python decode for the BAM extraction stage
// (reference alignments.hpp wraps samtools; this is the equivalent
// host-side native ingest without the vendored library).  Batches are
// returned as flat arrays: fixed-width int32 header fields plus byte
// blobs with offsets for names / decoded sequences / quals / two chosen
// string tags (cell barcode + UMI), and a 64-bit FNV name hash per
// record for fast mate-set membership tests.
//
// BAM layout: SAM spec v1.6 §4.2; BGZF: §4.1 (concatenated gzip
// members, handled by zlib with windowBits 15+16 and inflateReset at
// member boundaries).

// libdeflate (whole-buffer inflate, ~2x zlib on BGZF members) is used
// when available; plain zlib raw inflate otherwise, so the build needs
// only zlib.  The Makefile links -ldeflate only when the header exists.
#if defined(__has_include)
#if __has_include(<libdeflate.h>)
#define T1K_HAVE_LIBDEFLATE 1
#endif
#endif
#ifdef T1K_HAVE_LIBDEFLATE
#include <libdeflate.h>
#endif
#include <zlib.h>

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace t1kbam {

// Parallel BGZF inflater: BGZF members are independently-deflated gzip
// members (SAM spec §4.1, BC extra subfield carries the member size),
// so a batch of members can be raw-inflated concurrently.  The
// reference's samtools bgzf reader is strictly serial; this pool is
// where the extraction stage beats it on wall clock.
struct InflatePool {
  struct Task {
    const uint8_t* src;
    size_t srcLen;
    uint8_t* dst;
    size_t dstLen;
  };
  std::vector<std::thread> workers;
  std::vector<Task> tasks;
  std::mutex mu;
  std::condition_variable cvWork, cvDone;
  size_t next = 0;
  size_t done = 0;
  uint64_t generation = 0;
  bool stop = false;

  explicit InflatePool(int n) {
    for (int i = 0; i < n; ++i)
      workers.emplace_back([this] { Run(); });
  }
  ~InflatePool() {
    {
      std::lock_guard<std::mutex> lk(mu);
      stop = true;
    }
    cvWork.notify_all();
    for (auto& w : workers) w.join();
  }

  std::atomic<bool> fail{false};

  // Per-worker decompressor state: libdeflate's whole-buffer raw
  // inflate when available (BGZF members carry their exact decompressed
  // size ISIZE, libdeflate's fast path — measured ~2x zlib's streaming
  // inflate on BGZF payloads), zlib raw inflate otherwise.
#ifdef T1K_HAVE_LIBDEFLATE
  typedef libdeflate_decompressor* Dec;
  static Dec DecAlloc() {
    Dec d = libdeflate_alloc_decompressor();
    if (!d)
      std::fprintf(stderr, "t1k bamscan: libdeflate_alloc_decompressor() "
                           "failed; the BAM scan stops at this batch\n");
    return d;
  }
  static void DecFree(Dec d) {
    if (d) libdeflate_free_decompressor(d);
  }
  void InflateOne(Dec dec, const Task& t) {
    // a failed decompressor allocation is a scan error, never a call
    // through a null decompressor
    if (!dec) {
      fail.store(true, std::memory_order_relaxed);
      return;
    }
    enum libdeflate_result rc = libdeflate_deflate_decompress(
        dec, t.src, t.srcLen, t.dst, t.dstLen, nullptr);
    // a corrupt/truncated member must not be silently accepted: the
    // zero-filled dst would parse as garbage records downstream
    if (rc != LIBDEFLATE_SUCCESS)
      fail.store(true, std::memory_order_relaxed);
  }
#else
  typedef z_stream* Dec;
  static Dec DecAlloc() {
    z_stream* zs = new z_stream{};
    if (inflateInit2(zs, -15) != Z_OK) {  // raw deflate
      delete zs;
      return nullptr;
    }
    return zs;
  }
  static void DecFree(Dec zs) {
    if (!zs) return;
    inflateEnd(zs);
    delete zs;
  }
  void InflateOne(Dec zs, const Task& t) {
    // a failed decompressor init must surface as a scan error, not a
    // silent fake EOF on a truncated output
    if (!zs) {
      fail.store(true, std::memory_order_relaxed);
      return;
    }
    inflateReset(zs);
    zs->next_in = const_cast<Bytef*>(t.src);
    zs->avail_in = (uInt)t.srcLen;
    zs->next_out = t.dst;
    zs->avail_out = (uInt)t.dstLen;
    int rc = inflate(zs, Z_FINISH);
    if (rc != Z_STREAM_END || zs->avail_out != 0)
      fail.store(true, std::memory_order_relaxed);
  }
#endif

  void Run() {
    Dec dec = DecAlloc();
    uint64_t gen = 0;
    std::unique_lock<std::mutex> lk(mu);
    for (;;) {
      cvWork.wait(lk, [&] { return stop || (generation != gen
                                            && next < tasks.size()); });
      if (stop) break;
      gen = generation;
      while (next < tasks.size()) {
        Task t = tasks[next++];
        lk.unlock();
        InflateOne(dec, t);
        lk.lock();
        ++done;
      }
      if (done == tasks.size()) cvDone.notify_all();
    }
    DecFree(dec);
  }

  // Run all tasks (caller's thread participates), blocking until done.
  // Returns false when any member failed to inflate cleanly.
  bool Execute(std::vector<Task>&& batch) {
    Dec dec = DecAlloc();
    {
      std::lock_guard<std::mutex> lk(mu);
      tasks = std::move(batch);
      next = 0;
      done = 0;
      ++generation;
      fail.store(false, std::memory_order_relaxed);
    }
    cvWork.notify_all();
    for (;;) {
      Task t;
      {
        std::lock_guard<std::mutex> lk(mu);
        if (next >= tasks.size()) break;
        t = tasks[next++];
      }
      InflateOne(dec, t);
      std::lock_guard<std::mutex> lk(mu);
      ++done;
      if (done == tasks.size()) cvDone.notify_all();
    }
    DecFree(dec);
    std::unique_lock<std::mutex> lk(mu);
    cvDone.wait(lk, [&] { return done == tasks.size(); });
    return !fail.load(std::memory_order_relaxed);
  }
};

struct Scanner {
  FILE* fp = nullptr;
  z_stream zs{};
  std::vector<uint8_t> data;   // decompressed, rolling
  size_t dataPos = 0;
  bool eof = false;

  // parallel BGZF path (nullptr => serial gzip-stream fallback)
  InflatePool* pool = nullptr;
  std::vector<uint8_t> comp;   // compressed, rolling
  size_t compPos = 0;
  bool fileEof = false;

  // async prefetch: between scan calls the Python side only touches
  // copies, so a background thread keeps inflating into `data`
  std::thread prefetch;
  bool prefetchActive = false;

  // header
  std::string headerText;
  std::vector<std::string> refNames;
  std::vector<int32_t> refLens;

  // current batch staging
  std::vector<int32_t> fields;   // [n, 9]
  std::vector<uint64_t> nameHash;
  std::vector<int64_t> nameOff, seqOff, qualOff, bcOff, umiOff;
  std::string names, seqs, quals, bcs, umis;
  // lazy mode: raw record bytes (block_size-prefixed layout without the
  // prefix), decoded on demand by t1k_bam_fetch
  std::vector<int64_t> rawOff;
  std::string raw;
  char bcTag[3] = {0, 0, 0};
  char umiTag[3] = {0, 0, 0};
  int32_t trimLen = -1;  // -1: strip a trailing /1 or /2

  ~Scanner() {
    if (prefetchActive) prefetch.join();
    if (fp) fclose(fp);
    inflateEnd(&zs);
    delete pool;
  }
};

// Append more compressed bytes from the file; returns false if nothing
// could be added.
static bool AppendComp(Scanner& s) {
  if (s.fileEof) return false;
  size_t old = s.comp.size();
  s.comp.resize(old + (4 << 20));
  size_t got = fread(s.comp.data() + old, 1, 4 << 20, s.fp);
  s.comp.resize(old + got);
  if (got == 0) {
    s.fileEof = true;
    return false;
  }
  return true;
}

static uint16_t Le16(const uint8_t* p) {
  return (uint16_t)(p[0] | (p[1] << 8));
}
static uint32_t Le32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}

// Serial fallback: stream the comp buffer through the gzip-mode
// z_stream (handles non-BGZF gzip and odd members).
static bool RefillSerial(Scanner& s) {
  if (s.eof) return false;
  if (s.dataPos > (1 << 20)) {
    s.data.erase(s.data.begin(), s.data.begin() + s.dataPos);
    s.dataPos = 0;
  }
  uint8_t out[1 << 16];
  for (int round = 0; round < 64; ++round) {
    if (s.zs.avail_in == 0) {
      // compact + top up the compressed buffer (safe: no live next_in)
      if (s.compPos > (8 << 20)) {
        s.comp.erase(s.comp.begin(), s.comp.begin() + s.compPos);
        s.compPos = 0;
      }
      if (s.comp.size() == s.compPos && !AppendComp(s)) {
        s.eof = true;
        return s.data.size() > s.dataPos;
      }
      s.zs.next_in = s.comp.data() + s.compPos;
      s.zs.avail_in = (uInt)(s.comp.size() - s.compPos);
      s.compPos = s.comp.size();
    }
    s.zs.next_out = out;
    s.zs.avail_out = sizeof(out);
    int rc = inflate(&s.zs, Z_NO_FLUSH);
    size_t produced = sizeof(out) - s.zs.avail_out;
    s.data.insert(s.data.end(), out, out + produced);
    if (rc == Z_STREAM_END) {
      inflateReset(&s.zs);  // next gzip member
    } else if (rc != Z_OK && rc != Z_BUF_ERROR) {
      s.eof = true;
      return s.data.size() > s.dataPos;
    }
    if (s.data.size() - s.dataPos > (1 << 18)) return true;
  }
  return true;
}

static bool Refill(Scanner& s);

// Parallel path: collect a window of complete BGZF members, inflate
// them concurrently on the pool, append in order.
static bool RefillParallel(Scanner& s) {
  if (s.eof) return false;
  if (s.dataPos > (1 << 20)) {
    s.data.erase(s.data.begin(), s.data.begin() + s.dataPos);
    s.dataPos = 0;
  }
  if (s.compPos > (8 << 20)) {
    s.comp.erase(s.comp.begin(), s.comp.begin() + s.compPos);
    s.compPos = 0;
  }

  struct Member {
    size_t payloadOff, payloadLen, outLen;
  };
  std::vector<Member> members;
  size_t totalOut = 0;
  size_t p = s.compPos;
  bool parseFail = false;
  while (totalOut < (8u << 20)) {
    while (s.comp.size() - p < 18) {
      if (!AppendComp(s)) break;
    }
    if (s.comp.size() - p < 18) break;  // trailing partial / EOF
    const uint8_t* h = s.comp.data() + p;
    if (!(h[0] == 0x1f && h[1] == 0x8b && h[2] == 8 && (h[3] & 4))) {
      parseFail = true;
      break;
    }
    uint16_t xlen = Le16(h + 10);
    while (s.comp.size() - p < (size_t)12 + xlen) {
      if (!AppendComp(s)) break;
    }
    if (s.comp.size() - p < (size_t)12 + xlen) break;
    h = s.comp.data() + p;
    size_t bsize = 0;
    for (size_t q = 12; q + 4 <= (size_t)12 + xlen;) {
      uint16_t slen = Le16(h + q + 2);
      if (h[q] == 'B' && h[q + 1] == 'C' && slen == 2) {
        bsize = (size_t)Le16(h + q + 4) + 1;
        break;
      }
      q += 4 + slen;
    }
    if (bsize < (size_t)12 + xlen + 8) {
      parseFail = true;
      break;
    }
    while (s.comp.size() - p < bsize) {
      if (!AppendComp(s)) break;
    }
    if (s.comp.size() - p < bsize) break;
    uint32_t isize = Le32(s.comp.data() + p + bsize - 4);
    members.push_back({p + 12 + xlen, bsize - 12 - xlen - 8, isize});
    totalOut += isize;
    p += bsize;
  }

  if (members.empty()) {
    if (parseFail) {
      // odd member mid-stream: hand the remainder to the serial path
      delete s.pool;
      s.pool = nullptr;
      return RefillSerial(s);
    }
    s.eof = true;
    return s.data.size() > s.dataPos;
  }

  size_t base = s.data.size();
  s.data.resize(base + totalOut);
  std::vector<InflatePool::Task> tasks;
  tasks.reserve(members.size());
  uint8_t* dst = s.data.data() + base;
  for (const Member& m : members) {
    tasks.push_back({s.comp.data() + m.payloadOff, m.payloadLen,
                     dst, m.outLen});
    dst += m.outLen;
  }
  if (!s.pool->Execute(std::move(tasks))) {
    // corrupt/truncated member OR failed decompressor init: drop this
    // batch's (partially zeroed) output and stop, like the serial path
    // does on an inflate error.  Stop-at-corruption (rather than
    // raising) is the documented survival deviation the BAM fuzz pins;
    // an environmental init failure lands here too and yields an empty
    // scan instead of garbage records.
    s.data.resize(base);
    s.eof = true;
    return s.data.size() > s.dataPos;
  }
  s.compPos = p;
  return true;
}

// Pull more decompressed bytes; returns false at end of stream.
static bool Refill(Scanner& s) {
  return s.pool ? RefillParallel(s) : RefillSerial(s);
}

static void JoinPrefetch(Scanner& s) {
  if (s.prefetchActive) {
    s.prefetch.join();
    s.prefetchActive = false;
  }
}

static void StartPrefetch(Scanner& s) {
  if (s.eof || !s.pool || s.prefetchActive) return;
  s.prefetchActive = true;
  s.prefetch = std::thread([&s] {
    while (!s.eof && s.data.size() - s.dataPos < (64u << 20)) {
      if (!Refill(s)) break;
    }
  });
}

static bool Need(Scanner& s, size_t n) {
  while (s.data.size() - s.dataPos < n) {
    if (!Refill(s)) return false;
  }
  return true;
}

static int32_t RdI32(Scanner& s) {
  int32_t v;
  std::memcpy(&v, s.data.data() + s.dataPos, 4);
  s.dataPos += 4;
  return v;
}

static const char kNibble[17] = "=ACMGRSVTWYHKDBN";

// Decode the variable-length parts of one raw record (name, sequence
// text, qual text, requested Z tags) into the staging blobs.
static void DecodeRecord(Scanner& s, const uint8_t* d, size_t blockSize) {
  uint32_t binMqNl, flagNC;
  int32_t lSeq;
  std::memcpy(&binMqNl, d + 8, 4);
  std::memcpy(&flagNC, d + 12, 4);
  std::memcpy(&lSeq, d + 16, 4);
  int lReadName = binMqNl & 0xFF;
  int nCigar = flagNC & 0xFFFF;

  size_t off = 32;
  s.names.append((const char*)d + off, lReadName - 1);
  off += lReadName + 4 * (size_t)nCigar;

  size_t seqBase = s.seqs.size();
  s.seqs.resize(seqBase + lSeq);
  const uint8_t* packed = d + off;
  for (int i = 0; i < lSeq; ++i) {
    uint8_t b = packed[i >> 1];
    s.seqs[seqBase + i] = kNibble[(i & 1) ? (b & 0xF) : (b >> 4)];
  }
  off += (lSeq + 1) / 2;

  // The reference's GetQual (alignments.hpp:565-580) adds 33 without a
  // missing-qual check, so absent quals (0xFF bytes) become spaces via
  // char truncation; candidate output is then always FASTQ.
  size_t qualBase = s.quals.size();
  s.quals.resize(qualBase + lSeq);
  for (int i = 0; i < lSeq; ++i)
    s.quals[qualBase + i] = (char)(d[off + i] + 33);
  off += lSeq;

  // aux tags: harvest the requested Z tags, skip the rest
  while (off + 3 <= blockSize) {
    char t0 = d[off], t1 = d[off + 1], typ = d[off + 2];
    off += 3;
    if (typ == 'Z' || typ == 'H') {
      size_t end = off;
      while (end < blockSize && d[end] != 0) ++end;
      if (t0 == s.bcTag[0] && t1 == s.bcTag[1])
        s.bcs.append((const char*)d + off, end - off);
      else if (t0 == s.umiTag[0] && t1 == s.umiTag[1])
        s.umis.append((const char*)d + off, end - off);
      off = end + 1;
    } else if (typ == 'A' || typ == 'c' || typ == 'C') {
      off += 1;
    } else if (typ == 's' || typ == 'S') {
      off += 2;
    } else if (typ == 'i' || typ == 'I' || typ == 'f') {
      off += 4;
    } else if (typ == 'B') {
      uint8_t sub = d[off];
      int32_t cnt;
      std::memcpy(&cnt, d + off + 1, 4);
      int sz = (sub == 'c' || sub == 'C') ? 1
               : (sub == 's' || sub == 'S') ? 2
                                            : 4;
      off += 5 + (size_t)cnt * sz;
    } else {
      break;
    }
  }

  s.nameOff.push_back((int64_t)s.names.size());
  s.seqOff.push_back((int64_t)s.seqs.size());
  s.qualOff.push_back((int64_t)s.quals.size());
  s.bcOff.push_back((int64_t)s.bcs.size());
  s.umiOff.push_back((int64_t)s.umis.size());
}

static void ClearTextStaging(Scanner& s) {
  s.nameOff.assign(1, 0);
  s.seqOff.assign(1, 0);
  s.qualOff.assign(1, 0);
  s.bcOff.assign(1, 0);
  s.umiOff.assign(1, 0);
  s.names.clear();
  s.seqs.clear();
  s.quals.clear();
  s.bcs.clear();
  s.umis.clear();
}

}  // namespace t1kbam

extern "C" {

void* t1k_bam_open2(const char* path, const char* bc_tag,
                    const char* umi_tag, int32_t trim_len) {
  auto* s = new t1kbam::Scanner();
  s->fp = fopen(path, "rb");
  if (!s->fp) {
    delete s;
    return nullptr;
  }
  inflateInit2(&s->zs, 15 + 16);
  s->trimLen = trim_len;

  // BGZF probe: gzip magic + FEXTRA with a BC subfield => members are
  // independently deflated and the parallel inflate path applies.
  {
    uint8_t head[18];
    size_t got = fread(head, 1, sizeof(head), s->fp);
    // keep the probe bytes by staging them into the compressed rolling
    // buffer: seeking back fails silently on pipes/FIFOs
    s->comp.insert(s->comp.end(), head, head + got);
    bool bgzf = false;
    if (got == sizeof(head) && head[0] == 0x1f && head[1] == 0x8b &&
        head[2] == 8 && (head[3] & 4)) {
      uint16_t xlen = t1kbam::Le16(head + 10);
      if (xlen >= 6 && head[12] == 'B' && head[13] == 'C' &&
          t1kbam::Le16(head + 14) == 2)
        bgzf = true;
    }
    if (bgzf) {
      unsigned hw = std::thread::hardware_concurrency();
      int extra = hw > 1 ? (int)(hw > 8 ? 7 : hw - 1) : 0;
      s->pool = new t1kbam::InflatePool(extra);
    }
  }
  if (bc_tag && bc_tag[0]) std::memcpy(s->bcTag, bc_tag, 2);
  if (umi_tag && umi_tag[0]) std::memcpy(s->umiTag, umi_tag, 2);

  if (!t1kbam::Need(*s, 12)) {
    delete s;
    return nullptr;
  }
  if (std::memcmp(s->data.data() + s->dataPos, "BAM\x01", 4) != 0) {
    delete s;
    return nullptr;
  }
  s->dataPos += 4;
  int32_t lText = t1kbam::RdI32(*s);
  if (!t1kbam::Need(*s, (size_t)lText + 4)) {
    delete s;
    return nullptr;
  }
  s->headerText.assign((const char*)s->data.data() + s->dataPos, lText);
  s->dataPos += lText;
  int32_t nRef = t1kbam::RdI32(*s);
  for (int i = 0; i < nRef; ++i) {
    if (!t1kbam::Need(*s, 4)) break;
    int32_t lName = t1kbam::RdI32(*s);
    if (!t1kbam::Need(*s, (size_t)lName + 4)) break;
    s->refNames.emplace_back((const char*)s->data.data() + s->dataPos,
                             lName - 1);
    s->dataPos += lName;
    s->refLens.push_back(t1kbam::RdI32(*s));
  }
  return s;
}

void t1k_bam_close(void* h) { delete static_cast<t1kbam::Scanner*>(h); }

int32_t t1k_bam_n_refs(void* h) {
  return (int32_t)static_cast<t1kbam::Scanner*>(h)->refNames.size();
}

const char* t1k_bam_ref_name(void* h, int32_t i) {
  return static_cast<t1kbam::Scanner*>(h)->refNames[i].c_str();
}

int32_t t1k_bam_ref_len(void* h, int32_t i) {
  return static_cast<t1kbam::Scanner*>(h)->refLens[i];
}

const char* t1k_bam_header_text(void* h) {
  return static_cast<t1kbam::Scanner*>(h)->headerText.c_str();
}

// Scan up to max_records records into the staging batch.  Returns the
// record count (0 at end of file).  Header fields per record:
// [flag, tid, pos, mapq, mtid, mpos, tlen, l_seq, ref_span].
// mode 0: eager — text blobs (name/seq/qual/tags) decoded for every
//         record.
// mode 1: lazy — fields + name hashes + raw record bytes; text decoded
//         later for selected indices via t1k_bam_fetch.
// mode 2: headers-only — fields only (sampling pass; no hashes/raw).
int64_t t1k_bam_scan2(void* h, int64_t max_records, int32_t mode) {
  auto& s = *static_cast<t1kbam::Scanner*>(h);
  t1kbam::JoinPrefetch(s);
  s.fields.clear();
  s.nameHash.clear();
  s.rawOff.assign(1, 0);
  s.raw.clear();
  t1kbam::ClearTextStaging(s);

  int64_t n = 0;
  while (n < max_records) {
    if (!t1kbam::Need(s, 4)) break;
    int32_t blockSize;
    std::memcpy(&blockSize, s.data.data() + s.dataPos, 4);
    if (!t1kbam::Need(s, (size_t)blockSize + 4)) break;
    s.dataPos += 4;
    const uint8_t* d = s.data.data() + s.dataPos;
    s.dataPos += blockSize;

    int32_t tid, pos, mtid, mpos, tlen, lSeq;
    uint32_t flagNC;
    std::memcpy(&tid, d, 4);
    std::memcpy(&pos, d + 4, 4);
    uint32_t binMqNl;
    std::memcpy(&binMqNl, d + 8, 4);
    std::memcpy(&flagNC, d + 12, 4);
    std::memcpy(&lSeq, d + 16, 4);
    std::memcpy(&mtid, d + 20, 4);
    std::memcpy(&mpos, d + 24, 4);
    std::memcpy(&tlen, d + 28, 4);
    int lReadName = binMqNl & 0xFF;
    int mapq = (binMqNl >> 8) & 0xFF;
    int nCigar = flagNC & 0xFFFF;
    int flag = flagNC >> 16;

    size_t off = 32;
    const char* name = (const char*)d + off;
    int nameLen = lReadName - 1;
    if (mode != 2) {
      // hash over the mate-trimmed name so both mates share the key
      int hashLen = nameLen;
      if (s.trimLen == -1) {
        if (nameLen >= 2 && name[nameLen - 2] == '/' &&
            (name[nameLen - 1] == '1' || name[nameLen - 1] == '2'))
          hashLen = nameLen - 2;
      } else if (s.trimLen > 0 && s.trimLen <= nameLen) {
        hashLen = nameLen - s.trimLen;
      }
      uint64_t hsh = 1469598103934665603ull;
      for (int i = 0; i < hashLen; ++i)
        hsh = (hsh ^ (uint8_t)name[i]) * 1099511628211ull;
      s.nameHash.push_back(hsh);
    }
    off += lReadName;

    int32_t refSpan = 0;
    for (int i = 0; i < nCigar; ++i) {
      uint32_t v;
      std::memcpy(&v, d + off + 4 * i, 4);
      int op = v & 0xF;
      // M I D N S H P = X -> consumes reference: M D N = X
      if (op == 0 || op == 2 || op == 3 || op == 7 || op == 8)
        refSpan += v >> 4;
    }

    const int32_t row[9] = {flag, tid, pos, mapq, mtid,
                            mpos, tlen, lSeq, refSpan};
    s.fields.insert(s.fields.end(), row, row + 9);
    if (mode == 0) {
      t1kbam::DecodeRecord(s, d, (size_t)blockSize);
    } else if (mode == 1) {
      s.raw.append((const char*)d, blockSize);
      s.rawOff.push_back((int64_t)s.raw.size());
    }
    ++n;
  }
  t1kbam::StartPrefetch(s);
  return n;
}

int64_t t1k_bam_scan(void* h, int64_t max_records) {
  return t1k_bam_scan2(h, max_records, 0);
}

// Decode text blobs for a subset of the last lazy (mode 1) batch.  The
// offset/blob accessors then describe the k selected records in order.
void t1k_bam_fetch(void* h, const int64_t* idxs, int64_t k) {
  auto& s = *static_cast<t1kbam::Scanner*>(h);
  t1kbam::ClearTextStaging(s);
  for (int64_t j = 0; j < k; ++j) {
    int64_t i = idxs[j];
    const uint8_t* d = (const uint8_t*)s.raw.data() + s.rawOff[i];
    t1kbam::DecodeRecord(s, d, (size_t)(s.rawOff[i + 1] - s.rawOff[i]));
  }
}

// Batch accessors (valid until the next t1k_bam_scan call).
const int32_t* t1k_bam_fields(void* h) {
  return static_cast<t1kbam::Scanner*>(h)->fields.data();
}
const uint64_t* t1k_bam_name_hashes(void* h) {
  return static_cast<t1kbam::Scanner*>(h)->nameHash.data();
}
const int64_t* t1k_bam_offsets(void* h, int32_t which) {
  auto& s = *static_cast<t1kbam::Scanner*>(h);
  switch (which) {
    case 0: return s.nameOff.data();
    case 1: return s.seqOff.data();
    case 2: return s.qualOff.data();
    case 3: return s.bcOff.data();
    default: return s.umiOff.data();
  }
}
const char* t1k_bam_blob(void* h, int32_t which, int64_t* len) {
  auto& s = *static_cast<t1kbam::Scanner*>(h);
  const std::string* b;
  switch (which) {
    case 0: b = &s.names; break;
    case 1: b = &s.seqs; break;
    case 2: b = &s.quals; break;
    case 3: b = &s.bcs; break;
    default: b = &s.umis; break;
  }
  *len = (int64_t)b->size();
  return b->data();
}

}  // extern "C"
