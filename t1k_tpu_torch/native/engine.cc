// t1k_tpu native host engine.
//
// Implements the read-to-allele assignment hot path on the host CPU:
//   k-mer probing -> per-(strand,allele) diagonal clustering -> LIS chaining
//   -> banded affine-gap DP gap fill -> overhang extension -> full-span
//   alignment with exon-relaxed recount and coverage accumulation.
//
// This is a from-scratch implementation of the behavioral contracts
// documented in SURVEY.md sections 2-3 (reference: mourisl/T1K; file:line
// citations in comments refer to that codebase).  The companion TPU path
// (t1k_tpu/ops) executes the same DP contract as a batched Pallas kernel;
// this engine is the CPU fallback and the bit-exactness oracle.
//
// All sequence data uses the framework's integer encoding:
//   A=0 C=1 G=2 T=3, N/other=4.
//
// Build: see Makefile (produces libt1k_native.so, loaded via ctypes).

#include <array>
#include <cassert>
#include <chrono>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <algorithm>
#include <memory>
#include <mutex>
#include <thread>
#include <string>
#include <unordered_map>
#include <vector>

namespace t1k {

// ----------------------------------------------------------------- scoring
// Alignment score set (reference AlignAlgo.hpp:12-16).
constexpr int kMatch = 2;
constexpr int kMismatch = -2;
constexpr int kGapOpen = -4;
constexpr int kGapExtend = -1;

constexpr int8_t kEditMatch = 0;
constexpr int8_t kEditMismatch = 1;
constexpr int8_t kEditInsert = 2;  // consumes read (pattern) only
constexpr int8_t kEditDelete = 3;  // consumes reference (text) only
constexpr int8_t kEditEnd = -1;

inline bool BaseEq(int8_t t, int8_t p) {
  // N matches everything (reference AlignAlgo.hpp:304).
  return t == p || t == 4 || p == 4;
}

// Banded global alignment with affine gaps.
//
// Semantics contract (reference AlignAlgo.hpp:215-421): band of `band`
// widened on one side by the length difference; sentinel cells just outside
// the band; the specific boundary initialization (including the quirk that
// the insert-matrix top row uses lenp+1 gap opens); traceback preference
// diagonal > delete > insert with the exact matrix-switch rules.
// Returns the score; appends the edit walk (left-to-right) to `edits`
// terminated implicitly by its size.
struct AlignScratch {
  std::vector<int> m, e, f;
  std::vector<int8_t> rev;
};

static int BandedGlobalAlign(const int8_t* t, int lent, const int8_t* p,
                             int lenp, int band, std::vector<int8_t>* edits,
                             AlignScratch* scr) {
  edits->clear();
  if (lent == 0 || lenp == 0) return 0;
  if (lent == 1 && lenp == 1) {
    bool eq = BaseEq(t[0], p[0]);
    edits->push_back(eq ? kEditMatch : kEditMismatch);
    return eq ? kMatch : kMismatch;
  }
  if (lent == lenp) {
    // Same exact all-match diagonal shortcut as the stats kernel: the
    // unique optimum is the pure diagonal, so the edit walk is lenp
    // matches and the score 2*lenp.
    int i = 0;
    while (i < lent && BaseEq(t[i], p[i])) ++i;
    if (i == lent) {
      edits->assign(lent, kEditMatch);
      return lent * kMatch;
    }
  }

  int leftBand = band, rightBand = band;
  if (lent > lenp) rightBand += lent - lenp;
  else if (lent < lenp) leftBand += lenp - lent;

  const int W = lent + 1;
  const long total = (long)(lenp + 1) * W;
  const int negInf = (lent + 1) * (lenp + 1) * kGapOpen;
  std::vector<int>& m = scr->m;
  std::vector<int>& e = scr->e;
  std::vector<int>& f = scr->f;
  if ((long)m.size() < total) {
    m.resize(total);
    e.resize(total);
    f.resize(total);
  }

  m[0] = e[0] = f[0] = 0;
  // Boundary init is trimmed to the band reach: the fill reads column 0
  // only on rows with start == 1 (i <= leftBand + 1) and row 0 only at
  // columns <= rightBand + 1, and a traceback path can enter column 0 /
  // row 0 only from an in-band neighbor (i <= leftBand + 1 resp.
  // j <= rightBand + 1) before walking toward the origin — cells
  // beyond that are never read, so their init is skipped.
  const int initRows = lenp < leftBand + 1 ? lenp : leftBand + 1;
  const int initCols = lent < rightBand + 1 ? lent : rightBand + 1;
  for (int i = 1; i <= initRows; ++i) {
    e[(long)i * W] = kGapOpen + i * kGapExtend;
    f[(long)i * W] = kGapOpen + i * kGapOpen;
    m[(long)i * W] = kGapOpen + i * kGapOpen;
  }
  for (int j = 1; j <= initCols; ++j) {
    f[j] = kGapOpen + j * kGapExtend;
    // Quirk preserved from the reference (AlignAlgo.hpp:268): the loop
    // counter value lenp+1 leaks into the insert-row initialization.
    e[j] = kGapOpen + (lenp + 1) * kGapOpen;
    m[j] = kGapOpen + j * kGapOpen;
  }

  int* __restrict__ eb = e.data();
  int* __restrict__ fb = f.data();
  int* __restrict__ mb = m.data();
  const int goge = kGapOpen + kGapExtend;
  for (int i = 1; i <= lenp; ++i) {
    int start = i - leftBand < 1 ? 1 : i - leftBand;
    int end = i + rightBand > lent ? lent : i + rightBand;
    long row = (long)i * W;
    long prow = row - W;
    if (start > 1) eb[row + start - 1] = fb[row + start - 1] = mb[row + start - 1] = negInf;
    if (end < lent) eb[row + end + 1] = fb[row + end + 1] = mb[row + end + 1] = negInf;
    // Register-carried neighbors: fJm1/mJm1 are this row's previous
    // cell (computed last iteration), mUpJm1 is the up-row value loaded
    // last iteration -- identical arithmetic, fewer memory reads.
    int fJm1 = fb[row + start - 1];
    int mJm1 = mb[row + start - 1];
    int mUpJm1 = mb[prow + start - 1];
    const int8_t pc = p[i - 1];
    for (int j = start; j <= end; ++j) {
      int eUp = eb[prow + j];
      int mUp = mb[prow + j];
      int ev = eUp + kGapExtend;
      int t2 = mUp + goge;
      if (t2 > ev) ev = t2;
      eb[row + j] = ev;
      int fv = fJm1 + kGapExtend;
      t2 = mJm1 + goge;
      if (t2 > fv) fv = t2;
      fb[row + j] = fv;
      int mv = mUpJm1 + (BaseEq(t[j - 1], pc) ? kMatch : kMismatch);
      if (ev > mv) mv = ev;
      if (fv > mv) mv = fv;
      mb[row + j] = mv;
      fJm1 = fv;
      mJm1 = mv;
      mUpJm1 = mUp;
    }
  }

  int score = m[(long)lenp * W + lent];

  // Traceback; ops collected right-to-left then reversed.
  std::vector<int8_t>& rev = scr->rev;
  rev.clear();
  int ti = lenp, tj = lent;
  int state = 0;  // 0 = main, 1 = insert run, 2 = delete run
  while (ti > 0 || tj > 0) {
    long cell = (long)ti * W + tj;
    if (state == 0) {
      int a = kEditInsert;
      if (f[cell] >= e[cell]) a = kEditDelete;
      if (ti > 0 && tj > 0) {
        bool eq = BaseEq(t[tj - 1], p[ti - 1]);
        if (m[cell - W - 1] + (eq ? kMatch : kMismatch) == m[cell])
          a = eq ? kEditMatch : kEditMismatch;
      }
      if (a == kEditMatch || a == kEditMismatch) {
        rev.push_back(a);
        --ti;
        --tj;
      } else if (a == kEditInsert) {
        state = 1;
      } else {
        state = 2;
      }
    } else if (state == 1) {
      rev.push_back(kEditInsert);
      if (ti > 0) {
        if (m[cell - W] + kGapOpen + kGapExtend == e[cell]) state = 0;
        --ti;
      } else {
        state = 2;
      }
    } else {
      rev.push_back(kEditDelete);
      if (tj > 0) {
        if (m[cell - 1] + kGapOpen + kGapExtend == f[cell]) state = 0;
        --tj;
      } else {
        state = 1;
      }
    }
  }
  edits->assign(rev.rbegin(), rev.rend());
  return score;
}

struct EditStats {
  int match = 0, mismatch = 0, indel = 0;
};

// Small-window stats DP: same arithmetic/quirks as the generic version
// below but with a compile-time stride and stack state, which lets the
// compiler fold all addressing — the overhang/gap windows this serves
// are mostly <= 16bp, where fixed overhead dominates the fill.
static EditStats BandedGlobalAlignStatsSmall(const int8_t* t, int lent,
                                             const int8_t* p, int lenp,
                                             int band) {
  EditStats st;
  constexpr long W = 32;
  // The 32x32 stack arrays admit lengths <= 31 only; callers dispatch on
  // that condition, and this guard keeps a future direct caller from
  // silently corrupting the stack.
  assert(lent <= 31 && lenp <= 31);
  int leftBand = band, rightBand = band;
  if (lent > lenp) rightBand += lent - lenp;
  else if (lent < lenp) leftBand += lenp - lent;
  const int negInf = (lent + 1) * (lenp + 1) * kGapOpen;
  int m[32 * 32], e[32 * 32], f[32 * 32];
  m[0] = e[0] = f[0] = 0;
  const int initRows = lenp < leftBand + 1 ? lenp : leftBand + 1;
  const int initCols = lent < rightBand + 1 ? lent : rightBand + 1;
  for (int i = 1; i <= initRows; ++i) {
    e[i * W] = kGapOpen + i * kGapExtend;
    f[i * W] = kGapOpen + i * kGapOpen;
    m[i * W] = kGapOpen + i * kGapOpen;
  }
  for (int j = 1; j <= initCols; ++j) {
    f[j] = kGapOpen + j * kGapExtend;
    e[j] = kGapOpen + (lenp + 1) * kGapOpen;
    m[j] = kGapOpen + j * kGapOpen;
  }
  const int goge = kGapOpen + kGapExtend;
  for (int i = 1; i <= lenp; ++i) {
    int start = i - leftBand < 1 ? 1 : i - leftBand;
    int end = i + rightBand > lent ? lent : i + rightBand;
    long row = i * W;
    long prow = row - W;
    if (start > 1) e[row + start - 1] = f[row + start - 1] = m[row + start - 1] = negInf;
    if (end < lent) e[row + end + 1] = f[row + end + 1] = m[row + end + 1] = negInf;
    int fJm1 = f[row + start - 1];
    int mJm1 = m[row + start - 1];
    int mUpJm1 = m[prow + start - 1];
    const int8_t pc = p[i - 1];
    for (int j = start; j <= end; ++j) {
      int eUp = e[prow + j];
      int mUp = m[prow + j];
      int ev = eUp + kGapExtend;
      int t2 = mUp + goge;
      if (t2 > ev) ev = t2;
      e[row + j] = ev;
      int fv = fJm1 + kGapExtend;
      t2 = mJm1 + goge;
      if (t2 > fv) fv = t2;
      f[row + j] = fv;
      int mv = mUpJm1 + (BaseEq(t[j - 1], pc) ? kMatch : kMismatch);
      if (ev > mv) mv = ev;
      if (fv > mv) mv = fv;
      m[row + j] = mv;
      fJm1 = fv;
      mJm1 = mv;
      mUpJm1 = mUp;
    }
  }
  int ti = lenp, tj = lent;
  int state = 0;
  while (ti > 0 || tj > 0) {
    long cell = ti * W + tj;
    if (state == 0) {
      int a = kEditInsert;
      if (f[cell] >= e[cell]) a = kEditDelete;
      bool eq = false;
      if (ti > 0 && tj > 0) {
        eq = BaseEq(t[tj - 1], p[ti - 1]);
        if (m[cell - W - 1] + (eq ? kMatch : kMismatch) == m[cell])
          a = eq ? kEditMatch : kEditMismatch;
      }
      if (a == kEditMatch) { ++st.match; --ti; --tj; }
      else if (a == kEditMismatch) { ++st.mismatch; --ti; --tj; }
      else if (a == kEditInsert) state = 1;
      else state = 2;
    } else if (state == 1) {
      ++st.indel;
      if (ti > 0) {
        if (m[cell - W] + kGapOpen + kGapExtend == e[cell]) state = 0;
        --ti;
      } else state = 2;
    } else {
      ++st.indel;
      if (tj > 0) {
        if (m[cell - 1] + kGapOpen + kGapExtend == f[cell]) state = 0;
        --tj;
      } else state = 1;
    }
  }
  return st;
}

// Traceback counting only — identical walk to BandedGlobalAlign but
// without materializing the edit string (used for gap fill / extension
// where only the counts feed the score bookkeeping).
static EditStats BandedGlobalAlignStats(const int8_t* t, int lent,
                                        const int8_t* p, int lenp, int band,
                                        AlignScratch* scr) {
  EditStats st;
  if (lent == 0 || lenp == 0) return st;
  if (lent == 1 && lenp == 1) {
    if (BaseEq(t[0], p[0])) ++st.match; else ++st.mismatch;
    return st;
  }
  if (lent == lenp) {
    // Exact shortcut: when the equal-length windows match base-for-base,
    // the all-match diagonal scores 2*lenp, which no path containing a
    // mismatch or an indel pair can reach, and the unique optimum makes
    // the traceback follow the diagonal cell-by-cell — the DP would
    // count exactly lenp matches.
    int i = 0;
    while (i < lent && BaseEq(t[i], p[i])) ++i;
    if (i == lent) {
      st.match = lent;
      return st;
    }
  }
  if (lent <= 31 && lenp <= 31 && band == 5)
    return BandedGlobalAlignStatsSmall(t, lent, p, lenp, band);
  // fill phase shared with the full version
  static thread_local std::vector<int8_t> tmp;
  // (reuse the full routine's fill by calling it with a scratch edit
  // buffer would reverse-copy; do the walk inline instead)
  int leftBand = band, rightBand = band;
  if (lent > lenp) rightBand += lent - lenp;
  else if (lent < lenp) leftBand += lenp - lent;
  const int W = lent + 1;
  const long total = (long)(lenp + 1) * W;
  const int negInf = (lent + 1) * (lenp + 1) * kGapOpen;
  std::vector<int>& m = scr->m;
  std::vector<int>& e = scr->e;
  std::vector<int>& f = scr->f;
  if ((long)m.size() < total) { m.resize(total); e.resize(total); f.resize(total); }
  m[0] = e[0] = f[0] = 0;
  // Same trimmed boundary init as BandedGlobalAlign (see proof there).
  const int initRows = lenp < leftBand + 1 ? lenp : leftBand + 1;
  const int initCols = lent < rightBand + 1 ? lent : rightBand + 1;
  for (int i = 1; i <= initRows; ++i) {
    e[(long)i * W] = kGapOpen + i * kGapExtend;
    f[(long)i * W] = kGapOpen + i * kGapOpen;
    m[(long)i * W] = kGapOpen + i * kGapOpen;
  }
  for (int j = 1; j <= initCols; ++j) {
    f[j] = kGapOpen + j * kGapExtend;
    e[j] = kGapOpen + (lenp + 1) * kGapOpen;
    m[j] = kGapOpen + j * kGapOpen;
  }
  int* __restrict__ eb = e.data();
  int* __restrict__ fb = f.data();
  int* __restrict__ mb = m.data();
  const int goge = kGapOpen + kGapExtend;
  for (int i = 1; i <= lenp; ++i) {
    int start = i - leftBand < 1 ? 1 : i - leftBand;
    int end = i + rightBand > lent ? lent : i + rightBand;
    long row = (long)i * W;
    long prow = row - W;
    if (start > 1) eb[row + start - 1] = fb[row + start - 1] = mb[row + start - 1] = negInf;
    if (end < lent) eb[row + end + 1] = fb[row + end + 1] = mb[row + end + 1] = negInf;
    // Register-carried neighbors: fJm1/mJm1 are this row's previous
    // cell (computed last iteration), mUpJm1 is the up-row value loaded
    // last iteration -- identical arithmetic, fewer memory reads.
    int fJm1 = fb[row + start - 1];
    int mJm1 = mb[row + start - 1];
    int mUpJm1 = mb[prow + start - 1];
    const int8_t pc = p[i - 1];
    for (int j = start; j <= end; ++j) {
      int eUp = eb[prow + j];
      int mUp = mb[prow + j];
      int ev = eUp + kGapExtend;
      int t2 = mUp + goge;
      if (t2 > ev) ev = t2;
      eb[row + j] = ev;
      int fv = fJm1 + kGapExtend;
      t2 = mJm1 + goge;
      if (t2 > fv) fv = t2;
      fb[row + j] = fv;
      int mv = mUpJm1 + (BaseEq(t[j - 1], pc) ? kMatch : kMismatch);
      if (ev > mv) mv = ev;
      if (fv > mv) mv = fv;
      mb[row + j] = mv;
      fJm1 = fv;
      mJm1 = mv;
      mUpJm1 = mUp;
    }
  }
  int ti = lenp, tj = lent;
  int state = 0;
  while (ti > 0 || tj > 0) {
    long cell = (long)ti * W + tj;
    if (state == 0) {
      int a = kEditInsert;
      if (f[cell] >= e[cell]) a = kEditDelete;
      bool eq = false;
      if (ti > 0 && tj > 0) {
        eq = BaseEq(t[tj - 1], p[ti - 1]);
        if (m[cell - W - 1] + (eq ? kMatch : kMismatch) == m[cell])
          a = eq ? kEditMatch : kEditMismatch;
      }
      if (a == kEditMatch) { ++st.match; --ti; --tj; }
      else if (a == kEditMismatch) { ++st.mismatch; --ti; --tj; }
      else if (a == kEditInsert) state = 1;
      else state = 2;
    } else if (state == 1) {
      ++st.indel;
      if (ti > 0) {
        if (m[cell - W] + kGapOpen + kGapExtend == e[cell]) state = 0;
        --ti;
      } else state = 2;
    } else {
      ++st.indel;
      if (tj > 0) {
        if (m[cell - 1] + kGapOpen + kGapExtend == f[cell]) state = 0;
        --tj;
      } else state = 1;
    }
  }
  return st;
}


// -------------------------------------------------------------- k-mer index
struct Posting {
  int32_t seq;
  int32_t off;
};

// Rolling 2-bit k-mer code over the integer base encoding.  To preserve the
// reference's probe-dedup semantics, invalid bases contribute bit pattern 3
// to the code (matching its nucToNum['N'] & 3) while a validity window is
// tracked separately (reference KmerCode.hpp:93-108).
struct RollingCode {
  uint64_t code = 0;
  uint64_t mask;
  int k;
  int invalid = -1;  // countdown position of the most recent invalid base

  explicit RollingCode(int kl) : k(kl) {
    mask = (kl >= 32) ? ~0ull : ((1ull << (2 * kl)) - 1);
  }
  inline void push(int8_t c) {
    if (invalid != -1) ++invalid;
    code = ((code << 2) & mask) | (uint64_t)(c == 4 ? 3 : c);
    if (c == 4) invalid = 0;
    if (invalid >= k) invalid = -1;
  }
  inline bool valid() const { return invalid == -1; }
  inline void reset() {
    code = 0;
    invalid = -1;
  }
};

class KmerIndex {
 public:
  explicit KmerIndex(int k) : k_(k) {}

  // Index all k-mers of one sequence.  Consecutive duplicate codes are
  // inserted only once, with the reference's two boundary quirks: the very
  // first window is skipped when its code equals the empty rolling state
  // (0), and the window at offset 1 is always inserted
  // (KmerIndex.hpp:107-130).
  void AddSequence(const int8_t* s, int len, int32_t id) {
    if (len < k_) return;
    RollingCode rc(k_);
    uint64_t prev = 0;
    for (int i = 0; i < k_ - 1; ++i) rc.push(s[i]);
    for (int i = k_ - 1; i < len; ++i) {
      rc.push(s[i]);
      if (rc.valid() && (i == k_ || rc.code != prev))
        table_[rc.code].push_back({id, i - k_ + 1});
      prev = rc.code;
    }
  }

  const std::vector<Posting>* Find(uint64_t code) const {
    auto it = table_.find(code);
    return it == table_.end() ? nullptr : &it->second;
  }

  int k() const { return k_; }

 private:
  int k_;
  std::unordered_map<uint64_t, std::vector<Posting>> table_;
};

// ------------------------------------------------------------------- engine
struct Overlap {
  int32_t seq = -1;
  int32_t readStart = 0, readEnd = 0;
  int32_t seqStart = 0, seqEnd = 0;
  int32_t strand = 0;
  int32_t matchCnt = 0;
  int32_t relaxedMatchCnt = 0;
  double similarity = 0;
  int32_t leftClip = 0, rightClip = 0;
};

// Ranking order for overlaps (reference SeqSet.hpp:103-127): more matched
// bases first, then higher similarity, longer read span, smaller ids/coords.
static bool OverlapRankLess(const Overlap& a, const Overlap& b) {
  if (a.matchCnt != b.matchCnt) return a.matchCnt > b.matchCnt;
  if (a.similarity != b.similarity) return a.similarity > b.similarity;
  int la = a.readEnd - a.readStart, lb = b.readEnd - b.readStart;
  if (la != lb) return la > lb;
  if (a.seq != b.seq) return a.seq < b.seq;
  if (a.strand != b.strand) return a.strand < b.strand;
  if (a.readStart != b.readStart) return a.readStart < b.readStart;
  if (a.readEnd != b.readEnd) return a.readEnd < b.readEnd;
  if (a.seqStart != b.seqStart) return a.seqStart < b.seqStart;
  return a.seqEnd < b.seqEnd;
}

struct Hit {
  int32_t strand;  // -1 or 1
  int32_t seq;
  int32_t roff;  // offset in read (rc-read offsets for strand -1)
  int32_t soff;  // offset in reference sequence
};

struct Seed {
  int32_t a;  // read offset
  int32_t b;  // seq offset
};

inline void AtomicAdd(int32_t* p, int32_t v) {
  __atomic_fetch_add(p, v, __ATOMIC_RELAXED);
}

// Trace counters of the read-assignment passes (t1k_engine_set_trace,
// t1k_engine_trace_fetch): counts, and thread-nanoseconds of each phase.
// Kept only while the engine's trace is on; each worker fills a block of
// its own and the blocks are summed into the engine's when the workers
// join, so the hot loops take no atomics.  The fetch order is the order
// of TraceField.
enum TraceField {
  kTrReads,       // reads handed to the engine
  kTrHits,        // CollectHitsSorted's hits
  kTrOverlaps,    // overlaps that survive chaining and scoring
  kTrGapItems,    // deferred gap-fill items emitted (fresh windows)
  kTrSpecItems,   // deferred speculative extension items emitted
  kTrSpecUsed,    // distinct speculative items the finish replay reads
  kTrHitNs,       // hit collection
  kTrChainNs,     // clustering and chaining
  kTrScoreNs,     // gap fill (inline DP, or item emission when deferred)
  kTrSpecNs,      // speculative extension item emission
  kTrReplayNs,    // finish: count fold, similarity, sort, extension replay
  kTrFullspanNs,  // near-best full-span walks and coverage scatter
  kTrExtendNs,    // inline path: sort and extension with the overhang DP
  kTrFields
};

// The fields' names, in TraceField order (t1k_engine_trace_name): a count
// ends in _count, a phase's thread-nanoseconds in _ns.
constexpr const char* kTraceNames[] = {
    "engine_read_count", "hit_count", "overlap_count", "gap_item_count",
    "spec_item_count", "spec_item_used_count", "hit_ns", "chain_ns",
    "score_ns", "spec_ns", "replay_ns", "fullspan_ns", "extend_ns"};
static_assert(sizeof(kTraceNames) / sizeof(kTraceNames[0]) == kTrFields,
              "one name a TraceField");

// aligned so that no two workers' blocks share a cache line
struct alignas(64) TraceBlock {
  int64_t v[kTrFields] = {};
  void Add(const TraceBlock& o) {
    for (int f = 0; f < kTrFields; ++f) v[f] += o.v[f];
  }
};

inline int64_t TraceNowNs() {
  return std::chrono::duration_cast<std::chrono::nanoseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

// Adds the scope's nanoseconds to one field of `tb`; a null block (trace
// off) reads no clock.
struct PhaseTimer {
  int64_t* acc;
  int64_t t0;
  PhaseTimer(TraceBlock* tb, TraceField f)
      : acc(tb ? &tb->v[f] : nullptr), t0(tb ? TraceNowNs() : 0) {}
  ~PhaseTimer() {
    if (acc) *acc += TraceNowNs() - t0;
  }
};

struct DeferState;

struct Engine {
  int nThreads = 1;
  bool storeResults = true;  // stage per-read records for t1k_get_results
  // Deferred-DP chunk slots (owned); two so the driver can pipeline
  // device scoring of one chunk against host begin-work on the next.
  DeferState* defer2[2] = {nullptr, nullptr};
  // Trace counters (TraceBlock): on only when the caller traces; zeroed
  // at the start of each assignment pass (t1k_defer_reserve,
  // t1k_assign_batch).
  bool trace = false;
  TraceBlock traceSum;
  // Chunked deferral: lastAssign pre-reserved for the full unique-read
  // set; each begin/counts/finish cycle fills [deferBase, base+n).
  int64_t deferBase = -1;
  // Packed reference.
  const int8_t* codes;
  std::vector<int64_t> starts;
  std::vector<int32_t> lens;
  const uint8_t* exonMask;
  int32_t nSeqs;
  // Separator (N) positions per seq incl. the -1/len boundary
  // sentinels, flat arena + per-seq offsets: the per-overlap range
  // checks in the extension loop were chasing a vector-of-vectors.
  std::vector<int32_t> sepFlat;
  std::vector<int32_t> sepStart;  // nSeqs+1 offsets into sepFlat
  std::vector<int8_t> ownedCodes;
  std::vector<uint8_t> ownedExon;

  KmerIndex index;
  int radius = 10;
  int hitLenRequired = 31;
  double refSim = 0.8;
  bool relaxIntron = false;

  // Device-candidate pruning (phase-A-lite, ops/phase_a.py
  // DeviceCandidates): per unique read, a (strand, seq) bucket bitset —
  // bit index = (strand == +1 ? nSeqs : 0) + seq, matching the
  // CollectHitsSorted counting layout.  Hit collection drops postings
  // whose bucket is absent; the device guarantees (parity-tested) that
  // every dropped bucket would emit zero overlaps, so results are
  // byte-identical.  candHas[i] == 0 leaves read i unpruned (device
  // overflow fallback).
  std::vector<uint64_t> candBits;
  std::vector<uint8_t> candHas;
  int32_t candWords = 0;

  // Per-base coverage of matched read bases, [sum(len)][4].
  std::vector<int32_t> posWeight;
  // Per-seq coverage locks for multi-threaded scatter (the reference's
  // lockBaseCoverage, SeqSet.hpp:860-869): one lock per ~100-add walk
  // beats a lock-prefixed add per element.
  std::unique_ptr<std::mutex[]> seqLocks;

  // Result staging for the batched API.
  std::vector<double> results;
  std::vector<int64_t> resultOffsets;
  std::vector<std::vector<Overlap>> lastAssign;  // per unique read

  // Coalesced read groups (t1k_coalesce_batch staging).
  struct {
    std::vector<int64_t> goff;                 // [G+1] row offsets
    std::vector<int64_t> allele, start, end;   // [rows]
    std::vector<float> weight, qual, adjust;   // [rows]
    int64_t assignedFragments = 0;
  } coalesced;

  AlignScratch scratch;

  Engine(int k) : index(k) {}

  int64_t SeqStart(int s) const { return starts[s]; }
  const int8_t* Seq(int s) const { return codes + starts[s]; }
  int32_t SeqLen(int s) const { return lens[s]; }

  const int32_t* SepBegin(int seq) const { return sepFlat.data() + sepStart[seq]; }
  const int32_t* SepEnd(int seq) const { return sepFlat.data() + sepStart[seq + 1]; }
  int SepCount(int seq) const { return sepStart[seq + 1] - sepStart[seq]; }

  bool SeparatorInRange(int s, int e, int seq) const {
    const int32_t* p = SepBegin(seq);
    const int32_t* q = SepEnd(seq);
    for (; p != q; ++p)
      if (*p >= s && *p <= e) return true;
    return false;
  }
};

// Probe every k-mer of the read (both strands unless `strand` pins one) and
// collect postings.  Probe-skipping: positions whose posting list has >= 100
// entries are skipped up to k/2 times in a row (SeqSet.hpp:1081-1119).
// One probe pass records the surviving posting lists; hits are then
// emitted directly into (strand, seq) bucket order with a counting
// scatter — no intermediate unsorted hit array or separate sort pass.
static void CollectHitsSorted(const Engine& eng, const int8_t* read, int len,
                              const int8_t* rcRead, int strand,
                              std::vector<Hit>* hits,
                              const uint64_t* candBits = nullptr) {
  const int k = eng.index.k();
  const int skipLimit = k / 2;
  struct Probe {
    const std::vector<Posting>* plist;
    int32_t roff;
    int32_t strand;
  };
  static thread_local std::vector<Probe> probes;
  probes.clear();
  size_t total = 0;
  for (int pass = 0; pass < 2; ++pass) {
    int hitStrand = pass == 0 ? 1 : -1;
    if ((hitStrand == 1 && strand == -1) || (hitStrand == -1 && strand == 1))
      continue;
    const int8_t* r = pass == 0 ? read : rcRead;
    RollingCode rc(k);
    uint64_t prev = 0;
    int skipCnt = 0;
    for (int i = 0; i < k - 1; ++i) rc.push(r[i]);
    for (int i = k - 1; i < len; ++i) {
      rc.push(r[i]);
      if (i == k - 1 || rc.code != prev) {
        const std::vector<Posting>* plist =
            rc.valid() ? eng.index.Find(rc.code) : nullptr;
        int size = plist ? (int)plist->size() : 0;
        if (size >= 100 && i != k - 1 && i != len - 1 && skipCnt < skipLimit) {
          ++skipCnt;
          continue;  // note: prev deliberately not updated (contract quirk)
        }
        skipCnt = 0;
        if (size) {
          probes.push_back({plist, i - k + 1, hitStrand});
          total += size;
        }
      }
      prev = rc.code;
    }
  }

  const int nSeqs = eng.nSeqs;
  static thread_local std::vector<int> counts;
  counts.assign(2 * nSeqs + 1, 0);
  auto allowed = [&](int idx) {
    return (candBits[idx >> 6] >> (idx & 63)) & 1;
  };
  size_t kept = 0;
  for (const Probe& pr : probes) {
    int base = pr.strand == 1 ? nSeqs : 0;
    if (candBits) {
      for (const Posting& p : *pr.plist)
        if (allowed(base + p.seq)) {
          ++counts[base + p.seq + 1];
          ++kept;
        }
    } else {
      for (const Posting& p : *pr.plist) ++counts[base + p.seq + 1];
    }
  }
  for (int i = 1; i <= 2 * nSeqs; ++i) counts[i] += counts[i - 1];
  hits->resize(candBits ? kept : total);
  Hit* out = hits->data();
  for (const Probe& pr : probes) {
    int base = pr.strand == 1 ? nSeqs : 0;
    if (candBits) {
      for (const Posting& p : *pr.plist) {
        if (!allowed(base + p.seq)) continue;
        out[counts[base + p.seq]++] = {pr.strand, p.seq, pr.roff, p.off};
      }
    } else {
      for (const Posting& p : *pr.plist)
        out[counts[base + p.seq]++] = {pr.strand, p.seq, pr.roff, p.off};
    }
  }
}


// O(n log n) longest (strictly) increasing subsequence in `a` over seeds
// sorted by (b, a); same tie handling as the reference
// (SeqSet.hpp:352-436), then collapse duplicate b keeping the first.
static void ChainLIS(const std::vector<Seed>& in, std::vector<Seed>* out) {
  int n = (int)in.size();
  out->clear();
  if (n == 0) return;
  std::vector<int> top(n), link(n, -1);
  top[0] = 0;
  int ret = 1;
  for (int i = 1; i < n; ++i) {
    int tag;
    if (in[top[ret - 1]].a <= in[i].a) {
      tag = ret - 1;
    } else {
      // binary search: rightmost index with top value a <= in[i].a,
      // stopping early on exact equality
      int l = 0, r = ret - 1, m;
      tag = -1;
      while (l <= r) {
        m = (l + r) / 2;
        if (in[top[m]].a == in[i].a) {
          tag = m;
          break;
        } else if (in[i].a < in[top[m]].a) {
          r = m - 1;
        } else {
          l = m + 1;
        }
      }
      if (tag == -1) tag = l - 1;
    }
    if (tag == -1) {
      top[0] = i;
      link[i] = -1;
    } else if (in[i].a > in[top[tag]].a) {
      if (tag == ret - 1) {
        top[ret] = i;
        link[i] = top[tag];
        ++ret;
      } else if (in[i].a < in[top[tag + 1]].a) {
        top[tag + 1] = i;
        link[i] = top[tag];
      }
    }
  }
  std::vector<Seed> lis;
  for (int k = top[ret - 1]; k != -1; k = link[k]) lis.push_back(in[k]);
  std::reverse(lis.begin(), lis.end());
  out->push_back(lis[0]);
  for (int i = 1; i < (int)lis.size(); ++i)
    if (lis[i].b != out->back().b) out->push_back(lis[i]);
}

// Flat per-call seed storage: one arena plus a (start,len) span per
// overlap.  A vector<vector<Seed>> here cost one heap allocation per
// overlap — ~17.8M per KIR-scale run.
struct SeedSpans {
  std::vector<Seed> flat;
  std::vector<std::pair<int32_t, int32_t>> span;
  void clear() {
    flat.clear();
    span.clear();
  }
  const Seed* data(int i) const { return flat.data() + span[i].first; }
  int size(int i) const { return span[i].second; }
  void push(const std::vector<Seed>& s) {
    span.emplace_back((int32_t)flat.size(), (int32_t)s.size());
    flat.insert(flat.end(), s.begin(), s.end());
  }
};

static int TotalSpan(const Seed* seeds, int n, bool onRead, int k) {
  int ret = 0;
  int i = 0;
  while (i < n) {
    int j = i + 1;
    while (j < n) {
      int cur = onRead ? seeds[j].a : seeds[j].b;
      int prv = onRead ? seeds[j - 1].a : seeds[j - 1].b;
      if (cur > prv + k - 1) break;
      ++j;
    }
    ret += (onRead ? seeds[j - 1].a - seeds[i].a : seeds[j - 1].b - seeds[i].b) + k;
    i = j;
  }
  return ret;
}

// Per-read memo over (strand, seq) hit groups: the chain computation
// (diagonal clustering, dominant-diagonal dedupe, LIS, span filters)
// depends only on the group's (readOff, seqOff) pair list, and is
// invariant under a uniform shift of the seqOffs — every comparison is
// between diagonal or offset DIFFERENCES.  Candidate alleles of a gene
// present identical (or identically shifted) hit patterns wherever the
// read span contains no variant, so the chain result can be replayed
// with the shift applied instead of recomputed (at HLA scale ~24M
// groups per run collapse to a few hundred distinct patterns per read).
// Collisions resolve by exact pair-list compare against the first
// occurrence's slice of the (stable, per-read) hits array.
struct GroupMemo {
  struct Entry {
    uint32_t gen = 0;
    uint64_t h;
    int32_t hitIdx, nHits;  // first occurrence: slice of the hits array
    int32_t ovStart, ovCnt; // produced overlaps: span into the arenas
  };
  std::vector<Entry> slots = std::vector<Entry>(1 << 12);
  uint32_t gen = 0;
  // Arenas of the produced overlaps, seqStart/seqEnd and seed.b stored
  // relative to the group's first seqOff.
  std::vector<Overlap> ovArena;
  std::vector<std::pair<int32_t, int32_t>> seedSpan;
  std::vector<Seed> seedArena;

  void Clear() {
    ++gen;
    ovArena.clear();
    seedSpan.clear();
    seedArena.clear();
  }

  static uint64_t Hash(const Hit* h, int n, int32_t base) {
    // O(1) sampled hash over the group's (roff, soff-base) words:
    // count + first/middle/last two.  Groups that sample equal but
    // differ elsewhere fail the full per-hit verify below and fall
    // through to a recompute — results are identical either way, so
    // only hash cost and chain length change.
    auto word = [&](int i) {
      return ((uint64_t)(uint32_t)h[i].roff << 32) |
             (uint32_t)(h[i].soff - base);
    };
    uint64_t x = 1469598103934665603ull;
    x = (x ^ (uint64_t)n) * 1099511628211ull;
    int idx[6] = {0, 1, n / 2, n / 2 + 1, n - 2, n - 1};
    for (int q = 0; q < 6; ++q) {
      int i = idx[q];
      if (i < 0 || i >= n) continue;
      x = (x ^ word(i)) * 1099511628211ull;
    }
    return x;
  }
};

// From sorted hits build candidate overlaps: per (strand, seq) group,
// cluster by diagonal (radius 10 for reference sequences), keep per read
// offset the seed closest to the dominant diagonal, chain with LIS, apply
// the minimum-span filters (SeqSet.hpp:1232-1556).
static void BuildOverlaps(Engine& eng, const std::vector<Hit>& hits,
                          int hitLenRequired,
                          std::vector<Overlap>* overlaps,
                          SeedSpans* overlapSeeds) {
  const int k = eng.index.k();
  const int minHitRequired = 3;
  int n = (int)hits.size();
  int maxReadOffset = -1;
  for (const Hit& h : hits)
    if (h.roff > maxReadOffset) maxReadOffset = h.roff;
  std::vector<int> offsetBest(maxReadOffset + 1, 0);

  static thread_local GroupMemo memo;
  memo.Clear();

  struct DiagSeed {
    int32_t a, b, c;
  };
  std::vector<DiagSeed> diag;
  std::vector<Seed> concordant, lis;

  int i = 0;
  while (i < n) {
    int j = i + 1;
    while (j < n && hits[j].strand == hits[i].strand && hits[j].seq == hits[i].seq)
      ++j;
    if (j - i < minHitRequired) {
      i = j;
      continue;
    }
    // ---- group memo probe
    const int32_t base = hits[i].soff;
    const uint64_t gh = GroupMemo::Hash(&hits[i], j - i, base);
    GroupMemo::Entry* fill = nullptr;
    bool replayed = false;
    {
      size_t mask = memo.slots.size() - 1;
      size_t si = gh & mask;
      size_t probes = 0;
      for (;;) {
        GroupMemo::Entry& e = memo.slots[si];
        if (e.gen != memo.gen) {
          e.gen = memo.gen;
          e.h = gh;
          e.hitIdx = i;
          e.nHits = j - i;
          e.ovStart = (int32_t)memo.ovArena.size();
          e.ovCnt = -1;  // filled below after the group is computed
          fill = &e;
          break;
        }
        if (e.h == gh && e.nHits == j - i && e.ovCnt >= 0) {
          const Hit* a = &hits[e.hitIdx];
          const Hit* b = &hits[i];
          const int32_t abase = a[0].soff;
          bool same = true;
          for (int t = 0; t < e.nHits; ++t)
            if (a[t].roff != b[t].roff ||
                a[t].soff - abase != b[t].soff - base) {
              same = false;
              break;
            }
          if (same) {
            for (int t = 0; t < e.ovCnt; ++t) {
              Overlap o = memo.ovArena[e.ovStart + t];
              o.seq = hits[i].seq;
              o.strand = hits[i].strand;
              o.seqStart += base;
              o.seqEnd += base;
              overlaps->push_back(o);
              auto sp = memo.seedSpan[e.ovStart + t];
              std::vector<Seed>& flat = overlapSeeds->flat;
              overlapSeeds->span.emplace_back((int32_t)flat.size(),
                                              sp.second);
              // bulk copy, then rebase the seq offsets in place
              flat.insert(flat.end(), memo.seedArena.begin() + sp.first,
                          memo.seedArena.begin() + sp.first + sp.second);
              Seed* dst = flat.data() + flat.size() - sp.second;
              for (int q = 0; q < sp.second; ++q) dst[q].b += base;
            }
            replayed = true;
            break;
          }
        }
        si = (si + 1) & mask;
        if (++probes > memo.slots.size() / 2) break;  // saturated: compute
      }
      if (replayed) {
        i = j;
        continue;
      }
    }
    const size_t ovBefore = overlaps->size();
    diag.clear();
    for (int t = i; t < j; ++t)
      diag.push_back({hits[t].roff, hits[t].soff, hits[t].roff - hits[t].soff});
    std::sort(diag.begin(), diag.end(), [](const DiagSeed& x, const DiagSeed& y) {
      if (x.c != y.c) return x.c < y.c;
      if (x.b != y.b) return x.b < y.b;
      return x.a < y.a;
    });

    int dominantDiff = 0;
    int s = 0;
    const int adjustRadius = eng.radius;
    while (s < (int)diag.size()) {
      int currDiff = diag[s].c, currCnt = 1, domCnt = 0;
      offsetBest[diag[s].a] = -1;
      int e = s + 1;
      for (; e < (int)diag.size(); ++e) {
        int d = diag[e].c - diag[e - 1].c;
        if (d < 0) d = -d;
        if (d > adjustRadius) break;
        if (d == 0) {
          ++currCnt;
        } else {
          if (currCnt > domCnt) {
            dominantDiff = currDiff;
            domCnt = currCnt;
          }
          currDiff = diag[e].c;
          currCnt = 1;
        }
        offsetBest[diag[e].a] = -1;
      }
      if (currCnt > domCnt) dominantDiff = currDiff;

      if (e - s < minHitRequired || (e - s) * k < hitLenRequired) {
        s = e;
        continue;
      }

      concordant.clear();
      for (int t = s; t < e; ++t) concordant.push_back({diag[t].a, diag[t].b});

      if (adjustRadius > 0) {
        for (const Seed& sd : concordant) {
          int d = sd.a - sd.b - dominantDiff;
          if (d < 0) d = -d;
          if (offsetBest[sd.a] == -1 || offsetBest[sd.a] > d) offsetBest[sd.a] = d;
        }
        int l = 0;
        for (int t = 0; t < (int)concordant.size(); ++t) {
          int d = concordant[t].a - concordant[t].b - dominantDiff;
          if (d < 0) d = -d;
          if (d == offsetBest[concordant[t].a]) concordant[l++] = concordant[t];
        }
        concordant.resize(l);
        std::sort(concordant.begin(), concordant.end(), [](const Seed& x, const Seed& y) {
          if (x.b != y.b) return x.b < y.b;
          return x.a < y.a;
        });
      }

      ChainLIS(concordant, &lis);
      if ((int)lis.size() * k < hitLenRequired) {
        s = e;
        continue;
      }
      int hitLen = TotalSpan(lis.data(), (int)lis.size(), true, k);
      if (hitLen < hitLenRequired ||
          TotalSpan(lis.data(), (int)lis.size(), false, k) < hitLenRequired) {
        s = e;
        continue;
      }

      Overlap o;
      o.seq = hits[i].seq;
      o.strand = hits[i].strand;
      o.readStart = lis.front().a;
      o.readEnd = lis.back().a + k - 1;
      o.seqStart = lis.front().b;
      o.seqEnd = lis.back().b + k - 1;
      o.matchCnt = 2 * hitLen;
      o.similarity = 0;
      overlaps->push_back(o);
      overlapSeeds->push(lis);
      s = e;
    }

    // ---- record the group's result (shift-relative) for replay
    if (fill != nullptr) {
      const int cnt = (int)(overlaps->size() - ovBefore);
      fill->ovCnt = cnt;
      for (int t = 0; t < cnt; ++t) {
        Overlap o = (*overlaps)[ovBefore + t];
        o.seqStart -= base;
        o.seqEnd -= base;
        memo.ovArena.push_back(o);
        auto sp = overlapSeeds->span[ovBefore + t];
        memo.seedSpan.emplace_back((int32_t)memo.seedArena.size(), sp.second);
        for (int q = 0; q < sp.second; ++q) {
          Seed sd = overlapSeeds->flat[sp.first + q];
          sd.b -= base;
          memo.seedArena.push_back(sd);
        }
      }
    }
    i = j;
  }
}

// Walk consecutive LIS seeds and accumulate the exact match count: perfect
// diagonal continuations count positionally, gaps are closed with the
// banded DP (SeqSet.hpp:1594-1912).
//
// Split into three parts so the DP can run out-of-line: the core walk
// (gap DP via a pluggable stats provider; only the match count of a gap
// alignment is ever consumed), the similarity finalization, and the
// refSim filter.  The inline wrapper composes them with the native DP.
template <class GapStats>
static void ScoreOverlapsCore(Engine& eng, const int8_t* read,
                              const int8_t* rcRead, int len,
                              std::vector<Overlap>* overlaps,
                              SeedSpans* overlapSeeds,
                              GapStats&& gapMatch) {
  const int k = eng.index.k();
  int cnt = (int)overlaps->size();
  if (cnt == 0) return;

  // Keep only overlaps on the strand of the preliminary best.
  int best = 0;
  for (int i = 1; i < cnt; ++i)
    if (OverlapRankLess((*overlaps)[i], (*overlaps)[best])) best = i;
  int w = 0;
  for (int i = 0; i < cnt; ++i) {
    if ((*overlaps)[i].strand != (*overlaps)[best].strand) continue;
    (*overlaps)[w] = (*overlaps)[i];
    overlapSeeds->span[w] = overlapSeeds->span[i];
    ++w;
  }
  overlaps->resize(w);
  overlapSeeds->span.resize(w);
  cnt = w;

  for (int i = 0; i < cnt; ++i) {
    Overlap& o = (*overlaps)[i];
    const Seed* seeds = overlapSeeds->data(i);
    const int nSeeds = overlapSeeds->size(i);
    const int8_t* r = o.strand == 1 ? read : rcRead;
    int matchCnt = 2 * k;
    for (int j = 1; j < nSeeds; ++j) {
      const Seed& prev = seeds[j - 1];
      const Seed& cur = seeds[j];
      if (prev.b - prev.a == cur.b - cur.a) {
        if (prev.a + k - 1 >= cur.a) {
          matchCnt += 2 * (cur.a - prev.a);
        } else {
          matchCnt += 2 * k;
          matchCnt += 2 * gapMatch(i, o.seq, prev.b + k,
                                   cur.b - (prev.b + k), r, prev.a + k,
                                   cur.a - (prev.a + k));
        }
      } else {
        bool readOv = prev.a + k - 1 >= cur.a;
        bool seqOv = prev.b + k - 1 >= cur.b;
        if (readOv && !seqOv) {
          matchCnt += 2 * (cur.a - prev.a);
        } else if (!readOv && seqOv) {
          matchCnt += 2 * (cur.b - prev.b);
        } else if (readOv && seqOv) {
          int da = cur.a - prev.a, db = cur.b - prev.b;
          matchCnt += 2 * (da < db ? da : db);
        } else {
          matchCnt += 2 * k;
          matchCnt += 2 * gapMatch(i, o.seq, prev.b + k,
                                   cur.b - (prev.b + k), r, prev.a + k,
                                   cur.a - (prev.a + k));
        }
      }
    }
    o.matchCnt = matchCnt;
  }
}

// Similarity from the final match counts + low-complexity knockout
// (reference SeqSet.hpp:1893-1908): shared by the inline path and the
// deferred-DP finish.
static void ComputeOverlapSimilarity(const int8_t* read, const int8_t* rcRead,
                                     Overlap* ov, int cnt) {
  if (cnt == 0) return;
  // Low-complexity filter on the aligned read span (reference
  // SeqSet.hpp:458-485: a span is low-complexity when >= 2 bases occur
  // <= 2 times, unless those rare bases still make up >= 1/7 of it).
  // The test depends only on the span's base counts; running the byte
  // scan per overlap cost ~100 loads × every candidate allele, so one
  // prefix-sum pass per (read, strand) makes each test O(1).
  static thread_local std::vector<int32_t> pfx[2];  // [strand][4*(len+1)]
  int built[2] = {0, 0};
  for (int i = 0; i < cnt; ++i) {
    Overlap& o = ov[i];
    const int si = o.strand == 1 ? 1 : 0;
    const int8_t* r = si ? read : rcRead;
    if (!built[si]) {
      int len = o.readEnd + 1;
      // length of the read: spans never exceed it; build up to the max
      // readEnd across overlaps of this strand
      for (int t = i; t < cnt; ++t)
        if ((ov[t].strand == 1 ? 1 : 0) == si && ov[t].readEnd + 1 > len)
          len = ov[t].readEnd + 1;
      std::vector<int32_t>& p = pfx[si];
      p.assign(4 * (len + 1), 0);
      for (int q = 0; q < len; ++q) {
        for (int c = 0; c < 4; ++c) p[4 * (q + 1) + c] = p[4 * q + c];
        if (r[q] < 4) ++p[4 * (q + 1) + r[q]];
      }
      built[si] = 1;
    }
    const std::vector<int32_t>& p = pfx[si];
    o.similarity = (double)o.matchCnt /
                   (o.seqEnd - o.seqStart + 1 + o.readEnd - o.readStart + 1);
    int lowCnt = 0, lowTotal = 0;
    for (int c = 0; c < 4; ++c) {
      int v = p[4 * (o.readEnd + 1) + c] - p[4 * o.readStart + c];
      if (v <= 2) {
        ++lowCnt;
        lowTotal += v;
      }
    }
    bool lowComplexity =
        !(lowTotal * 7 >= o.readEnd - o.readStart + 1) && lowCnt >= 2;
    if (lowComplexity) o.similarity = 0;
  }
}

// ...then the refSim filter, compacting the parallel seed spans.
static void FinalizeOverlapSimilarity(Engine& eng, const int8_t* read,
                                      const int8_t* rcRead,
                                      std::vector<Overlap>* overlaps,
                                      SeedSpans* overlapSeeds) {
  int cnt = (int)overlaps->size();
  if (cnt == 0) return;
  ComputeOverlapSimilarity(read, rcRead, overlaps->data(), cnt);
  int w = 0;
  for (int i = 0; i < cnt; ++i) {
    if ((*overlaps)[i].similarity < eng.refSim) continue;
    (*overlaps)[w] = (*overlaps)[i];
    overlapSeeds->span[w] = overlapSeeds->span[i];
    ++w;
  }
  overlaps->resize(w);
  overlapSeeds->span.resize(w);
}

// Arena variant for the deferred finish: filters in place, keeping the
// parallel per-overlap extension-slot pairs aligned.  Returns the new
// count.
static int FinalizeOverlapSimilarityArr(Engine& eng, const int8_t* read,
                                        const int8_t* rcRead, Overlap* ov,
                                        int cnt, int32_t* slots2) {
  if (cnt == 0) return 0;
  ComputeOverlapSimilarity(read, rcRead, ov, cnt);
  int w = 0;
  for (int i = 0; i < cnt; ++i) {
    if (ov[i].similarity < eng.refSim) continue;
    ov[w] = ov[i];
    slots2[2 * w] = slots2[2 * i];
    slots2[2 * w + 1] = slots2[2 * i + 1];
    ++w;
  }
  return w;
}

// Per-read memo for small stat DPs: across a read's candidate alleles
// the same (pattern window, text content) recurs constantly — similar
// alleles present identical windows.  All overlaps share one strand
// after the core's filter, so (pOff, pLen, text bytes) keys a unique
// alignment.  Open-addressing with pointer keys: the text lives in the
// immutable packed reference, so entries store a pointer + length and
// collisions resolve by memcmp — no per-lookup string allocation.
struct StatsMemo {
  struct Entry {
    uint32_t gen = 0;
    uint64_t h;
    const int8_t* t;
    int32_t tLen, pOff, pLen;
    int32_t match;
  };
  std::vector<Entry> slots = std::vector<Entry>(1 << 12);
  uint32_t gen = 0;
  // One-entry front cache: ext-loop queries arrive in allele order and
  // adjacent alleles usually present byte-identical windows at the same
  // geometry, so the immediately preceding query repeats constantly.
  // Keyed exactly like the table (content + pOff/pLen), so correctness
  // is unchanged; it only skips the hash+probe.
  const int8_t* lastT = nullptr;
  int32_t lastTLen = -1, lastPOff = -1, lastPLen = -1, lastMatch = 0;
#ifndef NDEBUG
  // Both the slot table and the front cache key on (t content, pOff,
  // pLen) and NOT on p content: correctness depends on the invariant
  // that p is one fixed buffer (one strand of one read) between Clear()
  // calls.  Debug builds pin the invariant by recording the p pointer
  // per generation and asserting it never changes.
  const int8_t* genP = nullptr;
#endif

  static uint64_t Hash(const int8_t* t, int tLen, int pOff, int pLen) {
    // O(1) sampled content hash: first/middle/last 8-byte windows plus
    // the lengths.  Distinct contents that sample equal merely extend
    // the probe chain (every candidate hit is confirmed by memcmp), so
    // correctness is unaffected; identical contents always hash equal.
    uint64_t h = 1469598103934665603ull;
    h = (h ^ (uint64_t)pOff) * 1099511628211ull;
    h = (h ^ (uint64_t)pLen) * 1099511628211ull;
    h = (h ^ (uint64_t)tLen) * 1099511628211ull;
    uint64_t a = 0, b = 0, c = 0;
    if (tLen >= 8) {
      std::memcpy(&a, t, 8);
      std::memcpy(&b, t + tLen - 8, 8);
      if (tLen > 16) std::memcpy(&c, t + tLen / 2 - 4, 8);
    } else {
      for (int i = 0; i < tLen; ++i) a = (a << 8) | (uint8_t)t[i];
    }
    h = (h ^ a) * 1099511628211ull;
    h = (h ^ b) * 1099511628211ull;
    h = (h ^ c) * 1099511628211ull;
    return h;
  }

  void Clear() {
    ++gen;
    lastTLen = -1;  // the p side changes with the read: drop the front cache
#ifndef NDEBUG
    genP = nullptr;
#endif
  }

  void Remember(const int8_t* t, int tLen, int pOff, int pLen, int match) {
    lastT = t;
    lastTLen = tLen;
    lastPOff = pOff;
    lastPLen = pLen;
    lastMatch = match;
  }

  int Get(const int8_t* t, int tLen, const int8_t* p, int pOff, int pLen,
          AlignScratch* scratch) {
#ifndef NDEBUG
    // Callers pass the window start p = base + pOff; the keying
    // invariant is that the BASE buffer (one strand of one read) is
    // fixed between Clear() calls, so content at a given pOff never
    // changes within a generation.
    if (genP == nullptr) genP = p - pOff;
    assert(genP == p - pOff &&
           "StatsMemo: p must come from one base buffer per generation");
#endif
    if (tLen == lastTLen && pOff == lastPOff && pLen == lastPLen &&
        (t == lastT || std::memcmp(t, lastT, tLen) == 0)) {
      return lastMatch;
    }
    uint64_t h = Hash(t, tLen, pOff, pLen);
    size_t mask = slots.size() - 1;
    size_t i = h & mask;
    size_t probes = 0;
    for (;;) {
      Entry& e = slots[i];
      if (e.gen != gen) {
        e.gen = gen;
        e.h = h;
        e.t = t;
        e.tLen = tLen;
        e.pOff = pOff;
        e.pLen = pLen;
        e.match =
            BandedGlobalAlignStats(t, tLen, p, pLen, 5, scratch).match;
        Remember(t, tLen, pOff, pLen, e.match);
        return e.match;
      }
      if (e.h == h && e.tLen == tLen && e.pOff == pOff && e.pLen == pLen &&
          (e.t == t || std::memcmp(e.t, t, tLen) == 0)) {
        Remember(t, tLen, pOff, pLen, e.match);
        return e.match;
      }
      i = (i + 1) & mask;
      if (++probes > slots.size() / 2) {
        // table saturated for this read: fall through uncached
        int match = BandedGlobalAlignStats(t, tLen, p, pLen, 5, scratch).match;
        Remember(t, tLen, pOff, pLen, match);
        return match;
      }
    }
  }
};

static void ScoreOverlaps(Engine& eng, const int8_t* read, const int8_t* rcRead,
                          int len, std::vector<Overlap>* overlaps,
                          SeedSpans* overlapSeeds,
                          AlignScratch* scratch) {
  static thread_local StatsMemo memo;
  memo.Clear();
  ScoreOverlapsCore(
      eng, read, rcRead, len, overlaps, overlapSeeds,
      [&](int, int seq, int tOff, int tLen, const int8_t* r, int pOff,
          int pLen) {
        if (tLen <= 0 || pLen <= 0)
          return BandedGlobalAlignStats(eng.Seq(seq) + tOff, tLen, r + pOff,
                                        pLen, 5, scratch)
              .match;
        return memo.Get(eng.Seq(seq) + tOff, tLen, r + pOff, pOff, pLen,
                        scratch);
      });
  FinalizeOverlapSimilarity(eng, read, rcRead, overlaps, overlapSeeds);
}

// Extension geometry: overhang windows clipped at reference 'N'
// separators and reference boundaries (SeqSet.hpp:1994-2099).  Pure —
// independent of any alignment result, so it can be computed before the
// overhang DP runs.
struct ExtGeom {
  int leftOver, rightOver, leftClip, rightClip;
};

static ExtGeom ExtendGeometry(Engine& eng, const Overlap& o, int len) {
  int seqLen = eng.SeqLen(o.seq);
  const int32_t* sepLo = eng.SepBegin(o.seq);
  const int32_t* sepHi = eng.SepEnd(o.seq);
  ExtGeom g;
  g.leftOver = std::min(o.readStart, o.seqStart);
  g.leftClip = 0;
  g.rightClip = 0;
  if (o.readStart > o.seqStart) g.leftClip = o.readStart - o.seqStart;
  {
    // nearest 'N' separator in [seqStart - leftOver, seqStart) — binary
    // search over the precomputed positions instead of a byte scan
    const int32_t* it =
        std::lower_bound(sepLo, sepHi, o.seqStart - g.leftOver);
    if (it != sepHi && *it < o.seqStart) {
      // the reference scans outward from seqStart, so the CLOSEST
      // separator wins: the last one below seqStart
      const int32_t* it2 = std::lower_bound(sepLo, sepHi, o.seqStart);
      int32_t sep = *(it2 - 1);
      int i = o.seqStart - 1 - sep;  // scan index at which it was found
      g.leftClip = g.leftOver - i;
      g.leftOver = i;
    }
  }
  g.rightOver = std::min(len - 1 - o.readEnd, seqLen - 1 - o.seqEnd);
  if (len - 1 - o.readEnd > seqLen - 1 - o.seqEnd)
    g.rightClip = (len - 1 - o.readEnd) - (seqLen - 1 - o.seqEnd);
  {
    const int32_t* it = std::lower_bound(sepLo, sepHi, o.seqEnd + 1);
    if (it != sepHi && *it <= o.seqEnd + g.rightOver) {
      int i = *it - (o.seqEnd + 1);
      g.rightClip = g.rightOver - i;
      g.rightOver = i;
    }
  }
  return g;
}

// Combine precomputed overhang match counts with the geometry into the
// extended overlap; returns whether it passes the similarity floor.
static bool ExtendCombine(Engine& eng, const Overlap& o, const ExtGeom& g,
                          int leftMatch, int rightMatch, Overlap* out) {
  int leftOver = g.leftOver, rightOver = g.rightOver;
  int leftClip = g.leftClip, rightClip = g.rightClip;
  int matchCnt = leftMatch + rightMatch;

  out->seq = o.seq;
  out->readStart = o.readStart - leftOver;
  out->readEnd = o.readEnd + rightOver;
  out->seqStart = o.seqStart - leftOver;
  out->seqEnd = o.seqEnd + rightOver;
  out->strand = o.strand;
  out->matchCnt = 2 * matchCnt + o.matchCnt;
  out->similarity = (double)out->matchCnt /
                    (out->readEnd - out->readStart + 1 + out->seqEnd - out->seqStart + 1);
  out->relaxedMatchCnt = out->matchCnt;
  out->leftClip = leftClip;
  out->rightClip = rightClip;
  bool pass = out->similarity >= eng.refSim;
  if (leftClip > 0 || rightClip > 0) {
    out->matchCnt += 2 * leftClip + 2 * rightClip;
    out->similarity = (double)out->matchCnt /
                      (out->readEnd - out->readStart + 1 + out->seqEnd - out->seqStart + 1 +
                       2 * leftClip + 2 * rightClip);
  }
  return pass;
}


// Extension loop + near-best full-span pass + truncation — the tail of
// the read assignment shared by the inline and deferred-DP paths.  The
// overhang DP is abstracted behind extStats(sortedOverlapIdx, overlap,
// geom, r) -> {leftMatch, rightMatch}; everything downstream of it
// (including the sequential onlyConsiderClip state machine and the
// full-span edit walks) runs here.  With a trace block the extension
// loop's time goes to `loopField` and the full-span walks' to
// kTrFullspanNs.
template <class ExtStats>
static void AssignExtendAndFinish(Engine& eng, const int8_t* read,
                                  const int8_t* rcData, int len, int weight,
                                  std::vector<Overlap>& overlaps,
                                  std::vector<Overlap>* out,
                                  AlignScratch* scratch, TraceBlock* tb,
                                  TraceField loopField, ExtStats&& extStats) {
  if (overlaps.empty()) return;
  const int8_t* r = overlaps[0].strand == 1 ? read : rcData;

  std::vector<Overlap>& ext = *out;
  ext.reserve(overlaps.size());
  bool onlyConsiderClip = false;
  int goodMatchCnt = -1;
  const int64_t loopT0 = tb ? TraceNowNs() : 0;
  for (int oi = 0; oi < (int)overlaps.size(); ++oi) {
    const Overlap& o = overlaps[oi];
    if (eng.SeparatorInRange(o.seqStart, o.seqEnd, o.seq)) continue;
    bool needClip = eng.SeparatorInRange(o.seqStart - o.readStart,
                                         o.seqEnd + (len - o.readEnd - 1), o.seq);
    if (onlyConsiderClip && o.matchCnt < goodMatchCnt &&
        (!needClip || o.similarity < 0.95))
      continue;
    ExtGeom g = ExtendGeometry(eng, o, len);
    int lm = 0, rm = 0;
    extStats(oi, o, g, r, &lm, &rm);
    ext.emplace_back();
    if (ExtendCombine(eng, o, g, lm, rm, &ext.back())) {
      if (!onlyConsiderClip && (goodMatchCnt == -1 || o.matchCnt > goodMatchCnt))
        goodMatchCnt = o.matchCnt;
    } else {
      ext.pop_back();
      onlyConsiderClip = true;
    }
  }
  if (tb) tb->v[loopField] += TraceNowNs() - loopT0;

  if (!ext.empty() && weight >= 0) {
    PhaseTimer fullspanTimer(tb, kTrFullspanNs);
    // Full-span alignment for near-best candidates: exon-relaxed match
    // recount and per-base coverage scatter (SeqSet.hpp:2188-2285).
    int bestIdx = 0;
    for (int i = 1; i < (int)ext.size(); ++i)
      if (OverlapRankLess(ext[i], ext[bestIdx])) bestIdx = i;
    int bestMatch = ext[bestIdx].matchCnt;
    // Candidate alleles frequently present byte-identical windows over
    // the read span (they differ only at sites outside it), and the edit
    // walk depends only on the two window contents — cache walks per
    // read keyed by (span, window bytes) and replay the per-allele
    // scatter/recount from the cached walk.  (The reference recomputes
    // the DP per candidate; results are identical.)
    // Walk cache: same pointer-key open-addressing scheme as StatsMemo,
    // storing an index into a per-read walk arena.
    struct WalkSlot {
      uint32_t gen = 0;
      uint64_t h;
      const int8_t* t;
      int32_t tLen, rs, re;
      int32_t walkIdx;
    };
    // Cached walks also carry flat replay arrays built lazily on first
    // use: the coverage scatter becomes a branch-free stream of packed
    // (4*refOff + readBase) adds and the exon-relaxed recount a stream
    // of (refOff<<1 | isMatch) lookups — identical results to walking
    // the edit string, ~3x fewer instructions per op.  Valid because
    // the cache key (window bytes, readStart, readEnd) pins both the
    // edit walk and the read bases within one read.
    struct WalkData {
      std::vector<int8_t> edits;
      std::vector<uint32_t> scatter;  // 4*refOff + base, match ops only
      std::vector<uint32_t> relax;    // refOff<<1 | (op == match)
      bool scatterBuilt = false;
      bool relaxBuilt = false;
    };
    static thread_local std::vector<WalkSlot> walkSlots(1 << 12);
    static thread_local std::vector<WalkData> walkArena;
    static thread_local uint32_t walkGen = 0;
    ++walkGen;
    size_t walkUsed = 0;

    for (Overlap& e : ext) {
      if (e.matchCnt < bestMatch - 10) {
        e.relaxedMatchCnt = 0;
        continue;
      }
      if (!eng.relaxIntron && weight <= 0) {
        // the walk would feed only the coverage scatter (weight) and the
        // exon-relaxed recount (relaxIntron) — neither is active
        e.relaxedMatchCnt = e.matchCnt;
        continue;
      }
      const int8_t* seq = eng.Seq(e.seq);
      const int spanT = e.seqEnd - e.seqStart + 1;
      const int8_t* t = seq + e.seqStart;
      uint64_t h = StatsMemo::Hash(t, spanT, e.readStart, e.readEnd);
      size_t mask = walkSlots.size() - 1;
      size_t si = h & mask;
      int32_t widx = -1;
      for (size_t probes = 0; probes <= walkSlots.size() / 2; ++probes) {
        WalkSlot& sl = walkSlots[si];
        if (sl.gen != walkGen) {
          sl.gen = walkGen;
          sl.h = h;
          sl.t = t;
          sl.tLen = spanT;
          sl.rs = e.readStart;
          sl.re = e.readEnd;
          if (walkUsed == walkArena.size()) walkArena.emplace_back();
          sl.walkIdx = (int32_t)walkUsed++;
          WalkData& wd = walkArena[sl.walkIdx];
          wd.scatterBuilt = wd.relaxBuilt = false;
          BandedGlobalAlign(t, spanT, r + e.readStart,
                            e.readEnd - e.readStart + 1, 5, &wd.edits,
                            scratch);
          widx = sl.walkIdx;
          break;
        }
        if (sl.h == h && sl.tLen == spanT && sl.rs == e.readStart &&
            sl.re == e.readEnd &&
            (sl.t == t || std::memcmp(sl.t, t, spanT) == 0)) {
          widx = sl.walkIdx;
          break;
        }
        si = (si + 1) & mask;
      }
      static thread_local std::vector<int8_t> overflow;
      if (widx < 0) {  // table saturated: compute uncached
        BandedGlobalAlign(t, spanT, r + e.readStart,
                          e.readEnd - e.readStart + 1, 5, &overflow, scratch);
      }
      const std::vector<int8_t>& edits =
          widx >= 0 ? walkArena[widx].edits : overflow;
      const uint8_t* exon = eng.exonMask + eng.SeqStart(e.seq);
      const int seqLenClamp = eng.SeqLen(e.seq) - 1;
      if (eng.relaxIntron) {
        int match = 0;
        if (widx >= 0) {
          WalkData& wd = walkArena[widx];
          if (!wd.relaxBuilt) {
            wd.relax.clear();
            wd.relax.reserve(wd.edits.size());
            uint32_t off = 0;
            for (int8_t op : wd.edits) {
              wd.relax.push_back((off << 1) | (op == kEditMatch ? 1u : 0u));
              if (op != kEditInsert) ++off;
            }
            wd.relaxBuilt = true;
          }
          const uint8_t* exonS = exon + e.seqStart;
          // clamp guards a trailing-insert edge the reference reads OOB on
          const uint32_t maxOff = (uint32_t)(seqLenClamp - e.seqStart);
          for (uint32_t rk : wd.relax) {
            uint32_t off = rk >> 1;
            match += exonS[off <= maxOff ? off : maxOff] ? (int)(rk & 1) : 1;
          }
        } else {
          int refPos = e.seqStart;
          for (int8_t op : edits) {
            if (exon[refPos <= seqLenClamp ? refPos : seqLenClamp]) {
              if (op == kEditMatch) ++match;
            } else {
              ++match;
            }
            if (op != kEditInsert) ++refPos;
          }
        }
        e.relaxedMatchCnt = 2 * match;
      } else {
        e.relaxedMatchCnt = e.matchCnt;
      }
      if (weight > 0) {
        int32_t* pw = eng.posWeight.data() + 4 * eng.SeqStart(e.seq);
        if (widx >= 0) {
          WalkData& wd = walkArena[widx];
          if (!wd.scatterBuilt) {
            wd.scatter.clear();
            uint32_t refPos = 0;
            int readPos = e.readStart;
            for (int8_t op : wd.edits) {
              if (op == kEditMatch && r[readPos] < 4)
                wd.scatter.push_back(4u * refPos + (uint32_t)r[readPos]);
              if (op != kEditInsert) ++refPos;
              if (op != kEditDelete) ++readPos;
            }
            wd.scatterBuilt = true;
          }
          int32_t* target = pw + 4 * e.seqStart;
          if (eng.nThreads <= 1) {
            // single-threaded: plain adds skip the lock prefix — this
            // scatter runs once per near-best allele per read (~1e9
            // adds at HLA scale)
            for (uint32_t pk : wd.scatter) target[pk] += weight;
          } else {
            std::lock_guard<std::mutex> lk(eng.seqLocks[e.seq]);
            for (uint32_t pk : wd.scatter) target[pk] += weight;
          }
        } else {
          int refPos = e.seqStart, readPos = e.readStart;
          if (eng.nThreads <= 1) {
            for (int8_t op : edits) {
              if (op == kEditMatch && r[readPos] < 4)
                pw[4 * refPos + r[readPos]] += weight;
              if (op != kEditInsert) ++refPos;
              if (op != kEditDelete) ++readPos;
            }
          } else {
            std::lock_guard<std::mutex> lk(eng.seqLocks[e.seq]);
            for (int8_t op : edits) {
              if (op == kEditMatch && r[readPos] < 4)
                pw[4 * refPos + r[readPos]] += weight;
              if (op != kEditInsert) ++refPos;
              if (op != kEditDelete) ++readPos;
            }
          }
        }
      }
    }
  }

  if (ext.size() > 1000) {
    std::sort(ext.begin(), ext.end(), OverlapRankLess);
    size_t j = 1;
    while (j < ext.size() && ext[j].similarity >= ext[0].similarity - 0.1) ++j;
    ext.resize(j);
  }
}

// Full read-end assignment (reference SeqSet.hpp:2119-2303).  `tb`, when
// not null, takes the read's counts and phase times.
static void AssignRead(Engine& eng, const int8_t* read, int len, int weight,
                       std::vector<Overlap>* out, AlignScratch* scratch,
                       const uint64_t* candBits, TraceBlock* tb) {
  out->clear();
  const int k = eng.index.k();
  if (len < k || eng.nSeqs == 0) return;

  std::vector<int8_t> rc(len);
  for (int i = 0; i < len; ++i) {
    int8_t c = read[len - 1 - i];
    rc[i] = c < 4 ? 3 - c : 4;
  }

  static thread_local std::vector<Hit> hits;
  {
    PhaseTimer t(tb, kTrHitNs);
    CollectHitsSorted(eng, read, len, rc.data(), 0, &hits, candBits);
  }
  if (tb) tb->v[kTrHits] += (int64_t)hits.size();

  std::vector<Overlap> overlaps;
  static thread_local SeedSpans seeds;
  seeds.clear();
  {
    PhaseTimer t(tb, kTrChainNs);
    BuildOverlaps(eng, hits, eng.hitLenRequired, &overlaps, &seeds);
  }
  {
    PhaseTimer t(tb, kTrScoreNs);
    ScoreOverlaps(eng, read, rc.data(), len, &overlaps, &seeds, scratch);
  }
  if (tb) tb->v[kTrOverlaps] += (int64_t)overlaps.size();
  if (overlaps.empty()) return;

  {
    PhaseTimer t(tb, kTrExtendNs);
    std::sort(overlaps.begin(), overlaps.end(), OverlapRankLess);
  }
  static thread_local StatsMemo extMemo;
  extMemo.Clear();
  AssignExtendAndFinish(
      eng, read, rc.data(), len, weight, overlaps, out, scratch, tb,
      kTrExtendNs,
      [&](int, const Overlap& o, const ExtGeom& g, const int8_t* r, int* lm,
          int* rm) {
        const int8_t* seq = eng.Seq(o.seq);
        *lm = g.leftOver <= 0
                  ? 0
                  : extMemo.Get(seq + o.seqStart - g.leftOver, g.leftOver,
                                r + o.readStart - g.leftOver,
                                o.readStart - g.leftOver, g.leftOver, scratch);
        *rm = g.rightOver <= 0
                  ? 0
                  : extMemo.Get(seq + o.seqEnd + 1, g.rightOver,
                                r + o.readEnd + 1, o.readEnd + 1, g.rightOver,
                                scratch);
      });
}

// ------------------------------------------------------- deferred DP mode
// The assignment pipeline with the small banded alignments (seed-gap
// fill and overhang extension) batched out to an external scorer — on
// TPU, the band-packed Pallas stats kernel (ops/align_pallas_band.py).
//
// v2: ONE device round trip per chunk.  The overhang-extension windows
// depend only on the chain geometry (ExtendGeometry is pure), not on
// the gap-fill counts, so both item families are emitted together in
// the begin pass — speculatively for every strand-filtered overlap (the
// refSim filter and the sequential onlyConsiderClip walk may skip some;
// their device results simply go unused).  The finish pass folds the
// gap counts, finalizes similarity, sorts, replays the extension state
// machine on the batched counts, and runs the near-best full-span edit
// walks on the host (they feed the per-base coverage scatter).
//
// The v1 three-phase design kept per-read std::vector state (overlaps +
// full seed arenas) alive across its two round trips; at HLA scale that
// held ~1.6GB of cold per-read buffers per chunk and the group-memo
// replay ran 5x slower than the inline path purely on memory behaviour.
// v2 does all chain work in the same hot thread-local arenas as the
// inline path and persists only flat per-chunk SoA arenas (compact
// overlap records, gap-consumption pairs, extension slots), written and
// read as streaming sweeps.
//
// Items whose shape can't ride the W=32 band window (|Δlen| > 10) or
// exceed the device length cap are aligned inline — the external counts
// are exact (the kernel is bit-exact vs BandedGlobalAlignStats), so the
// end-to-end output is byte-identical to the inline path.
//
// Two chunk slots exist so the driver can software-pipeline: dispatch
// chunk i's device batch asynchronously, run chunk i+1's begin on the
// host while the device scores, then finish chunk i.

constexpr int kDeferMaxDiff = 10;   // window-fit guarantee: 5+10+|ML|<=30<32
// Device item length cap: the Pallas stats kernel packs the three
// traceback counters into 9-bit fields of one int32, and no field can
// exceed tLen+pLen+2 ops — 254+254+2 = 510 < 512 is the true boundary
// (tests/test_defer_caps.py pins both sides).  254 keeps 250-300bp
// reads' gap/extension windows on device.
constexpr int kDeferMaxLen = 254;

struct DeferItem {
  int32_t readIdx;
  int64_t tOff;   // absolute offset into the packed reference
  int32_t tLen;
  int32_t pOff;   // offset into the strand-resolved read
  int32_t pLen;
  bool useRc;
};

// Per-read window -> local-item dedup with the StatsMemo recipe
// (open-addressing, pointer keys into the immutable packed reference,
// generation-bumped clear) — a std::string-keyed map spent more time in
// malloc/memcpy than the entire inline DP it replaced.
struct DeferMemo {
  struct Entry {
    uint32_t gen = 0;
    uint64_t h;
    const int8_t* t;
    int32_t tLen, pOff, pLen;
    int32_t local;
  };
  std::vector<Entry> slots = std::vector<Entry>(1 << 13);
  uint32_t gen = 0;
  size_t used = 0;  // current-generation installs

  void Clear() {
    ++gen;
    used = 0;
  }

  // Double the table when the load factor reaches 1/2: one pass emits
  // gap AND extension windows, so a read with many candidate alleles
  // holds thousands of distinct windows — a fixed-size table saturates
  // and every probe degenerates to a half-table scan (measured: ~90s of
  // the HLA-scale begin pass before this grew).
  void Grow() {
    std::vector<Entry> next(slots.size() * 2);
    size_t mask = next.size() - 1;
    for (const Entry& e : slots) {
      if (e.gen != gen) continue;
      size_t i = e.h & mask;
      while (next[i].gen == gen) i = (i + 1) & mask;
      next[i] = e;
    }
    slots.swap(next);
  }

  // Returns the existing local item index or installs `local` for a
  // fresh window (`fresh` reports which).
  int32_t GetOrInstall(const int8_t* t, int tLen, int pOff, int pLen,
                       int32_t local, bool* fresh) {
    if (used >= slots.size() / 2) Grow();
    uint64_t h = StatsMemo::Hash(t, tLen, pOff, pLen);
    size_t mask = slots.size() - 1;
    size_t i = h & mask;
    for (;;) {
      Entry& e = slots[i];
      if (e.gen != gen) {
        e.gen = gen;
        e.h = h;
        e.t = t;
        e.tLen = tLen;
        e.pOff = pOff;
        e.pLen = pLen;
        e.local = local;
        ++used;
        *fresh = true;
        return local;
      }
      if (e.h == h && e.tLen == tLen && e.pOff == pOff && e.pLen == pLen &&
          (e.t == t || std::memcmp(e.t, t, tLen) == 0)) {
        *fresh = false;
        return e.local;
      }
      i = (i + 1) & mask;
    }
  }
};

// Flat per-chunk state: everything the finish pass needs, as SoA arenas
// with per-read offset tables.  No seed data survives the begin pass.
struct DeferState {
  struct ReadMeta {
    const int8_t* read = nullptr;
    int32_t len = 0;
    int32_t weight = 0;
    int64_t flatOff = 0;  // offset of this read in the caller's flat array
  };
  std::vector<ReadMeta> meta;                       // [n]
  std::vector<int64_t> itemOff, ovOff, consOff;     // [n+1]
  std::vector<Overlap> ov;                          // flat overlap arena
  std::vector<int32_t> slots;                       // [2 * |ov|] ext slots
  std::vector<std::pair<int32_t, int32_t>> cons;    // (localItem, ovIdx)
  std::vector<DeferItem> items;
  // Per item, while the engine traces: 1 for a speculative extension
  // item, 3 once the finish replay has read its count; 0 for gap items.
  std::vector<uint8_t> itemFlag;
  int64_t totalReadLen = 0;  // caller's flat read array length (rc base)
  int32_t maxTL = 0, maxPL = 0;

  void Clear() {
    meta.clear();
    itemOff.clear();
    ovOff.clear();
    consOff.clear();
    ov.clear();
    slots.clear();
    cons.clear();
    items.clear();
    itemFlag.clear();
    totalReadLen = 0;
    maxTL = maxPL = 0;
  }
};

static bool DeferEligible(int tLen, int pLen) {
  int d = tLen - pLen;
  if (d < -kDeferMaxDiff || d > kDeferMaxDiff) return false;
  return tLen <= kDeferMaxLen && pLen <= kDeferMaxLen;
}

// Begin pass: seed/chain every read in the hot thread-local arenas,
// emit gap-fill AND speculative extension items, persist the compact
// per-read state.
static void DeferBegin2(Engine& eng, const int8_t* readCodes,
                        const int64_t* readStarts, const int32_t* readLens,
                        const int32_t* weights, int64_t nReads,
                        int64_t totalReadLen, DeferState& st) {
  st.Clear();
  st.totalReadLen = totalReadLen;
  st.meta.resize(nReads);

  int nt = eng.nThreads < 1 ? 1 : eng.nThreads;
  if (nt > nReads) nt = nReads > 0 ? (int)nReads : 1;

  struct Local {
    std::vector<Overlap> ov;
    std::vector<int32_t> slots;
    std::vector<std::pair<int32_t, int32_t>> cons;
    std::vector<DeferItem> items;
    std::vector<int32_t> ovCnt, consCnt, itemCnt;  // per read in range
    int32_t maxTL = 0, maxPL = 0;
    TraceBlock tr;
    std::vector<uint8_t> itemFlag;  // DeferState::itemFlag, while tracing
  };
  std::vector<Local> locals(nt);

  auto worker = [&](int tid) {
    Local& L = locals[tid];
    TraceBlock* tb = eng.trace ? &L.tr : nullptr;
    AlignScratch scratch;
    static thread_local DeferMemo memo;
    static thread_local std::vector<Hit> hits;
    static thread_local std::vector<int8_t> rcBuf;
    static thread_local std::vector<Overlap> overlaps;
    static thread_local SeedSpans seeds;
    const int k = eng.index.k();
    int64_t lo = nReads / nt * tid;
    int64_t hi = (tid == nt - 1) ? nReads : nReads / nt * (tid + 1);
    if (tb) tb->v[kTrReads] += hi - lo;
    for (int64_t i = lo; i < hi; ++i) {
      st.meta[i] = {readCodes + readStarts[i], readLens[i], weights[i],
                    readStarts[i]};
      const size_t ov0 = L.ov.size();
      const size_t cons0 = L.cons.size();
      const size_t item0 = L.items.size();
      const int len = readLens[i];
      const int8_t* read = st.meta[i].read;
      if (len >= k && eng.nSeqs != 0) {
        rcBuf.resize(len);
        for (int j = 0; j < len; ++j) {
          int8_t c = read[len - 1 - j];
          rcBuf[j] = c < 4 ? 3 - c : 4;
        }
        overlaps.clear();
        seeds.clear();
        {
          PhaseTimer t(tb, kTrHitNs);
          // chunked deferral: global unique-read index = deferBase + i
          const int64_t gi = (eng.deferBase >= 0 ? eng.deferBase : 0) + i;
          CollectHitsSorted(
              eng, read, len, rcBuf.data(), 0, &hits,
              (eng.candWords && gi < (int64_t)eng.candHas.size() &&
               eng.candHas[gi])
                  ? eng.candBits.data() + gi * eng.candWords
                  : nullptr);
        }
        if (tb) tb->v[kTrHits] += (int64_t)hits.size();
        {
          PhaseTimer t(tb, kTrChainNs);
          BuildOverlaps(eng, hits, eng.hitLenRequired, &overlaps, &seeds);
        }
        memo.Clear();
        {
          PhaseTimer t(tb, kTrScoreNs);
          ScoreOverlapsCore(
              eng, read, rcBuf.data(), len, &overlaps, &seeds,
              [&](int ov, int seq, int tOff, int tLen, const int8_t* r,
                  int pOff, int pLen) -> int {
                if (tLen <= 0 || pLen <= 0) return 0;
                // All-match shortcut at emission: byte-equal windows hit
                // the same diagonal fast path the inline DP takes
                // (BandedGlobalAlignStats), so they never become device
                // items — in the genotyper regime (near-identical
                // alleles) this resolves the majority of gap windows
                // host-side for the cost of a <=30-byte memcmp.
                if (tLen == pLen &&
                    std::memcmp(eng.Seq(seq) + tOff, r + pOff, tLen) == 0)
                  return tLen;
                if (!DeferEligible(tLen, pLen))
                  return BandedGlobalAlignStats(eng.Seq(seq) + tOff, tLen,
                                                r + pOff, pLen, 5, &scratch)
                      .match;
                bool fresh = false;
                int32_t local = memo.GetOrInstall(
                    eng.Seq(seq) + tOff, tLen, pOff, pLen,
                    (int32_t)(L.items.size() - item0), &fresh);
                if (fresh) {
                  DeferItem it;
                  it.readIdx = (int32_t)i;
                  it.tOff = eng.SeqStart(seq) + tOff;
                  it.tLen = tLen;
                  it.pOff = pOff;
                  it.pLen = pLen;
                  it.useRc = r == rcBuf.data();
                  L.items.push_back(it);
                  L.maxTL = std::max(L.maxTL, it.tLen);
                  L.maxPL = std::max(L.maxPL, it.pLen);
                }
                L.cons.emplace_back(local, ov);
                return 0;
              });
        }
        // Speculative extension windows for every surviving overlap.
        const size_t specItem0 = L.items.size();
        if (tb) {
          tb->v[kTrOverlaps] += (int64_t)overlaps.size();
          tb->v[kTrGapItems] += (int64_t)(specItem0 - item0);
          L.itemFlag.resize(specItem0, 0);
        }
        const int64_t specT0 = tb ? TraceNowNs() : 0;
        for (int oi = 0; oi < (int)overlaps.size(); ++oi) {
          const Overlap& o = overlaps[oi];
          int32_t sl[2] = {-1, -1};
          bool sep = eng.SeparatorInRange(o.seqStart, o.seqEnd, o.seq);
          if (!sep) {
            ExtGeom g = ExtendGeometry(eng, o, len);
            const int sides[2] = {g.leftOver, g.rightOver};
            const int8_t* rr = o.strand == 1 ? read : rcBuf.data();
            for (int s = 0; s < 2; ++s) {
              if (sides[s] <= 0) continue;
              if (!DeferEligible(sides[s], sides[s])) {
                sl[s] = -2;  // inline fallback at finish
                continue;
              }
              DeferItem it;
              it.readIdx = (int32_t)i;
              it.tOff = eng.SeqStart(o.seq) +
                        (s == 0 ? o.seqStart - g.leftOver : o.seqEnd + 1);
              it.tLen = sides[s];
              it.pOff = s == 0 ? o.readStart - g.leftOver : o.readEnd + 1;
              it.pLen = sides[s];
              it.useRc = o.strand != 1;
              if (std::memcmp(eng.codes + it.tOff, rr + it.pOff,
                              it.tLen) == 0) {
                sl[s] = -3;  // all-match: res = sides[s] at finish
                continue;
              }
              bool fresh = false;
              int32_t local = memo.GetOrInstall(
                  eng.codes + it.tOff, it.tLen, it.pOff, it.pLen,
                  (int32_t)(L.items.size() - item0), &fresh);
              if (fresh) {
                L.items.push_back(it);
                L.maxTL = std::max(L.maxTL, it.tLen);
                L.maxPL = std::max(L.maxPL, it.pLen);
              }
              sl[s] = local;
            }
          }
          L.slots.push_back(sl[0]);
          L.slots.push_back(sl[1]);
        }
        if (tb) {
          tb->v[kTrSpecNs] += TraceNowNs() - specT0;
          tb->v[kTrSpecItems] += (int64_t)(L.items.size() - specItem0);
          L.itemFlag.resize(L.items.size(), 1);
        }
        L.ov.insert(L.ov.end(), overlaps.begin(), overlaps.end());
      }
      L.ovCnt.push_back((int32_t)(L.ov.size() - ov0));
      L.consCnt.push_back((int32_t)(L.cons.size() - cons0));
      L.itemCnt.push_back((int32_t)(L.items.size() - item0));
    }
  };
  if (nt == 1) {
    worker(0);
  } else {
    std::vector<std::thread> threads;
    for (int t = 0; t < nt; ++t) threads.emplace_back(worker, t);
    for (auto& th : threads) th.join();
  }

  // Merge in thread order (worker ranges are contiguous ascending).
  st.itemOff.resize(nReads + 1);
  st.ovOff.resize(nReads + 1);
  st.consOff.resize(nReads + 1);
  st.itemOff[0] = st.ovOff[0] = st.consOff[0] = 0;
  int64_t r = 0;
  for (int t = 0; t < nt; ++t) {
    const Local& L = locals[t];
    for (size_t j = 0; j < L.ovCnt.size(); ++j, ++r) {
      st.itemOff[r + 1] = st.itemOff[r] + L.itemCnt[j];
      st.ovOff[r + 1] = st.ovOff[r] + L.ovCnt[j];
      st.consOff[r + 1] = st.consOff[r] + L.consCnt[j];
    }
    st.maxTL = std::max(st.maxTL, L.maxTL);
    st.maxPL = std::max(st.maxPL, L.maxPL);
  }
  for (const Local& L : locals) eng.traceSum.Add(L.tr);
  if (nt == 1) {
    st.ov = std::move(locals[0].ov);
    st.slots = std::move(locals[0].slots);
    st.cons = std::move(locals[0].cons);
    st.items = std::move(locals[0].items);
    st.itemFlag = std::move(locals[0].itemFlag);
  } else {
    size_t novTot = 0, nconsTot = 0, nitemTot = 0;
    for (const Local& L : locals) {
      novTot += L.ov.size();
      nconsTot += L.cons.size();
      nitemTot += L.items.size();
    }
    st.ov.reserve(novTot);
    st.slots.reserve(2 * novTot);
    st.cons.reserve(nconsTot);
    st.items.reserve(nitemTot);
    for (Local& L : locals) {
      st.ov.insert(st.ov.end(), L.ov.begin(), L.ov.end());
      st.slots.insert(st.slots.end(), L.slots.begin(), L.slots.end());
      st.cons.insert(st.cons.end(), L.cons.begin(), L.cons.end());
      st.items.insert(st.items.end(), L.items.begin(), L.items.end());
      st.itemFlag.insert(st.itemFlag.end(), L.itemFlag.begin(),
                         L.itemFlag.end());
    }
  }
}

// Finish pass: fold gap counts, finalize + sort, replay the extension
// state machine on the batched counts, near-best full-span walks,
// result staging (identical to the inline batch path).
static int64_t DeferFinish2(Engine& eng, const int32_t* match,
                            DeferState& st) {
  int64_t nReads = (int64_t)st.meta.size();
  int nt = eng.nThreads < 1 ? 1 : eng.nThreads;
  if (nt > nReads) nt = nReads > 0 ? (int)nReads : 1;

  int64_t base = 0;
  if (eng.deferBase >= 0) {
    base = eng.deferBase;  // chunked: lastAssign reserved up front
  } else {
    eng.lastAssign.assign(nReads, {});
  }
  std::vector<std::vector<double>> shardResults(nt);
  std::vector<std::vector<int64_t>> shardCounts(nt);
  std::vector<TraceBlock> shardTrace(eng.trace ? nt : 0);
  // the begin pass flagged the speculative items only if it traced
  uint8_t* itemFlag =
      st.itemFlag.size() == st.items.size() ? st.itemFlag.data() : nullptr;

  auto worker = [&](int tid) {
    TraceBlock* tb = eng.trace ? &shardTrace[tid] : nullptr;
    AlignScratch scratch;
    static thread_local std::vector<int8_t> rcBuf;
    static thread_local std::vector<Overlap> ovs;
    static thread_local std::vector<std::array<int32_t, 2>> slts;
    static thread_local std::vector<int32_t> perm;
    int64_t lo = nReads / nt * tid;
    int64_t hi = (tid == nt - 1) ? nReads : nReads / nt * (tid + 1);
    for (int64_t i = lo; i < hi; ++i) {
      const DeferState::ReadMeta& M = st.meta[i];
      std::vector<Overlap>& assign = eng.lastAssign[base + i];
      int ovCnt = (int)(st.ovOff[i + 1] - st.ovOff[i]);
      if (ovCnt) {
        const int64_t replayT0 = tb ? TraceNowNs() : 0;
        Overlap* ovp = st.ov.data() + st.ovOff[i];
        int32_t* slp = st.slots.data() + 2 * st.ovOff[i];
        const int64_t itemBase = st.itemOff[i];
        for (int64_t c = st.consOff[i]; c < st.consOff[i + 1]; ++c)
          ovp[st.cons[c].second].matchCnt +=
              2 * match[itemBase + st.cons[c].first];
        rcBuf.resize(M.len);
        for (int j = 0; j < M.len; ++j) {
          int8_t c = M.read[M.len - 1 - j];
          rcBuf[j] = c < 4 ? 3 - c : 4;
        }
        int w = FinalizeOverlapSimilarityArr(eng, M.read, rcBuf.data(), ovp,
                                             ovCnt, slp);
        if (w) {
          // Sort a permutation with the same comparator: std::sort's
          // comparison/exchange sequence depends only on comparator
          // outcomes over logical positions, so the resulting order
          // equals sorting the Overlap array directly (what the inline
          // path does) for this standard library.
          perm.resize(w);
          for (int q = 0; q < w; ++q) perm[q] = q;
          std::sort(perm.begin(), perm.end(), [&](int a, int b) {
            return OverlapRankLess(ovp[a], ovp[b]);
          });
          ovs.resize(w);
          slts.resize(w);
          for (int q = 0; q < w; ++q) {
            ovs[q] = ovp[perm[q]];
            slts[q] = {slp[2 * perm[q]], slp[2 * perm[q] + 1]};
          }
          if (tb) tb->v[kTrReplayNs] += TraceNowNs() - replayT0;
          AssignExtendAndFinish(
              eng, M.read, rcBuf.data(), M.len, M.weight, ovs, &assign,
              &scratch, tb, kTrReplayNs,
              [&](int oi, const Overlap& o, const ExtGeom& g, const int8_t* r,
                  int* lm, int* rm) {
                const int sides[2] = {g.leftOver, g.rightOver};
                int res[2];
                for (int s = 0; s < 2; ++s) {
                  int32_t slot = slts[oi][s];
                  if (slot == -1) {
                    res[s] = 0;
                  } else if (slot == -3) {
                    res[s] = sides[s];  // all-match window (begin memcmp)
                  } else if (slot == -2) {
                    const int8_t* seq = eng.Seq(o.seq);
                    const int8_t* t = s == 0 ? seq + o.seqStart - g.leftOver
                                             : seq + o.seqEnd + 1;
                    const int8_t* p = s == 0 ? r + o.readStart - g.leftOver
                                             : r + o.readEnd + 1;
                    res[s] = BandedGlobalAlignStats(t, sides[s], p, sides[s],
                                                    5, &scratch)
                                 .match;
                  } else {
                    res[s] = match[itemBase + slot];
                    if (tb && itemFlag && itemFlag[itemBase + slot] == 1) {
                      itemFlag[itemBase + slot] = 3;
                      ++tb->v[kTrSpecUsed];
                    }
                  }
                }
                *lm = res[0];
                *rm = res[1];
              });
        } else {
          ovs.clear();
          if (tb) tb->v[kTrReplayNs] += TraceNowNs() - replayT0;
        }
      }
      if (!eng.storeResults) {
        shardCounts[tid].push_back((int64_t)assign.size());
        continue;
      }
      for (const Overlap& o : assign) {
        double rec[11] = {(double)o.seq,        (double)o.readStart,
                          (double)o.readEnd,    (double)o.seqStart,
                          (double)o.seqEnd,     (double)o.strand,
                          (double)o.matchCnt,   (double)o.relaxedMatchCnt,
                          o.similarity,         (double)o.leftClip,
                          (double)o.rightClip};
        shardResults[tid].insert(shardResults[tid].end(), rec, rec + 11);
      }
      shardCounts[tid].push_back((int64_t)assign.size());
    }
  };
  if (nt == 1) {
    worker(0);
  } else {
    std::vector<std::thread> threads;
    for (int t = 0; t < nt; ++t) threads.emplace_back(worker, t);
    for (auto& th : threads) th.join();
  }
  for (const TraceBlock& b : shardTrace) eng.traceSum.Add(b);

  eng.results.clear();
  eng.resultOffsets.clear();
  eng.resultOffsets.reserve(nReads + 1);
  eng.resultOffsets.push_back(0);
  for (int t = 0; t < nt; ++t) {
    eng.results.insert(eng.results.end(), shardResults[t].begin(),
                       shardResults[t].end());
    for (int64_t c : shardCounts[t])
      eng.resultOffsets.push_back(eng.resultOffsets.back() + c);
  }
  st.Clear();
  return eng.storeResults ? (int64_t)(eng.results.size() / 11)
                          : eng.resultOffsets.back();
}

static void DeferRelease(Engine& eng) {
  for (int s = 0; s < 2; ++s) {
    if (!eng.defer2[s]) continue;
    delete eng.defer2[s];
    eng.defer2[s] = nullptr;
  }
}

// Candidate screen used by the extractor: best (strand, seq) hit bucket,
// chained, then tested against the read-level mismatch budget
// (SeqSet.hpp:1915-1990).
static bool HasHitInSet(Engine& eng, const int8_t* read, int len) {
  // (seed/chain only; no DP scratch needed)
  const int k = eng.index.k();
  if (len < k) return false;
  std::vector<int8_t> rc(len);
  for (int i = 0; i < len; ++i) {
    int8_t c = read[len - 1 - i];
    rc[i] = c < 4 ? 3 - c : 4;
  }
  static thread_local std::vector<Hit> hits;
  CollectHitsSorted(eng, read, len, rc.data(), 0, &hits);
  if (hits.empty()) return false;
  // hits arrive bucket-sorted: strand -1 first, then seq ascending
  int bestStart = -1, bestLen = 0;
  int i = 0, n = (int)hits.size();
  while (i < n) {
    int j = i + 1;
    while (j < n && hits[j].strand == hits[i].strand && hits[j].seq == hits[i].seq)
      ++j;
    if (j - i > bestLen) {
      bestLen = j - i;
      bestStart = i;
    }
    i = j;
  }
  if (k * bestLen < eng.hitLenRequired) return false;

  std::vector<Hit> bucket(hits.begin() + bestStart, hits.begin() + bestStart + bestLen);
  std::vector<Overlap> overlaps;
  static thread_local SeedSpans seeds;
  seeds.clear();
  BuildOverlaps(eng, bucket, eng.hitLenRequired, &overlaps, &seeds);
  int mismatchBudget = (int)(len * (1 - eng.refSim)) * k;
  for (const Overlap& o : overlaps)
    if (len - o.matchCnt / 2 <= mismatchBudget) return true;
  return false;
}

}  // namespace t1k

// ----------------------------------------------------------------- C ABI
extern "C" {

void* t1k_engine_create(const int8_t* seq_codes, const int64_t* seq_starts,
                        const int32_t* seq_lens, const uint8_t* exon_mask,
                        int32_t n_seqs, int64_t total_len, int32_t kmer_length,
                        double ref_seq_similarity, int32_t hit_len_required,
                        int32_t relax_intron_align) {
  auto* eng = new t1k::Engine(kmer_length);
  eng->ownedCodes.assign(seq_codes, seq_codes + total_len);
  eng->ownedExon.assign(exon_mask, exon_mask + total_len);
  eng->codes = eng->ownedCodes.data();
  eng->exonMask = eng->ownedExon.data();
  eng->starts.assign(seq_starts, seq_starts + n_seqs);
  eng->lens.assign(seq_lens, seq_lens + n_seqs);
  eng->nSeqs = n_seqs;
  eng->refSim = ref_seq_similarity;
  eng->hitLenRequired = hit_len_required;
  eng->relaxIntron = relax_intron_align != 0;
  eng->posWeight.assign((size_t)total_len * 4, 0);
  eng->seqLocks.reset(new std::mutex[n_seqs > 0 ? n_seqs : 1]);
  eng->sepStart.assign(1, 0);
  for (int s = 0; s < n_seqs; ++s) {
    const int8_t* sc = eng->Seq(s);
    // Sentinels at -1 and len mirror the reference's separator list
    // (SeqSet.hpp:924-928): boundary positions count as separators, so
    // e.g. a mate pair that would extend exactly to position 0 trips
    // the truncated-mate filter.
    eng->sepFlat.push_back(-1);
    for (int i = 0; i < eng->lens[s]; ++i)
      if (sc[i] == 4) eng->sepFlat.push_back(i);
    eng->sepFlat.push_back(eng->lens[s]);
    eng->sepStart.push_back((int32_t)eng->sepFlat.size());
    eng->index.AddSequence(sc, eng->lens[s], s);
  }
  return eng;
}

void t1k_engine_destroy(void* e) {
  auto* eng = static_cast<t1k::Engine*>(e);
  t1k::DeferRelease(*eng);
  delete eng;
}

// ---- deferred-DP batch ABI (see "deferred DP mode" above) ----

// Chunked deferral: reserve the full unique-read assignment table, then
// run begin/counts/finish cycles per chunk with t1k_defer_set_base.
void t1k_defer_reserve(void* e, int64_t n_reads) {
  auto& eng = *static_cast<t1k::Engine*>(e);
  eng.lastAssign.assign(n_reads, {});
  eng.deferBase = 0;
  eng.traceSum = t1k::TraceBlock();
}

void t1k_defer_set_base(void* e, int64_t base) {
  static_cast<t1k::Engine*>(e)->deferBase = base;
}

void t1k_defer_end_chunked(void* e) {
  auto& eng = *static_cast<t1k::Engine*>(e);
  eng.deferBase = -1;
  t1k::DeferRelease(eng);
}

// Free the deferral working state (kept across chunks for capacity
// reuse); the unchunked driver calls this after finish.
void t1k_defer_release(void* e) {
  t1k::DeferRelease(*static_cast<t1k::Engine*>(e));
}

// Begin pass: seed/chain + item emission for one chunk into `slot`;
// returns the number of DP items to score externally.  The read arrays
// must stay valid until t1k_defer2_finish(slot) returns.
// total_read_len is the caller's FULL flat read-codes array length (the
// descriptor fetch addresses reverse-complement windows at
// total_read_len + offset, matching a device-resident [fwd | rc]
// doubled array).
int64_t t1k_defer2_begin(void* e, int32_t slot, const int8_t* read_codes,
                         const int64_t* read_starts,
                         const int32_t* read_lens, const int32_t* weights,
                         int64_t n_reads, int64_t total_read_len) {
  auto& eng = *static_cast<t1k::Engine*>(e);
  if (!eng.defer2[slot]) eng.defer2[slot] = new t1k::DeferState();
  t1k::DeferBegin2(eng, read_codes, read_starts, read_lens, weights, n_reads,
                   total_read_len, *eng.defer2[slot]);
  return (int64_t)eng.defer2[slot]->items.size();
}

void t1k_defer2_dims(void* e, int32_t slot, int64_t* n_items, int32_t* max_t,
                     int32_t* max_p) {
  auto& st = *static_cast<t1k::Engine*>(e)->defer2[slot];
  *n_items = (int64_t)st.items.size();
  *max_t = st.maxTL;
  *max_p = st.maxPL;
}

// Copy the pending items' text/pattern windows into caller buffers
// (row-major [n_items, cap]; rows beyond each length are left untouched,
// so pass zero-initialised arrays).  Reverse-complement reads are
// rebuilt lazily (items of one read are contiguous).
void t1k_defer2_fetch(void* e, int32_t slot, int8_t* t_out, int32_t* t_lens,
                      int8_t* p_out, int32_t* p_lens, int32_t t_cap,
                      int32_t p_cap) {
  auto& eng = *static_cast<t1k::Engine*>(e);
  auto& st = *eng.defer2[slot];
  std::vector<int8_t> rc;
  int32_t cur = -1;
  for (size_t i = 0; i < st.items.size(); ++i) {
    const t1k::DeferItem& it = st.items[i];
    std::memcpy(t_out + i * (size_t)t_cap, eng.codes + it.tOff, it.tLen);
    t_lens[i] = it.tLen;
    const t1k::DeferState::ReadMeta& M = st.meta[it.readIdx];
    const int8_t* p;
    if (it.useRc) {
      if (it.readIdx != cur) {
        rc.resize(M.len);
        for (int j = 0; j < M.len; ++j) {
          int8_t c = M.read[M.len - 1 - j];
          rc[j] = c < 4 ? 3 - c : 4;
        }
        cur = it.readIdx;
      }
      p = rc.data() + it.pOff;
    } else {
      p = M.read + it.pOff;
    }
    std::memcpy(p_out + i * (size_t)p_cap, p, it.pLen);
    p_lens[i] = it.pLen;
  }
}

// Descriptor fetch: instead of copying window bytes, emit per-item
// (t_off, t_len, p_off, p_len) indices into device-RESIDENT sequence
// tensors — t_off into the packed reference (uploaded once per engine),
// p_off into a doubled [fwd | rc] flat read array (uploaded once per
// batch; rc windows are contiguous ascending slices there).  ~20 bytes
// cross the link per item instead of the two padded windows.
void t1k_defer2_fetch_desc(void* e, int32_t slot, int64_t* t_off,
                           int32_t* t_len, int64_t* p_off, int32_t* p_len) {
  auto& eng = *static_cast<t1k::Engine*>(e);
  auto& st = *eng.defer2[slot];
  for (size_t i = 0; i < st.items.size(); ++i) {
    const t1k::DeferItem& it = st.items[i];
    const t1k::DeferState::ReadMeta& M = st.meta[it.readIdx];
    t_off[i] = it.tOff;
    t_len[i] = it.tLen;
    p_off[i] = (it.useRc ? st.totalReadLen : (int64_t)0) + M.flatOff +
               it.pOff;
    p_len[i] = it.pLen;
  }
}

// Finish pass; returns the number of result records (same getters as
// t1k_assign_batch).
int64_t t1k_defer2_finish(void* e, int32_t slot, const int32_t* match) {
  auto& eng = *static_cast<t1k::Engine*>(e);
  return t1k::DeferFinish2(eng, match, *eng.defer2[slot]);
}

void t1k_engine_set_hit_len(void* e, int32_t h) {
  static_cast<t1k::Engine*>(e)->hitLenRequired = h;
}

// Install device-generated candidate buckets (phase-A-lite): per unique
// read i of the NEXT t1k_assign_batch / defer cycle, has[i] != 0 makes
// hit collection keep only postings whose (strand, seq) bucket bit is
// set in bits[i * words .. (i+1) * words).  Bit index =
// (strand == +1 ? nSeqs : 0) + seq.  Passing n_reads = 0 clears.
void t1k_set_candidates(void* e, int64_t n_reads, const uint8_t* has,
                        const uint64_t* bits, int32_t words) {
  auto& eng = *static_cast<t1k::Engine*>(e);
  if (n_reads <= 0) {
    eng.candBits.clear();
    eng.candHas.clear();
    eng.candWords = 0;
    return;
  }
  eng.candWords = words;
  eng.candHas.assign(has, has + n_reads);
  eng.candBits.assign(bits, bits + n_reads * (int64_t)words);
}

// Parity oracle for the device candidate generator (ops/phase_a.py
// DeviceCandidates): per read, the distinct (seq, strand) buckets whose
// chains emit >= 1 overlap in BuildOverlaps — the exact pre-DP keep set
// of the assignment path.  CSR output: out_off [n_reads+1]; returns the
// total bucket count (caller re-sizes and re-calls if > cap_out).
int64_t t1k_overlap_buckets(void* ep, const int8_t* read_codes,
                            const int64_t* read_starts,
                            const int32_t* read_lens, int64_t n_reads,
                            int64_t cap_out, int32_t* out_seq,
                            int8_t* out_strand, int64_t* out_off) {
  auto& eng = *static_cast<t1k::Engine*>(ep);
  const int k = eng.index.k();
  int64_t total = 0;
  std::vector<int8_t> rc;
  std::vector<t1k::Hit> hits;
  std::vector<t1k::Overlap> overlaps;
  t1k::SeedSpans seeds;
  for (int64_t i = 0; i < n_reads; ++i) {
    out_off[i] = total;
    const int8_t* read = read_codes + read_starts[i];
    const int len = read_lens[i];
    if (len < k || eng.nSeqs == 0) continue;
    rc.assign(len, 0);
    for (int t = 0; t < len; ++t) {
      int8_t c = read[len - 1 - t];
      rc[t] = c < 4 ? (int8_t)(3 - c) : (int8_t)4;
    }
    t1k::CollectHitsSorted(eng, read, len, rc.data(), 0, &hits);
    overlaps.clear();
    seeds.clear();
    t1k::BuildOverlaps(eng, hits, eng.hitLenRequired, &overlaps, &seeds);
    int32_t lastSeq = -1;
    int8_t lastStrand = 0;
    for (const t1k::Overlap& o : overlaps) {
      // overlaps arrive in group order: consecutive dedupe is exact
      if (o.seq == lastSeq && (int8_t)o.strand == lastStrand) continue;
      lastSeq = o.seq;
      lastStrand = (int8_t)o.strand;
      if (total < cap_out) {
        out_seq[total] = o.seq;
        out_strand[total] = (int8_t)o.strand;
      }
      ++total;
    }
  }
  out_off[n_reads] = total;
  return total;
}

// Assign a batch of (unique) reads.  Each result record is 11 doubles:
// [seqIdx, readStart, readEnd, seqStart, seqEnd, strand, matchCnt,
//  relaxedMatchCnt, similarity, leftClip, rightClip].
// Returns total record count; use the getter functions to copy results out.
int64_t t1k_assign_batch(void* ep, const int8_t* read_codes,
                         const int64_t* read_starts, const int32_t* read_lens,
                         const int32_t* weights, int64_t n_reads) {
  auto& eng = *static_cast<t1k::Engine*>(ep);
  int nt = eng.nThreads;
  if (nt < 1) nt = 1;
  if (nt > n_reads) nt = n_reads > 0 ? (int)n_reads : 1;

  eng.lastAssign.assign(n_reads, {});
  std::vector<std::vector<double>> shardResults(nt);
  std::vector<std::vector<int64_t>> shardCounts(nt);
  eng.traceSum = t1k::TraceBlock();
  std::vector<t1k::TraceBlock> shardTrace(eng.trace ? nt : 0);

  auto worker = [&](int tid) {
    t1k::TraceBlock* tb = eng.trace ? &shardTrace[tid] : nullptr;
    t1k::AlignScratch scratch;
    int64_t start = n_reads / nt * tid;
    int64_t end = (tid == nt - 1) ? n_reads : n_reads / nt * (tid + 1);
    if (tb) tb->v[t1k::kTrReads] += end - start;
    for (int64_t i = start; i < end; ++i) {
      std::vector<t1k::Overlap>& assign = eng.lastAssign[i];
      t1k::AssignRead(eng, read_codes + read_starts[i], read_lens[i],
                      weights[i], &assign, &scratch,
                      (eng.candWords && i < (int64_t)eng.candHas.size() &&
                       eng.candHas[i])
                          ? eng.candBits.data() + i * eng.candWords
                          : nullptr,
                      tb);
      if (!eng.storeResults) {
        shardCounts[tid].push_back((int64_t)assign.size());
        continue;
      }
      for (const t1k::Overlap& o : assign) {
        double rec[11] = {(double)o.seq,        (double)o.readStart,
                          (double)o.readEnd,    (double)o.seqStart,
                          (double)o.seqEnd,     (double)o.strand,
                          (double)o.matchCnt,   (double)o.relaxedMatchCnt,
                          o.similarity,         (double)o.leftClip,
                          (double)o.rightClip};
        shardResults[tid].insert(shardResults[tid].end(), rec, rec + 11);
      }
      shardCounts[tid].push_back((int64_t)assign.size());
    }
  };

  if (nt == 1) {
    worker(0);
  } else {
    std::vector<std::thread> threads;
    for (int t = 0; t < nt; ++t) threads.emplace_back(worker, t);
    for (auto& th : threads) th.join();
  }
  for (const t1k::TraceBlock& b : shardTrace) eng.traceSum.Add(b);

  eng.results.clear();
  eng.resultOffsets.clear();
  eng.resultOffsets.reserve(n_reads + 1);
  eng.resultOffsets.push_back(0);
  for (int t = 0; t < nt; ++t) {
    eng.results.insert(eng.results.end(), shardResults[t].begin(),
                       shardResults[t].end());
    for (int64_t c : shardCounts[t])
      eng.resultOffsets.push_back(eng.resultOffsets.back() + c);
  }
  return eng.storeResults ? (int64_t)(eng.results.size() / 11)
                        : eng.resultOffsets.back();
}

void t1k_engine_set_threads(void* ep, int32_t n) {
  static_cast<t1k::Engine*>(ep)->nThreads = n;
}

// Trace counters of the assignment passes (TraceBlock): on != 0 makes
// the passes count and time their phases; off, they read no clock.
void t1k_engine_set_trace(void* ep, int32_t on) {
  static_cast<t1k::Engine*>(ep)->trace = on != 0;
}

// The name of the counter block's field f (TraceField order), or null
// past the last field.
const char* t1k_engine_trace_name(int32_t f) {
  return f >= 0 && f < t1k::kTrFields ? t1k::kTraceNames[f] : nullptr;
}

// Copies up to n fields of the counter block, in TraceField order, into
// out; returns the number of fields the engine keeps.
int32_t t1k_engine_trace_fetch(void* ep, int64_t* out, int32_t n) {
  const auto& eng = *static_cast<t1k::Engine*>(ep);
  for (int32_t f = 0; f < n && f < t1k::kTrFields; ++f)
    out[f] = eng.traceSum.v[f];
  return t1k::kTrFields;
}

// Disable per-read record staging (t1k_get_results) when the caller only
// consumes engine-side state (lastAssign + posWeight); the batch calls
// then return the total assignment count from the offsets instead.
void t1k_engine_set_store_results(void* ep, int32_t on) {
  static_cast<t1k::Engine*>(ep)->storeResults = on != 0;
}

const double* t1k_get_results(void* ep) {
  return static_cast<t1k::Engine*>(ep)->results.data();
}

const int64_t* t1k_get_result_offsets(void* ep) {
  return static_cast<t1k::Engine*>(ep)->resultOffsets.data();
}

const int32_t* t1k_get_pos_weight(void* ep) {
  return static_cast<t1k::Engine*>(ep)->posWeight.data();
}

// Extractor screen for a read batch; writes 0/1 flags.
void t1k_screen_batch(void* ep, const int8_t* read_codes,
                      const int64_t* read_starts, const int32_t* read_lens,
                      int64_t n_reads, uint8_t* out_flags) {
  auto& eng = *static_cast<t1k::Engine*>(ep);
  int nt = eng.nThreads;
  if (nt < 1) nt = 1;
  auto worker = [&](int tid) {
    for (int64_t i = tid; i < n_reads; i += nt)
      out_flags[i] = t1k::HasHitInSet(eng, read_codes + read_starts[i],
                                      read_lens[i]) ? 1 : 0;
  };
  if (nt == 1) {
    worker(0);
  } else {
    std::vector<std::thread> threads;
    for (int t = 0; t < nt; ++t) threads.emplace_back(worker, t);
    for (auto& th : threads) th.join();
  }
}

// Standalone banded global alignment; returns score, writes the edit walk
// (codes 0..3) terminated with -1 into align_out (capacity lent+lenp+3:
// the boundary quirks can emit two ops beyond lent+lenp).
int32_t t1k_align_global(const int8_t* t, int32_t lent, const int8_t* p,
                         int32_t lenp, int32_t band, int8_t* align_out) {
  t1k::AlignScratch scr;
  std::vector<int8_t> edits;
  int score = t1k::BandedGlobalAlign(t, lent, p, lenp, band, &edits, &scr);
  std::memcpy(align_out, edits.data(), edits.size());
  align_out[edits.size()] = -1;
  return score;
}

// Test hook for the stats (count-only) DP: writes {match, mismatch,
// indel} to out[0..2].  Exercises the same dispatch the engine uses
// (small stack-state kernel for windows <= 31bp, generic otherwise).
void t1k_align_stats(const int8_t* t, int32_t lent, const int8_t* p,
                     int32_t lenp, int32_t band, int32_t* out) {
  t1k::AlignScratch scr;
  t1k::EditStats st = t1k::BandedGlobalAlignStats(t, lent, p, lenp, band, &scr);
  out[0] = st.match;
  out[1] = st.mismatch;
  out[2] = st.indel;
}

// Batched banded global alignments: pair i aligns tcat[toff[i] ..
// toff[i]+tlen[i]) against pcat[poff[i] .. poff[i]+plen[i]); the edit
// walk is written at align_cat[aoff[i]] (caller reserves
// tlen[i]+plen[i]+3 per pair) and its length at alens[i].
void t1k_align_global_batch(const int8_t* tcat, const int64_t* toff,
                            const int32_t* tlen, const int8_t* pcat,
                            const int64_t* poff, const int32_t* plen,
                            const int64_t* aoff, int64_t n, int32_t band,
                            int8_t* align_cat, int32_t* alens) {
  t1k::AlignScratch scr;
  std::vector<int8_t> edits;
  for (int64_t i = 0; i < n; ++i) {
    t1k::BandedGlobalAlign(tcat + toff[i], tlen[i], pcat + poff[i], plen[i],
                           band, &edits, &scr);
    std::memcpy(align_cat + aoff[i], edits.data(), edits.size());
    alens[i] = (int32_t)edits.size();
  }
}

// Batched count-only stats over the padded [n, tcap]/[n, pcap] row
// layout that t1k_defer2_fetch emits — the native oracle for the
// deferred-DP transport (tests and the host-half profiling harness
// score the deferred items with this instead of a device).
void t1k_align_stats_batch(const int8_t* tc, const int32_t* tl,
                           const int8_t* pc, const int32_t* pl,
                           int64_t tcap, int64_t pcap, int64_t n,
                           int32_t band, int32_t* out_match) {
  t1k::AlignScratch scr;
  for (int64_t i = 0; i < n; ++i)
    out_match[i] = t1k::BandedGlobalAlignStats(tc + i * tcap, tl[i],
                                               pc + i * pcap, pl[i], band,
                                               &scr)
                       .match;
}

}  // extern "C"

// --------------------------------------------------------- fragment stage
// Mate pairing, per-allele dedupe, tie relaxation, dangling and
// truncated-reference filters, and similarity-bucket weighting — the exact
// semantics of core/fragment.py (reference SeqSet.hpp:2310-2655,
// Genotyper.hpp:205-230, 778-832), executed natively over the engine's
// stored per-read assignments.
namespace t1k {

struct FragRec {
  int32_t seq;
  int32_t seqStart, seqEnd;
  int32_t matchCnt;
  int32_t relaxedMatchCnt;
  double similarity;
  bool hasMatePair;
  bool o1FromR2;
  const Overlap* o1;
  const Overlap* o2;
  double qual = 0.0;
};

static bool FragBetter(const FragRec& a, const FragRec& b) {
  if (a.matchCnt != b.matchCnt) return a.matchCnt > b.matchCnt;
  if (a.similarity != b.similarity) return a.similarity > b.similarity;
  return OverlapRankLess(*a.o1, *b.o1);
}

static bool OverlapIntersect(const Overlap& a, const Overlap& b) {
  return a.seq == b.seq &&
         ((a.seqStart <= b.seqStart && b.seqStart <= a.seqEnd) ||
          (b.seqStart <= a.seqStart && a.seqStart <= b.seqEnd));
}

static bool TruncatedMate(const Engine& eng, const Overlap& o,
                          const Overlap& comp1, const Overlap& comp2) {
  if (o.seq == -1) return false;
  if (o.strand == 1) {
    int shift = comp2.seqEnd - comp1.seqEnd;
    if (eng.lens[o.seq] - 1 < o.seqEnd + shift) return true;
    if (eng.SeparatorInRange(o.seqEnd, o.seqEnd + shift + 1, o.seq)) return true;
  } else if (o.strand == -1) {
    int shift = comp1.seqStart - comp2.seqStart;
    if (o.seqStart - shift < 0) return true;
    if (eng.SeparatorInRange(o.seqStart - shift - 1, o.seqStart, o.seq))
      return true;
  }
  return false;
}

static float FragWeight(double similarity, double refSim, bool hasN) {
  double segment = (1 - refSim) / 4.0;
  if (segment < 0.01) segment = 0.01;
  double ret = 1.0;
  if (similarity < 1 - 3 * segment) ret = 0.01;
  else if (similarity < 1 - 2 * segment) ret = 0.1;
  else if (similarity < 1 - segment) ret = 0.5;
  if (hasN) ret /= 10.0;
  return (float)ret;
}

// Per-thread scratch for FragmentAssign: generation-stamped flat arrays
// replace per-fragment hash maps (the maps' alloc/clear/hash overhead
// dominated the fragment stage at scale); iteration orders are
// identical (insertion-ordered per-seq chains, first-seen assign slots).
struct FragScratch {
  std::vector<uint32_t> stampJ, stampA;  // per-seq generation marks
  std::vector<int32_t> head, tail;       // per-seq chain of o2 indices
  std::vector<int32_t> assignAt;         // per-seq slot in `assign`
  std::vector<int32_t> nxt;              // chain links, per o2 index
  std::vector<FragRec> assign;
  uint32_t gen = 0;

  void Begin(int64_t nSeqs, size_t o2cnt) {
    if ((int64_t)stampJ.size() < nSeqs) {
      stampJ.assign(nSeqs, 0);
      stampA.assign(nSeqs, 0);
      head.resize(nSeqs);
      tail.resize(nSeqs);
      assignAt.resize(nSeqs);
      gen = 0;
    }
    if (nxt.size() < o2cnt) nxt.resize(o2cnt);
    if (++gen == 0) {
      std::fill(stampJ.begin(), stampJ.end(), 0u);
      std::fill(stampA.begin(), stampA.end(), 0u);
      gen = 1;
    }
    assign.clear();
  }
};

// Returns kept fragment records for one fragment (read pair).
static void FragmentAssign(const Engine& eng,
                           const std::vector<Overlap>* ov1,
                           const std::vector<Overlap>* ov2, bool hasN,
                           bool paired, std::vector<FragRec>* out) {
  out->clear();
  static thread_local std::vector<std::pair<int, int>> fragments;
  fragments.clear();
  static const std::vector<Overlap> kEmpty;
  const std::vector<Overlap>& o1v = ov1 ? *ov1 : kEmpty;
  const std::vector<Overlap>& o2v = (paired && ov2) ? *ov2 : kEmpty;

  static thread_local FragScratch fs;
  fs.Begin(eng.nSeqs, o2v.size());

  if (!paired) {
    for (int i = 0; i < (int)o1v.size(); ++i) fragments.push_back({i, -1});
  } else if (o1v.empty() || o2v.empty()) {
    for (int i = 0; i < (int)o1v.size(); ++i) fragments.push_back({i, -1});
    for (int j = 0; j < (int)o2v.size(); ++j) fragments.push_back({-1, j});
  } else {
    for (int j = 0; j < (int)o2v.size(); ++j) {
      const int s = o2v[j].seq;
      if (fs.stampJ[s] != fs.gen) {
        fs.stampJ[s] = fs.gen;
        fs.head[s] = j;
      } else {
        fs.nxt[fs.tail[s]] = j;
      }
      fs.tail[s] = j;
      fs.nxt[j] = -1;
    }
    for (int i = 0; i < (int)o1v.size(); ++i) {
      const int s = o1v[i].seq;
      if (fs.stampJ[s] != fs.gen) continue;
      for (int j = fs.head[s]; j != -1; j = fs.nxt[j]) {
        if (o1v[i].strand == o2v[j].strand) continue;
        if ((o1v[i].strand == 1 && o1v[i].seqStart < o2v[j].seqStart) ||
            (o1v[i].strand == -1 && o1v[i].seqStart > o2v[j].seqStart))
          fragments.push_back({i, j});
      }
    }
  }

  std::vector<FragRec>& assign = fs.assign;
  for (auto [fi, fj] : fragments) {
    FragRec rec;
    if (fi >= 0) {
      const Overlap& o = o1v[fi];
      rec = {o.seq, o.seqStart, o.seqEnd, o.matchCnt, o.relaxedMatchCnt,
             o.similarity, false, false, &o, nullptr};
      if (fj >= 0) {
        const Overlap& o2 = o2v[fj];
        rec.matchCnt += o2.matchCnt;
        rec.relaxedMatchCnt += o2.relaxedMatchCnt;
        if (o.strand == 1) rec.seqEnd = o2.seqEnd;
        else rec.seqStart = o2.seqStart;
        rec.similarity =
            (double)rec.matchCnt /
            (o.readEnd - o.readStart + 1 + o2.readEnd - o2.readStart + 1 +
             o.seqEnd - o.seqStart + 1 + o2.seqEnd - o2.seqStart + 1 +
             2 * o.leftClip + 2 * o.rightClip + 2 * o2.leftClip +
             2 * o2.rightClip);
        rec.hasMatePair = true;
        rec.o2 = &o2;
      }
    } else if (fj >= 0) {
      const Overlap& o = o2v[fj];
      rec = {o.seq, o.seqStart, o.seqEnd, o.matchCnt, o.relaxedMatchCnt,
             o.similarity, false, true, &o, nullptr};
    } else {
      continue;
    }
    if (fs.stampA[rec.seq] == fs.gen) {
      FragRec& cur = assign[fs.assignAt[rec.seq]];
      if (FragBetter(rec, cur)) cur = rec;
    } else {
      fs.stampA[rec.seq] = fs.gen;
      fs.assignAt[rec.seq] = (int)assign.size();
      assign.push_back(rec);
    }
  }
  if (assign.empty()) return;

  const FragRec* best = &assign[0];
  for (size_t i = 1; i < assign.size(); ++i) {
    if (assign[i].matchCnt > best->matchCnt ||
        (assign[i].matchCnt == best->matchCnt &&
         assign[i].similarity > best->similarity))
      best = &assign[i];
  }
  FragRec bestCopy = *best;

  std::vector<FragRec>& kept = *out;
  for (FragRec& rec : assign) {
    int matchRelax = 2;
    if (eng.relaxIntron && rec.hasMatePair &&
        OverlapIntersect(*rec.o1, *rec.o2) &&
        rec.o1->matchCnt < rec.o1->relaxedMatchCnt &&
        rec.o2->matchCnt < rec.o2->relaxedMatchCnt)
      matchRelax = 4;
    if (rec.matchCnt == bestCopy.matchCnt &&
        rec.similarity == bestCopy.similarity) {
      rec.qual = 1.0;
      kept.push_back(rec);
    } else if (eng.relaxIntron && rec.matchCnt >= bestCopy.matchCnt - matchRelax &&
               rec.relaxedMatchCnt == bestCopy.relaxedMatchCnt) {
      rec.qual = 1.0;
      kept.push_back(rec);
    }
  }

  // dangling filter
  if (!kept.empty() && paired && !kept[0].hasMatePair) {
    bool ok = true;
    for (const FragRec& rec : kept) {
      const Overlap& o1 = *rec.o1;
      if (rec.similarity < 1 ||
          eng.SeparatorInRange(rec.seqStart, rec.seqEnd, rec.seq) ||
          (rec.seqEnd - rec.seqStart + 1 + o1.readEnd - o1.readStart + 1 <
           3 * eng.hitLenRequired)) {
        ok = false;
        break;
      }
      const int spanRange = 100;
      if ((o1.strand == 1 && rec.seqEnd + spanRange < eng.lens[rec.seq]) ||
          (o1.strand == -1 && rec.seqStart - spanRange >= 0)) {
        ok = false;
        break;
      }
    }
    if (!ok) {
      kept.clear();
      return;
    }
  }

  // truncated-reference filter
  if (!kept.empty() && paired && kept[0].hasMatePair) {
    const FragRec* rep = &kept[0];
    for (const FragRec& rec : kept)
      if (rec.qual == 1.0) {
        rep = &rec;
        break;
      }
    bool filt = false;
    for (const Overlap& o : o1v) {
      if (filt) break;
      if (o.matchCnt > rep->o1->matchCnt ||
          (o.matchCnt == rep->o1->matchCnt &&
           o.similarity > rep->o1->similarity &&
           fs.stampA[o.seq] != fs.gen)) {
        if (TruncatedMate(eng, o, *rep->o1, *rep->o2)) filt = true;
        else if (o.similarity > rep->o2->similarity + 0.1) filt = true;
      }
    }
    for (const Overlap& o : o2v) {
      if (filt) break;
      if (o.matchCnt > rep->o2->matchCnt ||
          (o.matchCnt == rep->o2->matchCnt &&
           o.similarity > rep->o2->similarity &&
           fs.stampA[o.seq] != fs.gen)) {
        if (TruncatedMate(eng, o, *rep->o2, *rep->o1)) filt = true;
        else if (o.similarity > rep->o1->similarity + 0.1) filt = true;
      }
    }
    if (filt) kept.clear();
  }
}

}  // namespace t1k

extern "C" {

// Fragment assignment over stored read-end assignments.  uid1/uid2 map
// each fragment to its unique-read index from the last t1k_assign_batch
// (-1 = no mate / unpaired).  Each output record is 6 doubles:
// [allele_idx, seq_start, seq_end, weight(f32), adjust_weight(f32), qual].
// A fragment's records are dropped entirely per SetReadAssignments rules
// (separator span, max assignment count, whitelist).
int64_t t1k_fragment_batch(void* ep, const int64_t* uid1, const int64_t* uid2,
                           const uint8_t* has_n, int64_t n_frags,
                           int32_t paired, int32_t max_assign_cnt,
                           const uint8_t* whitelist) {
  auto& eng = *static_cast<t1k::Engine*>(ep);
  int nt = eng.nThreads;
  if (nt < 1) nt = 1;

  std::vector<std::vector<double>> shardResults(nt);
  std::vector<std::vector<int64_t>> shardCounts(nt);

  auto worker = [&](int tid) {
    std::vector<t1k::FragRec> kept;
    int64_t start = n_frags / nt * tid;
    int64_t end = (tid == nt - 1) ? n_frags : n_frags / nt * (tid + 1);
    for (int64_t i = start; i < end; ++i) {
      const std::vector<t1k::Overlap>* o1 =
          uid1[i] >= 0 ? &eng.lastAssign[uid1[i]] : nullptr;
      const std::vector<t1k::Overlap>* o2 =
          uid2[i] >= 0 ? &eng.lastAssign[uid2[i]] : nullptr;
      t1k::FragmentAssign(eng, o1, o2, has_n[i] != 0, paired != 0, &kept);

      // SetReadAssignments (Genotyper.hpp:778-832)
      int64_t emitted = 0;
      bool drop = kept.empty() ||
                  (max_assign_cnt > 0 && (int64_t)kept.size() > max_assign_cnt);
      if (!drop) {
        for (const t1k::FragRec& rec : kept)
          if (eng.SeparatorInRange(rec.seqStart, rec.seqEnd, rec.seq)) {
            drop = true;
            break;
          }
      }
      if (!drop) {
        double maxSim = 0;
        for (const t1k::FragRec& rec : kept)
          if (rec.similarity > maxSim) maxSim = rec.similarity;
        double adjustFactor = maxSim < 1 ? 0.25 : 1.0;
        for (const t1k::FragRec& rec : kept) {
          if (whitelist && !whitelist[rec.seq]) continue;
          float w = t1k::FragWeight(rec.similarity, eng.refSim,
                                    has_n[i] != 0);
          float adj = (float)(adjustFactor * (double)w);
          double out[6] = {(double)rec.seq, (double)rec.seqStart,
                           (double)rec.seqEnd, (double)w, (double)adj,
                           rec.qual};
          shardResults[tid].insert(shardResults[tid].end(), out, out + 6);
          ++emitted;
        }
      }
      // flag byte: whether the fragment had any (pre-whitelist) assignment
      shardCounts[tid].push_back((emitted << 1) | (kept.empty() ? 0 : 1));
    }
  };

  if (nt == 1) {
    worker(0);
  } else {
    std::vector<std::thread> threads;
    for (int t = 0; t < nt; ++t) threads.emplace_back(worker, t);
    for (auto& th : threads) th.join();
  }

  eng.results.clear();
  eng.resultOffsets.clear();
  eng.resultOffsets.reserve(2 * n_frags + 1);
  eng.resultOffsets.push_back(0);
  for (int t = 0; t < nt; ++t) {
    eng.results.insert(eng.results.end(), shardResults[t].begin(),
                       shardResults[t].end());
    for (int64_t c : shardCounts[t]) eng.resultOffsets.push_back(c);
  }
  return (int64_t)(eng.results.size() / 6);
}

// Coalesce the staged fragment records into weighted read groups
// (Genotyper.hpp:841-908): fragments whose sorted (allele, qual) vector
// is identical merge into one group, float32 weights accumulating in
// fragment order, with the reference's min-start / quirky-end span
// updates (a smaller incoming end stores the incoming *start*,
// Genotyper.hpp:893-894).  Groups are emitted in first-appearance
// order; fingerprint collisions resolve by exact vector comparison
// like the reference.  Returns the assigned-fragment count.
int64_t t1k_coalesce_batch(void* ep) {
  auto& eng = *static_cast<t1k::Engine*>(ep);
  auto& cb = eng.coalesced;
  cb.goff.clear();
  cb.allele.clear();
  cb.start.clear();
  cb.end.clear();
  cb.weight.clear();
  cb.qual.clear();
  cb.adjust.clear();
  cb.assignedFragments = 0;
  cb.goff.push_back(0);

  const double* R = eng.results.data();
  const int64_t F = (int64_t)eng.resultOffsets.size() - 1;
  std::unordered_map<uint64_t, std::vector<int32_t>> fpToGroups;
  std::vector<int32_t> idx;
  int64_t rowBase = 0;
  for (int64_t f = 0; f < F; ++f) {
    const int64_t m = eng.resultOffsets[f + 1] >> 1;
    const double* rows = R + rowBase * 6;
    rowBase += m;
    if (m == 0) continue;
    ++cb.assignedFragments;
    idx.resize(m);
    for (int64_t i = 0; i < m; ++i) idx[i] = (int32_t)i;
    std::stable_sort(idx.begin(), idx.end(), [&](int32_t a, int32_t b) {
      return rows[a * 6] < rows[b * 6];
    });
    // FNV-1a over the sorted (allele, qual-bits) vector
    uint64_t h = 1469598103934665603ull;
    auto mix = [&h](uint64_t v) {
      h ^= v;
      h *= 1099511628211ull;
    };
    for (int64_t i = 0; i < m; ++i) {
      const double* r = rows + idx[i] * 6;
      mix((uint64_t)(int64_t)r[0]);
      float q = (float)r[5];
      uint32_t qb;
      memcpy(&qb, &q, sizeof qb);
      mix(qb);
    }
    int32_t grp = -1;
    auto it = fpToGroups.find(h);
    if (it != fpToGroups.end()) {
      for (int32_t g : it->second) {
        const int64_t gs = cb.goff[g];
        if (cb.goff[g + 1] - gs != m) continue;
        bool same = true;
        for (int64_t i = 0; i < m; ++i) {
          const double* r = rows + idx[i] * 6;
          if (cb.allele[gs + i] != (int64_t)r[0] ||
              cb.qual[gs + i] != (float)r[5]) {
            same = false;
            break;
          }
        }
        if (same) {
          grp = g;
          break;
        }
      }
    }
    if (grp == -1) {
      grp = (int32_t)(cb.goff.size() - 1);
      for (int64_t i = 0; i < m; ++i) {
        const double* r = rows + idx[i] * 6;
        cb.allele.push_back((int64_t)r[0]);
        cb.start.push_back((int64_t)r[1]);
        cb.end.push_back((int64_t)r[2]);
        cb.weight.push_back((float)r[3]);
        cb.adjust.push_back((float)r[4]);
        cb.qual.push_back((float)r[5]);
      }
      cb.goff.push_back((int64_t)cb.allele.size());
      fpToGroups[h].push_back(grp);
    } else {
      const int64_t gs = cb.goff[grp];
      for (int64_t i = 0; i < m; ++i) {
        const double* r = rows + idx[i] * 6;
        if ((float)r[5] == 1.0f) {
          const int64_t s = (int64_t)r[1], e = (int64_t)r[2];
          if (s < cb.start[gs + i]) cb.start[gs + i] = s;
          // reference quirk: smaller end stores the incoming start
          if (e < cb.end[gs + i]) cb.end[gs + i] = s;
        }
        cb.weight[gs + i] += (float)r[3];
        cb.adjust[gs + i] += (float)r[4];
      }
    }
  }
  return cb.assignedFragments;
}

void t1k_coalesce_dims(void* ep, int64_t* groups, int64_t* rows) {
  auto& cb = static_cast<t1k::Engine*>(ep)->coalesced;
  *groups = (int64_t)cb.goff.size() - 1;
  *rows = (int64_t)cb.allele.size();
}

void t1k_coalesce_fetch(void* ep, int64_t* goff, int64_t* allele,
                        int64_t* start, int64_t* end, float* weight,
                        float* qual, float* adjust) {
  auto& cb = static_cast<t1k::Engine*>(ep)->coalesced;
  memcpy(goff, cb.goff.data(), cb.goff.size() * sizeof(int64_t));
  memcpy(allele, cb.allele.data(), cb.allele.size() * sizeof(int64_t));
  memcpy(start, cb.start.data(), cb.start.size() * sizeof(int64_t));
  memcpy(end, cb.end.data(), cb.end.size() * sizeof(int64_t));
  memcpy(weight, cb.weight.data(), cb.weight.size() * sizeof(float));
  memcpy(qual, cb.qual.data(), cb.qual.size() * sizeof(float));
  memcpy(adjust, cb.adjust.data(), cb.adjust.size() * sizeof(float));
}

}  // extern "C"
