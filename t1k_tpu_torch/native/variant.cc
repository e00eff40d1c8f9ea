// Native per-base variant-evidence accumulation for the analyzer stage.
//
// Mirrors the reference walk exactly (VariantCaller.hpp:103-173 via
// UpdateBaseVariantFromFragmentOverlap :273-305): every overlap's edit
// string is walked sequentially IN FRAGMENT ORDER, including the
// reference's stall quirk — a filtered (low-quality) or N substitution
// `continue`s past the position increments, shifting every later
// position of that overlap.  The Python implementation in
// core/variant.py (_walk_sequential / the batched _update_all) is the
// behavioural oracle; this C++ pass replaces the per-fragment Python
// loops as the production path (VERDICT r2 item 7).
//
// State is a set of caller-owned flat arenas over the concatenated
// selected-allele positions (rows = sum of allele lengths):
//   count / uniq / unweighted  [rows*4] f64
//   best_match                 [rows*4] i64   (alignInfo.a)
//   best_sim                   [rows*4] f64   (alignInfo.b)
//   best_match_max             [rows]   i64   (row max of best_match)
// core/variant.py's BaseVariants objects hold numpy views into the same
// memory, so the downstream candidate discovery reads the results with
// no copies.

#include <cstdint>

namespace {
constexpr int8_t kEditMatch = 0;
constexpr int8_t kEditMismatch = 1;
constexpr int8_t kEditInsert = 2;   // consumes read only
constexpr int8_t kEditDelete = 3;   // consumes reference only
}  // namespace

extern "C" {

// One full update pass over `n_items` overlaps (already enumerated in
// fragment order by the caller).  filter_low_qual=0 corresponds to the
// alignment-info pass (update_type=1), where `uniq_add` is all zero.
void t1k_variant_update(
    int64_t n_items, const int8_t* align_cat, const int64_t* align_off,
    const int32_t* align_len, const int32_t* seq_idx,
    const int32_t* seq_start, const int32_t* read_start,
    const int32_t* match_cnt, const double* similarity,
    const uint8_t* uniq_add, const int8_t* reads_cat,
    const int64_t* read_off, int32_t filter_low_qual,
    const int64_t* seq_base, double* count, double* uniq,
    double* unweighted, int64_t* best_match, double* best_sim,
    int64_t* best_match_max) {
  for (int64_t it = 0; it < n_items; ++it) {
    const int8_t* a = align_cat + align_off[it];
    const int n = align_len[it];
    const int8_t* r = reads_cat + read_off[it];
    const int64_t base = seq_base[seq_idx[it]];
    const int64_t m = match_cnt[it];
    const double sim = similarity[it];
    const bool addUniq = uniq_add[it] != 0;
    int64_t rp = base + seq_start[it];
    int64_t rdp = read_start[it];
    for (int i = 0; i < n; ++i) {
      const int8_t op = a[i];
      if (op == kEditMatch || op == kEditMismatch) {
        // good iff matchCnt is within 4 of every best alignment here
        if (filter_low_qual && m < best_match_max[rp] - 4)
          continue;  // stall: no position advance (reference quirk)
        const int8_t nuc = r[rdp];
        if (nuc >= 4) continue;  // stall
        const int64_t cell = rp * 4 + nuc;
        if (addUniq) uniq[cell] += 1.0;
        count[cell] += 1.0;
        unweighted[cell] += 1.0;
        if (m > best_match[cell]) {
          best_match[cell] = m;
          best_sim[cell] = sim;
          if (m > best_match_max[rp]) best_match_max[rp] = m;
        } else if (m == best_match[cell] && sim > best_sim[cell]) {
          best_sim[cell] = sim;
        }
      }
      if (op != kEditInsert) ++rp;
      if (op != kEditDelete) ++rdp;
    }
  }
}

}  // extern "C"
