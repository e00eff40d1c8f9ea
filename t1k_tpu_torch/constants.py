"""Numerical contracts of the host stages (the reference T1K's).

Citations point at the reference lines that pin each value:

  * alignment scores: AlignAlgo.hpp:12-16
  * edit codes:       AlignAlgo.hpp:7-10
  * k-mer defaults:   FastqExtractor.cpp:272 (k=9), Genotyper.cpp:207 (k=11)
  * seeding:          SeqSet.hpp:760-772 (radius, hitLenRequired,
                      refSeqSimilarity)
  * extraction:       FastqExtractor.cpp:390-407 (hit-length thresholds)
  * EM:               Genotyper.hpp:1195 (max iterations), 1289 (converge)
  * selection:        Genotyper.hpp:1371-2090
"""

import numpy as np

# Edit operation codes of the alignment walks (AlignAlgo.hpp:7-10).
EDIT_MATCH = 0
EDIT_MISMATCH = 1
EDIT_INSERT = 2  # insertion to the text (reference consumes nothing)
EDIT_DELETE = 3  # deletion from the text (read consumes nothing)

# Alignment scores (AlignAlgo.hpp:12-16).
SCORE_MATCH = 2
SCORE_MISMATCH = -2
SCORE_GAPOPEN = -4
SCORE_GAPEXTEND = -1
SCORE_INDEL = -4  # linear-gap score used by the posWeight aligner

DEFAULT_BAND = 5

# K-mer lengths.
EXTRACTOR_KMER_LENGTH = 9
GENOTYPER_KMER_LENGTH = 11
GENE_PROFILE_KMER_LENGTH = 31  # gene-gene similarity profiles

# Seeding / chaining thresholds.
SEED_RADIUS = 10               # diagonal clustering radius for reference seqs
DEFAULT_HIT_LEN_REQUIRED = 31
NOVEL_SEQ_SIMILARITY = 0.9
DEFAULT_REF_SEQ_SIMILARITY = 0.8
MIN_HITS_REQUIRED = 3          # per (strand, sequence) group
HEAVY_POSTING_CUTOFF = 100     # posting lists >= this trigger probe skipping

# Extractor.
EXTRACTOR_HIT_LEN_PAIRED = 27
EXTRACTOR_HIT_LEN_SINGLE = 23

# Genotyper.
DEFAULT_MAX_ASSIGN_CNT = 2000
DEFAULT_FILTER_FRAC = 0.15
DEFAULT_FILTER_COV = 1.0
DEFAULT_CROSS_GENE_RATE = 0.04
CROSS_ALLELE_RATE = 0.01
COALESCE_BLOCK = 500000
READ_GROUP_FINGERPRINT_MOD = 20000003
EC_FINGERPRINT_MOD = 1000003
MAX_EM_ITERATIONS = 1000
EM_CONVERGENCE = 1e-5
EM_MASK_ROUND = 10
LARGE_DELETION = 500           # effective-length mode repair threshold
EC_LIKELIHOOD_CUTOFF = 0.05
MAX_QUALITY = 60

# Base encoding. A=0 C=1 G=2 T=3; everything else (incl. N) is INVALID_BASE.
INVALID_BASE = 4

BASE_LUT = np.full(256, INVALID_BASE, dtype=np.int8)
for _i, _b in enumerate("ACGT"):
    BASE_LUT[ord(_b)] = _i
    BASE_LUT[ord(_b.lower())] = _i

NUM_TO_BASE = np.frombuffer(b"ACGTN", dtype=np.uint8).copy()


def encode_seq(seq: str) -> np.ndarray:
    """Encode an ASCII nucleotide string into int8 codes (N -> 4)."""
    raw = np.frombuffer(seq.encode("ascii"), dtype=np.uint8)
    return BASE_LUT[raw]


def decode_seq(codes: np.ndarray) -> str:
    return NUM_TO_BASE[np.asarray(codes, dtype=np.int64)].tobytes().decode("ascii")


def revcomp_codes(codes: np.ndarray) -> np.ndarray:
    """Reverse-complement on the integer encoding; invalid stays invalid."""
    rc = codes[::-1].copy()
    valid = rc < 4
    rc[valid] = 3 - rc[valid]
    return rc


def revcomp_str(seq: str) -> str:
    return decode_seq(revcomp_codes(encode_seq(seq)))
