"""Allele reference database model.

Parses the allele FASTA produced by the database builder (header comment
carries exon coordinates: ``>GENE*allele exonCnt e1s e1e e2s e2e ...``,
see db/parse_dat.py and reference ParseDatFile.pl:748-751), dedupes
identical sequences into weights (reference Genotyper.hpp:707-730), and
packs everything into flat numpy arrays ready to ship to the device.

Behavior contracts mirrored from the reference:
  * exon coordinates are 0-based inclusive and may exceed the sequence
    length (RNA truncation) — the exon mask is clipped (SeqSet.hpp:666),
  * 'N' runs inside a sequence act as separators between independently
    alignable blocks (SeqSet.hpp:924-928); alignments may not span them,
  * effective length counts a run of N as a single base (SeqSet.hpp:747),
  * "dna" databases (any intron gap present) share weights across alleles
    with identical exon-restricted sequence (SeqSet.hpp:1008-1029),
  * allele names parse into gene / major-allele:  KIR style
    ``GENE*0010102`` keeps 3 digits; HLA style ``GENE*01:01:01`` keeps 3
    ':'-fields (Genotyper.hpp:63-131).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..constants import encode_seq
from ..utils.observability import traced_range
from .reads import read_seq_file


def parse_exons_from_comment(comment: Optional[str], seq_len: int) -> List[Tuple[int, int]]:
    """Extract exon [start, end] pairs (0-based inclusive) from a FASTA comment.

    The reference scans the comment for runs of digits: the first number is
    the exon count, followed by start/end pairs (SeqSet.hpp:933-969).  A
    comment without digits yields a single whole-sequence exon.
    """
    nums: List[int] = []
    if comment is not None:
        cur = 0
        in_num = False
        for ch in comment:
            if ch.isdigit():
                cur = cur * 10 + ord(ch) - 48
                in_num = True
            else:
                # the reference pushes on every non-digit character,
                # including zeros from consecutive delimiters
                nums.append(cur)
                cur = 0
                in_num = False
        if cur:
            nums.append(cur)
    if not nums:
        return [(0, seq_len - 1)]
    exons = []
    for i in range(1, len(nums) - 1, 2):
        exons.append((nums[i], nums[i + 1]))
    return exons


def parse_allele_name(
    allele: str,
    digit_units: int = -1,
    delimiter: str = "",
    fields_type: int = 0,
) -> Tuple[str, str]:
    """Split an allele name into (gene, major_allele).

    fields_type 0 is the default granularity; 1 keeps the exon-stage digits
    (used to compare alleles at the exon level).
    """
    star = allele.find("*")
    gene = allele if star < 0 else allele[:star]
    if star < 0:
        star = len(allele)

    use_delim = ""
    fields = digit_units
    if fields == -1:
        fields = 3
        if ":" in allele:
            use_delim = ":"
        if fields_type >= 1:
            fields = 3 if use_delim else 5
    if delimiter:
        use_delim = delimiter

    if not use_delim:
        # keep '*' plus `fields` characters
        end = min(len(allele), star + fields + 1)
        return gene, allele[:end]
    # delimiter style: keep up to the `fields`-th delimiter after the gene
    k = 0
    j = star
    while j < len(allele):
        if allele[j] == use_delim:
            k += 1
            if k >= fields:
                break
        j += 1
    return gene, allele[:j]


def compute_effective_len(seq: str) -> int:
    ret = 0
    prev_n = False
    for ch in seq:
        if ch != "N" or not prev_n:
            ret += 1
        prev_n = ch == "N"
    return ret


@dataclass
class Allele:
    name: str
    seq: str
    codes: np.ndarray                 # int8 [len], N -> 4
    exons: List[Tuple[int, int]]
    separators: np.ndarray            # int32 positions of 'N' in seq
    effective_len: int
    weight: int = 1
    gene_idx: int = -1
    major_allele_idx: int = -1

    exon_mask: np.ndarray = field(default=None, repr=False)  # bool [len]

    def __post_init__(self):
        if self.exon_mask is None:
            mask = np.zeros(len(self.seq), dtype=bool)
            for a, b in self.exons:
                if a < len(self.seq):
                    mask[a:min(b + 1, len(self.seq))] = True
            self.exon_mask = mask

    @property
    def length(self) -> int:
        return len(self.seq)

    def exon_seq(self) -> str:
        return "".join(ch for ch, m in zip(self.seq, self.exon_mask) if m)


class RefSet:
    """The allele store: sequences, k-mer-able codes, gene bookkeeping."""

    def __init__(
        self,
        digit_units: int = -1,
        delimiter: str = "",
    ):
        self.alleles: List[Allele] = []
        self.gene_names: List[str] = []
        self.major_allele_names: List[str] = []
        self.gene_name_to_idx: Dict[str, int] = {}
        self.major_allele_name_to_idx: Dict[str, int] = {}
        self.major_allele_size: List[int] = []
        self.digit_units = digit_units
        self.delimiter = delimiter
        self.rna_data = True  # becomes False if any allele has intron gaps
        self.gene_similarity: Optional[np.ndarray] = None

    # ---------------------------------------------------------------- load
    @classmethod
    @traced_range("refset_load")
    def from_fasta(
        cls,
        path: str,
        digit_units: int = -1,
        delimiter: str = "",
        selected_names: Optional[set] = None,
        init_gene_info: bool = True,
    ) -> "RefSet":
        rs = cls(digit_units, delimiter)
        seen: Dict[str, int] = {}
        for rec in read_seq_file(path):
            if selected_names is not None and rec.id not in selected_names:
                continue
            if rec.seq in seen:
                rs.alleles[seen[rec.seq]].weight += 1
                continue
            seen[rec.seq] = len(rs.alleles)
            rs.add_allele(rec.id, rec.seq, rec.comment)
        rs.finalize(init_gene_info=init_gene_info)
        return rs

    def add_allele(self, name: str, seq: str, comment: Optional[str]) -> int:
        codes = encode_seq(seq)
        exons = parse_exons_from_comment(comment, len(seq))
        seps = np.flatnonzero(np.frombuffer(seq.encode(), dtype=np.uint8) == ord("N")).astype(np.int32)
        a = Allele(
            name=name,
            seq=seq,
            codes=codes,
            exons=exons,
            separators=seps,
            effective_len=compute_effective_len(seq),
        )
        for i in range(1, len(exons)):
            if exons[i][0] > exons[i - 1][1] + 1:
                self.rna_data = False
                break
        self.alleles.append(a)
        return len(self.alleles) - 1

    def finalize(self, init_gene_info: bool = True) -> None:
        """Dna-weight sharing + gene/major-allele maps + similarity matrix."""
        if not self.rna_data:
            # share weights across alleles with identical exon sequence
            exon_seqs = [a.exon_seq() for a in self.alleles]
            weight_by_exon: Dict[str, int] = {}
            for a, es in zip(self.alleles, exon_seqs):
                weight_by_exon[es] = weight_by_exon.get(es, 0) + a.weight
            for a, es in zip(self.alleles, exon_seqs):
                a.weight = weight_by_exon[es]

        for a in self.alleles:
            gene, major = parse_allele_name(a.name, self.digit_units, self.delimiter)
            if gene not in self.gene_name_to_idx:
                self.gene_name_to_idx[gene] = len(self.gene_names)
                self.gene_names.append(gene)
            if major not in self.major_allele_name_to_idx:
                self.major_allele_name_to_idx[major] = len(self.major_allele_names)
                self.major_allele_names.append(major)
                self.major_allele_size.append(0)
            a.gene_idx = self.gene_name_to_idx[gene]
            a.major_allele_idx = self.major_allele_name_to_idx[major]
            self.major_allele_size[a.major_allele_idx] += a.weight

        if init_gene_info:
            self._compute_gene_similarity()
            self._repair_effective_lengths()

    def _compute_gene_similarity(self, k: int = 31) -> None:
        """Asymmetric k-mer profile similarity between genes.

        Per gene the representative is the allele with the lexicographically
        smallest sequence; similarity(i, j) = fraction of i's canonical
        31-mer multiset present in j's set (Genotyper.hpp:597-639,
        KmerCount.hpp:196-216).
        """
        n_genes = len(self.gene_names)
        reps: List[Optional[int]] = [None] * n_genes
        for idx, a in enumerate(self.alleles):
            g = a.gene_idx
            if reps[g] is None or a.seq < self.alleles[reps[g]].seq:
                reps[g] = idx

        profiles: List[Dict[int, int]] = []
        for g in range(n_genes):
            profiles.append(_canonical_kmer_counts(self.alleles[reps[g]].codes, k))

        sim = np.ones((n_genes, n_genes), dtype=np.float64)
        for i in range(n_genes):
            total_i = sum(profiles[i].values())
            for j in range(n_genes):
                if i == j:
                    continue
                shared = sum(c for kmer, c in profiles[i].items() if kmer in profiles[j])
                sim[i, j] = shared / total_i if total_i else 0.0
        self.gene_similarity = sim

    def _repair_effective_lengths(self) -> None:
        """Alleles with >500bp deletions get the per-gene modal effective
        length for abundance normalization (Genotyper.hpp:641-681)."""
        from ..constants import LARGE_DELETION

        by_gene: Dict[int, List[int]] = {}
        for idx, a in enumerate(self.alleles):
            by_gene.setdefault(a.gene_idx, []).append(idx)
        for g, ids in by_gene.items():
            lens = sorted(self.alleles[i].effective_len for i in ids)
            mode, best = 0, 0
            i = 0
            while i < len(lens):
                j = i
                while j < len(lens) and lens[j] == lens[i]:
                    j += 1
                if j - i > best:
                    best = j - i
                    mode = lens[i]
                i = j
            for i in ids:
                if self.alleles[i].effective_len < mode - LARGE_DELETION:
                    self.alleles[i].effective_len = mode

    # ------------------------------------------------------------- access
    def __len__(self) -> int:
        return len(self.alleles)

    @property
    def n_genes(self) -> int:
        return len(self.gene_names)

    @property
    def n_major_alleles(self) -> int:
        return len(self.major_allele_names)

    def name_to_idx(self) -> Dict[str, int]:
        return {a.name: i for i, a in enumerate(self.alleles)}

    def infer_kmer_length(self) -> int:
        """log4 of total reference length, plus one (SeqSet.hpp:2830-2845)."""
        total = sum(a.length for a in self.alleles)
        ret = 0
        while total:
            ret += 1
            total //= 4
        return ret + 1

    # -------------------------------------------------------- device pack
    def packed(self) -> "PackedRef":
        return PackedRef.from_refset(self)


@dataclass
class PackedRef:
    """Flat tensors describing the reference — the device-side layout.

    seq_codes is a single concatenated int8 array addressed by
    (seq_starts[i], seq_lens[i]); the same indexing covers exon_mask.
    This layout is shared by the native C++ engine (zero-copy via ctypes)
    and the torch ops (padded views are built on demand).
    """

    n: int
    seq_codes: np.ndarray     # int8  [sum(len)]
    seq_starts: np.ndarray    # int64 [n]
    seq_lens: np.ndarray      # int32 [n]
    exon_mask: np.ndarray     # uint8 [sum(len)]
    effective_lens: np.ndarray  # int32 [n]
    weights: np.ndarray       # int32 [n]
    gene_idx: np.ndarray      # int32 [n]
    major_idx: np.ndarray     # int32 [n]

    @classmethod
    def from_refset(cls, rs: RefSet) -> "PackedRef":
        lens = np.array([a.length for a in rs.alleles], dtype=np.int32)
        starts = np.zeros(len(lens), dtype=np.int64)
        if len(lens):
            starts[1:] = np.cumsum(lens[:-1], dtype=np.int64)
        codes = np.concatenate([a.codes for a in rs.alleles]) if rs.alleles else np.zeros(0, np.int8)
        emask = (
            np.concatenate([a.exon_mask.astype(np.uint8) for a in rs.alleles])
            if rs.alleles else np.zeros(0, np.uint8)
        )
        return cls(
            n=len(rs.alleles),
            seq_codes=np.ascontiguousarray(codes, dtype=np.int8),
            seq_starts=starts,
            seq_lens=lens,
            exon_mask=np.ascontiguousarray(emask),
            effective_lens=np.array([a.effective_len for a in rs.alleles], dtype=np.int32),
            weights=np.array([a.weight for a in rs.alleles], dtype=np.int32),
            gene_idx=np.array([a.gene_idx for a in rs.alleles], dtype=np.int32),
            major_idx=np.array([a.major_allele_idx for a in rs.alleles], dtype=np.int32),
        )


def _canonical_kmer_counts(codes: np.ndarray, k: int) -> Dict[int, int]:
    """Canonical k-mer multiset of one sequence (vectorized rolling hash)."""
    n = len(codes)
    if n < k:
        return {}
    c = codes.astype(np.uint64)
    valid = c < 4
    # forward codes via sliding dot with powers of 4
    win = np.lib.stride_tricks.sliding_window_view(c & np.uint64(3), k)
    pows = (np.uint64(4) ** np.arange(k - 1, -1, -1, dtype=np.uint64))
    fwd = (win * pows).sum(axis=1, dtype=np.uint64)
    # reverse complement codes
    rcw = (np.uint64(3) - (win & np.uint64(3)))[:, ::-1]
    rev = (rcw * pows).sum(axis=1, dtype=np.uint64)
    canon = np.minimum(fwd, rev)
    ok = np.lib.stride_tricks.sliding_window_view(valid, k).all(axis=1)
    out: Dict[int, int] = {}
    for v in canon[ok]:
        vi = int(v)
        out[vi] = out.get(vi, 0) + 1
    return out
