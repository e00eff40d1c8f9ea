"""FASTA/FASTQ ingestion.

Behavior contract (reference ReadFiles.hpp + kseq.h):
  * transparently handles gzip,
  * the record id is the first whitespace-delimited token; a trailing
    "/1" or "/2" is stripped (ReadFiles.hpp:185-189),
  * the rest of the header line is kept as the comment (used by the
    reference FASTA to carry exon coordinates),
  * multiple files can be chained; interleaved files can present only
    mate 1 or mate 2 records.
"""

from __future__ import annotations

import gzip
import io as _io
from dataclasses import dataclass
from typing import Iterator, Optional, Sequence


@dataclass
class SeqRecord:
    id: str
    seq: str
    qual: Optional[str] = None
    comment: Optional[str] = None


def _open_text(path: str):
    f = open(path, "rb")
    magic = f.peek(2)[:2] if hasattr(f, "peek") else f.read(2)
    if magic == b"\x1f\x8b":
        return _io.TextIOWrapper(gzip.GzipFile(fileobj=f), encoding="ascii")
    return _io.TextIOWrapper(_io.BufferedReader(f), encoding="ascii")


def _trim_mate_suffix(name: str) -> str:
    if len(name) >= 2 and name[-2] == "/" and name[-1] in "12":
        return name[:-2]
    return name


def _parse_header(line: str) -> tuple[str, Optional[str]]:
    body = line[1:].rstrip("\n")
    sp = body.find(" ")
    tb = body.find("\t")
    if tb != -1 and (sp == -1 or tb < sp):
        sp = tb
    if sp == -1:
        return _trim_mate_suffix(body), None
    return _trim_mate_suffix(body[:sp]), body[sp + 1:] or None


def _iter_lines(f, chunk_size: int = 1 << 22) -> Iterator[str]:
    """Stream lines (without trailing newline) via bulk reads — the
    per-readline path costs ~2x on multi-GB fastq ingestion."""
    rem = ""
    while True:
        buf = f.read(chunk_size)
        if not buf:
            if rem:
                yield rem
            return
        parts = (rem + buf).split("\n")
        rem = parts.pop()
        yield from parts


def read_seq_file(path: str) -> Iterator[SeqRecord]:
    """Stream records from one FASTA/FASTQ (optionally gzipped) file."""
    with _open_text(path) as f:
        lines = _iter_lines(f)
        line = next(lines, None)
        while line is not None:
            c = line[:1]
            if c == ">":
                name, comment = _parse_header(line)
                chunks = []
                line = next(lines, None)
                while line is not None and line[:1] not in (">", "@"):
                    chunks.append(line.strip())
                    line = next(lines, None)
                yield SeqRecord(name, "".join(chunks), None, comment)
            elif c == "@":
                # kseq semantics: the sequence may wrap over multiple
                # lines until the '+' separator, and the quality
                # accumulates until it is at least as long as the
                # sequence (kseq.h ks_getuntil loops)
                name, comment = _parse_header(line)
                chunks = []
                line = next(lines, None)
                while line is not None and line[:1] != "+":
                    chunks.append(line.strip())
                    line = next(lines, None)
                seq = chunks[0] if len(chunks) == 1 else "".join(chunks)
                qchunks = []
                qlen = 0
                while qlen < len(seq):
                    line = next(lines, None)
                    if line is None:
                        break
                    part = line.strip()
                    qchunks.append(part)
                    qlen += len(part)
                qual = (qchunks[0] if len(qchunks) == 1 else "".join(qchunks))
                yield SeqRecord(name, seq, qual, comment)
                line = next(lines, None)
            elif not line.strip():
                line = next(lines, None)
            else:
                raise ValueError(f"{path}: unexpected line {line[:40]!r}")


def read_seq_files(paths: Sequence[str], interleaved_id: int = 0) -> Iterator[SeqRecord]:
    """Chain several files; interleaved_id 1/2 keeps only odd/even records."""
    for path in paths:
        it = read_seq_file(path)
        if interleaved_id == 0:
            yield from it
        else:
            for i, rec in enumerate(it):
                if i % 2 == interleaved_id - 1:
                    yield rec


def write_fasta(path: str, records) -> None:
    with open(path, "w") as f:
        for rec in records:
            f.write(f">{rec.id}\n{rec.seq}\n")


def write_fastq(path: str, records) -> None:
    with open(path, "w") as f:
        for rec in records:
            if rec.qual is None:
                f.write(f">{rec.id}\n{rec.seq}\n")
            else:
                f.write(f"@{rec.id}\n{rec.seq}\n+\n{rec.qual}\n")
