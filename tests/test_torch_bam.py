"""The port's BAM extraction (t1k_tpu_torch.io.bam) against the JAX
package's (t1k_tpu.io.bam) on BAMs written from multigene_rna.fa alleles:
candidate reads, barcodes and UMIs byte for byte, the port on its gpu
route through the kernels' plain versions on the CPU and the JAX package
on its native route; the port's BAM writer against the JAX package's;
the screen gate's counts against the JAX package's, flush for flush; and
the split unaligned-pair error."""

import os

import numpy as np
import pytest
import torch

from t1k_tpu.constants import revcomp_str
from t1k_tpu.io import bam as host_bam
from t1k_tpu.io.reads import read_seq_file
from t1k_tpu.tools.simulate import SimConfig, simulate_pairs
from t1k_tpu_torch.io import bam as port_bam
from t1k_tpu_torch.utils.observability import metrics

HERE = os.path.dirname(os.path.abspath(__file__))
REF = os.path.join(HERE, "data", "multigene_rna.fa")
CONTIGS = (["chr1", "chr6", "chr6_GL000251v2_alt"], [1_000_000, 1_000_000,
                                                     100_000])
# gene g's alleles lie on chr6 at [GENE_START + GENE_STEP * g, + GENE_SPAN]
GENE_START, GENE_STEP, GENE_SPAN = 100_000, 20_000, 2_000
OUTPUTS = ("_1.fq", "_2.fq", ".fq", "_bc.fa", "_umi.fa")
HEADER = "@HD\tVN:1.6\tSO:coordinate\n"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The plain versions run as many small tensor operations: on one
    thread, so that the suite's test processes running side by side do
    not wait on each other's thread pools."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _alleles():
    return list(read_seq_file(REF))


def write_coord(path):
    """The coordinate fasta: every allele with its gene's interval."""
    genes = sorted({r.id.split("*")[0] for r in _alleles()})
    with open(path, "w") as f:
        for r in _alleles():
            s = GENE_START + GENE_STEP * genes.index(r.id.split("*")[0])
            f.write(f">{r.id} chr6 {s} {s + GENE_SPAN} +\n{r.seq}\n")


class Builder:
    """Records of one synthetic BAM: aligned reads in coordinate order,
    unaligned templates after them, as `bam` (a package's io.bam module)
    records and writes them."""

    def __init__(self, seed, quals=True, suffix=("", ""), bam=host_bam):
        self.bam = bam
        self.rng = np.random.default_rng(seed)
        self.quals = quals
        self.suffix = suffix
        self.aligned = []
        self.unaligned = []
        self.n = 0
        by_name = {r.id: r for r in _alleles()}
        self.panel = simulate_pairs(
            [by_name["GENA*83"], by_name["GENB*104"], by_name["GENC*50"]],
            [1.0, 1.0, 0.5], SimConfig(n_pairs=400, seed=seed))

    def _qual(self, n):
        if not self.quals:
            return None
        return "".join(chr(33 + int(q))
                       for q in self.rng.integers(2, 41, n))

    def _tags(self):
        kind = self.n % 4
        self.n += 1
        cb = "ACGTACGTAC%06d" % (self.n % 3)
        ub = "UMI%07d" % self.n
        return [{"CB": cb, "UB": ub}, {"CB": cb}, {"UB": ub}, {}][kind]

    def _random(self, n=100):
        return "".join(self.rng.choice(list("ACGT"), n))

    def next_panel(self):
        r1, r2 = self.panel[0].pop(0), self.panel[1].pop(0)
        return r1.id, r1.seq, r2.seq

    def pair(self, tid, p1, p2, seqs=None, single=False):
        name, s1, s2 = seqs or (f"bg{self.n}", self._random(),
                                self._random())
        tags = self._tags()
        q1, q2 = self._qual(len(s1)), self._qual(len(s2))
        if single:
            self.aligned.append(self.bam.BamRecord(
                name, 0x10 * (self.n % 2), tid, p1, 60, [(len(s1), 0)],
                -1, -1, 0, s1, q1, tags))
            return
        tlen = p2 - p1 + len(s2)
        self.aligned.append(self.bam.BamRecord(
            name + self.suffix[0], 0x63, tid, p1, 60, [(len(s1), 0)], tid,
            p2, tlen, s1, q1, tags))
        self.aligned.append(self.bam.BamRecord(
            name + self.suffix[1], 0x93, tid, p2, 60, [(len(s2), 0)], tid,
            p1, -tlen, revcomp_str(s2), q2 and q2[::-1], dict(tags)))

    def unaligned_pair(self, seqs=None, single=False):
        name, s1, s2 = seqs or (f"ubg{self.n}", self._random(),
                                self._random())
        tags = self._tags()
        if single:
            self.unaligned.append(self.bam.BamRecord(
                name, 0x4, -1, -1, 0, [], -1, -1, 0, s1,
                self._qual(len(s1)), tags))
            return
        rec = self.bam.BamRecord
        self.unaligned += [
            rec(name + self.suffix[0], 0x4D, -1, -1, 0, [], -1, -1, 0, s1,
                self._qual(len(s1)), tags),
            rec(name + self.suffix[1], 0x8D, -1, -1, 0, [], -1, -1, 0, s2,
                self._qual(len(s2)), dict(tags))]

    def write(self, path, split_unaligned=False):
        recs = sorted(self.aligned, key=lambda r: (r.tid, r.pos))
        unaligned = self.unaligned
        if split_unaligned:  # every first mate, then every second mate
            unaligned = unaligned[0::2] + unaligned[1::2]
        w = self.bam.BamWriter(path, *CONTIGS, HEADER)
        for r in recs + unaligned:
            w.write(r)
        w.close()
        return len(recs) + len(unaligned)


def mixed_bam(path, seed=21, quals=True, suffix=("", ""), single=False,
              split_unaligned=False, bam=host_bam):
    """In-region, edge, alt-contig, unaligned and off-target templates:
    on chr6 the panel's pairs inside GENA's and GENB's intervals, a read
    ending exactly on GENB's start and one a base past it, reads within
    5 kb of an interval; on the alt contig panel and random pairs;
    on chr1 panel and random pairs (off target); unaligned panel, random
    and low-complexity templates."""
    b = Builder(seed, quals, suffix, bam)
    ga, gb = GENE_START, GENE_START + GENE_STEP
    for i in range(40):
        b.pair(1, ga + 5 + 30 * i, ga + 160 + 30 * i, b.next_panel(), single)
    for i in range(20):
        b.pair(1, gb + 11 + 40 * i, gb + 170 + 40 * i, b.next_panel(),
               single)
    # a read ending on GENB's start and one a base past it, their mates
    # past the interval
    far = gb + GENE_SPAN + 3000
    b.pair(1, gb - 99, far, b.next_panel(), single)
    b.pair(1, gb - 98, far + 50, b.next_panel(), single)
    for i in range(10):                                     # near misses
        b.pair(1, gb - 5000 + 450 * i, gb - 4800 + 450 * i, None, single)
        b.pair(1, gb + GENE_SPAN + 1 + 400 * i,
               gb + GENE_SPAN + 150 + 400 * i,
               b.next_panel() if i % 3 == 0 else None, single)
    for i in range(15):
        b.pair(2, 500 + 50 * i, 650 + 50 * i,
               b.next_panel() if i % 2 else None, single)
    for i in range(40):
        b.pair(0, 10_000 + 100 * i, 10_200 + 100 * i,
               b.next_panel() if i % 4 == 0 else None, single)
    for i in range(25):
        b.unaligned_pair(b.next_panel(), single)
        b.unaligned_pair(None, single)
    b.unaligned_pair(("lowc", "A" * 60 + b._random(40), b._random()), single)
    return b.write(path, split_unaligned)


def flush_bam(path):
    """More than 65,536 jobs (one flush per 65,536): 5,000 off-target
    pairs on chr1 (no job), then 32,800 alt-contig pairs, every record a
    job, mostly low-complexity (screened out before the k-mer screen)
    with a panel pair every 1,000 pairs, and unaligned panel pairs after
    them."""
    b = Builder(5, quals=False)
    rng = np.random.default_rng(6)
    for i in range(5_000):
        b.pair(0, 1000 + 100 * i, 1150 + 100 * i)
    for i in range(32_800):
        if i % 1000 == 500:
            b.pair(2, 100 + 2 * i, 150 + 2 * i, b.next_panel())
        else:
            s = "A" * 70 + "".join(rng.choice(list("ACGT"), 30))
            b.pair(2, 100 + 2 * i, 150 + 2 * i, (f"l{i}", s, s))
    for _ in range(5):
        b.unaligned_pair(b.next_panel())
    return b.write(path)


CASES = {
    "mixed": (dict(), dict(bc_field="CB", umi_field="UB")),
    "no_tags_asked": (dict(), dict()),
    "single_end": (dict(single=True), dict(bc_field="CB", umi_field="UB")),
    "abnormal_unmap_flag": (dict(split_unaligned=True),
                            dict(abnormal_unmap_flag=True, bc_field="CB")),
    "mate_id_suffix_len_2": (dict(suffix=("/1", "/2")),
                             dict(mate_id_len=2, umi_field="UB")),
    "no_qualities": (dict(quals=False), dict(bc_field="CB")),
    "flush_boundary": (None, dict(bc_field="CB", umi_field="UB")),
}


@pytest.fixture
def coord(tmp_path):
    path = str(tmp_path / "coord.fa")
    write_coord(path)
    return path


@pytest.fixture(scope="module")
def flush(tmp_path_factory):
    """(path, record count) of the flush_bam BAM."""
    path = str(tmp_path_factory.mktemp("flush") / "flush.bam")
    return path, flush_bam(path)


def _outputs(prefix):
    got = {}
    for suffix in OUTPUTS:
        if os.path.exists(prefix + suffix):
            with open(prefix + suffix, "rb") as f:
                got[suffix] = f.read()
    return got


@pytest.mark.parametrize("case", sorted(CASES))
def test_extraction_matches_jax_native(tmp_path, coord, flush, monkeypatch,
                                       case):
    build, kwargs = CASES[case]
    bam = flush[0]
    if build is not None:
        bam = str(tmp_path / "in.bam")
        mixed_bam(bam, **build)
    monkeypatch.setenv("T1K_BACKEND", "native")
    want = host_bam.extract_from_bam(bam, coord, coord,
                                     str(tmp_path / "host"), **kwargs)
    monkeypatch.delenv("T1K_BACKEND")
    got = port_bam.extract_from_bam(bam, coord, coord,
                                    str(tmp_path / "port"), backend="gpu",
                                    device="cpu", **kwargs)
    assert got == want and got["candidates"] > 0
    host, port = (_outputs(str(tmp_path / p)) for p in ("host", "port"))
    assert port == host
    assert port[".fq" if case == "single_end" else "_1.fq"]
    st = metrics().stages["extraction_screen"]
    assert st["candidate_count"] == got["candidates"]
    assert st["device_screened_reads"] > 0
    assert st["device_decided_reads"] > 0


@pytest.mark.parametrize("layout", ["mixed", "no_qualities",
                                    "single_end"])
def test_writer_matches_the_jax_package(tmp_path, layout):
    """The port's BamRecord and BamWriter write the JAX package's bytes
    for the same records."""
    build = {"mixed": {}, "no_qualities": dict(quals=False),
             "single_end": dict(single=True)}[layout]
    paths = [str(tmp_path / f"{p}.bam") for p in ("host", "port")]
    assert mixed_bam(paths[0], **build) == mixed_bam(paths[1], **build,
                                                     bam=port_bam)
    with open(paths[0], "rb") as f, open(paths[1], "rb") as g:
        assert f.read() == g.read()


LAYOUTS = {"mixed": {}, "no_qualities": dict(quals=False),
           "single_end": dict(single=True),
           "mate_id_suffix": dict(suffix=("/1", "/2"))}
RECORD_FIELDS = ("name", "flag", "tid", "pos", "mapq", "cigar", "mtid",
                 "mpos", "tlen", "seq", "qual", "tags")
RECORD_PROPERTIES = ("is_paired", "is_unmapped", "is_reverse",
                     "mate_reverse", "is_first_mate", "is_primary")
RECORD_METHODS = ("is_template_aligned", "is_aligned", "ref_span",
                  "original_seq", "original_qual")


def _record_view(rec):
    """A record's fields, flag properties and derived values."""
    return ([getattr(rec, k) for k in RECORD_FIELDS + RECORD_PROPERTIES]
            + [getattr(rec, k)() for k in RECORD_METHODS])


def typed_tags_bam(path):
    """Records with every aux type the decoder reads (A, c, C, s, S, i,
    I, f, Z, B arrays) and a CIGAR with every op, in BGZF blocks of the
    port's writer; returns the record count."""
    import struct

    hdr = port_bam.BamRecord("h", 0, 0, 0, 0, [], -1, -1, 0, "", None, {})
    w = port_bam.BamWriter(path, *CONTIGS, HEADER)
    w.write(hdr)
    aux = (b"XAA" + b"q" + b"XBc" + struct.pack("<b", -5)
           + b"XCC" + struct.pack("<B", 200)
           + b"XDs" + struct.pack("<h", -300) + b"XES" + struct.pack("<H", 60000)
           + b"XFi" + struct.pack("<i", -70000)
           + b"XGI" + struct.pack("<I", 3_000_000_000)
           + b"XHf" + struct.pack("<f", 1.5) + b"CBZACGT\x00"
           + b"XBB" + b"s" + struct.pack("<i", 3) + struct.pack("<3h", 1, 2, 3)
           + b"UBZumi1\x00")
    cigar = [(5, 4), (10, 0), (2, 1), (3, 2), (4, 3), (6, 7), (1, 8),
             (2, 6), (7, 5)]
    seq = "ACGTNACGTRYACGTACGT"
    name = b"typed\x00"
    data = struct.pack("<iiBBHHHiiii", 1, 1234, len(name), 33, 0,
                       len(cigar), 0x51, len(seq), 1, 1500, 400)
    data += name + b"".join(struct.pack("<I", (ln << 4) | op)
                            for ln, op in cigar)
    lookup = {c: i for i, c in enumerate(port_bam._SEQ_NIBBLE)}
    data += bytes((lookup[seq[i]] << 4)
                  | (lookup[seq[i + 1]] if i + 1 < len(seq) else 0)
                  for i in range(0, len(seq), 2))
    data += bytes(range(10, 10 + len(seq))) + aux
    w._buf += struct.pack("<i", len(data)) + data
    w.close()
    return 2


@pytest.mark.parametrize("layout", sorted(LAYOUTS) + ["typed_tags"])
def test_bam_reader_matches_the_jax_reader(tmp_path, layout):
    """The port's pure-Python BamReader and BamRecord (fields, flag
    properties, reference span, original orientation) against
    t1k_tpu.io.bam's on BAMs the port's writer wrote: paired, unmapped,
    reverse and tagged records; rewind reads them again."""
    path = str(tmp_path / "in.bam")
    if layout == "typed_tags":
        n = typed_tags_bam(path)
    else:
        n = mixed_bam(path, **LAYOUTS[layout], bam=port_bam)
    host = host_bam.BamReader(path)
    with port_bam.BamReader(path) as port:
        for k in ("header_text", "ref_names", "ref_lens", "name_to_tid"):
            assert getattr(port, k) == getattr(host, k), k
        want = [_record_view(r) for r in host]
        got = [_record_view(r) for r in port]
        assert got == want and len(got) == n
        port.rewind()
        assert [_record_view(r) for r in port] == want
    flags = {r[1] for r in want}
    if layout == "typed_tags":
        assert want[1][-3] == 10 + 3 + 4 + 6 + 1  # M D N = X
        assert want[1][RECORD_FIELDS.index("tags")]["XG"] == 3_000_000_000
    elif layout != "single_end":
        assert {0x63, 0x93, 0x4D, 0x8D} <= flags
    host._fh.close()


@pytest.mark.parametrize("tags", [("", ""), ("CB", "UB")],
                         ids=["no_tags", "cb_ub"])
def test_native_scans_match_the_jax_scanner(tmp_path, flush, tags):
    """BamScan.scan, scan_headers and NativeBamReader.scan_blocks against
    t1k_tpu.native's and t1k_tpu.io.bam's, batch for batch; the native
    reader's records against the pure-Python reader's."""
    from t1k_tpu import native as host_native
    from t1k_tpu_torch import native as port_native

    path = str(tmp_path / "in.bam")
    n = mixed_bam(path, bam=port_bam)

    def same_batches(a, b):
        assert (a is None) == (b is None)
        if a is None:
            return False
        for x, y in zip(a, b):
            if isinstance(x, dict):
                assert x.keys() == y.keys()
                for k in x:
                    assert np.array_equal(x[k], y[k]), k
            else:
                assert np.array_equal(x, y)
        return True

    for bam, cap in ((path, 37), (flush[0], 262144)):
        for mode in ("scan", "scan_headers"):
            host = host_native.BamScan(bam, *tags)
            port = port_native.BamScan(bam, *tags)
            assert port.ref_names == host.ref_names
            assert port.ref_lens == host.ref_lens
            assert port.header_text == host.header_text == HEADER
            batches = 0
            while True:
                a, b = (getattr(s, mode)(cap) for s in (host, port))
                if mode == "scan_headers" and a is not None:
                    a, b = [a], [b]
                if not same_batches(a, b):
                    break
                batches += 1
            assert batches >= (2 if bam == path else 1)
            host.close()
            port.close()
        host = host_bam.NativeBamReader(bam, *tags)
        port = port_bam.NativeBamReader(bam, *tags)
        for k in ("path", "header_text", "ref_names", "ref_lens"):
            assert getattr(port, k) == getattr(host, k), k
        for _ in range(2):  # and again after rewind
            blocks = list(port.scan_blocks())
            want = list(host.scan_blocks())
            assert len(blocks) == len(want)
            for a, b in zip(want, blocks):
                same_batches(a, b)
            port.rewind()
            host.rewind()
    # the scanner's records against the pure-Python decoder's
    views = list(port_bam.NativeBamReader(path, "CB", "UB"))
    with port_bam.BamReader(path) as reader:
        recs = list(reader)
    assert len(views) == len(recs) == n
    for v, r in zip(views, recs):
        assert (v.name, v.flag, v.tid, v.pos, v.mapq, v.mtid, v.mpos,
                v.tlen, v.seq) == (r.name, r.flag, r.tid, r.pos, r.mapq,
                                   r.mtid, r.mpos, r.tlen, r.seq)
        assert [getattr(v, k) for k in RECORD_PROPERTIES[:1]
                + RECORD_PROPERTIES[2:]] == [
            getattr(r, k) for k in RECORD_PROPERTIES[:1]
            + RECORD_PROPERTIES[2:]]
        assert (v.ref_span(), v.original_seq(), v.original_qual(),
                v.is_aligned(), v.is_template_aligned()) == (
            r.ref_span(), r.original_seq(), r.original_qual(),
            r.is_aligned(), r.is_template_aligned())
        assert v.tags.get("__bc__") == r.tags.get("CB")
        assert v.tags.get("__umi__") == r.tags.get("UB")


@pytest.mark.parametrize("min_reads", ["0", "40000", "10000000"])
def test_auto_gate_counts_screened_reads(tmp_path, coord, flush,
                                         monkeypatch, min_reads):
    """Under "auto" on a card (the presence verdict injected, the screen's
    build a stub), the gate receives at each flush the reads that go to
    the screen, as the JAX package's gate does (the off-target records
    never count), and opens once T1K_SCREEN_DEVICE_MIN_READS of them
    have been screened; the outputs stay the native route's."""
    import t1k_tpu.core.extractor as host_extractor

    bam, n_records = flush
    seen = {"port": [], "jax": []}
    built = []

    def spy(real, key, stub=None):
        def factory(backend, build, *device):
            get = real(backend, stub or build, *device)

            def counted(n_new):
                seen[key].append(n_new)
                return get(n_new)

            return counted

        return factory

    for var in ("T1K_BACKEND", "T1K_GPU_PRESENT"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("T1K_GPU_PRESENT", "1")
    monkeypatch.setenv("T1K_SCREEN_DEVICE_MIN_READS", min_reads)
    monkeypatch.setattr(port_bam, "lazy_device_screen",
                        spy(port_bam.lazy_device_screen, "port",
                            lambda: built.append(1)))
    port_bam.extract_from_bam(bam, coord, coord, str(tmp_path / "port"),
                              backend="auto")
    monkeypatch.setenv("T1K_BACKEND", "native")
    monkeypatch.setattr(host_extractor, "lazy_device_screen",
                        spy(host_extractor.lazy_device_screen, "jax"))
    host_bam.extract_from_bam(bam, coord, coord, str(tmp_path / "host"))
    got = seen["port"]
    assert got == seen["jax"] and len(got) >= 2
    # the flush BAM's 10,000 off-target records never reach the screen
    assert sum(got) <= n_records - 10_000
    # the gate opens at the first flush whose earlier reads reach it
    want = int(any(sum(got[:i]) >= int(min_reads) for i in range(len(got))))
    assert len(built) == want
    assert want == (min_reads != "10000000")
    assert _outputs(str(tmp_path / "port")) == _outputs(
        str(tmp_path / "host"))


@pytest.mark.parametrize("package", ["port", "jax"])
def test_split_unaligned_pair_is_an_error(tmp_path, coord, monkeypatch,
                                          package):
    bam = str(tmp_path / "split.bam")
    mixed_bam(bam, split_unaligned=True)
    monkeypatch.setenv("T1K_BACKEND", "native")
    extract = (port_bam if package == "port" else host_bam).extract_from_bam
    with pytest.raises(RuntimeError, match="Two reads from the unaligned "
                       "fragment are not showing up together"):
        extract(bam, coord, coord, str(tmp_path / "x"))


def test_bamextract_cli_matches_the_jax_cli(tmp_path, coord, monkeypatch,
                                           capsys):
    from t1k_tpu.cli.bamextract import main as host_main
    from t1k_tpu_torch.cli.bamextract import main

    bam = str(tmp_path / "in.bam")
    mixed_bam(bam)
    args = ["-b", bam, "-f", coord, "--barcode", "CB", "--UMI", "UB"]
    monkeypatch.setenv("T1K_BACKEND", "native")
    assert host_main([*args, "-o", str(tmp_path / "host")]) == 0
    monkeypatch.delenv("T1K_BACKEND")
    assert main([*args, "-o", str(tmp_path / "port"), "--backend", "gpu",
                 "--device", "cpu"]) == 0
    assert "extracted" in capsys.readouterr().err
    assert _outputs(str(tmp_path / "port")) == _outputs(
        str(tmp_path / "host"))


def test_bamextract_auto_without_a_card_exits_before_any_output(
        tmp_path, coord, monkeypatch, capsys):
    import torch

    from t1k_tpu_torch.cli.bamextract import main

    for var in ("T1K_BACKEND", "T1K_GPU_PRESENT"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    bam = str(tmp_path / "in.bam")
    mixed_bam(bam)
    with pytest.raises(SystemExit) as exc:
        main(["-b", bam, "-f", coord, "-o", str(tmp_path / "x")])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert "--backend native" in err and "--device cpu" in err
    assert not any(n.startswith("x") for n in os.listdir(tmp_path))
