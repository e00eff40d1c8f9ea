"""The port's variant-panel database builder
(t1k_tpu_torch.db.variant_gene_db) against the JAX package's on the
recipe of tests/test_variant_gene_db.py, and the panel chain end to end:
the port exports the .dat, builds the rna fasta and genotypes simulated
pairs through the kernels' plain versions on the CPU (device="cpu"),
byte-identical to the JAX package's native route on its own build."""

import dataclasses
import itertools
import os

import numpy as np
import pytest

from t1k_tpu.db import variant_gene_db as host
from t1k_tpu_torch.db import variant_gene_db as port


def _model(mod):
    """The recipe of tests/test_variant_gene_db.py::_model: a 650 bp
    transcript (30 bp UTR, ATG, 160 non-stop codons, TAA, tail) over
    exons [200,449], [600,899], [1000,1099] of a 1,200 bp gene."""
    rng = np.random.default_rng(42)
    bases = np.array(list("ACGT"))
    non_stop = [c for c in ("".join(p) for p in itertools.product(
        "ACGT", repeat=3)) if c not in ("TAA", "TAG", "TGA")]
    utr5 = "".join(rng.choice(bases, 30))
    coding = "ATG" + "".join(rng.choice(non_stop, 160)) + "TAA"
    tail = "".join(rng.choice(bases, 650 - 30 - len(coding)))
    transcript = utr5 + coding + tail
    seq = list("".join(rng.choice(bases, 1200)))
    seq[200:450] = transcript[:250]
    seq[600:900] = transcript[250:550]
    seq[1000:1100] = transcript[550:650]
    return mod.TranscriptModel(genome="".join(seq),
                               exons=[(200, 449), (600, 899), (1000, 1099)],
                               utr5_len=30, gene="PANEL")


def _nonsyn(m, mod, cpos: int) -> str:
    """A substitution at cDNA position cpos that changes the protein."""
    wild = mod.build_allele(m, "")
    base = m.genome[m.cdna_to_dna(str(cpos))]
    for alt in "ACGT":
        if alt == base:
            continue
        rec = mod.build_allele(m, f"c.{cpos}{base}>{alt}")
        if rec.protein != wild.protein:
            return f"c.{cpos}{base}>{alt}"
    raise AssertionError(f"no non-synonymous alt at c.{cpos}")


def _fields(obj):
    return (type(obj).__name__, dataclasses.astuple(obj))


@pytest.fixture(scope="module")
def models():
    return _model(port), _model(host)


def _names(m):
    ref = m.genome
    snv = f"c.10{ref[239]}>{'A' if ref[239] != 'A' else 'G'}"
    b300 = ref[m.cdna_to_dna("300")]
    return {
        "snv": snv,
        "del": "c.10_12del",
        "del_ref": f"c.10_12del{ref[239:242]}",
        "del_one": "c.15del",
        "ins": "c.10_11insTTT",
        "dup": "c.10_12dup",
        "dup_one": "c.44dupA",
        "delins": "c.20_22delinsGA",
        "delins_one": "c.25delinsTT",
        "compound": f"c.[10_12del;300{b300}>{'A' if b300 != 'A' else 'C'}]",
        "intronic": f"c.220+5{ref[454]}>{'A' if ref[454] != 'A' else 'T'}",
        "intronic_minus": "c.221-3_221-1del",
        "utr": f"c.-5{ref[225]}>{'A' if ref[225] != 'A' else 'G'}",
        "exon3": "c.560_561insAAAA",
        "reference": "",
    }


def _bad_names(m):
    """Names that raise: unsupported, outside the transcript, a declared
    reference base that is not the gene's, an empty insertion, and a bad
    part of a compound."""
    wrong = "C" if m.genome[239] != "C" else "G"
    return ["c.10_12inv", "c.99999A>G", f"c.10{wrong}>T", "c.1_2ins",
            "c.[10del;5T]", f"c.10_11del{wrong}{wrong}"]


def test_translate_and_model_match(models):
    mp, mh = models
    for s in ("ATGAAATTTTAA", "ccATGGGGtagTT", "GGGG", "ATGNNNAAA", ""):
        assert port.translate(s) == host.translate(s)
    assert [_fields(r) for r in mp.regions] == \
        [_fields(r) for r in mh.regions]
    for token in ("1", "-1", "-30", "220", "221", "220+5", "221-3", "480",
                  "620"):
        assert mp.cdna_to_dna(token) == mh.cdna_to_dna(token)
    for token in ("621", "-31"):
        for m in models:
            with pytest.raises(ValueError, match="outside transcript"):
                m.cdna_to_dna(token)
    for pos in (0, 199, 200, 450, 1099, 1199):
        assert mp.region_index_of(pos) == mh.region_index_of(pos)


def test_from_coords_csv_matches(models, tmp_path):
    path = tmp_path / "coords.csv"
    path.write_text("type,pos1,pos2,label\nintron,451,600,i1\n"
                    "Exon ,601,900,e2\nexon,201,450,e1\nEXON,1001,1100,e3\n")
    got = port.TranscriptModel.from_coords_csv(str(path), models[0].genome,
                                               30, "PANEL")
    want = host.TranscriptModel.from_coords_csv(str(path), models[1].genome,
                                                30, "PANEL")
    assert _fields(got) == _fields(want)
    assert got.exons == [(200, 449), (600, 899), (1000, 1099)]


@pytest.mark.parametrize("case", sorted(_names(_model(host))))
def test_parse_apply_and_build_allele_match(models, case):
    mp, mh = models
    name = _names(mh)[case]
    if name:
        got = port.parse_cdna_variant(name, mp)
        want = host.parse_cdna_variant(name, mh)
        assert [_fields(e) for e in got] == [_fields(e) for e in want]
        seq, lengths = port.apply_edits(mp, got)
        assert (seq, lengths) == host.apply_edits(mh, want)
    a, b = port.build_allele(mp, name), host.build_allele(mh, name)
    assert _fields(a) == _fields(b)
    named = port.build_allele(mp, name, display_name="shown")
    assert _fields(named) == _fields(host.build_allele(mh, name, "shown"))


@pytest.mark.parametrize("case", range(6))
def test_bad_names_raise_alike(models, case):
    mp, mh = models
    name = _bad_names(mh)[case]
    with pytest.raises(ValueError) as got:
        port.build_allele(mp, name)
    with pytest.raises(ValueError) as want:
        host.build_allele(mh, name)
    assert str(got.value) == str(want.value)


def _variants(m, mod):
    return [
        {"cdna": _nonsyn(m, mod, 11), "name": "v1", "freq": 0.2},
        {"cdna": "c.50_52del", "name": "v2", "freq": 0.05},
        {"cdna": _nonsyn(m, mod, 331), "name": "v3", "freq": 0.001},
        {"cdna": "c.[10_12dup;400del]", "freq": "0.3"},
        {"cdna": "c.10_12inv", "name": "bad", "freq": 0.5},
    ]


@pytest.mark.parametrize("threshold", [0.01, 0.1, 1.0])
def test_expand_and_build_database_match(models, capsys, threshold):
    mp, mh = models
    vp, vh = _variants(mp, port), _variants(mh, host)
    assert port.expand_combined(vp, threshold) == \
        host.expand_combined(vh, threshold)
    capsys.readouterr()
    got = port.build_database(mp, vp, threshold)
    got_err = capsys.readouterr().err
    want = host.build_database(mh, vh, threshold)
    want_err = capsys.readouterr().err
    assert [_fields(r) for r in got] == [_fields(r) for r in want]
    assert got_err == want_err and "skipping c.10_12inv" in got_err
    no_ref = port.build_database(mp, vp, threshold, include_reference=False)
    assert [_fields(r) for r in no_ref] == [
        _fields(r) for r in host.build_database(mh, vh, threshold, False)]


def test_export_dat_matches(models, tmp_path):
    mp, mh = models
    records = port.build_database(mp, _variants(mp, port))
    port.export_dat(records, str(tmp_path / "port.dat"))
    host.export_dat(host.build_database(mh, _variants(mh, host)),
                    str(tmp_path / "jax.dat"))
    got = (tmp_path / "port.dat").read_bytes()
    assert got == (tmp_path / "jax.dat").read_bytes()
    assert got.count(b"//\n") == len(records) > 5


@pytest.mark.parametrize("suffix", [".tsv", ".csv", ".txt"])
def test_read_variant_table_matches(tmp_path, suffix):
    d = "\t" if suffix != ".csv" else ","
    path = tmp_path / f"variants{suffix}"
    rows = [["cdna", "name", "freq"], ["c.10_12del", "F508", "0.3"],
            [" c.11A>G | c.12C>T ", "", ""], ["c.50dup", "  ", "0.001"]]
    path.write_text("".join(d.join(r) + "\n" for r in rows))
    got = port.read_variant_table(str(path))
    assert got == host.read_variant_table(str(path))
    assert [v["cdna"] for v in got] == ["c.10_12del", "c.11A>G", "c.12C>T",
                                        "c.50dup"]


def test_cli_matches(models, tmp_path, capsys):
    """main() reads the genome through the port's own FASTA reader."""
    m = models[1]
    (tmp_path / "gene.fa").write_text(
        ">PANEL local\n" + "\n".join(m.genome[i:i + 70].lower()
                                     for i in range(0, len(m.genome), 70))
        + "\n")
    (tmp_path / "coords.csv").write_text(
        "type,pos1,pos2\nexon,201,450\nexon,601,900\nexon,1001,1100\n")
    (tmp_path / "v.tsv").write_text(
        f"cdna\tname\tfreq\n{_nonsyn(m, host, 11)}|c.50_52del\tv1\t0.2\n"
        "c.331del\t\t0.001\n")
    outs = {}
    for tag, mod in (("port", port), ("jax", host)):
        capsys.readouterr()
        out = tmp_path / f"{tag}.dat"
        assert mod.main(["--genome", str(tmp_path / "gene.fa"), "--coords",
                         str(tmp_path / "coords.csv"), "--variants",
                         str(tmp_path / "v.tsv"), "--gene", "PANEL",
                         "--utr5-len", "30", "--allele-threshold", "0.1",
                         "-o", str(out)]) == 0
        err = capsys.readouterr().err
        outs[tag] = (out.read_bytes(), err.replace(str(out), "OUT"))
    assert outs["port"] == outs["jax"]
    assert outs["port"][1] == "wrote 8 alleles to OUT\n"


def test_panel_chain_genotypes_alike(models, tmp_path):
    """.dat export -> rna fasta -> 300 simulated pairs -> genotyper with
    the CFTR-style options: the port throughout (plain versions on the
    CPU) against the JAX package's native route on its own build."""
    from t1k_tpu.core import pipeline as host_pipeline
    from t1k_tpu.db import parse_dat as host_parse
    from t1k_tpu_torch.core.pipeline import GenotypeOptions, run_genotyper
    from t1k_tpu_torch.db import parse_dat
    from t1k_tpu_torch.io.reads import read_seq_file, write_fastq
    from t1k_tpu_torch.tools.simulate import SimConfig, simulate_pairs

    mp, mh = models
    fasta = {}
    for tag, mod, parse, m in (("port", port, parse_dat, mp),
                               ("jax", host, host_parse, mh)):
        records = mod.build_database(m, [
            {"cdna": _nonsyn(m, mod, 11), "name": "v1", "freq": 0.2},
            {"cdna": "c.50_52del", "name": "v2", "freq": 0.05},
            {"cdna": _nonsyn(m, mod, 331), "name": "v3", "freq": 0.001}],
            0.01)
        dat = str(tmp_path / f"{tag}.dat")
        mod.export_dat(records, dat)
        fasta[tag] = str(tmp_path / f"{tag}_rna.fa")
        with open(fasta[tag], "w") as out:
            parse.build_allele_fasta(dat, out, parse.BuildOptions(mode="rna"))
    assert (tmp_path / "port.dat").read_bytes() == \
        (tmp_path / "jax.dat").read_bytes()
    with open(fasta["port"]) as a, open(fasta["jax"]) as b:
        assert a.read() == b.read()

    alleles = {r.id: r for r in read_seq_file(fasta["port"])}
    target = next(r.allele_id for r in records if ";" in r.name)
    r1, r2 = simulate_pairs([alleles["PANEL*0001:0001"], alleles[target]],
                            [1.0, 0.9], SimConfig(n_pairs=300, seed=3))
    fq1, fq2 = str(tmp_path / "p_1.fq"), str(tmp_path / "p_2.fq")
    write_fastq(fq1, r1)
    write_fastq(fq2, r2)
    common = dict(digit_units=1, delimiter=":", min_squarem_alpha=10.0)
    run_genotyper(fasta["port"], [fq1], [fq2], str(tmp_path / "port"),
                  GenotypeOptions(backend="gpu", em_backend="gpu",
                                  device="cpu", **common))
    host_pipeline.run_genotyper(
        fasta["jax"], [fq1], [fq2], str(tmp_path / "jax"),
        host_pipeline.GenotypeOptions(backend="native", em_backend="native",
                                      **common))
    for suffix in ("_genotype.tsv", "_allele.tsv"):
        got = (tmp_path / f"port{suffix}").read_bytes()
        assert got == (tmp_path / f"jax{suffix}").read_bytes(), suffix
    with open(tmp_path / "port_allele.tsv") as f:
        assert {line.split()[0] for line in f} == {target, "PANEL*0001:0001"}
