#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (t1k_tpu_torch) on one CUDA card.

  python3 chip_smoke.py

Phases, in order; any failure raises and the exit code is non-zero:
  1. card      nvidia-smi name and power limit, torch and CUDA versions
  2. build     nvcc builds csrc/band_stats.cu and csrc/em_squarem.cu for
               sm_90a and loads them
  3. kernel    band kernel vs its plain PyTorch version on the card, exact:
               the 400 golden alignment cases, 100,000 seeded deferred
               items through the descriptor service (W=32, rc-half
               descriptors included), and batches at W = 64, 128, 256
  4. em        f64 SQUAREM EM kernel on a seeded 5,000 read group x 900 EC
               problem (the HLA-scale EC matrix): the native f64 loop's
               iteration count and counts, bit for bit, and equal to the
               plain version on the CPU; kernel vs plain version on the
               card timed in turns
  5. main      the genotyper stage at HLA scale (24 genes x 240 alleles,
               12,000 read pairs of 100 bp) through
               t1k_tpu_torch.cli.genotype --backend gpu --emBackend gpu,
               byte-compared with the native route of t1k_tpu; both
               kernels' launch counts over the run must be > 0
  6. timing    band kernel vs plain version, in turns, on the largest
               deferred-item batch one engine chunk of the main path sends
Then the card line, one JSON line describing the kernels, and
{"ok": true, "device": {...}} as the last line.  Work files go to a
temporary directory that is removed at exit.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(ROOT, "tests", "data")
GOLDEN = os.path.join(ROOT, "tests", "golden")

PANEL_GENES = 24
PANEL_COPIES = 2          # x 120 source alleles = 240 alleles per gene
SIM_PAIRS = 12000
EM_RG, EM_EC = 5000, 900
RANDOM_ITEMS = 100_000

_LUT = np.full(256, 4, np.int8)
for _i, _b in enumerate(b"ACGT"):
    _LUT[_b] = _i
    _LUT[ord(chr(_b).lower())] = _i


def encode(seq: str) -> np.ndarray:
    return _LUT[np.frombuffer(seq.encode("ascii"), np.uint8)]


@contextlib.contextmanager
def phase(name: str):
    t0 = time.perf_counter()
    info = {}
    yield info
    extras = " ".join(f"{k}={v}" for k, v in info.items())
    print(f"[phase {name}] ok {time.perf_counter() - t0:.2f}s {extras}",
          flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def read_fasta(path: str):
    recs, name, comment, seq = [], None, "", []
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if line.startswith(">"):
                if name is not None:
                    recs.append((name, comment, "".join(seq)))
                head = line[1:].split(" ", 1)
                name, comment = head[0], head[1] if len(head) > 1 else ""
                seq = []
            else:
                seq.append(line)
    if name is not None:
        recs.append((name, comment, "".join(seq)))
    return recs


def build_panel(path: str, n_genes: int = PANEL_GENES,
                copies: int = PANEL_COPIES) -> None:
    """HLA-scale panel from the committed 3-gene panel: each gene gets its
    own seeded substitution set (the recipe of benchmarks/hla_scale.py),
    every source allele enters it `copies` times (later copies carry three
    extra seeded substitutions), and names stay unique within a gene."""
    src = read_fasta(os.path.join(DATA, "multigene_rna.fa"))
    rng = np.random.default_rng(7)
    with open(path, "w") as f:
        for gi in range(n_genes):
            gene = f"GEN{chr(65 + gi // 26)}{chr(65 + gi % 26)}"
            n_mut = 40 * (gi % 6) + 25 * (gi // 6)
            pos = rng.integers(0, 1200, size=n_mut)
            sub = rng.integers(1, 4, size=n_mut)
            for c in range(copies):
                for si, (name, comment, seq) in enumerate(src):
                    s = list(seq)
                    extra = rng.integers(0, len(s), size=3 * (c > 0))
                    for p, d in list(zip(pos, sub)) + [(p, 1) for p in extra]:
                        if p < len(s) and s[p] in "ACGT":
                            s[p] = "ACGT"[("ACGT".index(s[p]) + d) % 4]
                    v = (si // 40) * copies + c + 1
                    allele = name.split("*")[1]
                    f.write(f">{gene}*{v}{allele} {comment}\n{''.join(s)}\n")


def simulate_reads(panel: str, prefix: str, n_pairs: int = SIM_PAIRS,
                   n_genes: int = 8) -> None:
    """Two alleles from each of `n_genes` genes, fixed seeds, through the
    shared simulator's command line."""
    names = [r[0] for r in read_fasta(panel)]
    rng = np.random.default_rng(13)
    chosen, abund = [], []
    for g in sorted({n.split("*")[0] for n in names})[:n_genes]:
        alleles = sorted(n for n in names if n.startswith(g + "*"))
        for j, p in enumerate(rng.choice(len(alleles), 2, replace=False)):
            chosen.append(alleles[p])
            abund.append(1.0 - 0.3 * j)
    subprocess.run(
        [sys.executable, "-m", "t1k_tpu.tools.simulate", "-f", panel,
         "-o", prefix, "-n", str(n_pairs), "--seed", "3", "--alleles",
         *chosen, "--abundances", *map(str, abund)],
        check=True, cwd=ROOT, env=child_env())


def child_env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    return env


def golden_windows():
    cases = []
    with open(os.path.join(GOLDEN, "align_global.tsv")) as f:
        for line in f:
            _, _, t, p, score, _ = line.rstrip("\n").split("\t")
            cases.append(("" if t == "-" else t, "" if p == "-" else p,
                          int(score)))
    n = len(cases)
    tc = np.zeros((n, max(len(c[0]) for c in cases) + 1), np.int8)
    pc = np.zeros((n, max(len(c[1]) for c in cases) + 1), np.int8)
    for i, (t, p, _) in enumerate(cases):
        tc[i, :len(t)] = encode(t)
        pc[i, :len(p)] = encode(p)
    tl = np.array([len(c[0]) for c in cases], np.int32)
    pl = np.array([len(c[1]) for c in cases], np.int32)
    return tc, tl, pc, pl, np.array([c[2] for c in cases], np.int32)


def random_items(n: int, rng, max_diff: int = 10):
    """Reference, reads and descriptors of `n` deferred-like items: text
    windows of a random reference, patterns that are mutated copies with
    |t_len - p_len| <= max_diff, half of them addressed through the rc
    half of the doubled read tensor."""
    ref = rng.integers(0, 4, 4_000_000).astype(np.int8)
    ref[rng.random(ref.size) < 0.002] = 4
    t_len = rng.integers(1, 255, n)
    p_len = np.clip(t_len + rng.integers(-max_diff, max_diff + 1, n), 1, 254)
    t_off = rng.integers(0, ref.size - 300, n)
    rc = rng.random(n) < 0.5
    reads = []
    for i in range(n):
        p = ref[t_off[i]:t_off[i] + p_len[i]].copy()
        mut = rng.random(p_len[i]) < 0.05
        p[mut] = rng.integers(0, 5, int(mut.sum()))
        # an rc item stores the reverse complement, so the rc half of the
        # doubled tensor holds the pattern itself
        reads.append(np.where(p < 4, 3 - p, p)[::-1] if rc[i] else p)
    lens = p_len.astype(np.int32)
    starts = np.zeros(n, np.int64)
    starts[1:] = np.cumsum(lens[:-1])
    return ref, np.concatenate(reads).astype(np.int8), starts, lens, \
        t_off, t_len, rc


def time_ms(fn, reps: int, dev) -> float:
    """Mean milliseconds of `fn` over `reps` calls: CUDA events on a card,
    the host clock on the CPU (rehearsals only)."""
    import torch

    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


class Checker:
    """Holds kernel outputs against the plain version's, exactly."""

    def __init__(self):
        self.max_err = 0

    def __call__(self, kernel_out, plain_out, what: str) -> None:
        err = int((kernel_out.long() - plain_out.long()).abs().max()) \
            if kernel_out.numel() else 0
        self.max_err = max(self.max_err, err)
        if err != 0:
            raise AssertionError(f"{what}: kernel differs from plain by {err}")


def phase_kernel(dev, check: Checker, n_random: int, info: dict) -> None:
    import torch

    from t1k_tpu_torch.ops import align_band as ab

    tc, tl, pc, pl, want = golden_windows()
    ref, reads, desc = ab._pack_windows(tc, tl, pc, pl, dev)
    ml, over = ab._window_class(tl, pl)
    w = ab.band_window(ml, over)
    for stats in (False, True):
        k_out = ab.band_stats(ref, reads, desc, ml, w, stats)
        check(k_out, ab.band_stats_plain(ref, reads, desc, ml, w, stats),
              f"golden stats={stats}")
        if not (k_out[0].cpu().numpy() == want).all():
            raise AssertionError("golden scores differ from the table")
    info["golden"] = len(want)

    rng = np.random.default_rng(2024)
    rref, rreads, starts, lens, t_off, t_len, rc = random_items(n_random, rng)
    svc = ab.DeferredDescService(dev)
    svc.set_ref(rref)
    svc.set_layout(starts, lens)
    base = svc.begin_batch(rreads)
    p_off = np.where(rc, base, 0) + starts
    match = svc.stats(t_off, t_len, p_off, lens)
    d = torch.from_numpy(
        np.stack([t_off, t_len, p_off, lens]).astype(np.int64)).to(dev)
    k_out = ab.band_stats(svc._ref, svc._reads, d, ab.DESC_ML, ab.DESC_W)
    p_out = ab.band_stats_plain(svc._ref, svc._reads, d, ab.DESC_ML,
                                ab.DESC_W)
    check(k_out, p_out, "random W=32")
    if not (match == (p_out[1].cpu().numpy() & 511)).all():
        raise AssertionError("service match counts differ from plain")
    info["random_items"] = n_random
    info["rc_items"] = int(rc.sum())

    for w in (64, 128, 256):
        n = 4096
        over = (w - 32) // 2
        t_len = rng.integers(40, 200, n)
        p_len = np.clip(t_len - rng.integers(0, over + 1, n), 1, None)
        tcw = rng.integers(0, 5, (n, 200)).astype(np.int8)
        pcw = tcw.copy()
        pcw[rng.random(pcw.shape) < 0.05] = 1
        ref, reads, desc = ab._pack_windows(tcw, t_len, pcw, p_len, dev)
        check(ab.band_stats(ref, reads, desc, 5, w),
              ab.band_stats_plain(ref, reads, desc, 5, w), f"W={w}")
    info["wide_windows"] = "64,128,256"


def phase_em(dev, n_rg: int, n_ec: int, info: dict):
    """Returns (max |kernel - plain|, kernel ms, plain ms)."""
    import torch

    from t1k_tpu_torch.core.genotyper import em_quantify
    from t1k_tpu_torch.ops import em

    rng = np.random.default_rng(5)
    n_alleles, n_genes, n_majors = 2 * n_ec, 24, n_ec // 3
    ec_to_alleles = [[] for _ in range(n_ec)]
    for a in range(n_alleles):
        ec_to_alleles[a % n_ec].append(a)
    offs, ecs = [0], []
    for _ in range(n_rg):
        ecs.extend(rng.choice(n_ec, size=int(rng.integers(1, 12)),
                              replace=False).tolist())
        offs.append(len(ecs))
    problem = dict(
        ec_to_alleles=ec_to_alleles,
        rg_ecs_csr=(np.array(offs, np.int64), np.array(ecs, np.int32)),
        rg_counts=rng.choice([1.0, 0.5, 2.0, 3.0], n_rg),
        allele_eff_len=rng.integers(900, 1400, n_alleles).astype(np.int32),
        allele_missing=np.zeros(n_alleles, np.int32),
        allele_weight=rng.integers(1, 4, n_alleles).astype(np.int32),
        allele_gene=(np.arange(n_alleles) % n_genes).astype(np.int32),
        allele_major=(np.arange(n_alleles) % n_majors).astype(np.int32),
        n_genes=n_genes, n_majors=n_majors)
    t0 = time.perf_counter()
    it_n, c_n = em_quantify(**problem)
    t_native = time.perf_counter() - t0
    it_k, c_k = em.em_quantify_gpu(**problem, device=dev)
    it_p, c_p = em.em_quantify_gpu(**problem, device="cpu")
    if not it_k == it_p == it_n:
        raise AssertionError(f"EM iterations: kernel {it_k}, plain {it_p}, "
                             f"native {it_n}")
    if not (np.array_equal(c_k, c_n) and np.array_equal(c_p, c_n)):
        raise AssertionError("EM counts differ from the native loop's")
    err = float(np.abs(c_k - c_p).max())

    tables = em.em_tables(**{k: v for k, v in problem.items()
                             if k != "allele_missing"})
    args = dict(tables, filter_frac=0.15, min_squarem_alpha=0.0,
                max_iterations=1000, device=dev, dtype=torch.float64)
    # on the CPU (rehearsals) both sides are the plain version
    run = em.squarem_cuda if dev.type == "cuda" else em.squarem_plain

    def kernel():
        return run(**args)

    def plain():
        return em.squarem_plain(**args)

    plain_ms = [time_ms(plain, 1, dev)]
    kernel_ms = [time_ms(kernel, 5, dev), time_ms(kernel, 5, dev)]
    plain_ms.append(time_ms(plain, 1, dev))
    info["iterations"] = it_k
    info["bit_identical_to_native"] = True
    info["kernel_ms"] = " ".join(f"{t:.3f}" for t in kernel_ms)
    info["plain_ms"] = " ".join(f"{t:.1f}" for t in plain_ms)
    info["native_ms"] = f"{t_native * 1e3:.3f}"
    return err, float(np.mean(kernel_ms)), float(np.mean(plain_ms))


def phase_main(dev, work: str, n_genes: int, copies: int, n_pairs: int,
               info: dict) -> int:
    """Port CLI vs native CLI on the HLA-scale panel; returns each
    kernel's launch count over the port's run."""
    from t1k_tpu_torch.cli import genotype as cli
    from t1k_tpu_torch.ops import align_band as ab
    from t1k_tpu_torch.ops import em

    panel = os.path.join(work, "panel.fa")
    build_panel(panel, n_genes, copies)
    simulate_reads(panel, os.path.join(work, "r"), n_pairs)
    fq1, fq2 = os.path.join(work, "r_1.fq"), os.path.join(work, "r_2.fq")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "t1k_tpu.cli.genotype", "-f", panel,
         "-1", fq1, "-2", fq2, "-o", os.path.join(work, "native"),
         "--backend", "native", "--emBackend", "native"],
        cwd=ROOT, env=child_env(), capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"native route failed:\n{proc.stderr[-4000:]}")
    t_native = time.perf_counter() - t0
    ab.launch_counts["band_stats"] = 0
    em.launch_counts["em_squarem"] = 0
    t0 = time.perf_counter()
    cli.main(["-f", panel, "-1", fq1, "-2", fq2, "-o",
              os.path.join(work, "port"), "--backend", "gpu",
              "--emBackend", "gpu", "--device", str(dev)])
    t_port = time.perf_counter() - t0
    launches = {"band_stats": ab.launch_counts["band_stats"],
                "em_squarem": em.launch_counts["em_squarem"]}
    for suffix in ("_genotype.tsv", "_allele.tsv", "_aligned_1.fa",
                   "_aligned_2.fa"):
        with open(os.path.join(work, "native" + suffix), "rb") as f:
            a = f.read()
        with open(os.path.join(work, "port" + suffix), "rb") as f:
            b = f.read()
        if a != b:
            raise AssertionError(f"{suffix} differs from the native route")
    metrics = {}
    for route in ("port", "native"):
        with open(os.path.join(work, f"{route}_metrics.json")) as f:
            metrics[route] = json.load(f)
    ra = metrics["port"]["read_assignment"]
    if ra["band_kernel_launches"] != launches["band_stats"]:
        raise AssertionError("metrics and wrapper disagree on launches")
    if dev.type == "cuda" and min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the main path never launched: "
                             f"{launches}")
    if ra["deferred_item_count"] <= 0:
        raise AssertionError("the main path deferred no DP item")
    with open(os.path.join(work, "port_genotype.tsv")) as f:
        info["genotype_rows"] = sum(1 for _ in f)
    info["alleles"] = n_genes * copies * 120
    info["pairs"] = n_pairs
    info["port_s"] = f"{t_port:.2f}"
    info["native_s"] = f"{t_native:.2f}"
    info["deferred_item_count"] = ra["deferred_item_count"]
    info["band_kernel_launches"] = launches["band_stats"]
    info["em_kernel_launches"] = launches["em_squarem"]
    info["em_iterations"] = metrics["port"]["em_quantification"][
        "em_iteration_count"]
    for route, m in metrics.items():
        print(f"  {route} stages: " + " ".join(
            f"{k}={v['seconds']}s" for k, v in m.items()), flush=True)
    return launches


def phase_timing(dev, check: Checker, work: str, n_reads: int,
                 info: dict):
    """Kernel vs plain version, in turns (plain, kernel, kernel, plain), on
    the largest batch of deferred items one engine chunk of the main path
    sends.  Returns (kernel ms, plain ms)."""
    import torch

    from t1k_tpu_torch.core import pipeline as tp
    from t1k_tpu_torch.ops import align_band as ab

    class Recorder(ab.DeferredDescService):
        largest = None

        def stats_async(self, t_off, t_len, p_off, p_len):
            if self.largest is None or len(t_len) > len(self.largest[1]):
                self.largest = [np.asarray(x, np.int64).copy()
                                for x in (t_off, t_len, p_off, p_len)]
            return super().stats_async(t_off, t_len, p_off, p_len)

    rec = Recorder(dev)
    seqs = [r.seq for r in tp.read_seq_files([os.path.join(work, "r_1.fq")])]
    refset = tp.RefSet.from_fasta(os.path.join(work, "panel.fa"))
    engine = tp.NativeEngine(refset.packed(), tp.GENOTYPER_KMER_LENGTH)
    tp.assign_unique_reads(engine, seqs[:n_reads], "gpu", rec,
                           store_results=False,
                           defer_chunk=tp.GenotypeOptions().defer_chunk)
    d = torch.from_numpy(np.stack(rec.largest)).to(dev)

    def kernel():
        return ab.band_stats(rec._ref, rec._reads, d, ab.DESC_ML, ab.DESC_W)

    def plain():
        return ab.band_stats_plain(rec._ref, rec._reads, d, ab.DESC_ML,
                                   ab.DESC_W)

    check(kernel(), plain(), "main-path chunk")
    plain_ms = [time_ms(plain, 3, dev)]
    kernel_ms = [time_ms(kernel, 50, dev), time_ms(kernel, 50, dev)]
    plain_ms.append(time_ms(plain, 3, dev))
    info["items"] = int(d.shape[1])
    info["kernel_ms"] = " ".join(f"{t:.4f}" for t in kernel_ms)
    info["plain_ms"] = " ".join(f"{t:.2f}" for t in plain_ms)
    return float(np.mean(kernel_ms)), float(np.mean(plain_ms))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from t1k_tpu_torch.ops import _build
    from t1k_tpu_torch.ops import align_band as ab
    from t1k_tpu_torch.ops import em

    dev = torch.device("cuda")
    check = Checker()
    with phase("card") as info:
        print(card_line(), flush=True)
        info["torch"] = torch.__version__
        info["cuda"] = torch.version.cuda
        info["python"] = sys.version.split()[0]
    with phase("build") as info:
        for name, lib in (("band_stats", ab._kernel_lib),
                          ("em_squarem", em._kernel_lib)):
            t0 = time.perf_counter()
            lib()
            info[f"{name}_s"] = f"{time.perf_counter() - t0:.2f}"
            with open(os.path.join(_build.BUILD_DIR, f"{name}.log")) as f:
                for line in f:
                    if "registers" in line or "spill" in line:
                        print(f"  ptxas {name}:", line.strip(), flush=True)
    with phase("kernel") as info:
        phase_kernel(dev, check, RANDOM_ITEMS, info)
        torch.cuda.synchronize()
    with phase("em") as info:
        em_err, em_ms, em_plain_ms = phase_em(dev, EM_RG, EM_EC, info)
    with tempfile.TemporaryDirectory(prefix="t1k_smoke_") as work:
        with phase("main") as info:
            launches = phase_main(dev, work, PANEL_GENES, PANEL_COPIES,
                                  SIM_PAIRS, info)
        with phase("timing") as info:
            kernel_ms, plain_ms = phase_timing(dev, check, work, 8192, info)

    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    print(card_line())
    print(json.dumps({"kernels": [{
        "name": "band_stats", "route": "cuda",
        "source": "t1k_tpu_torch/csrc/band_stats.cu",
        "replaces": "t1k_tpu/ops/align_pallas_band.py:55",
        "launches": launches["band_stats"], "max_abs_err": check.max_err,
        "ms": kernel_ms, "plain_ms": plain_ms,
    }, {
        "name": "em_squarem", "route": "cuda",
        "source": "t1k_tpu_torch/csrc/em_squarem.cu",
        "replaces": "t1k_tpu/ops/em.py:213",
        "launches": launches["em_squarem"], "max_abs_err": em_err,
        "ms": em_ms, "plain_ms": em_plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
