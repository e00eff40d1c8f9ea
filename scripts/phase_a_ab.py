#!/usr/bin/env python3
"""Time this checkout's phase-A probe and chain kernels against another
checkout's, in turns, on one CUDA card.

  python3 scripts/phase_a_ab.py OTHER [--reps N] [--chunks C]

OTHER is a directory holding t1k_tpu_torch/csrc/phase_a_probe.cu and
phase_a_chain.cu with the same C interface (an earlier commit unpacked
with `git archive`, say).  Both versions are built with this checkout's
nvcc flags.  The inputs are chip_smoke.py's: the first C full 1024-row
chunks of mate 1 of its extraction cell (1,000,000 pairs against the
HLA-scale panel, k = 13 hashed table), each probed and expanded into the
[1024, 512] seed tile the chain kernel takes.  On every chunk each
version is first held exactly against the plain PyTorch version; then
the two are timed with CUDA events in turns (other, this, this, other),
`--reps` launches each.  Prints the card line and one JSON line of
milliseconds per launch, chunk by chunk.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def build_other(other: str, out_dir: str) -> dict:
    """nvcc the other checkout's two sources with this checkout's flags."""
    from t1k_tpu_torch.ops import _build

    libs = {}
    os.makedirs(out_dir, exist_ok=True)
    procs = []
    for name in ("phase_a_probe", "phase_a_chain"):
        src = os.path.join(other, "t1k_tpu_torch", "csrc", f"{name}.cu")
        out = os.path.join(out_dir, f"lib{name}_other.so")
        cmd = [_build._nvcc(), *_build.ARCH_FLAGS, *_build.FP_FLAGS,
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-o",
               out, src]
        procs.append((name, out, subprocess.Popen(cmd)))
    for name, out, proc in procs:
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed for the other {name}")
        libs[name] = ctypes.CDLL(out)
    return libs


def bind(libs: dict) -> dict:
    p = libs["phase_a_probe"].t1k_phase_a_probe
    p.restype = ctypes.c_int
    p.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    c = libs["phase_a_chain"].t1k_phase_a_chain
    c.restype = ctypes.c_int
    c.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    return {"probe": p, "chain": c}


def compare_chunk(reads, index, k: int, hlr: int, fns: dict, reps: int,
                  result: dict) -> int:
    """Check both versions on one chunk against the plain versions, then
    time them in turns; appends to `result`, returns the widest row."""
    import torch

    from t1k_tpu_torch.ops import phase_a as pa

    dev = index.device
    codes, lens = cs.pad_reads(reads)
    codes_d = torch.from_numpy(codes).to(dev)
    lens_d = torch.from_numpy(lens).to(dev)
    budgets = torch.from_numpy(np.trunc(lens * 0.2).astype(np.int32)
                               * k).to(dev)
    R, L = codes.shape
    W = L - k + 1
    want_probe = pa.probe_plain(codes_d, lens_d, index)
    a, b, nb, _, _ = pa.expand_buckets(want_probe[0], want_probe[1],
                                       int(want_probe[2].sum()), index, hlr,
                                       512)
    core, budget = pa.chain_rows_plain(a, b, nb, lens_d, budgets, k=k,
                                       radius=10, hit_len_required=hlr)
    want_chain = torch.stack([(core & budget).any(dim=1),
                              core.any(dim=1)]).to(torch.int32)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def probe(fn):
        contrib = torch.empty((R, 2 * W), dtype=torch.int32, device=dev)
        cstart = torch.empty_like(contrib)
        tot = torch.zeros(R, dtype=torch.int32, device=dev)
        rc = fn(codes_d.data_ptr(), lens_d.data_ptr(), R, L, k,
                int(index.direct), index.starts.data_ptr(),
                index.keys.data_ptr(), index.hstart.data_ptr(),
                index.hcount.data_ptr(), index.hsize - 1, index.max_probe,
                contrib.data_ptr(), cstart.data_ptr(), tot.data_ptr(), stream)
        assert rc == 0, rc
        return contrib, cstart, tot

    def chain(fn):
        out = torch.empty((2, R), dtype=torch.int32, device=dev)
        rc = fn(a.data_ptr(), b.data_ptr(), nb.data_ptr(), lens_d.data_ptr(),
                budgets.data_ptr(), R, a.shape[1], k, 10, hlr,
                out.data_ptr(), stream)
        assert rc == 0, rc
        return out

    for side, f in fns.items():
        for g, w in zip(probe(f["probe"]), want_probe):
            if not torch.equal(g, w):
                raise AssertionError(f"{side} probe differs from plain")
        if not torch.equal(chain(f["chain"]), want_chain):
            raise AssertionError(f"{side} chain differs from plain")
    for kernel, run in (("probe", probe), ("chain", chain)):
        ms = {"other": [], "this": []}
        for side in ("other", "this", "this", "other"):
            f = fns[side][kernel]
            ms[side].append(cs.time_ms(lambda: run(f), reps, dev))
        for side in ms:
            result[kernel][side].append(float(np.mean(ms[side])))
    return int(nb.max())


def main() -> int:
    import torch

    from t1k_tpu_torch.core import extractor as tx
    from t1k_tpu_torch.ops import phase_a as pa

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--chunks", type=int, default=8)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("phase_a_ab: CUDA is not available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    this = {"phase_a_probe": pa._probe_lib(), "phase_a_chain": pa._chain_lib()}
    fns = {"this": bind(this),
           "other": bind(build_other(os.path.abspath(args.other),
                                     os.path.join(ROOT, "build", "ab")))}

    with tempfile.TemporaryDirectory(prefix="t1k_ab_") as work:
        panel = os.path.join(work, "panel.fa")
        cs.build_panel(panel)
        prefix = cs.extract_inputs(work, panel)
        rs = tx.RefSet(digit_units=-1, delimiter="")
        for name, comment, seq in cs.read_fasta(panel):
            rs.add_allele(name, seq, comment)
        k = max(tx.EXTRACTOR_KMER_LENGTH, rs.infer_kmer_length())
        hlr = max(tx.EXTRACTOR_HIT_LEN_PAIRED, cs.READ_LEN // 5, k)
        index = pa.PhaseAIndex.build(rs.packed(), k, dev)
        reads = cs.read_fastq_seqs(prefix + "_1.fq", 1024 * args.chunks)
    result = {"k": k, "reps": args.reps, "max_nb": [],
              "probe": {"other": [], "this": []},
              "chain": {"other": [], "this": []}}
    for lo in range(0, len(reads), 1024):
        chunk = [r.decode() for r in reads[lo:lo + 1024]]
        nb_max = compare_chunk(chunk, index, k, hlr, fns, args.reps, result)
        result["max_nb"].append(nb_max)
    print(cs.card_line())
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
