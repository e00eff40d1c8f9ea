#!/usr/bin/env python3
"""K11 (csrc/kmer_classify.cu) on one CUDA card: the gather ceiling, the
kernel's thread-mapping and loads-in-flight variants in turns with the
first design, and at k = 14 the centre-canonical layout against the
bitmap.

  python3 scripts/kmer_ab.py [--variants committed,kParts=2,kBatch=16]
                             [--ks 11,12,13,14,15,16] [--reps N]

1. The gather ceiling: a probe kernel that issues random 4-byte loads,
   from keys hashed in registers (no index array), into a buffer of a
   table's size that stays in L2 (8, 16 and 32 MB: the k = 13 bitmap,
   the k = 13 pair table, the k = 14 bitmap), 1, 2, 4 and 8 independent
   loads a thread (and 1 and 8 as ld.global.cg, past L1), 250,000
   threads, as many loads as the first design (176 a thread, two a
   window) and the pair table (88) issue on the run cell's reads.  Each
   reading's loads/s, and the bytes/s they would be if each load moved a
   32-byte L2 sector (a product, not a hardware counter).
2. Each variant is this checkout's kmer_classify.cu with constants
   rewritten before nvcc (NAME=VALUE pairs joined by "+": kThreads,
   kParts, kBatch, kTileWin), built with this checkout's nvcc flags, its
   register report printed.  At each k, on chip_smoke.py's run-cell
   reads (250,000 mate-1 reads of 100 bp from the HLA-scale panel) and
   on edge reads, every variant and the first design are held exactly
   to classify_plain, then timed with CUDA events in turns (first
   design, variants, then the same reversed).
3. At k = 14, where the kernel reads the centre-canonical layout (40 MB,
   one lookup a window), also the bitmap (32 MB, two lookups a window)
   in the kernel's thread loop, held and timed the same way.

Prints the card line and one JSON line.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

THREADS = 250_000               # one a read of the run cell
LOADS_PER_THREAD = (176, 88)    # two lookups a window / one, 88 windows
BUFFER_MB = (8, 16, 32)
ILPS = (1, 2, 4, 8)


def probe_source(kernel_src: str) -> str:
    """The gather probe and the bitmap entry (two bitmap words a window in
    the kernel's thread loop), compiled with a copy of kmer_classify.cu."""
    return f'''#include "{kernel_src}"

namespace {{

struct BitmapLookup {{  // k <= 14: a bitmap word for each strand
  uint32_t wf, wr;
  __device__ __forceinline__ void load(const uint32_t* __restrict__ t,
                                       uint32_t fk, uint32_t rk, bool ok,
                                       uint32_t) {{
    wf = ok ? __ldg(t + (fk >> 5)) : 0u;
    wr = ok ? __ldg(t + (rk >> 5)) : 0u;
  }}
  __device__ __forceinline__ bool probe(const uint32_t* __restrict__,
                                        uint32_t, uint32_t, uint32_t) {{
    return false;
  }}
  __device__ __forceinline__ void count(uint32_t fk, uint32_t rk, bool,
                                        int& n_fwd, int& n_rc) const {{
    n_fwd += (wf >> (fk & 31u)) & 1u;
    n_rc += (wr >> (rk & 31u)) & 1u;
  }}
}};

template <int ILP, bool L2_ONLY>
__global__ void gather_kernel(const uint32_t* __restrict__ buf, uint32_t mask,
                              int n_threads, int per_thread, uint32_t seed,
                              uint32_t* __restrict__ out) {{
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= n_threads) return;
  uint32_t x = (uint32_t)tid * 0x9E3779B9u ^ seed, acc = 0;
  for (int n = 0; n < per_thread; n += ILP) {{
    uint32_t w[ILP];
#pragma unroll
    for (int j = 0; j < ILP; ++j) {{
      x = x * 1664525u + 1013904223u;
      const uint32_t h = (x ^ (x >> 16)) * 0x45d9f3bu;
      const uint32_t* p = buf + ((h ^ (h >> 16)) & mask);
      w[j] = L2_ONLY ? __ldcg(p) : __ldg(p);
    }}
#pragma unroll
    for (int j = 0; j < ILP; ++j) acc += w[j];
  }}
  if (acc == 0xFFFFFFFFu) out[tid] = acc;  // keeps the loads
}}

}}  // namespace

extern "C" int t1k_kmer_classify_bitmap(
    const void* codes, const void* lens, int R, int L, int k, int,
    const void* table, int64_t mask, int max_probe, void* fwd, void* rc,
    void* stream) {{
  if (R <= 0) return 0;
  if (k > 14 || L < k) return (int)cudaErrorInvalidValue;
  classify_kernel<BitmapLookup><<<(R + kRows - 1) / kRows, kThreads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(codes), static_cast<const int32_t*>(lens), R,
      L, k, static_cast<const uint32_t*>(table), (uint32_t)mask, max_probe,
      static_cast<int32_t*>(fwd), static_cast<int32_t*>(rc));
  return (int)cudaGetLastError();
}}

// n_threads x per_thread loads (per_thread a multiple of ilp) into a
// power-of-two buffer of mask + 1 words; l2_only: ld.global.cg
extern "C" int t1k_gather_probe(const void* buf, int64_t mask, int n_threads,
                                int per_thread, int ilp, int l2_only,
                                void* out, void* stream) {{
  const unsigned grid = (unsigned)((n_threads + 255) / 256);
  auto* kernel =
      l2_only ? (ilp == 1 ? gather_kernel<1, true> : gather_kernel<8, true>)
      : ilp == 1 ? gather_kernel<1, false> : ilp == 2 ? gather_kernel<2, false>
      : ilp == 4 ? gather_kernel<4, false> : gather_kernel<8, false>;
  kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(buf), (uint32_t)mask, n_threads,
      per_thread, 12345u, static_cast<uint32_t*>(out));
  return (int)cudaGetLastError();
}}
'''


def build(variants, out_dir: str):
    """({variant: library}, probe library), one nvcc each, all at once."""
    from t1k_tpu_torch.ops import _build, kmer

    with open(os.path.join(_build.CSRC_DIR, "kmer_classify.cu")) as f:
        source = f.read()
    procs = {}
    srcs = {}
    for k, name in enumerate(variants):
        text = source
        for pair in name.split("+") if name != "committed" else ():
            key, value = pair.split("=")
            text, n = re.subn(rf"constexpr int {key} = \d+;",
                              f"constexpr int {key} = {int(value)};", text)
            if n != 1:
                raise RuntimeError(f"{key} not found in kmer_classify.cu")
        srcs[name] = os.path.join(out_dir, f"kmer_{k}.cu")
        with open(srcs[name], "w") as f:
            f.write(text)
    probe = os.path.join(out_dir, "probe.cu")
    with open(probe, "w") as f:
        f.write(probe_source(srcs[variants[0]]))
    for name, src in (*srcs.items(), ("probe", probe)):
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.ARCH_FLAGS, *_build.FP_FLAGS,
             "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
             "-Xptxas", "-v", "-o", src[:-3] + ".so", src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the {name} build:\n{log}")
        kernel = None
        for line in log.splitlines():   # each kernel's registers, spills
            if "Compiling entry function" in line:
                m = re.search(r"(classify_v1_kernel|classify_kernel\w*?"
                              r"(Pair|Bitmap|Hashed|Centre)|gather_kernel"
                              r"ILi(\d)ELb(\d))", line)
                kernel = m and (m.group(2) or (
                    f"gather ilp {m.group(3)} cg {m.group(4)}"
                    if m.group(3) else "v1"))
            elif kernel and ("registers" in line or "spill" in line):
                print(f"  ptxas {name} {kernel}:", line.split(":", 1)[-1]
                      .strip(), flush=True)
        libs[name] = ctypes.CDLL(srcs.get(name, probe)[:-3] + ".so")
    probe_lib = kmer.bind_kmer_lib(libs.pop("probe"),
                                   ("t1k_kmer_classify_bitmap",))
    probe_lib.t1k_gather_probe.restype = ctypes.c_int
    probe_lib.t1k_gather_probe.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    return {u: kmer.bind_kmer_lib(lib) for u, lib in libs.items()}, probe_lib


@contextlib.contextmanager
def kernel_of(lib):
    """ops.kmer's wrappers on a build's library."""
    from t1k_tpu_torch.ops import kmer

    saved = kmer._kmer_lib
    kmer._kmer_lib = lambda: lib
    try:
        yield
    finally:
        kmer._kmer_lib = saved


def gather_ceiling(probe_lib, dev, reps: int) -> dict:
    """ms, loads/s and loads/s x 32 B of each (buffer, loads, ilp)."""
    import torch

    out = {}
    sink = torch.zeros(THREADS, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for mb in BUFFER_MB:
        words = mb * 2 ** 20 // 4
        buf = torch.randint(0, 2 ** 31 - 1, (words,), dtype=torch.int32,
                            device=dev)
        for per_thread in LOADS_PER_THREAD:
            for ilp, l2_only in [(i, 0) for i in ILPS] + [(1, 1), (8, 1)]:
                def run(ilp=ilp, per_thread=per_thread, l2_only=l2_only):
                    err = probe_lib.t1k_gather_probe(
                        buf.data_ptr(), words - 1, THREADS, per_thread, ilp,
                        l2_only, sink.data_ptr(), stream)
                    if err:
                        raise RuntimeError(f"gather probe: CUDA error {err}")
                run()
                ms = cs.time_ms(run, reps, dev)
                loads = THREADS * per_thread
                tag = f"{mb}MB_{loads}_ilp{ilp}" + ("_cg" if l2_only else "")
                out[tag] = dict(ms=ms, loads_per_s=loads / ms * 1e3,
                                bytes_per_s_at_32_a_load=32 * loads / ms * 1e3)
                print(f"  gather {tag}: {ms:.4f} ms, "
                      f"{loads / ms * 1e3:.4g} loads/s, "
                      f"{32 * loads / ms * 1e-9:.4g} TB/s at 32 B a load",
                      flush=True)
    return out


def main() -> int:
    import torch

    from t1k_tpu_torch.core import extractor as tx
    from t1k_tpu_torch.ops import kmer

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants",
                    default="committed,kParts=1,kParts=2,kParts=8,kBatch=4,"
                            "kBatch=16,kThreads=256")
    ap.add_argument("--ks", default="11,12,13,14,15,16")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kmer_ab: CUDA is not available", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    variants = args.variants.split(",")
    print(cs.card_line(), flush=True)
    out = {"variants": variants}
    with tempfile.TemporaryDirectory(prefix="kmer_ab_") as tmp:
        libs, probe_lib = build(variants, tmp)
        out["gather"] = gather_ceiling(probe_lib, dev, args.reps)
        panel = os.path.join(tmp, "panel.fa")
        cs.build_panel(panel)
        prefix = cs.extract_inputs(tmp, panel, cs.EXTRACT_PAIRS, tag="run",
                                   snp_genes=cs.SNP_GENES, barcodes=True)
        rs = tx.RefSet(digit_units=-1, delimiter="")
        for name, comment, seq in cs.read_fasta(panel):
            rs.add_allele(name, seq, comment)
        packed = rs.packed()
        allele = packed.seq_codes[int(packed.seq_starts[0]):][
            :int(packed.seq_lens[0])]
        codes, lens = cs.fastq_codes(prefix + "_1.fq", sum(cs.EXTRACT_PAIRS))
        put = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
        reads = (put(codes), put(lens))
        rng = np.random.default_rng(21)
        out["reads"] = len(lens)
        for k in map(int, args.ks.split(",")):
            table = kmer.DeviceKmerTable.build(packed, k, device=dev)
            edges = [put(a) for a in cs.kmer_edge_reads(allele, k, rng)]
            runs = {"v1": lambda: kmer.classify_v1_cuda(table, *reads)}
            for u, lib in libs.items():
                def run(lib=lib):
                    with kernel_of(lib):
                        return kmer.classify_cuda(table, *reads)
                runs[u] = run
            if table.mode == kmer.MODE_CENTRE:
                bitmap = table.table

                def run_bitmap(c, n):
                    fwd = torch.empty(len(n), dtype=torch.int32, device=dev)
                    rc = torch.empty_like(fwd)
                    err = probe_lib.t1k_kmer_classify_bitmap(
                        c.data_ptr(), n.data_ptr(), len(n), c.shape[1], k, 0,
                        bitmap.data_ptr(), 0, kmer.MAX_PROBE, fwd.data_ptr(),
                        rc.data_ptr(), torch.cuda.current_stream(dev)
                        .cuda_stream)
                    if err:
                        raise RuntimeError(f"bitmap: CUDA error {err}")
                    return fwd, rc
                runs["bitmap"] = lambda: run_bitmap(*reads)
            for c, n in (reads, edges):
                want = kmer.classify_plain(table, c, n)
                for u in runs:
                    if u == "v1":
                        got = kmer.classify_v1_cuda(table, c, n)
                    elif u == "bitmap":
                        got = run_bitmap(c, n)
                    else:
                        with kernel_of(libs[u]):
                            got = kmer.classify_cuda(table, c, n)
                    torch.cuda.synchronize()
                    if not (torch.equal(got[0], want[0])
                            and torch.equal(got[1], want[1])):
                        raise AssertionError(f"k={k} {u}: differs from "
                                             "classify_plain")
            ms = {u: [] for u in runs}
            for turn in (list(runs), list(runs)[::-1]):
                for u in turn:
                    ms[u].append(cs.time_ms(runs[u], args.reps, dev))
            fwd, ok, _, _ = kmer.window_keys(*reads, k)
            windows = int(ok.sum())
            out[f"k{k}"] = dict(mode=table.mode, windows=windows,
                                table_bytes=4 * len(table.pair if table.pair
                                                    is not None
                                                    else table.table),
                                ms=ms)
            print(f"k={k} mode={table.mode} windows={windows}: " + " ".join(
                f"{u}={'/'.join(f'{t:.4f}' for t in v)}"
                for u, v in ms.items()), flush=True)
    print(cs.card_line())
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
