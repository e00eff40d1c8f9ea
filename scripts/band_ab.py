#!/usr/bin/env python3
"""The band kernel's wide-window path (csrc/band_stats.cu) on one CUDA
card: the lane-group kernel at each CPL (slots a lane) and block size,
in turns with the first design's warp kernel, each held exactly to the
plain version.

  python3 scripts/band_ab.py [--reps N] [--sizes 256,1024,4096,16384]
                             [--parent DIR] [--out FILE]

Batches: chip_smoke.py's wide batches (4,096 pairs at W = 64, 128 and
256, ML = 5); parallel/dryrun.py's shard slices (1,024, 512 and 256
pairs of 112 / 100 bases at ML = 10, W = 64); that shape and the W = 256
shape at each of --sizes pairs; at W = 32 chip_smoke.py's 100,000 random
deferred items (the route there is the thread kernels).  For each batch
every variant is compared with band_stats_plain on the card's tensors,
then timed with CUDA events (chip_smoke.time_ms) in turns: the variants
in order, then reversed.  The route (band_stats with the batch's
lengths: group_launch, group_cpl) is timed as "auto", and its kernel and
the item sort alone by torch.profiler.

With --parent (a checkout of an earlier commit, e.g. from git archive)
it first builds DIR's band_stats.cu with this checkout's nvcc flags and
prints, for each thread-kernel function (the W = 32 route and its item
sort), its registers in both builds and whether its SASS is the same
instruction for instruction (addresses and the sort kernels' template
names aside).  Then it times DIR's thread path (through its own C entry,
loaded with ctypes, an earlier interface than this checkout's) against
this checkout's, the two bit for bit equal, on three batches: the
genotyper's chunk as chip_smoke.py's timing phase builds it (8,192
simulated reads of the HLA-scale panel), the analyzer's batch as its
run_profile phase records it (the port's run-t1k chain on the run
phase's 250,000 pairs, then the analyzer) and the 100,000 random items.
Each batch is timed in three rounds of turns (parent, this, this,
parent) on the caller's stream as it is and again on a stream of the
highest priority; for each build and stream it then reads, by
torch.profiler over 20 calls, when the narrow kernel (on the library's
second stream) started after the wide one, how long the two ran
together and their span, and the host's microseconds a call with the
card held busy (the wrapper's own cost).

Variants: cplC_u / cplC_s, the group kernel at C slots a lane, its items
unsorted (all at the batch's widest class) or sorted by class and
length (each row's count pass overlaps the next row's score pass at C
<= 2, the two run one after the other at 4 and 8).  Prints the card
line, the library's nvcc seconds and each kernel's registers and
spills, a line a batch, and one JSON line (card, registers); --out
writes every reading to FILE as JSON.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

def ptxas_report(log_path: str) -> dict:
    """{kernel: "N registers, S spill bytes"} from the build log."""
    with open(log_path) as f:
        lines = f.read().splitlines()
    names, out, fn = [], {}, None
    for line in lines:
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            fn = m.group(1)
            names.append(fn)
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and fn:
            out[fn] = f"spill {m.group(1)}"
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            out[fn] = f"{m.group(1)} registers, {out.get(fn, 'spill ?')}"
    filt = shutil.which("c++filt")
    if filt and names:
        plain = subprocess.run([filt], input="\n".join(names),
                               capture_output=True, text=True).stdout.split(
                                   "\n")
        out = {plain[names.index(k)] if names.index(k) < len(plain) else k: v
               for k, v in out.items()}
    return out


def thread_sass(lib: str) -> dict:
    """{thread-kernel function: [instructions]} of a built library's SASS:
    thread_narrow_kernel, thread_wide_kernel and the thread kernels' sort
    (keyed by their names without template arguments)."""
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import sass_mix
    from t1k_tpu_torch.ops import _build

    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", lib], check=True,
                          capture_output=True, text=True).stdout
    out = {}
    for func, insns in sass_mix.listing(sass).items():
        for name in ("thread_narrow_kernel", "thread_wide_kernel",
                     "sort_count_kernel", "sort_scan_kernel",
                     "sort_scatter_kernel"):
            if name not in func or "GroupBins" in func or "1536" in func:
                continue
            stats = "ILb1E" in func or "Lb1E" in func
            key = name + ("<true>" if "thread" in name and stats else
                          "<false>" if "thread" in name else "")
            out[key] = [f"{op}{args}" for _, op, args in insns]
    return out


def parent_report(parent: str) -> dict:
    """Builds `parent`'s csrc/band_stats.cu with this checkout's flags and
    compares its thread kernels with this checkout's build: registers
    (from each build's ptxas lines) and SASS."""
    from t1k_tpu_torch.ops import _build

    ours = _build.build("band_stats")
    src = os.path.join(parent, "t1k_tpu_torch", "csrc", "band_stats.cu")
    lib = os.path.join(_build.BUILD_DIR, "libband_stats_parent.so")
    cmd = [_build._nvcc(), *_build.ARCH_FLAGS, *_build.FP_FLAGS,
           "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas",
           "-v", "-o", lib, src]
    log = subprocess.run(cmd, check=True, capture_output=True, text=True)
    plog = os.path.join(_build.BUILD_DIR, "band_stats_parent.log")
    with open(plog, "w") as f:
        f.write(f"{' '.join(cmd)}\n\n{log.stdout}{log.stderr}")
    regs = {"parent": ptxas_report(plog), "this": ptxas_report(
        os.path.join(_build.BUILD_DIR, "band_stats.log"))}
    a, b = thread_sass(lib), thread_sass(ours)
    same = {k: a.get(k) == b.get(k) for k in sorted(set(a) | set(b))}
    thread_regs = {side: {k: v for k, v in r.items()
                          if "thread_" in k or ("sort_" in k and
                                                "Group" not in k)}
                   for side, r in regs.items()}
    return {"sass_identical": same, "registers": thread_regs}, lib


def parent_thread(lib_path: str):
    """The thread path of a library with the earlier C entry
    (t1k_band_stats(ref, reads, desc, n, ml, w, stats, thread, scratch,
    out, stream), t1k_band_order_ints()), wrapped as this checkout's
    wrapper wraps its own: (ref, reads, desc, ml, w) -> int32 [2, n]."""
    import ctypes

    import torch

    lib = ctypes.CDLL(lib_path)
    lib.t1k_band_order_ints.restype = ctypes.c_int
    lib.t1k_band_order_ints.argtypes = []
    lib.t1k_band_stats.restype = ctypes.c_int
    lib.t1k_band_stats.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]

    def run(ref, reads, desc, ml, w):
        n = int(desc.shape[1])
        out = torch.empty((2, n), dtype=torch.int32, device=ref.device)
        scratch = torch.empty(lib.t1k_band_order_ints() + n,
                              dtype=torch.int32, device=ref.device)
        rc = lib.t1k_band_stats(
            ref.data_ptr(), reads.data_ptr(), desc.data_ptr(), n, ml, 32, 1,
            1, scratch.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"parent band_stats failed: CUDA error {rc}")
        return out
    return run


def host_us(fn, reps: int) -> float:
    """Host microseconds a call of `fn` while the card is held busy by a
    spin kernel (about 0.1 s), so no call waits on the card: the
    wrapper's own cost."""
    import torch

    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t * 1e6 / reps


def thread_turns(parent_lib: str, batches, reps: int) -> dict:
    """The parent's thread path and this checkout's on each (name, ref,
    reads, desc) batch at the descriptor route's (ML, W), each pair of
    outputs equal: three rounds of turns (parent, this, this, parent) on
    the current stream and on a stream of the highest priority, then each
    build's thread_timeline (chip_smoke.py) and host_us on both."""
    import torch

    from t1k_tpu_torch.ops import align_band as ab

    dev = torch.device("cuda")
    parent = parent_thread(parent_lib)
    streams = {"current": None,
               "high": torch.cuda.Stream(dev, priority=-100)}
    out = {}
    for name, ref, reads, desc in batches:
        args = (ref, reads, desc, ab.DESC_ML, ab.DESC_W)
        fns = {"parent": lambda: parent(*args),
               "this": lambda: ab.band_stats(*args)}
        if not torch.equal(fns["parent"](), fns["this"]()):
            raise AssertionError(f"{name}: the parent's thread path differs")
        rec = {"n": int(desc.shape[1])}
        for sname, stream in streams.items():
            ctx = (torch.cuda.stream(stream) if stream is not None
                   else contextlib.nullcontext())
            with ctx:
                ms = {k: [] for k in fns}
                for _ in range(3):
                    for key in ("parent", "this", "this", "parent"):
                        ms[key].append(cs.time_ms(fns[key], reps, dev))
                rec[sname] = dict(ms=ms, **{
                    f"{k}_timeline": cs.thread_timeline(fn, 20)
                    for k, fn in fns.items()}, **{
                    f"{k}_host_us": host_us(fn, 50) for k, fn in fns.items()})
            torch.cuda.synchronize()
            print(f"[threads {name} {sname}] n={rec['n']} " + " ".join(
                f"{k}=" + "/".join(f"{t:.4f}" for t in v)
                for k, v in ms.items()), flush=True)
            for k in fns:
                print(f"  {k}: host {rec[sname][k + '_host_us']:.1f} us a "
                      f"call, timeline {json.dumps(rec[sname][k + '_timeline'])}",
                      flush=True)
        out[name] = rec
    return out


def analyzer_batch(dev, work: str):
    """The analyzer's largest batch of deferred items as chip_smoke.py's
    run_profile phase records it: the port's run-t1k chain on the run
    phase's pairs (a child process), then the analyzer on its outputs.
    Needs <work>/panel.fa."""
    panel = os.path.join(work, "panel.fa")
    prefix = cs.extract_inputs(work, panel, cs.EXTRACT_PAIRS, tag="run",
                               snp_genes=cs.SNP_GENES, barcodes=True)
    subprocess.run(
        [sys.executable, "-m", "t1k_tpu_torch.cli.run", "-f", panel,
         "-1", prefix + "_1.fq", "-2", prefix + "_2.fq", "--barcode",
         prefix + "_bc.fq", "-o", "run", "--od", os.path.join(work, "rport"),
         "--backend", "gpu", "--emBackend", "gpu", "--device", str(dev)],
        check=True, cwd=ROOT, env=cs.child_env(), capture_output=True)
    return cs.phase_run_profile(dev, work, {})


def batches(rng, sizes):
    """(name, t_codes, t_lens, p_codes, p_lens, ML, W) for the byte-window
    batches."""
    from t1k_tpu_torch.parallel import dryrun

    out = []
    for w in (64, 128, 256):
        tc, tl, pc, pl = cs.wide_windows(rng, w)
        out.append((f"wide_W{w}", tc, tl, pc, pl, 5, w))
    tc, tl, pc, pl = dryrun.example_batch(dryrun.B, dryrun.LT, dryrun.LP)
    for n in (1024, 512, 256):
        out.append((f"dryrun_{n}", tc[:n], tl[:n], pc[:n], pl[:n],
                    dryrun.ML, dryrun.W))
    for n in sizes:
        tc, tl, pc, pl = dryrun.example_batch(n, dryrun.LT, dryrun.LP,
                                              seed=n)
        out.append((f"dryshape_{n}", tc, tl, pc, pl, dryrun.ML, dryrun.W))
        tc, tl, pc, pl = cs.wide_windows(rng, 256, n)
        out.append((f"wide256_{n}", tc, tl, pc, pl, 5, 256))
    return out


def main() -> int:
    import torch

    from t1k_tpu_torch.ops import _build
    from t1k_tpu_torch.ops import align_band as ab

    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--sizes", default="256,1024,4096,16384")
    ap.add_argument("--parent", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    parent_lib = None
    if args.parent:
        rep, parent_lib = parent_report(args.parent)
        print(json.dumps({"parent": rep}), flush=True)
    if not torch.cuda.is_available():
        print("band_ab: CUDA is not available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    print(cs.card_line(), flush=True)
    _build.build("band_stats")
    log = os.path.join(_build.BUILD_DIR, "band_stats.log")
    with open(log) as f:
        print("nvcc band_stats:", f.read().splitlines()[1], flush=True)
    regs = ptxas_report(log)
    for k, v in regs.items():
        print(f"  {k}: {v}", flush=True)

    rng = np.random.default_rng(2024)
    sizes = [int(x) for x in args.sizes.split(",") if x]
    cases = []
    for name, tc, tl, pc, pl, ml, w in batches(rng, sizes):
        ref, reads, desc = ab._pack_windows(tc, tl, pc, pl, dev)
        cases.append((name, ref, reads, desc, ml, w, tl, pl))
    # W = 32: the thread kernels' route beside the group kernel, forced
    rref, rreads, starts, lens, t_off, t_len, rc = cs.random_items(
        100_000, rng)
    svc = ab.DeferredDescService(dev)
    svc.set_ref(rref)
    svc.set_layout(starts, lens)
    base = svc.begin_batch(rreads)
    p_off = np.where(rc, base, 0) + starts
    d = torch.from_numpy(np.stack([t_off, t_len, p_off, lens]).astype(
        np.int64)).to(dev)
    cases.append(("random_W32", svc._ref, svc._reads, d, ab.DESC_ML,
                  ab.DESC_W, t_len, lens))

    result = {"card": cs.card_line(), "registers": regs, "batches": {}}
    if parent_lib:
        import tempfile

        with tempfile.TemporaryDirectory(prefix="band_ab_") as work:
            cs.build_panel(os.path.join(work, "panel.fa"))
            cs.simulate_reads(os.path.join(work, "panel.fa"),
                              os.path.join(work, "r"))
            cref, creads, cdesc = cs.main_path_chunk(dev, work, 8192)
            aref, areads, adesc = analyzer_batch(dev, work)
        result["threads"] = thread_turns(parent_lib, [
            ("genotyper_chunk", cref, creads,
             torch.from_numpy(cdesc).to(dev)),
            ("analyzer_batch", aref, areads,
             torch.from_numpy(adesc).to(dev)),
            ("random_W32", svc._ref, svc._reads, d)], 50)
    for name, ref, reads, desc, ml, w, tl, pl in cases:
        n = int(desc.shape[1])
        kw = ab.kernel_window(w)
        auto_cpl, max_slots, auto_sort = ab.group_launch(tl, pl, ml, kw)
        fns = {"warp": lambda: ab._band_stats_warp_cuda(ref, reads, desc,
                                                         ml, w)}
        if kw == 32:
            fns["thread"] = lambda: ab.band_stats(ref, reads, desc, ml, w)
            fns["auto"] = lambda: ab._band_stats_group_cuda(
                ref, reads, desc, ml, w, max_slots=max_slots, cpl=auto_cpl,
                sort=auto_sort)
        else:
            fns["auto"] = lambda: ab.band_stats(ref, reads, desc, ml, w,
                                                lengths=(tl, pl))
        for cpl in ab.GROUP_CPL:
            if 32 * cpl < max_slots:
                continue
            for sort in (False, True):
                fns[f"cpl{cpl}_{'s' if sort else 'u'}"] = (
                    lambda cpl=cpl, sort=sort: ab._band_stats_group_cuda(
                        ref, reads, desc, ml, w, max_slots=max_slots,
                        cpl=cpl, sort=sort))
        want = ab.band_stats_plain(ref, reads, desc, ml, w)
        for key, fn in fns.items():
            got = fn()
            if not torch.equal(got, want):
                bad = int((got != want).any(0).sum())
                raise AssertionError(f"{name} {key}: {bad} items differ "
                                     "from plain")
        torch.cuda.synchronize()
        reps = args.reps if n >= 4096 else 4 * args.reps
        order = list(fns) + list(fns)[::-1]
        ms = {k: [] for k in fns}
        for key in order:
            ms[key].append(cs.time_ms(fns[key], reps, dev))
        slots = ab.window_slots(tl, pl, ml, kw)
        lanes = (ab.group_lanes(slots, auto_cpl) if auto_sort else
                 np.full(n, ab.group_lanes(max_slots, auto_cpl)))
        group_us = cs.kernel_device_us(fns["auto"], "group_kernel", 10)
        sort_us = cs.kernel_device_us(fns["auto"], "sort_", 10)
        cells = int((np.asarray(pl, np.int64) * (11 + np.abs(
            np.asarray(tl, np.int64) - pl))).sum())
        b_ms = cs.dp_bound(tl, pl, 40 * n)[0]
        rec = dict(n=n, ml=ml, w=w, kw=kw, max_slots=max_slots,
                   rows_max=int(np.max(pl)), band_cells=cells,
                   bound_ms=b_ms, auto=dict(cpl=auto_cpl, sort=auto_sort),
                   lanes=" ".join(f"G{g}:{int((lanes == g).sum())}"
                                  for g in (1, 2, 4, 8, 16, 32)
                                  if (lanes == g).any()),
                   ms={k: v for k, v in ms.items()},
                   group_us={k: v[0] for k, v in group_us.items()},
                   sort_us=sum(v[0] for v in sort_us.values()))
        result["batches"][name] = rec
        best = min((np.mean(v), k) for k, v in ms.items())
        print(f"[{name}] n={n} W={w} max_slots={max_slots} "
              f"auto=cpl{auto_cpl}_{'s' if auto_sort else 'u'} "
              f"{rec['lanes']} bound "
              f"{b_ms:.4f} best {best[1]} {best[0]:.4f} | " + " ".join(
                  f"{k}={v[0]:.4f}/{v[1]:.4f}" for k, v in ms.items()),
              flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(cs.card_line())
    print(json.dumps({k: result[k] for k in ("card", "registers")}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
