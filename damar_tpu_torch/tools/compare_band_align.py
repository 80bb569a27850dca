"""Time K4 against an earlier band_align.cu on the same launches.

    python3 -m damar_tpu_torch.tools.compare_band_align EARLIER.cu

EARLIER.cu is a version of damar_tpu_torch/csrc/band_align.cu with the
one-warp-a-pair C interface (band_align_launch taking max_band, a flag
byte scratch and its offsets), e.g. `git show
dddf3a0:damar_tpu_torch/csrc/band_align.cu`.  Needs one CUDA card.

It runs chip_smoke.py's phase 10b assembly once (run_pipeline with
polish from FASTA on the 300 kbp genome), keeping every K4 launch's
inputs.  Then it runs both kernels over every kept launch: each
launch's outputs (lengths, jstart and the ops) must be equal.  Then it
times the two in turns (new, earlier, earlier, new, new, earlier):
device time of each launch by CUDA events around it (the launches
queued ahead of the card), summed over the launches, the median of
three runs of each, over all launches, the
correct_reads launches, the polish and finishing launches, and the
first launch alone.  Last, the new kernel's launches once more with the
card idle before each (a sync, then events around the host's launch
call, as the pipeline's one-sync calls see them; chip_smoke.py's K4
events are taken so): the difference from the queued time is the host's
launch call inside such events.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from damar_tpu_torch.core.config import PipelineConfig
from damar_tpu_torch.ops import _cuda, band_align
from damar_tpu_torch.pipeline import consensus
from damar_tpu_torch.pipeline.run import run_pipeline
from damar_tpu_torch.utils.sim import make_genome, sample_reads, \
    write_sim_fasta

# chip_smoke.py's phase 10b unit
ASM_GENOME, ASM_SEED, ASM_REPEATS, ASM_TANDEMS = 300_000, 4040, 5, 2
COVERAGE, MEAN_LEN, ERR = 20.0, 6_000, 0.14

P_, I_ = ctypes.c_void_p, ctypes.c_int
EARLIER_SIGNATURE = [P_, P_, P_, P_, P_, I_, I_, I_, P_, P_, P_, P_, P_, P_,
                     P_]


def load_earlier(src: Path) -> ctypes.CDLL:
    tag = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    out = _cuda.BUILD_DIR / f"libearlier_k4_{tag}.so"
    if not out.exists():
        _cuda.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        _cuda._run_all([[_cuda._nvcc(), *_cuda.ARCH, "-std=c++17", "-O3",
                         "-shared", "-Xcompiler", "-fPIC", "-o", str(out),
                         str(src)]])
    lib = ctypes.CDLL(str(out))
    lib.band_align_launch.argtypes = EARLIER_SIGNATURE
    lib.band_align_launch.restype = ctypes.c_int
    return lib


def kept_launches(dev) -> list:
    """Phase 10b's assembly; every K4 launch's (a, a_off, b, b_off, band,
    plan, semiglobal, in correct_reads)."""
    w = tempfile.mkdtemp(prefix="damar_compare_k4_")
    kept, in_correct = [], [False]
    orig_launch, orig_correct = band_align._launch, consensus.correct_reads

    def spy(*a, **kw):
        kept.append((*a[:6], a[7], in_correct[0]))
        return orig_launch(*a, **kw)

    def correct(*a, **kw):
        in_correct[0] = True
        try:
            return orig_correct(*a, **kw)
        finally:
            in_correct[0] = False
    try:
        genome = make_genome(ASM_GENOME, seed=ASM_SEED,
                             n_repeats=ASM_REPEATS, repeat_len=1500,
                             tandem=ASM_TANDEMS, tandem_period=90,
                             tandem_len=1800)
        sim = sample_reads(genome, coverage=COVERAGE, mean_len=MEAN_LEN,
                           err=ERR, seed=ASM_SEED + 1, chimera_frac=0.06)
        total_bp = sum(len(r) for r in sim.reads)
        write_sim_fasta(f"{w}/reads.fasta", sim)
        cfg = PipelineConfig(block_mb=-(-total_bp // 2_000_000))
        band_align._launch, consensus.correct_reads = spy, correct
        t0 = time.time()
        run_pipeline(f"{w}/reads.fasta", w, cfg, polish=True,
                     verbose=False, device=dev)
        torch.cuda.synchronize()
        print(f"assembly: {time.time() - t0:.1f} s, {len(kept)} K4 "
              f"launches kept", flush=True)
    finally:
        band_align._launch, consensus.correct_reads = orig_launch, \
            orig_correct
        shutil.rmtree(w, ignore_errors=True)
    return kept


class Runs:
    """Both kernels' raw launches over the kept launches, with their
    arguments precomputed and scratch shared by all launches."""

    def __init__(self, kept: list, earlier: ctypes.CDLL, dev):
        self.kept, self.earlier, self.dev = kept, earlier, dev
        self.lib = _cuda.lib()
        self.stream = torch.cuda.current_stream(dev).cuda_stream
        T = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)  # noqa: E731
        self.new_meta, self.old_meta = [], []
        codes = flags = ops = 16
        for a, ao, b, bo, band, plan, semi, _ in kept:
            self.new_meta.append((T(plan.order), T(plan.c_off),
                                  T(plan.o_end)))
            fsz = (plan.m + 1) * (2 * plan.band + 1)
            self.old_meta.append((T(np.cumsum(fsz) - fsz),
                                  int(plan.band.max())))
            codes = max(codes, plan.code_bytes)
            flags = max(flags, int(fsz.sum()))
            ops = max(ops, plan.ops_bytes)
        P = max(len(k[5].band) for k in kept)
        u8, i32 = torch.uint8, torch.int32
        self.codes = torch.empty(codes, dtype=u8, device=dev)
        self.flags = torch.empty(flags, dtype=u8, device=dev)
        self.out = {k: (torch.empty(ops, dtype=u8, device=dev),
                        torch.empty(P, dtype=i32, device=dev),
                        torch.empty(P, dtype=i32, device=dev))
                    for k in ("new", "earlier")}

    def launch(self, which: str, i: int) -> None:
        a, ao, b, bo, band, plan, semi, _ = self.kept[i]
        ops, ln, js = self.out[which]
        if which == "new":
            order, c_off, o_end = self.new_meta[i]
            err = self.lib.band_align_launch(
                a.data_ptr(), ao.data_ptr(), b.data_ptr(), bo.data_ptr(),
                band.data_ptr(), order.data_ptr(), c_off.data_ptr(),
                o_end.data_ptr(), plan.n_narrow, plan.per_block,
                plan.n_wide, int(semi), plan.smem, self.codes.data_ptr(),
                ops.data_ptr(), ln.data_ptr(), js.data_ptr(), self.stream)
        else:
            f_off, max_band = self.old_meta[i]
            o_end = self.new_meta[i][2]
            err = self.earlier.band_align_launch(
                a.data_ptr(), ao.data_ptr(), b.data_ptr(), bo.data_ptr(),
                band.data_ptr(), len(plan.band), max_band, int(semi),
                self.flags.data_ptr(), f_off.data_ptr(), ops.data_ptr(),
                o_end.data_ptr(), ln.data_ptr(), js.data_ptr(),
                self.stream)
        _cuda.check(err, f"{which} band_align_kernel")

    def results(self, which: str, i: int) -> tuple:
        """(lengths, jstart, each pair's ops concatenated) on the host."""
        plan = self.kept[i][5]
        P = len(plan.band)
        ops, ln, js = self.out[which]
        ops = ops[:plan.ops_bytes].cpu().numpy()
        ln, js = ln[:P].cpu().numpy(), js[:P].cpu().numpy()
        ends = plan.o_end
        return ln, js, np.concatenate(
            [ops[e - n:e] for e, n in zip(ends, np.maximum(ln, 0))])

    def timed(self, which: str, sel: list) -> list:
        """Device ms of each launch in sel (CUDA events around each).  The
        stream first spins ~0.5 s on the card so that the host's launches
        queue up ahead of it and no gap of the host's enters a time."""
        ev = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in sel]
        torch.cuda._sleep(10 ** 9)
        for (e0, e1), i in zip(ev, sel):
            e0.record()
            self.launch(which, i)
            e1.record()
        torch.cuda.synchronize()
        return [e0.elapsed_time(e1) for e0, e1 in ev]

    def timed_idle(self, which: str, sel: list) -> list:
        """Device ms of each launch in sel with the card idle before it:
        a sync, then CUDA events around the host's launch call."""
        ev = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in sel]
        for (e0, e1), i in zip(ev, sel):
            torch.cuda.synchronize()
            e0.record()
            self.launch(which, i)
            e1.record()
        torch.cuda.synchronize()
        return [e0.elapsed_time(e1) for e0, e1 in ev]


def compare(src: Path, dev) -> dict:
    earlier = load_earlier(src)
    kept = kept_launches(dev)
    runs = Runs(kept, earlier, dev)
    bad = 0
    for i in range(len(kept)):
        got = {}
        for which in ("new", "earlier"):
            runs.launch(which, i)
            got[which] = runs.results(which, i)
        if not all(np.array_equal(x, y)
                   for x, y in zip(got["new"], got["earlier"])):
            bad += 1
    allsel = list(range(len(kept)))
    sets = {"all": allsel,
            "correct_reads": [i for i in allsel if kept[i][7]],
            "polish_and_finishing": [i for i in allsel if not kept[i][7]],
            "first": [0]}
    for which in ("new", "earlier"):          # warm-up
        runs.timed(which, allsel)
    t = {"new": [], "earlier": []}
    for which in ("new", "earlier", "earlier", "new", "new", "earlier"):
        t[which].append(np.array(runs.timed(which, allsel)))
    res = dict(launches=len(kept), launches_unequal=bad,
               pairs=int(sum(len(k[5].band) for k in kept)),
               first_launch_pairs=len(kept[0][5].band))
    for name, sel in sets.items():
        for which in ("new", "earlier"):
            res[f"{name}_{which}_ms"] = float(np.median(
                [x[sel].sum() for x in t[which]]))
        res[f"{name}_launches"] = len(sel)
    idle = float(np.median([sum(runs.timed_idle("new", allsel))
                            for _ in range(3)]))
    res["all_new_idle_ms"] = idle
    res["idle_minus_queued_us_per_launch"] = \
        1e3 * (idle - res["all_new_ms"]) / len(allsel)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("earlier", type=Path, help="the earlier band_align.cu")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("compare_band_align: no CUDA device")
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    res = compare(args.earlier, dev)
    print(f"band_align_kernel vs {args.earlier} on {card}: "
          f"{json.dumps(res)}", flush=True)
    if res["launches_unequal"]:
        raise SystemExit("compare_band_align: the earlier kernel's outputs "
                         "differ")
    return 0


if __name__ == "__main__":
    sys.exit(main())
