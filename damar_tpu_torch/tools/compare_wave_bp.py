"""Time K1 and K2 against an earlier wave_bp.cu on the same inputs.

    python3 -m damar_tpu_torch.tools.compare_wave_bp EARLIER.cu

EARLIER.cu is a version of damar_tpu_torch/csrc/wave_bp.cu with the
one-thread-per-unit C interface (bp_extend_launch and bp_trace_launch
with no work order and no counter), whose driver launched it in
equal-area batches; `git show <commit>:damar_tpu_torch/csrc/wave_bp.cu`
gives it for a commit before the persistent grid.  Needs one CUDA card.

It runs the large-50Mbp self pair of chip_smoke.py once cold and once
warm, keeping the arguments of every K1 and K2 launch of the warm pass.
Then it times, in turns (new; earlier in its driver's equal-area
batches; earlier in one launch), K1 over the pass's whole phase-2 unit
set and K2 over its largest bucket: device time under torch.profiler
and CUDA events around the whole launch sequence, median of three.
The earlier kernels' outputs must equal the new ones.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from damar_tpu_torch.core.blocks import block_from_reads
from damar_tpu_torch.core.config import OverlapConfig
from damar_tpu_torch.ops import _cuda, wave_bp
from damar_tpu_torch.pipeline import overlap as ov
from damar_tpu_torch.utils.sim import make_genome, sample_reads

# the large-50Mbp unit, as chip_smoke.py runs it
GENOME, COVERAGE, MEAN_LEN, ERR, SEED = 2_500_000, 20.0, 6_000, 0.14, 2024
HIT_CAP, SEED_CAP = 1 << 27, 1 << 21

P, I = ctypes.c_void_p, ctypes.c_int
EARLIER_SIGNATURES = {
    "bp_extend_launch": [P, I, P, I, P, P, P, P, P, I, I, I, I, I,
                         P, P, P, P, P],
    "bp_trace_launch": [P, I, P, I, P, P, P, P, P, P, I, I, I,
                        P, P, P, P],
}


def load_earlier(src: Path) -> ctypes.CDLL:
    tag = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    out = _cuda.BUILD_DIR / f"libearlier_{tag}.so"
    if not out.exists():
        _cuda.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        _cuda._run_all([[_cuda._nvcc(), *_cuda.ARCH, "-std=c++17", "-O3",
                         "-shared", "-Xcompiler", "-fPIC", "-o", str(out),
                         str(src)]])
    lib = ctypes.CDLL(str(out))
    for name, argtypes in EARLIER_SIGNATURES.items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = ctypes.c_int
    return lib


def area_plan(sorted_bound: np.ndarray, chunk: int, clip: int) -> list:
    """The earlier driver's equal-area batches over ascending bounds (K1)
    or spans (K2, with no clip): width w (a power of two in [1024,
    65536]) with w * (min(top, clip) // chunk + 1) <= 2^19 (for K1 from
    exact bounds, where that driver sampled every 512th)."""
    out, lo, n = [], 0, len(sorted_bound)
    while lo < n:
        w = 1 << 16
        while w > 1024:
            top = min(int(sorted_bound[min(lo + w, n) - 1]), clip)
            if w * (top // chunk + 1) <= 1 << 19:
                break
            w //= 2
        out.append((lo, min(w, n - lo)))
        lo += min(w, n - lo)
    return out


def spied_pass(dev) -> tuple[dict, OverlapConfig]:
    """A cold and a warm main-path pass; the warm pass's K1 and K2
    launch arguments."""
    sim = sample_reads(make_genome(GENOME, seed=SEED), coverage=COVERAGE,
                       mean_len=MEAN_LEN, err=ERR, seed=SEED + 1)
    blk = block_from_reads(sim.reads)
    cfg = OverlapConfig()
    kw = dict(self_block=True, hit_cap=HIT_CAP, seed_cap=SEED_CAP,
              emit_mirrors=False, device=dev)
    ov.overlap_block_pair(blk, blk, cfg, **kw)
    calls = {"extend_bp_kernel": [], "trace_bp_kernel": []}
    orig = {k: getattr(wave_bp, k) for k in calls}

    def keep(name):
        def spy(*a, **k):
            calls[name].append(a)
            return orig[name](*a, **k)
        return spy
    try:
        for k in calls:
            setattr(wave_bp, k, keep(k))
        ov.overlap_block_pair(blk, blk, cfg, **kw)
    finally:
        for k, fn in orig.items():
            setattr(wave_bp, k, fn)
    torch.cuda.synchronize()
    return calls, cfg


def timed(fn, name: str) -> tuple[float, float]:
    """(device ms of kernels named `name`, CUDA-event ms of the whole
    call) of one run of fn()."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
    dev_us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA and name in e.key)
    return dev_us / 1e3, e0.elapsed_time(e1)


def max_abs_err(a, b) -> int:
    return max((int((x.to(torch.int64) - y.to(torch.int64)).abs().max())
                for x, y in zip(a, b) if x.numel()), default=0)


def compare(src: Path, dev) -> dict:
    lib = load_earlier(src)
    calls, cfg = spied_pass(dev)
    i32 = lambda x: x.to(torch.int32).contiguous()  # noqa: E731
    ptr = lambda x: x.data_ptr()  # noqa: E731
    stream = torch.cuda.current_stream().cuda_stream

    # K1: every phase-2 launch (full depth) of the pass, live units in
    # ascending bound as the earlier driver sorted them
    p2 = [a for a in calls["extend_bp_kernel"] if a[8] > cfg.ext_phase1_rows]
    jobs = []
    for a in p2:
        bnd = torch.minimum(a[4], a[5])
        sel = torch.nonzero(a[4] > 0).flatten()
        sel = sel[torch.argsort(bnd[sel], stable=True)]
        ins = [i32(x[sel]) for x in a[2:6]] + [a[6][sel].to(torch.uint8)]
        outs = [torch.empty(len(sel), dtype=torch.int32, device=dev)
                for _ in range(4)]
        jobs.append((a, sel, ins, outs,
                     area_plan(bnd[sel].cpu().numpy(), a[7], a[8])))

    def k1_new():
        return [wave_bp.extend_bp_kernel(*a) for a in p2]

    def k1_old(batched: bool):
        for a, sel, ins, outs, plan in jobs:
            aw, bw = i32(a[0]), i32(a[1])
            for lo, m in (plan if batched else [(0, len(sel))]):
                _cuda.check(lib.bp_extend_launch(
                    ptr(aw), aw.shape[0], ptr(bw), bw.shape[0],
                    *[ptr(x) + 4 * lo for x in ins[:4]], ptr(ins[4]) + lo,
                    m, a[7], a[8], a[9], a[10],
                    *[ptr(o) + 4 * lo for o in outs], stream), "earlier K1")

    # K2: the launch with the most rows, extents in ascending span as the
    # earlier driver sorted them
    a2 = max(calls["trace_bp_kernel"], key=lambda a: int(a[6].sum()))
    S2, ms2 = a2[2].shape[0], a2[9]
    spans = a2[6].cpu().numpy()
    asc = torch.as_tensor(np.argsort(spans, kind="stable"), device=dev)
    ins2 = [i32(x[asc]) for x in a2[2:8]]
    tr_old = torch.zeros((S2, ms2, 2), dtype=torch.int32, device=dev)
    cnt_old = [torch.empty(S2, dtype=torch.int32, device=dev)
               for _ in range(2)]
    plan2 = area_plan(spans[asc.cpu().numpy()], cfg.tspace, 1 << 30)

    def k2_new():
        return wave_bp.trace_bp_kernel(*a2)

    def k2_old(batched: bool):
        aw, bw = i32(a2[0]), i32(a2[1])
        for lo, m in (plan2 if batched else [(0, S2)]):
            _cuda.check(lib.bp_trace_launch(
                ptr(aw), aw.shape[0], ptr(bw), bw.shape[0],
                *[ptr(x) + 4 * lo for x in ins2], m, a2[8], ms2,
                ptr(tr_old) + 8 * ms2 * lo,
                *[ptr(c) + 4 * lo for c in cnt_old], stream), "earlier K2")

    res = {}
    for name, new, old, n_new, n_old in (
            ("bp_extend_kernel", k1_new, k1_old, len(p2),
             sum(len(j[4]) for j in jobs)),
            ("bp_trace_kernel", k2_new, k2_old, 1, len(plan2))):
        runs = {"new": new, "earlier_batched": lambda o=old: o(True),
                "earlier_one_launch": lambda o=old: o(False)}
        for fn in runs.values():          # warm-up
            fn()
        t = {k: [] for k in runs}
        for _ in range(3):
            for k, fn in runs.items():
                t[k].append(timed(fn, name))
        res[name] = {f"{k}_{unit}": float(np.median([x[i] for x in v]))
                     for k, v in t.items()
                     for i, unit in enumerate(("device_ms", "events_ms"))}
        res[name].update(launches_new=n_new, launches_earlier=n_old)
    err = 0
    for (_, sel, _, outs, _), got in zip(jobs, k1_new()):
        err = max(err, max_abs_err(outs, [x[sel] for x in got]))
    res["bp_extend_kernel"]["max_abs_err"] = err
    tr, nseg, dsum = k2_new()
    res["bp_trace_kernel"]["max_abs_err"] = max_abs_err(
        [tr_old, *cnt_old], [tr[asc], nseg[asc], dsum[asc]])
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("earlier", type=Path, help="the earlier wave_bp.cu")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("compare_wave_bp: no CUDA device")
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    res = compare(args.earlier, dev)
    for name, r in res.items():
        print(f"{name} vs {args.earlier} on {card}: {json.dumps(r)}",
              flush=True)
    if any(r["max_abs_err"] for r in res.values()):
        raise SystemExit("compare_wave_bp: the earlier kernels disagree")
    return 0


if __name__ == "__main__":
    sys.exit(main())
