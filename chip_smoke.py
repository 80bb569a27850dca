#!/usr/bin/env python3
"""Smoke run of damar_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of a checkout
    python3 chip_smoke.py --passes 5 --profile out/profile.txt

Phases (any failure exits non-zero before the last line is printed):
  1. require a CUDA device and print the card's name and power limit;
  2. build the CUDA kernels from damar_tpu_torch/csrc (nvcc, sm_90a, one
     process per source), print ptxas's registers and spills, and count
     each kernel's instructions per DP row in its built code (see
     `sass_ops_per_row`);
  3. hold every kernel against its plain torch version on fuzz batches
     on the card (exact equality: integer outputs), among them one K1
     launch of units from 1 to ~20,000 rows, odd unit counts, windows
     past both pool edges, K2 starts off word boundaries and a bucket at
     its segment cap, the wide trace (K3) on extents of 1 to ~20,000
     rows with drifting commits, the d >= INF_I commit, alim = 0 rows
     and an overflowing max_segs, and K3's chunk form in both modes;
  4. run the main path, overlap_block_pair on the large-50Mbp unit (2.5
     Mbp genome, 20x, mean 6 kb, 14% error, seeds 2024/2025, one block
     self-compared): a cold pass, which also builds what the block
     caches keep (uploads, the A-side index, the reverse-complement
     block, the trace pool), then --passes warm passes that reuse them,
     each with every launch counter reset just before it; check_las
     must be clean.  Then one more warm pass under torch.profiler, with
     a spy that keeps every kernel launch's arguments and outputs: the
     profiler gives each kernel's device time, the work the launches did
     gives its bound (see `bound`); --profile PATH writes that pass's
     tables to PATH;
  5. hold each main-path kernel against its plain version on the
     arguments of its first main-path launch (capped at CAP work items),
     and time both: the kernel by its device time under the profiler,
     the plain version with CUDA events; hold every other
     wide_trace_kernel launch of the pass (each segment bucket, capped
     at CAP extents) against trace_wave_plain too; K3's chunk form
     (dp_rows_kernel, off the main path) the same way on fuzz shapes,
     in both modes; then run the profiled pass's wide retries again
     through the earlier route (trace_wave_steps: one dp_rows_kernel
     launch per segment step) and through wide_trace_kernel, hold both
     against the plain outputs, and print each route's device time,
     launches and wall;
  6. a small self pair and a distinct pair (emit_mirrors on) on the card
     must give the same .las columns as the CPU path (the plain versions,
     which the CPU tests hold byte-equal to damar_tpu);
then print one JSON line of per-kernel results and, last, the device
line.
"""
import argparse
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from damar_tpu_torch.core.blocks import block_from_reads
from damar_tpu_torch.core.config import OverlapConfig
from damar_tpu_torch.formats.las import check_las
from damar_tpu_torch.ops import _cuda, wave_bp, wave_wide
from damar_tpu_torch.ops.words import pack_bases
from damar_tpu_torch.pipeline import overlap as ov
from damar_tpu_torch.utils.sim import (band_batch, edge_units,
                                       make_genome, sample_reads,
                                       unit_batch, wide_trace_batch)

GENOME, COVERAGE, MEAN_LEN, ERR, SEED = 2_500_000, 20.0, 6_000, 0.14, 2024
HIT_CAP, SEED_CAP = 1 << 27, 1 << 21
CAP = 16_384          # work items of a first launch held against plain

# Bounds: the least time the card could take for a launch's work, the
# larger of its int32 operations over the INT32 rate (132 SMs x 64 lanes
# x 1.98 GHz boost, Hopper white paper) and its bytes (each input read
# once, each output written once) over the HBM rate (3.35 TB/s, H100
# SXM data sheet).  Operations per DP row (K3: per lane-row): the
# smaller of the built kernel's count (`sass_ops_per_row`) and an
# estimate of what a row needs with sm_90's three-input instructions
# (LOP3, IADD3, funnel shifts): ~60 for K1, ~50 for K2.  K3's warp row
# (csrc/dp_rows.cu, four lanes a thread) needs per lane ~12 (validity 3,
# sub 2, u 3, scan 2, write-back 2) and per thread ~20 more (the chars 5,
# the neighbour and the 5-step shuffle scan 15), so (4 x 12 + 20) / 4 =
# 17 per lane-row; the chunk form adds a char load a lane (~18), and
# with track_best the score and its four trackers (~9 more).  Chunk
# tails and commits are left out.
INT32_OPS_PER_S = 132 * 64 * 1.98e9
HBM_BYTES_PER_S = 3.35e12
OPS_ESTIMATE = {"bp_extend_kernel": 60, "bp_trace_kernel": 50,
                "wide_trace_kernel": 17, "dp_rows_kernel": 18}
TRACK_OPS = 9
# global loads per thread and DP row in a kernel's row loop: K1, K2 and
# the wide trace load one word of A and one of B per 16 rows; the chunk
# form one char of A and one of B for each of a thread's 4 lanes
LOADS_PER_ROW = {"bp_extend_kernel": 1 / 8, "bp_trace_kernel": 1 / 8,
                 "wide_trace_kernel": 1 / 8, "dp_rows_kernel": 5}
# band lanes a thread holds (K3), so SASS per thread-row / lanes = per
# lane-row
LANES = {"wide_trace_kernel": 4, "dp_rows_kernel": 4}
# the kernels the main path launches; dp_rows_kernel serves the wide
# extension, which is not ported yet
MAIN_PATH = ("bp_extend_kernel", "bp_trace_kernel", "wide_trace_kernel")

# kernel name -> (wrapper whose `launches` counts it, module, launch fn,
# plain torch version with the same contract, source, replaced TPU kernel)
KERNELS = {
    "bp_extend_kernel": (wave_bp.extend_wave_bp, wave_bp,
                         "extend_bp_kernel", wave_bp.extend_bp_plain,
                         "damar_tpu_torch/csrc/wave_bp.cu",
                         "damar_tpu/ops/wave_bp_pallas.py:228"),
    "bp_trace_kernel": (wave_bp.trace_wave_bp, wave_bp, "trace_bp_kernel",
                        wave_bp.trace_bp_plain,
                        "damar_tpu_torch/csrc/wave_bp.cu",
                        "damar_tpu/ops/wave_bp_pallas.py:420"),
    "wide_trace_kernel": (wave_wide.trace_wave, wave_wide,
                          "trace_wide_kernel", wave_wide.trace_wave_plain,
                          "damar_tpu_torch/csrc/dp_rows.cu",
                          "damar_tpu/ops/wave_pallas.py:43 (as trace_wave_pl"
                          " :411 drives it)"),
    "dp_rows_kernel": (wave_wide.dp_rows, wave_wide, "dp_rows_kernel",
                       wave_wide.dp_rows_plain,
                       "damar_tpu_torch/csrc/dp_rows.cu",
                       "damar_tpu/ops/wave_pallas.py:43"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def max_abs_err(a, b) -> int:
    """Largest |kernel - plain| over all outputs; raises on a shape or
    dtype mismatch."""
    err = 0
    for x, y in zip(a, b):
        if x.shape != y.shape:
            raise AssertionError(f"shape {tuple(x.shape)} != "
                                 f"{tuple(y.shape)}")
        if x.numel():
            err = max(err, int((x.to(torch.int64)
                                - y.to(torch.int64)).abs().max()))
    return err


def fuzz_checks(dev) -> dict:
    """Phase 3: each kernel vs its plain version on fuzz batches."""
    errs = {k: 0 for k in KERNELS}
    rng = np.random.default_rng(7)
    T = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731

    def ext(batch, max_rows, rv=None):
        A, B, ao, bo, alim, blim, rev = batch
        args = (pack_bases(T(A)), pack_bases(T(B)), T(ao), T(bo), T(alim),
                T(blim), T(rev) if rv is None else rv, 128, max_rows, 5, 60)
        e = max_abs_err(wave_bp.extend_bp_kernel(*args),
                        wave_bp.extend_bp_plain(*args))
        errs["bp_extend_kernel"] = max(errs["bp_extend_kernel"], e)

    batch = unit_batch(rng, 3000)
    for max_rows in (65536, 128):
        for dirs in ("mixed", "fwd", "rev"):
            ext(batch, max_rows, rv=None if dirs == "mixed" else torch.full(
                (3000,), dirs == "rev", dtype=torch.bool, device=dev))
    # one launch of units from 1 to ~20,000 rows
    ext(unit_batch(rng, 700, min_len=1, max_len=20_000), 65536)
    for S in (1, 33, 1031):
        ext(unit_batch(rng, S), 65536)
    ext(edge_units(rng, 64), 65536)

    def trace(S, tspace, max_segs, offsets, **kw):
        A, B, ao, bo, alim, blim, _ = unit_batch(rng, S, **kw)
        ta = np.minimum(alim, len(A) - ao).astype(np.int32)
        tb = np.minimum(blim, len(B) - bo).astype(np.int32)
        abp, bbp = ao, bo
        if offsets:     # starts and offsets off word boundaries
            abp = np.minimum(rng.integers(1, 90, S), ao).astype(np.int32)
            bbp = np.minimum(rng.integers(1, 90, S), bo).astype(np.int32)
        args = (pack_bases(T(A)), pack_bases(T(B)), T(ao - abp),
                T(bo - bbp), T(abp), T(bbp), T(ta), T(tb), tspace, max_segs)
        e = max_abs_err(wave_bp.trace_bp_kernel(*args),
                        wave_bp.trace_bp_plain(*args))
        errs["bp_trace_kernel"] = max(errs["bp_trace_kernel"], e)

    for tspace, max_segs in ((100, 32), (126, 24)):
        trace(3000, tspace, max_segs, False)
    for tspace, max_segs, S in ((100, 64, 517), (126, 48, 33),
                                (250, 24, 1), (100, 6, 400)):
        trace(S, tspace, max_segs, True, max_len=6000)

    for tspace, max_segs, S, max_len in (
            (100, 64, 1, 2500), (126, 48, 33, 2500), (100, 64, 1031, 2500),
            (126, 256, 300, 20_000), (100, 6, 400, 6000)):
        A, B, *vecs = wide_trace_batch(rng, S, max_len=max_len)
        args = (pack_bases(T(A)), pack_bases(T(B)), *map(T, vecs), tspace,
                max_segs)
        e = max_abs_err(wave_wide.trace_wide_kernel(*args),
                        wave_wide.trace_wave_plain(*args))
        errs["wide_trace_kernel"] = max(errs["wide_trace_kernel"], e)

    for track, recenter in ((False, False), (True, True)):
        args, kw = dp_rows_batch(rng, 4000, track, recenter)
        e = max_abs_err(wave_wide.dp_rows_kernel(*args, **kw),
                        wave_wide.dp_rows_plain(*args, **kw))
        errs["dp_rows_kernel"] = max(errs["dp_rows_kernel"], e)
    torch.cuda.synchronize()
    return errs


def dp_rows_batch(rng, S: int, track: bool, recenter: bool,
                  R: int = 100):
    """Arguments of one dp_rows_kernel launch over S random bands on the
    card (utils.sim.band_batch)."""
    *vals, cont = (torch.as_tensor(x, device="cuda")
                   for x in band_batch(rng, S, track, R))
    return vals, dict(R=R, W=128, diff_cost=5, xdrop=60, track_best=track,
                      recenter=recenter, cont=cont)


INSN = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/\s+([^;]*);")
LABEL = re.compile(r"^\s*(\.L_x_\d+):")
TARGET = re.compile(r"`\((\.L_x_\d+)\)|\b0x([0-9a-f]+)\b")


def _row_loop(insns: list, labels: dict) -> tuple[int, int]:
    """(instructions, global loads) of the smallest loop that holds a
    global load: the row loop, whose body is straight-line code over
    one or more 16-row groups (K1/K2) or rows (K3)."""
    ends = {}
    for addr, text in insns:
        op = text.split()
        op = op[1] if op[0].startswith("@") else op[0]
        if op.startswith("BRA"):
            m = TARGET.search(text)
            if m is None:                      # no direct target
                continue
            tgt = labels[m.group(1)] if m.group(1) else int(m.group(2), 16)
            if tgt <= addr:                    # backward: a loop
                ends[tgt] = max(ends.get(tgt, addr), addr)
    best = None
    for lo, hi in ends.items():
        body = [t for a, t in insns if lo <= a <= hi
                and not t.split()[-1].startswith("NOP")]
        n_ld = sum(1 for t in body
                   if any(w.startswith("LDG") for w in t.split()[:2]))
        if n_ld and (best is None or len(body) < best[0]):
            best = (len(body), n_ld)
    if best is None:
        raise SystemExit("chip_smoke: no row loop found in the SASS")
    return best


def sass_ops_per_row(lib_path: Path) -> dict:
    """Per kernel function (mangled name): SASS instructions per DP row
    (K3: per lane-row) of its row loop, from `cuobjdump -sass`: the
    loop's instructions over the rows it covers (its global loads over
    LOADS_PER_ROW) and, for K3, over the lanes a thread holds."""
    exe = Path(_cuda._nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(exe), "-sass", str(lib_path)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    funcs, cur, pending = {}, None, []
    for ln in text.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            cur = funcs.setdefault(m.group(1), ([], {}))
            continue
        if cur is None:
            continue
        lab = LABEL.match(ln)
        if lab:
            pending.append(lab.group(1))
            continue
        ins = INSN.match(ln)
        if ins:
            addr = int(ins.group(1), 16)
            cur[0].append((addr, ins.group(2).strip()))
            for lb in pending:
                cur[1][lb] = addr
            pending = []
    out = {}
    for fn, (insns, labels) in funcs.items():
        kern = next((k for k in KERNELS if k in fn), None)
        if kern is None:
            continue
        n_insn, n_ld = _row_loop(insns, labels)
        rows = n_ld / LOADS_PER_ROW[kern]
        lanes = LANES.get(kern, 1)
        out[fn] = dict(kernel=kern, insns=n_insn, loads=n_ld, rows=rows,
                       lanes=lanes, per_row=n_insn / rows / lanes)
    missing = set(KERNELS) - {v["kernel"] for v in out.values()}
    if missing:
        raise SystemExit(f"chip_smoke: no SASS for {sorted(missing)}")
    return out


def ops_per_row(name: str, kw, sass: dict) -> float:
    """Operations per DP row that the bound of this launch counts: the
    smaller of the SASS count of the function it runs and the
    estimate."""
    tag, est = name, OPS_ESTIMATE[name]
    if name == "dp_rows_kernel":            # the template instance
        tag += (f"ILb{int(kw.get('track_best', True))}"
                f"ELb{int(kw.get('recenter', False))}E")
        est += TRACK_OPS if kw.get("track_best", True) else 0
    counts = [v["per_row"] for fn, v in sass.items() if tag in fn]
    if len(counts) != 1:
        raise SystemExit(f"chip_smoke: {len(counts)} SASS functions "
                         f"match {tag}")
    return min(counts[0], est)


def work(name: str, a, kw, out, sass: dict,
         full_rows: int | None = None) -> tuple[int, float, int]:
    """(rows, int32 ops, bytes) of one launch.  K1: the rows its outputs
    prove were needed, sum(bva); given full_rows (the full depth), a
    launch to a smaller depth leaves out its active units, which a
    later full-depth launch re-runs from row 0 and counts, so each unit
    counts once per pass.  K2: sum(alim) of its extents; the wide trace
    128 lanes times sum(alim); the chunk form the rows of its live seeds
    times 128 lanes."""
    nb = lambda ts: sum(t.numel() * t.element_size()  # noqa: E731
                        for t in ts if torch.is_tensor(t))
    if name == "bp_extend_kernel":
        bva = out[1].to(torch.int64)
        if full_rows is not None and a[8] < full_rows:
            bva = torch.where(out[3] != 0, 0, bva)
        rows = int(bva.sum())
        byts = nb(a[2:7]) + nb(out)
    elif name == "bp_trace_kernel":
        rows = int(a[6].to(torch.int64).sum())
        byts = nb(a[2:8]) + nb(out[1:]) + 8 * int(out[1].sum())
    elif name == "wide_trace_kernel":
        alim = a[6].to(torch.int64).clamp(min=0)
        rows = 128 * int(alim.sum())
        segs = int(out[1].to(torch.int64).clamp(max=a[9]).sum())
        byts = (nb(a[2:8]) + nb(out[1:]) + 8 * segs
                + int(alim.sum()) // 2)                 # 2-bit chars
    else:
        R = kw["R"]
        live = (a[7] != 0) & (a[6] > 0)
        rows = 128 * int(torch.where(live, a[6].clamp(max=R), 0).sum())
        byts = nb(a[:12]) + nb(out)
    if name in ("bp_extend_kernel", "bp_trace_kernel"):
        byts += rows // 2                                # 2-bit chars
    return rows, rows * ops_per_row(name, kw, sass), byts


def bound(ops: int, byts: int) -> tuple[float, str]:
    """(least ms, what bounds it) for the given work."""
    t_ops, t_bytes = ops / INT32_OPS_PER_S, byts / HBM_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


# torch.profiler (torch 2.11 on the H100 machines) loses the first
# device records of a profile, by count: about one more for every 20 s
# since the process's first profile, whatever idle time comes before
# them (damar_tpu_torch/tools/profile_window.py).  So every profile here
# opens with LEAD_RECORDS one-element negations, which take the loss and
# which no count or time below includes.
LEAD_RECORDS, LEAD_KEY = 256, "neg_kernel"

# every time a profile still held fewer launch records of a kernel than
# its wrapper counted (the profile is then taken again); printed in the
# kernels line, so a recurrence shows in every run's output
LOST_LAUNCHES: list = []


def lead_records() -> None:
    """The records a profile opens with (see LEAD_RECORDS)."""
    x = torch.empty(1, device="cuda")
    for _ in range(LEAD_RECORDS):
        x.neg_()
    torch.cuda.synchronize()


def device_events(prof) -> list:
    """The profile's device-side events (kernels, copies), the lead
    records left out; a host op's device time repeats that of the
    kernels it launched, so host ops are left out too."""
    from torch.autograd import DeviceType
    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and LEAD_KEY not in e.key]


class LostLaunches(Exception):
    """The profiler's records miss launches that ran."""


def lost_launches(where: str, counted: dict, profiled: dict) -> list:
    """The kernels whose profiled launch count differs from the count
    of their wrappers; each is logged and kept in LOST_LAUNCHES."""
    bad = [dict(where=where, kernel=k, counted=counted[k],
                profiled=profiled[k])
           for k in counted if counted[k] != profiled[k]]
    for b in bad:
        log(f"profiler lost launches: {b}")
    LOST_LAUNCHES.extend(bad)
    return bad


class Spy:
    """While the main path runs: keeps the arguments and outputs of
    each kernel launch function's calls that launched (its wrapper's
    count moved; a call with no work launches nothing).  The launches
    go through unchanged."""

    def __init__(self):
        self.calls = {k: [] for k in KERNELS}
        self.orig = {}

    def __enter__(self):
        for name, (wrapper, mod, attr, *_rest) in KERNELS.items():
            fn = getattr(mod, attr)
            self.orig[name] = (mod, attr, fn)

            def spy(*a, _fn=fn, _name=name, _w=wrapper, **kw):
                n0 = _w.launches
                out = _fn(*a, **kw)
                if _w.launches != n0:
                    self.calls[_name].append((a, kw, out))
                return out
            setattr(mod, attr, spy)
        return self

    def __exit__(self, *exc):
        for mod, attr, fn in self.orig.values():
            setattr(mod, attr, fn)
        return False

    def summary(self, prof, sass: dict, full_rows: int) -> dict:
        """Per kernel: launches, device ms (from the profile `prof` of
        the spied pass), rows, bound ms and its kind, summed over the
        pass."""
        dev_ms, dev_n = device_ms(prof)
        if lost_launches("profiled pass",
                         {k: len(c) for k, c in self.calls.items()}, dev_n):
            raise LostLaunches
        out = {}
        for name, calls in self.calls.items():
            rows = ops = byts = 0
            for a, kw, res in calls:
                r, o, b = work(name, a, kw, res, sass, full_rows)
                rows, ops, byts = rows + r, ops + o, byts + b
            bms, by = bound(ops, byts)
            out[name] = dict(launches=len(calls), pass_ms=dev_ms[name],
                             rows=rows, pass_bound_ms=bms, bound_by=by)
        return out


def device_ms(prof) -> tuple[dict, dict]:
    """Per kernel: its self device time (ms) and launch count in the
    profile `prof`."""
    ms, n = {k: 0.0 for k in KERNELS}, {k: 0 for k in KERNELS}
    for e in device_events(prof):
        for k in KERNELS:
            if k in e.key:
                ms[k] += e.self_device_time_total / 1e3
                n[k] += e.count
    return ms, n


def kernel_ms(name: str, fn, reps: int, tries: int = 3) -> float:
    """Device time of one launch of kernel `name` by fn(), the mean of
    `reps` launches under the profiler.  A profile that lost launch
    records all the same is logged and taken again, up to `tries`
    times."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for t in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            lead_records()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ms, n = device_ms(prof)
        if not lost_launches(f"{name} timing, profile {t + 1} of {tries}",
                             {name: reps}, n):
            return ms[name] / reps
    raise SystemExit(f"chip_smoke: {name}: the profiler kept losing "
                     "launches")


def cuda_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def capped(name: str, a, kw):
    """The first CAP work items of a launch, as a launch of their own."""
    if name == "bp_extend_kernel":
        sel = wave_bp.longest_first(a[4], a[5])[:CAP]
        return (*a[:2], *[x[sel] for x in a[2:7]], *a[7:]), dict(kw)
    if name in ("bp_trace_kernel", "wide_trace_kernel"):
        return (*a[:2], *[x[:CAP] for x in a[2:8]], *a[8:]), dict(kw)
    S = a[0].shape[0]
    cut = lambda x: x[:CAP] if torch.is_tensor(x) and x.shape[0] == S \
        else x  # noqa: E731
    return tuple(cut(x) for x in a), {k: cut(v) for k, v in kw.items()}


def route_times(fn, kernel: str) -> tuple[float, float, float]:
    """(device ms of kernels named `kernel`, device ms of everything,
    host wall s) of one run of fn(): the wall without the profiler, the
    device times from a second run under it."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.time()
    fn()
    torch.cuda.synchronize()
    wall = time.time() - t0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        lead_records()
        fn()
        torch.cuda.synchronize()
    ev = device_events(prof)
    kern = sum(e.self_device_time_total for e in ev if kernel in e.key)
    return kern / 1e3, sum(e.self_device_time_total for e in ev) / 1e3, wall


def compare_wide_routes(jobs: list, want: list, card: str) -> dict:
    """The profiled pass's wide retries (every wide_trace_kernel launch's
    arguments) again through the earlier route, trace_wave_steps over
    dp_rows_kernel (one launch per segment step, the gathers and commit
    as torch ops), and through wide_trace_kernel, in turns, three times
    (medians).  Each route's outputs must equal `want`, the plain
    version's on the same arguments.  Also the longest extent alone
    (CUDA events over three launches): the serial row chain's floor."""
    def steps():
        return [wave_wide.trace_wave_steps(*a, wave_wide.dp_rows_kernel)
                for a in jobs]

    def wide():
        return [wave_wide.trace_wide_kernel(*a) for a in jobs]
    routes = {"steps over dp_rows_kernel": (steps, "dp_rows_kernel",
                                            wave_wide.dp_rows),
              "wide_trace_kernel": (wide, "wide_trace_kernel",
                                    wave_wide.trace_wave)}
    res = {}
    for name, (fn, kern, counted) in routes.items():
        n0 = counted.launches
        err = max(max_abs_err(x, y) for x, y in zip(fn(), want))
        res[name] = dict(equal=err == 0, launches=counted.launches - n0,
                         t=[])
    for _ in range(3):
        for name, (fn, kern, _) in routes.items():
            res[name]["t"].append(route_times(fn, kern))
    for name, r in res.items():
        t = r.pop("t")
        r.update(kernel_ms=float(np.median([x[0] for x in t])),
                 device_ms=float(np.median([x[1] for x in t])),
                 wall_s=float(np.median([x[2] for x in t])))
        log(f"wide retries via {name}: outputs equal {r['equal']}, "
            f"{r['launches']} kernel launches, kernel {r['kernel_ms']:.4f} "
            f"ms and all device work {r['device_ms']:.4f} ms device time, "
            f"wall {r['wall_s']:.4f} s on {card}")
    if not all(r["equal"] for r in res.values()):
        raise SystemExit("chip_smoke: the wide retry routes disagree")
    alim = torch.cat([a[6] for a in jobs]).to(torch.int64).clamp(min=0)
    j, i = max(((j, int(a[6].argmax())) for j, a in enumerate(jobs)),
               key=lambda ji: int(jobs[ji[0]][6][ji[1]]))
    one = (*jobs[j][:2], *[x[i:i + 1] for x in jobs[j][2:8]], *jobs[j][8:])
    # CUDA events: the launches queue back to back
    ms = cuda_ms(lambda: wave_wide.trace_wide_kernel(*one), 3)
    res["longest alone"] = dict(rows=int(alim.max()), kernel_ms=ms,
                                ns_per_row=1e6 * ms / max(int(alim.max()), 1))
    res["extents"] = dict(n=int(alim.numel()), sum_alim=int(alim.sum()),
                          max_alim=int(alim.max()))
    # the launches run one after another, each at least as long as its
    # longest extent's row chain
    longest = [int(a[6].max()) for a in jobs]
    res["chain_floor_ms"] = (res["longest alone"]["ns_per_row"]
                             * sum(longest) / 1e6)
    log(f"wide retries: {res['extents']}; per launch (extents, longest): "
        f"{[(int(a[6].numel()), m) for a, m in zip(jobs, longest)]}; "
        f"longest alone {res['longest alone']}; the launches' "
        f"serial-chain floor (sum of their longest extents x ns a row) "
        f"{res['chain_floor_ms']:.4f} ms on {card}")
    return res


def same_las(x, y) -> bool:
    return (x.tspace == y.tspace
            and np.array_equal(x.columns.headers, y.columns.headers)
            and np.array_equal(x.columns.trace, y.columns.trace)
            and np.array_equal(x.columns.offsets, y.columns.offsets))


def report_profile(prof, wall: float, path: str | None) -> None:
    """Prints the profiled pass's device time, busy share, the host's
    stream syncs and kernel launches; writes the full tables to `path`
    when given."""
    ka = prof.key_averages()
    on_dev = device_events(prof)
    dev_s = sum(e.self_device_time_total for e in on_dev) / 1e6
    log(f"profiled pass: wall {wall:.4f} s (profiler on), device time "
        f"{dev_s:.4f} s, busy share {dev_s / wall:.3f}")
    top = sorted(on_dev, key=lambda e: -e.self_device_time_total)[:10]
    log("device time by name: " + ", ".join(
        f"{e.key[:40]} {e.self_device_time_total / 1e3:.1f} ms "
        f"({e.count})" for e in top))
    # the pass's own calls: the lead records add LEAD_RECORDS launches
    for name, lead in (("cudaStreamSynchronize", 0),
                       ("cudaLaunchKernel", LEAD_RECORDS)):
        e = [x for x in ka if x.key == name]
        if e:
            log(f"{name}: {e[0].count - lead} calls in the pass "
                f"({e[0].cpu_time_total / 1e3:.1f} ms host time, the lead "
                f"records' included)")
    if path:
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        Path(path).write_text(
            ka.table(sort_by="self_cuda_time_total", row_limit=30,
                     max_name_column_width=60) + "\n"
            + ka.table(sort_by="cpu_time_total", row_limit=25,
                       max_name_column_width=60) + "\n")
        log(f"profile tables: {path}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--passes", type=int, default=1,
                    help="warm main-path passes to time (default 1)")
    ap.add_argument("--profile", metavar="PATH",
                    help="write the profiled warm pass's tables to PATH")
    args = ap.parse_args(argv)
    if args.passes < 1:
        ap.error("--passes must be at least 1")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda."
                         "is_available() is False); nothing was run")
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    t0 = time.time()
    lib_path = _cuda.build()
    _cuda.lib()
    log(f"build: {lib_path.name} in {time.time() - t0:.1f} s "
        f"(nvcc {_cuda.last_build_seconds or 0:.1f} s)")
    for ln in _cuda.build_log:
        log(f"  {ln}")
    sass = sass_ops_per_row(lib_path)
    for fn, v in sass.items():
        log(f"SASS {fn[:60]}: row loop {v['insns']} instructions, "
            f"{v['loads']} global loads = {v['rows']:g} rows, "
            f"{v['per_row']:.2f} per row (estimate "
            f"{OPS_ESTIMATE[v['kernel']]})")

    t0 = time.time()
    errs = fuzz_checks(dev)
    log(f"fuzz checks vs plain: max_abs_err {errs} "
        f"({time.time() - t0:.1f} s)")
    if any(errs.values()):
        raise SystemExit("chip_smoke: a kernel disagrees with its plain "
                         "version on fuzz batches")

    # ---- main path: large-50Mbp self pair ----
    t0 = time.time()
    g = make_genome(GENOME, seed=SEED)
    sim = sample_reads(g, coverage=COVERAGE, mean_len=MEAN_LEN, err=ERR,
                       seed=SEED + 1)
    blk = block_from_reads(sim.reads)
    total_bp = sum(len(r) for r in sim.reads)
    log(f"large-50Mbp: {len(sim.reads)} reads, {total_bp} bp, block cap "
        f"{blk.cap}, setup {time.time() - t0:.1f} s")
    cfg = OverlapConfig()
    kw = dict(self_block=True, hit_cap=HIT_CAP, seed_cap=SEED_CAP,
              emit_mirrors=False, device=dev)
    torch.cuda.synchronize()
    t0 = time.time()
    las_a, _, stats = ov.overlap_block_pair(blk, blk, cfg, **kw)
    torch.cuda.synchronize()
    wall = time.time() - t0
    aligned = int(las_a.a_spans().sum())
    log(f"cold pass (adds the uploads, A-side index build, rc block and "
        f"trace pool that warm passes reuse): wall {wall:.4f} s, "
        f"{aligned / wall / 1e9:.4f} Gbp-aligned/s, overlaps "
        f"{las_a.novl}; stats {json.dumps(stats, default=int)}")
    walls = []
    for i in range(args.passes):
        for wrapper, *_ in KERNELS.values():
            wrapper.launches = 0
        torch.cuda.reset_peak_memory_stats(dev)
        torch.cuda.synchronize()
        t0 = time.time()
        las_a, _, stats = ov.overlap_block_pair(blk, blk, cfg, **kw)
        torch.cuda.synchronize()
        walls.append(time.time() - t0)
        launches = {k: v[0].launches for k, v in KERNELS.items()}
        peak = torch.cuda.max_memory_allocated(dev)
        aligned = int(las_a.a_spans().sum())
        errs_las = check_las(las_a, blk.rlen)
        log(f"warm pass {i}: overlaps {las_a.novl}, aligned bp {aligned}, "
            f"wall {walls[-1]:.4f} s, "
            f"{aligned / walls[-1] / 1e9:.4f} Gbp-aligned/s on {card}")
        log(f"stats: {json.dumps(stats, default=int)}")
        log(f"trace_retries {stats.get('trace_retries', 0)}, "
            f"trace_retries_wide {stats.get('trace_retries_wide', 0)}, "
            f"dropped_trace {stats.get('dropped_trace', 0)}")
        log(f"launches in the pass: {launches}")
        log(f"peak device memory: {peak / 2**30:.2f} GiB ({peak} B)")
        if errs_las:
            raise SystemExit(f"chip_smoke: check_las failed: "
                             f"{errs_las[:5]}")
        if las_a.novl <= 0:
            raise SystemExit("chip_smoke: no overlaps")
        if stats.get("seed_overflow"):
            raise SystemExit("chip_smoke: seeding buffers overflowed")
        missing = [k for k in MAIN_PATH if launches[k] <= 0]
        if missing:
            raise SystemExit(f"chip_smoke: kernels not launched by the "
                             f"main path: {missing}")
    med = float(np.median(walls))
    log(f"warm passes: walls {[round(w, 4) for w in walls]} s, median "
        f"{med:.4f} s = {aligned / med / 1e9:.4f} Gbp-aligned/s on {card}")

    # ---- one more warm pass, profiled, with every launch kept (taken
    # again if the profile lost launch records) ----
    from torch.profiler import ProfilerActivity, profile
    for attempt in range(3):
        torch.cuda.synchronize()
        with Spy() as spy, profile(activities=[
                ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            lead_records()
            t0 = time.time()
            las_s, _, _ = ov.overlap_block_pair(blk, blk, cfg, **kw)
            torch.cuda.synchronize()
            wall = time.time() - t0
        try:
            per = spy.summary(prof, sass, cfg.max_read_len)
            break
        except LostLaunches:
            log(f"profiled pass {attempt + 1} of 3 lost launch records")
    else:
        raise SystemExit("chip_smoke: the profiler kept losing launches")
    report_profile(prof, wall, args.profile)
    if las_s.novl != las_a.novl:
        raise SystemExit("chip_smoke: the spied pass gave other records")
    for name in MAIN_PATH:
        p = per[name]
        log(f"{name} in one warm pass: {p['launches']} launches, "
            f"{p['pass_ms']:.4f} ms device time, {p['rows']} rows, bound "
            f"{p['pass_bound_ms']:.4f} ms ({p['bound_by']}), share of "
            f"bound {p['pass_bound_ms'] / p['pass_ms']:.3f} on {card}")
    k12 = sum(per[k]["pass_ms"] for k in ("bp_extend_kernel",
                                          "bp_trace_kernel"))
    log(f"K1 + K2 per warm pass: {k12:.4f} ms device time")

    # ---- every wide trace launch of the pass (one per segment bucket,
    # capped at CAP extents) vs plain; the retry routes must give the
    # plain outputs too ----
    jobs, want = [], []
    for i, (a, k, _) in enumerate(spy.calls["wide_trace_kernel"]):
        a, k = capped("wide_trace_kernel", a, k)
        t0 = time.time()
        ref = wave_wide.trace_wave_plain(*a, **k)
        e = max_abs_err(wave_wide.trace_wide_kernel(*a, **k), ref)
        errs["wide_trace_kernel"] = max(errs["wide_trace_kernel"], e)
        log(f"wide_trace_kernel, main-path launch {i}: {a[6].numel()} "
            f"extents, longest {int(a[6].max())} rows, max_abs_err {e} "
            f"(plain {time.time() - t0:.1f} s)")
        jobs.append(a)
        want.append(ref)

    # ---- each kernel vs plain at its first main-path launch, timed ----
    rows = []
    for name, (_, mod, attr, plain, src, replaces) in KERNELS.items():
        launch = getattr(mod, attr)
        if name in MAIN_PATH:
            if not spy.calls[name]:
                raise SystemExit(f"chip_smoke: no spied launch of {name}")
            cases = {"main path": capped(name, *spy.calls[name][0][:2])}
        else:       # off the main path: fuzz shapes, both modes
            rng = np.random.default_rng(13)
            cases = {mode: dp_rows_batch(rng, CAP, *flags) for mode, flags
                     in (("trace", (False, False)),
                         ("track_recenter", (True, True)))}
        timed = {}
        for case, (a, k) in cases.items():
            out = launch(*a, **k)
            e = max_abs_err(out, plain(*a, **k))
            errs[name] = max(errs[name], e)
            bms, by = bound(*work(name, a, k, out, sass)[1:])
            shapes = [tuple(x.shape) for x in a if torch.is_tensor(x)][:4]
            ms = kernel_ms(name, lambda: launch(*a, **k), 5)
            plain_ms = cuda_ms(lambda: plain(*a, **k), 1)
            log(f"{name}, {case}, first {CAP} items {shapes}: kernel "
                f"{ms:.4f} ms device time, bound {bms:.4f} ms ({by}), plain "
                f"{plain_ms:.4f} ms, max_abs_err {e}")
            timed[case] = dict(ms=round(ms, 4), plain_ms=round(plain_ms, 4),
                               bound_ms=round(bms, 4), bound_by=by,
                               max_abs_err=e)
        first = next(iter(timed.values()))
        row = dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=launches[name], max_abs_err=errs[name],
            ms=first["ms"], plain_ms=first["plain_ms"],
            bound_ms=first["bound_ms"], bound_by=first["bound_by"],
            library_ms=None,
            library="none: no PyTorch call computes this banded DP")
        p = per[name]
        if name in MAIN_PATH:
            row.update(pass_ms=round(p["pass_ms"], 4),
                       pass_bound_ms=round(p["pass_bound_ms"], 4),
                       pass_bound_by=p["bound_by"],
                       bound_share=round(p["pass_bound_ms"] / p["pass_ms"],
                                         4),
                       pass_rows=p["rows"])
        else:
            row.update(pass_ms=None, modes=timed,
                       note="off the main path (the wide extension's "
                            "kernel): ms, plain_ms, bound_ms are trace mode "
                            "on fuzz shapes; both modes under modes")
        rows.append(row)
    if any(r["max_abs_err"] for r in rows):
        raise SystemExit("chip_smoke: a kernel disagrees with its plain "
                         "version at main-path shapes")

    routes = compare_wide_routes(jobs, want, card)
    del spy, jobs, want

    # ---- small pairs: card == CPU path (== damar_tpu, per the tests) ----
    t0 = time.time()
    small = sample_reads(make_genome(60_000, seed=11), coverage=10.0,
                         mean_len=4000, err=0.14, seed=12).reads
    h = len(small) // 2
    blk_a = block_from_reads(small[:h], ids=np.arange(h))
    blk_b = block_from_reads(small[h:], ids=np.arange(h, len(small)))
    whole = block_from_reads(small)
    rlen = np.array([len(r) for r in small])
    for label, (x, y, selfb) in {"self": (whole, whole, True),
                                 "distinct": (blk_a, blk_b, False)}.items():
        outs = {}
        for d in (dev, "cpu"):
            outs[str(d)] = ov.overlap_block_pair(x, y, cfg, selfb,
                                                 emit_mirrors=True, device=d)
        gpu, cpu = outs[str(dev)], outs["cpu"]
        for i in (0, 1):
            problems = check_las(gpu[i], rlen)
            if problems:
                raise SystemExit(f"chip_smoke: {label} pair check_las: "
                                 f"{problems[:5]}")
            if not same_las(gpu[i], cpu[i]):
                raise SystemExit(f"chip_smoke: {label} pair: card and CPU "
                                 f"paths differ (las_{'ab'[i]})")
        log(f"{label} pair, emit_mirrors: {gpu[0].novl} + {gpu[1].novl} "
            f"records, card == CPU path, check_las clean")
    log(f"small pairs: {time.time() - t0:.1f} s")

    print(json.dumps({"kernels": rows, "wide_retry_routes": routes,
                      "profiler_lost_launches": LOST_LAUNCHES}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
