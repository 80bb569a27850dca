"""Peak device memory and wall of the default block's seeding, split
against unsplit.

    python3 -m damar_tpu_torch.tools.seed_peaks

Needs one CUDA card.  Builds chip_smoke.py's phase 11 unit (a 10 Mbp
genome with 80 tandem arrays at 20x, mean read 6 kb, 14% error, seeds
2024/2025), splits it at PipelineConfig.block_mb (200 Mbp) and takes
block 1.  On it, in turns (split, unsplit, unsplit, split):
- the datander search (ops/seeding.py find_tandem_seeds) by ranges of
  reads, as it runs, and unsplit (_SLICE_CAP raised in-process);
- the canonical seeding of its self pair (find_seeds_canonical_dev, no
  masks, a seed buffer that holds every seed) by slices, as it runs,
  and unsliced.
Each run starts from an emptied allocator cache with its peak reset; a
run that does not fit reports the out-of-memory error and its peak, and
the tool goes on.  Each form's outputs are held equal to the first
run's.  Then one more run of each canonical form under torch.profiler:
device time by kernel name.  Prints a line per run and one JSON line.
"""
from __future__ import annotations

import json
import subprocess
import tempfile
import time

import torch

from damar_tpu_torch.core.blocks import block_from_db
from damar_tpu_torch.core.config import OverlapConfig, PipelineConfig
from damar_tpu_torch.formats import dazzdb
from damar_tpu_torch.ops import seeding
from damar_tpu_torch.utils.sim import make_genome, sample_reads, \
    write_sim_fasta

# chip_smoke.py's phase 11 unit
GENOME, TANDEMS, SEED = 10_000_000, 80, 2024
COVERAGE, MEAN_LEN, ERR = 20.0, 6_000, 0.14
NO_SLICING = 1 << 62
SEED_CAP = 1 << 21
COLS = ("aread", "bread", "apos", "bpos", "cov")


def block_one():
    w = tempfile.mkdtemp(prefix="damar_seed_peaks_")
    sim = sample_reads(make_genome(GENOME, seed=SEED, tandem=TANDEMS),
                       coverage=COVERAGE, mean_len=MEAN_LEN, err=ERR,
                       seed=SEED + 1)
    write_sim_fasta(f"{w}/reads.fasta", sim)
    del sim
    dazzdb.create_db(f"{w}/D.db", [f"{w}/reads.fasta"])
    db = dazzdb.db_split(f"{w}/D.db", size_mb=PipelineConfig().block_mb,
                         cutoff=0)
    return block_from_db(db, 1)


def run(dev, fn, slice_cap: int):
    """(result or None, wall s, peak bytes, error) of fn() with
    _SLICE_CAP at slice_cap."""
    old = seeding._SLICE_CAP
    seeding._SLICE_CAP = slice_cap
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    t0 = time.time()
    try:
        out, err = fn(), None
        torch.cuda.synchronize()
    except torch.cuda.OutOfMemoryError as e:
        out, err = None, str(e).split(". ")[0]
    finally:
        seeding._SLICE_CAP = old
    wall = time.time() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    torch.cuda.empty_cache()
    return out, wall, peak, err


def same(a: dict, b: dict, cols) -> bool:
    return all(a[k] == b[k] for k in ("nseeds", "total_seeds")) and all(
        torch.equal(a[k], b[k]) for k in cols)


def device_ms(dev, fn, slice_cap: int) -> dict:
    """Device ms by kernel name (the ten largest) of one run of fn()."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    old = seeding._SLICE_CAP
    seeding._SLICE_CAP = slice_cap
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize(dev)
    finally:
        seeding._SLICE_CAP = old
    ev = [e for e in prof.key_averages()
          if e.device_type == DeviceType.CUDA]
    ev.sort(key=lambda e: -e.self_device_time_total)
    total = sum(e.self_device_time_total for e in ev) / 1e3
    return {"total": round(total, 3), **{
        e.key[:60]: round(e.self_device_time_total / 1e3, 3)
        for e in ev[:10]}}


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("seed_peaks: no CUDA device")
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    blk = block_one()
    cfg = OverlapConfig()
    print(f"block 1: {blk.nreads} reads, {blk.nbases} bp, cap {blk.cap} "
          f"on {card}", flush=True)
    forms = {
        "tandem": (lambda: seeding.find_tandem_seeds(blk, cfg, device=dev),
                   COLS, ("split", seeding._SLICE_CAP)),
        "canonical": (lambda: seeding.find_seeds_canonical_dev(
            blk, blk, cfg, upper_only=True, self_pair=True,
            seed_cap=SEED_CAP, device=dev), COLS + ("comp",),
            ("sliced", seeding._SLICE_CAP)),
    }
    out = {"card": card, "block_bp": blk.nbases}
    for name, (fn, cols, (cut, cut_cap)) in forms.items():
        first, rows = {}, []
        for label in (cut, "whole", "whole", cut):
            cap = cut_cap if label == cut else NO_SLICING
            res, wall, peak, err = run(dev, fn, cap)
            ok = None
            if res is not None:
                ok = same(first.setdefault("res", res), res, cols)
            rows.append(dict(form=label, wall_s=round(wall, 4),
                             peak_bytes=peak, oom=err, equal=ok))
            print(f"{name} {label}: wall {wall:.4f} s, peak "
                  f"{peak / 2**30:.2f} GiB ({peak} B)"
                  + (f", out of memory: {err}" if err else
                     f", total_hits {res['total_hits']}, seeds "
                     f"{res['nseeds']}, equal to the first run: {ok}")
                  + f" on {card}", flush=True)
            del res
        out[name] = rows
        if name == "canonical" and not any(r["oom"] for r in rows):
            out["canonical_device_ms"] = {
                label: device_ms(dev, fn, cap) for label, cap in
                ((cut, cut_cap), ("whole", NO_SLICING))}
            print(f"canonical device ms by kernel: "
                  f"{out['canonical_device_ms']}", flush=True)
        first.clear()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
