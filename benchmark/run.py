"""Run one cell of the port's benchmark once.

    python -m benchmark.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell is an entry of BENCHMARK.json's `workloads`.  Everything about
it is data found by name: benchmark/workloads/<cell>.json (its
configuration, entry, sample sizes and the limits of `correct`),
benchmark/configs/<config>.json (the deployment: genome, reads, blocks,
daligner's settings) and, for a traced run, benchmark/metrics/<metric>.py
for each per-layer metric that BENCHMARK.json gives the cell.  The entry
(the unit of work) is benchmark/entries/<entry>.py.

A run: the reads from the seed, made on the card; the entry's set-up
(a DB on disk, or blocks); one unit of work to build and warm every
kernel; then units back to back, each started while fewer than
`--seconds` have passed (a closed loop: one caller, as a sweep job), the
window ending when the last unit ends.  After the window: the peak
device memory, then the program's state freed, then the reference judges
one unit's records (drawn from the seed) and every unit's records are
held equal to it.  Stdout's last line is the result; stderr's last lines
are each number compared beside its limit.

Without a CUDA card the run exits 2 and prints no result.  It writes
only under the temporary directory (its DB and each unit's records,
removed before it exits) and the caches under .bench_cache/ in the
checkout.
"""
from __future__ import annotations

import time

T_PROCESS = time.time()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(ROOT, ".bench_cache")
# top-level module names no process of the benchmark may hold
FORBIDDEN = ("jax", "jaxlib", "flax", "damar_tpu")


def _fixed_caches() -> None:
    """Kernel caches at fixed paths inside the checkout, unless the
    environment names its own."""
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(CACHE, "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(CACHE, "torch_extensions"))
    os.environ.setdefault("USE_FLAX", "0")


_fixed_caches()

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark import reference, tracing, traffic, work  # noqa: E402



def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest() -> dict:
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


def find_cell(man: dict, name: str) -> dict:
    for w in man["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def cell_metrics(man: dict, cell: str) -> tuple[list[dict], list[dict]]:
    """(end-to-end, per-layer) metrics that BENCHMARK.json gives the
    cell: an end-to-end metric everywhere unless its `workloads` list
    leaves the cell out; a per-layer metric in the cells of its
    `workloads` list, which every one has."""
    e2e = [m for m in man["end_to_end"]
           if cell in m.get("workloads", [cell])]
    per = [m for m in man["per_layer"] if cell in m["workloads"]]
    return e2e, per


def load_metric(name: str):
    """benchmark/metrics/<name>.py, loaded by path (names hold dots)."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Context:
    """What an entry is given: the cell's data, the reads and where to
    work.  overlap_args: the OverlapConfig fields of the configuration's
    daligner settings; overlap_ref: the same for the reference."""

    def __init__(self, workload: dict, config: dict, reads, seed: int,
                 device, workdir: str):
        self.workload = workload
        self.config = config
        self.reads = reads
        self.seed = seed
        self.device = device
        self.workdir = workdir
        d = config["daligner"]
        self.overlap_args = dict(kmer=d["k"], band_shift=d["w"],
                                 hit_min=d["h"], err=d["e"],
                                 min_len=d["l"], tspace=d["s"])
        self.overlap_ref = dict(tspace=d["s"], min_len=d["l"], err=d["e"])
        blocks = traffic.dbsplit_blocks(reads.lengths,
                                        config["block_mb"],
                                        int(config["reads"]["min_bp"]))
        self.blocks = blocks[:int(config.get("blocks", len(blocks)))]

    def sync(self) -> None:
        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize()


def card_line() -> str | None:
    """nvidia-smi's name and power limit of card 0, or None."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader", "-i", "0"],
                           capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return r.stdout.strip() or None


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def unreadable(err: Exception) -> dict:
    """The numbers of a unit whose records cannot be read: every check
    fails."""
    log(f"# records unreadable: {err!r}")
    return dict(format_faults=1, format={"unreadable": 1},
                segment_faults=1, segments=0, excess=0, true_pairs=0,
                missed=0, missed_true_pct=100.0, misplaced_pct=100.0,
                over_e_pct=100.0)


def run_cell(cell: str, seed: int, seconds: float, trace: bool, *,
             device="cuda", man: dict | None = None, workload=None,
             config=None, breaker=None, warm: bool = True
             ) -> tuple[dict, list[tuple]]:
    """One run of a cell.  Returns (result, checks): the result line's
    object and the (name, value, limit) of every number compared.
    workload/config: the cell's data (default: read from the files).
    breaker: a context manager (benchmark.faults) that breaks the timed
    path during set-up and the window; warm=False skips the warm-up (a
    reading of the control or a fault needs no steady window).  The
    benchmark's own runs take neither."""
    man = man or manifest()
    w = find_cell(man, cell)
    workload = workload or load_json(
        os.path.join(HERE, "workloads", f"{cell}.json"))
    config = config or load_json(
        os.path.join(HERE, "configs", f"{w['config']}.json"))
    e2e, per = cell_metrics(man, cell)
    on_card = torch.device(device).type == "cuda"
    entry_mod = importlib.import_module(
        f"benchmark.entries.{workload['entry']}")
    workdir = tempfile.mkdtemp(prefix="bench_")
    entry = None
    try:
        t_gen = time.perf_counter()
        reads = traffic.make_reads(config, seed, device)
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        ctx = Context(workload, config, reads, seed, device, workdir)
        log(f"# {cell}: {reads.n} reads, {int(reads.offsets[-1])} bp, "
            f"blocks {ctx.blocks}, made in "
            f"{time.perf_counter() - t_gen:.2f}s")
        with breaker() if breaker else contextlib.nullcontext():
            entry = entry_mod.make(ctx)
            t_warm = time.perf_counter()
            if warm:
                entry.warm()
            log(f"# warm-up {time.perf_counter() - t_warm:.2f}s")
            saved = tracing.wrap_spans(entry_mod.SPANS) if trace else []
            prof = None
            if trace:
                with tracing.traced(device) as prof:
                    setup_s = time.time() - T_PROCESS
                    with torch.profiler.record_function(tracing.WINDOW):
                        t0, units = entry.run(seconds)
                tracing.unwrap_spans(saved)
            else:
                setup_s = time.time() - T_PROCESS
                t0, units = entry.run(seconds)
            entry.finish()
        t_end = units[-1]["t_end"]
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        entry.release()
        if on_card:
            torch.cuda.empty_cache()
        try:
            recs = [entry.records(u) for u in units]
            digests = [entry.digest(u) for u in units]
        except (OSError, ValueError) as e:
            recs, digests, broken = None, [None] * len(units), e
        aligned = ([work.aligned_bp(*r) for r in recs] if recs
                   else [0] * len(units))
        window = t_end - t0
        log(f"# window {window:.4f}s, {len(units)} units, walls "
            f"{[round(u['wall'], 4) for u in units]}, aligned bp {aligned}")
        log("# seeding (path, hits) a pair: "
            f"{[(p.get('seed_path'), p.get('total_hits')) for u in units for p in u['pairs']]}")
        rng = np.random.default_rng(traffic.seed_words(seed, 7))
        judged = int(rng.integers(len(units)))
        t_ref = time.perf_counter()
        a_ids, b_ids = entry.read_sets()
        verdict = (reference.judge(recs[judged][0], reads, a_ids, b_ids,
                                   ctx.overlap_ref, workload["check"], seed,
                                   device) if recs else unreadable(broken))
        log(f"# reference {time.perf_counter() - t_ref:.2f}s on unit "
            f"{judged}: {json.dumps(verdict)}")
        differing = sum(d != digests[judged] for d in digests)
        limits = workload["limits"]
        numbers = dict(verdict, units_differing=differing)
        checks = [(k, numbers[k], limits[k]) for k in sorted(limits)]
        correct = all(v <= lim for _, v, lim in checks)
        failed = differing + (0 if correct else len(units) - differing)
        values = dict(entry.end_to_end(recs or [], t0, t_end),
                      peak_mem_gib=peak / 2 ** 30, setup_s=setup_s)
        result = {"correct": correct, "attempted": len(units),
                  "failed": failed, "metrics": {}, "device": {}}
        if trace:
            red = tracing.reduce(prof)
            run = dict(units=units, records=recs, trace=red,
                       workload=workload, config=config)
            for m in per:
                v = load_metric(m["name"]).read(run)
                if v is not None:
                    result["metrics"][m["name"]] = {"value": float(v),
                                                    "unit": m["unit"]}
            result["breakdown"] = {"device_ops": red["device_ops"],
                                   "idle_gaps": red["idle_gaps"]}
        else:
            for m in e2e:
                result["metrics"][m["name"]] = {
                    "value": float(values[m["name"]]), "unit": m["unit"]}
        result["device"] = {
            "platform": "gpu" if on_card else "cpu",
            "kind": (torch.cuda.get_device_name(0) if on_card
                     else "cpu"),
            "count": 1, "memory_peak_bytes": int(peak)}
        if trace:
            result["device"].update(busy_s=red["busy_s"],
                                    window_s=red["window_s"])
        result["checks"] = {k: {"value": v, "limit": lim}
                            for k, v, lim in checks}
        return result, checks
    finally:
        if entry is not None:
            entry.cleanup()
        shutil.rmtree(workdir, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    man = manifest()
    chips = int(find_cell(man, args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"no result: the cell needs {chips} CUDA card(s), this machine "
            f"has {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    log(f"# card: {card_line()}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")
    result, checks = run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), man=man)
    bad = forbidden_modules()
    if bad:
        log(f"no result: the process holds {bad}")
        return 3
    for k, v, lim in checks:
        log(f"check {k} = {v} (limit {lim})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
