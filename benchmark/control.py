"""Readings that set the limits of `correct`: the program's sound runs
and the control's (and any planted fault's), on several seeds of a cell
at its own size, in one process so the kernels build once.

    python -m benchmark.control --workload <cell> --seconds <s> \\
        [--seeds 1,2,3] [--breakers weaker_settings,made_up \\
         --breaker-seeds 4,5,6]

Each run is a run of the cell without its warm-up (set-up, a window of
`--seconds`, the reference): sound on each of --seeds, and with the
timed path broken by each named breaker (benchmark/faults.py; the
control is `weaker_settings`, -k15 -h100 for -k14 -h35) on each of
--breaker-seeds.  Prints one JSON line a run with every number compared,
then the largest reading of the sound runs and the smallest of each
breaker's.  The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from benchmark import faults, run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--breakers", default="")
    ap.add_argument("--breaker-seeds", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        run.log("no CUDA card: the readings are the card's")
        return 2

    def ints(text):
        return [int(x) for x in text.split(",") if x]
    runs = [(None, s) for s in ints(args.seeds)] + [
        (b, s) for b in args.breakers.split(",") if b
        for s in ints(args.breaker_seeds)]
    readings: dict = {}
    for kind, seed in runs:
        res, checks = run.run_cell(
            args.workload, seed, args.seconds, False, warm=False,
            breaker=faults.BREAKERS[kind] if kind else None)
        line = dict(kind=kind or "program", seed=seed,
                    correct=res["correct"],
                    numbers={k: v for k, v, _ in checks},
                    metrics=res["metrics"])
        print(json.dumps(line), flush=True)
        readings.setdefault(kind or "program", []).append(line)
        torch.cuda.empty_cache()
    summary = {}
    for kind, lines in readings.items():
        pick = max if kind == "program" else min
        summary[kind] = {k: pick(x["numbers"][k] for x in lines)
                         for k in lines[0]["numbers"]}
        summary[kind]["correct"] = [x["correct"] for x in lines]
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
