"""Seconds of a sweep outside its pairs' device and emit phases: DB
load, block builds, the .las writes and the merge.  A sweep's wall less
its pairs' phase timers (t_seed, t_extend, t_dedupe, t_pool, t_trace),
mean over the window's sweeps; valid where the sweep has one pair, so
no pair's phases overlap another's."""
PHASES = ("t_seed", "t_extend", "t_dedupe", "t_pool", "t_trace")


def read(run):
    vals = [u["wall"] - sum(p[k] for k in PHASES)
            for u in run["units"]
            if len(u["pairs"]) == 1
            and all(k in u["pairs"][0] for k in PHASES)
            for p in u["pairs"]]
    return sum(vals) / len(vals) if vals else None
