"""What the per-layer readers of the pair timers share: the program's
pair stats of the window's units (t_seed and t_pool end at a
stream sync, t_trace when the records are on the host)."""
from __future__ import annotations


def mean_of(run: dict, keys: tuple[str, ...]):
    """Mean over the window's pairs of the sum of the timers `keys`, or
    None when no pair has them all."""
    vals = [sum(p[k] for k in keys) for u in run["units"]
            for p in u["pairs"] if all(k in p for k in keys)]
    return sum(vals) / len(vals) if vals else None
