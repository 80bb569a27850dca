"""A cell's data cut to a size the CPU runs in seconds: reads of ~1 kbp
over a 60 kbp genome, -l500, small samples.  The program runs its plain
kernel versions (device "cpu")."""
from __future__ import annotations

import copy
import json
import os

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load(cell: str) -> tuple[dict, dict]:
    with open(os.path.join(HERE, "workloads", f"{cell}.json")) as f:
        wl = json.load(f)
    with open(os.path.join(HERE, "configs", f"{wl['config']}.json")) as f:
        cfg = json.load(f)
    return tiny(wl, cfg)


def tiny(wl: dict, cfg: dict) -> tuple[dict, dict]:
    wl, cfg = copy.deepcopy(wl), copy.deepcopy(cfg)
    pair = wl["entry"] == "pair"
    cfg["genome"] = {"bp": 60_000, "repeat_copies": 0 if pair else 2,
                     "repeat_bp": 1500}
    cfg["reads"].update(coverage=8, mean_bp=1000, max_bp=1300, min_bp=500)
    if pair:
        cfg["reads"]["max_total_bp"] = 483_000
        cfg["block_mb"] = 0.24
    else:
        cfg["reads"].pop("max_total_bp", None)
        cfg["block_mb"] = 1
    cfg["daligner"]["l"] = 500
    wl["check"] = {"records": 60, "longest": 5, "a_reads": 40,
                   "true_min_bp": 700, "slack_bp": 100}
    wl["limits"] = dict(wl["limits"], missed_true_pct=25.0)
    return wl, cfg
