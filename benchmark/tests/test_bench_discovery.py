"""A configuration, a cell and a per-layer metric are added by adding
files alone: in a copy of the benchmark, a dummy configuration, cell and
metric (files and manifest entries, nothing else edited) run through
the harness's discovery, on the CPU at a small size."""
import hashlib
import json
import os
import shutil
import subprocess
import sys

from benchmark.tests import tiny

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


def digests(d):
    out = {}
    for dirpath, dirs, files in os.walk(d):
        dirs[:] = [x for x in dirs if x != "__pycache__"]
        for f in files:
            p = os.path.join(dirpath, f)
            out[os.path.relpath(p, d)] = hashlib.sha256(
                open(p, "rb").read()).hexdigest()
    return out


def test_dummy_config_cell_and_metric_run_by_discovery(tmp_path):
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    man = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    before = digests(tmp_path / "benchmark")
    wl, cfg = tiny.load("dmel-r6-clr30x-b100.pair")
    cfg.update(name="dummy-cfg", reduced=[])
    wl.update(name="dummy-cfg.pair", config="dummy-cfg")
    b = tmp_path / "benchmark"
    (b / "configs" / "dummy-cfg.json").write_text(json.dumps(cfg))
    (b / "workloads" / "dummy-cfg.pair.json").write_text(json.dumps(wl))
    (b / "metrics" / "dummy_units.py").write_text(
        '"""Units in the window."""\n\n\n'
        'def read(run):\n    return len(run["units"])\n')
    man["configs"].append(dict(name="dummy-cfg", source="a test",
                               file="benchmark/configs/dummy-cfg.json",
                               reduced=[], why="discovery"))
    man["workloads"].append(dict(name="dummy-cfg.pair", config="dummy-cfg",
                                 traffic="pair", chips=1, why="discovery"))
    for m in man["end_to_end"]:
        if "workloads" in m:
            m["workloads"].append("dummy-cfg.pair")
    man["per_layer"].append(dict(name="dummy_units", unit="units",
                                 better="higher", source="host_clock",
                                 layer="harness", moves="overlap_gbp_s",
                                 workloads=["dummy-cfg.pair"]))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    code = ("import json; from benchmark import run; "
            "r, c = run.run_cell('dummy-cfg.pair', 5, 1.0, True, "
            "device='cpu'); print(json.dumps(r))")
    env = {**os.environ, "PYTHONPATH": ROOT}
    r = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                       capture_output=True, text=True, timeout=900, env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert res["correct"], res
    assert res["metrics"]["dummy_units"]["value"] == res["attempted"]
    after = digests(tmp_path / "benchmark")
    changed = [k for k in before if before[k] != after.get(k)]
    assert changed == []
