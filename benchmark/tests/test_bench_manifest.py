"""BENCHMARK.json against the benchmark's contract: names, units and
lengths; every cell's data files; every per-layer metric's reader and
its `moves` reported in each cell it lists; the run-length budget."""
import json
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
MAN = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n\r]{1,200}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
CELLS = {w["name"]: w for w in MAN["workloads"]}


def test_top_level_keys_and_size():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 << 10
    assert 1 <= MAN["run_seconds"] <= 51
    assert isinstance(MAN["run_seconds"], int)


def test_paths_and_command():
    assert 1 <= len(MAN["paths"]) <= 16
    for p in MAN["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert os.path.isdir(os.path.join(ROOT, p))
    cmd = MAN["command"]
    assert 1 <= len(cmd) <= 32
    for w in cmd:
        assert LINE.match(w) and not w.startswith("/") and ".." not in w


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names(kind):
    entries = MAN[kind]
    names = [e["name"] for e in entries]
    assert len(set(names)) == len(names)
    for n in names:
        assert NAME.match(n), n


def test_names_unique_across_metrics():
    names = [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]]
    assert len(set(names)) == len(names)


def test_configs():
    assert 1 <= len(MAN["configs"]) <= 24
    used = {w["config"] for w in MAN["workloads"]}
    files = set()
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert LINE.match(c["source"]) and LINE.match(c["why"])
        assert c["file"].startswith("benchmark/") and c["file"] not in files
        files.add(c["file"])
        data = json.load(open(os.path.join(ROOT, c["file"])))
        assert data["source"] == c["source"]
        assert data["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16
        for k in c["reduced"]:
            assert NAME.match(k) and k in data


def test_workloads():
    assert 1 <= len(MAN["workloads"]) <= 24
    pairs = set()
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
        assert LINE.match(w["why"])
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        data = json.load(open(os.path.join(
            ROOT, "benchmark", "workloads", f"{w['name']}.json")))
        assert data["config"] == w["config"]
        assert os.path.exists(os.path.join(
            ROOT, "benchmark", "entries", f"{data['entry']}.py"))
        assert set(data["limits"]) >= {"format_faults", "segment_faults",
                                       "units_differing",
                                       "missed_true_pct", "misplaced_pct",
                                       "over_e_pct"}
        assert data["check"]["slack_bp"] > 0
    four = sum(w["chips"] == 4 for w in MAN["workloads"])
    assert four <= max(1, len(MAN["workloads"]) // 4)


def test_metrics_fields():
    for m in MAN["end_to_end"]:
        allowed = {"name", "unit", "better", "bound", "source", "workloads"}
        assert set(m) <= allowed and set(m) >= allowed - {"workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in MAN["end_to_end"])
    layers = {}
    for m in MAN["per_layer"]:
        # the harness reports a per-layer metric in the cells of its
        # `workloads` list: every one names them
        allowed = {"name", "unit", "better", "source", "layer", "moves",
                   "workloads"}
        assert set(m) == allowed
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert LINE.match(m["layer"])
        layers.setdefault(m["layer"], []).append(m["name"])
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_every_per_layer_metric_has_a_reader_and_its_moves():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    for m in MAN["per_layer"]:
        assert os.path.exists(os.path.join(
            ROOT, "benchmark", "metrics", f"{m['name']}.py")), m["name"]
        moves = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert cell in CELLS
            assert cell in moves.get("workloads", list(CELLS)), (
                m["name"], cell)


def test_every_cell_reports_setup_another_e2e_and_a_layer():
    from benchmark.run import cell_metrics
    for cell in CELLS:
        e2e, per = cell_metrics(MAN, cell)
        names = {m["name"] for m in e2e}
        assert "setup_s" in names and len(names) >= 2
        assert per


def test_run_length_fits_a_full_check_of_24_cells():
    runs = 2 + 14 * 24
    total = runs * (MAN["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


def test_files_under_paths_are_named_from_name_characters():
    for dirpath, dirnames, files in os.walk(os.path.join(ROOT, "benchmark")):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), ROOT)
            assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
