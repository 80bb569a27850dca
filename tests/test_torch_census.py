"""The census: every public function and class of damar_tpu (a top-level
def or class whose name does not start with "_", found by walking each
module's AST) has a counterpart of the same name in damar_tpu_torch,
except the names listed in EXCEPTIONS, each with its reason (ROADMAP.md,
"The census").  An exception that the port has come to define, or that
the reference no longer has, fails too, so the list stays exact.
Module constants are not counted."""
import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

NO_FALLBACK = ("host-C twins of the kernels and seeding; the port has no "
               "fallback: a CUDA tensor launches the kernel or raises")
PALLAS = ("Pallas wrappers of the TPU kernels; their work is done by "
          "ops/wave_bp.py (K1, K2) and ops/wave_wide.py (K3)")
OVERLAP = ("seed-download and dispatch helpers of the TPU pair path; their "
           "work is in pipeline/overlap.py _prep_units_dev, "
           "_extend_all_dev, extend_bidir and _assemble_extents_dev")
EXCEPTIONS = {
    "native.__init__": (NO_FALLBACK, (
        "available", "band_align_paths", "band_filter",
        "band_filter_packed", "bp_extend_batch", "bp_trace_batch",
        "canon_kmers", "dust_batch", "fill_hits_packed",
        "fill_hits_strand", "las_merge", "las_scan", "lexsort",
        "plain_kmers", "radix_argsort", "ragged_copy", "revcomp_reads",
        "run_firsts", "self_hit_counts", "trace_points_batch")),
    "ops.seeding_host": (NO_FALLBACK, (
        "canon_index_host", "fetch_seeds_host",
        "find_seeds_canonical_host", "find_tandem_seeds_host")),
    "ops.wave_bp_pallas": (PALLAS, ("extend_wave_bp_pl", "trace_wave_bp_pl")),
    "ops.wave_pallas": (PALLAS, ("extend_wave_pl", "trace_wave_pl")),
    "ops.wave": ("the wide lane-per-diagonal extension in pure JAX; "
                 "ops/wave_wide.py extend_wave_wide does its work on K3",
                 ("extend_wave",)),
    "pipeline.overlap": (OVERLAP, (
        "concat_extents", "dedupe_anchor_seeds", "extend_seeds_dispatch_p2",
        "extend_seeds_harvest", "extend_seeds_launch", "fetch_seeds",
        "fetch_seeds_meta", "split_seeds_by_comp")),
    "utils.platform": ("TPU platform probes; the port takes a torch device",
                       ("force_cpu", "on_tpu", "platform_name")),
}


def public_defs(pkg: str) -> dict:
    """{module (dotted, relative to the package): set of public top-level
    function and class names}."""
    out = {}
    base = os.path.join(ROOT, pkg)
    for root, _, files in os.walk(base):
        for f in sorted(files):
            if not f.endswith(".py"):
                continue
            path = os.path.join(root, f)
            mod = os.path.relpath(path, base)[:-3].replace(os.sep, ".")
            with open(path) as fh:
                tree = ast.parse(fh.read())
            out[mod] = {n.name for n in tree.body
                        if isinstance(n, (ast.FunctionDef,
                                          ast.AsyncFunctionDef,
                                          ast.ClassDef))
                        and not n.name.startswith("_")}
    return out


REF = public_defs("damar_tpu")
PORT = set().union(*public_defs("damar_tpu_torch").values())


@pytest.mark.parametrize("module", sorted(m for m in REF if REF[m]))
def test_every_public_name_has_a_counterpart(module):
    excepted = set(EXCEPTIONS.get(module, ("", ()))[1])
    missing = sorted(REF[module] - PORT - excepted)
    assert not missing, (f"damar_tpu.{module}: no counterpart in "
                         f"damar_tpu_torch for {missing}")


@pytest.mark.parametrize("module", sorted(EXCEPTIONS))
def test_every_exception_is_still_one(module):
    reason, names = EXCEPTIONS[module]
    assert reason and module in REF, module
    stale = sorted(n for n in names if n not in REF[module] or n in PORT)
    assert not stale, (f"{module}: {stale} are no longer exceptions (the "
                       f"port defines them or the reference lost them)")
