"""Port vs reference for the graph stage (pipeline/graph.py and
pipeline/touring.py, damar_tpu's OGbuild/OGtour equivalents) on the
reference's own FIX.filtered.las: a run_pipeline workdir of the
hard-assembly genome (tests/test_hard_assembly.py: planted repeats, a
tandem array and 6% chimeric reads), made by damar_tpu with its native
host kernels (the same files as its device route, in seconds).

Every function of the two files runs through both packages on the same
records and read lengths: build_graph (containment, the dovetail
edges with their twins, the dict order the tour depends on),
transitive_reduction, clip_spurs, pop_bubbles, tour_graph, tour_to_seq,
tour_layout, dedupe_contained_contigs, tour_las, assemble,
layout_coords, graphml and layout_svg; plus the edges whose mirror
record was discarded (fault 3i) and the edges without a twin, counted
in both.
Tolerance: exact equality (Python ints, strings, arrays)."""
import os

import numpy as np
import pytest

from damar_tpu.formats import las as ref_las
from damar_tpu.pipeline import graph as ref_graph
from damar_tpu.pipeline import touring as ref_touring
from damar_tpu.pipeline.run import run_pipeline as ref_run_pipeline
from damar_tpu_torch.formats import dazzdb, las, tracks
from damar_tpu_torch.formats.fasta import revcomp
from damar_tpu_torch.pipeline import graph, touring
from damar_tpu_torch.utils import sim

FUZZ, MIN_DOVETAIL = 40, 1000


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setenv("DAMAR_BP", "native")
    w = str(tmp_path_factory.mktemp("graph"))
    g = sim.make_genome(60_000, seed=41, n_repeats=3, repeat_len=1500,
                        tandem=1, tandem_period=90, tandem_len=1800)
    reads = sim.sample_reads(g, coverage=14, mean_len=4500, err=0.13,
                             seed=42, chimera_frac=0.06)
    sim.write_sim_fasta(os.path.join(w, "reads.fasta"), reads)
    try:
        ref_run_pipeline(os.path.join(w, "reads.fasta"), w, polish=False,
                         verbose=False)
    finally:
        mp.undo()
    return w


@pytest.fixture(scope="module")
def inputs(workdir):
    """The filtered records (each package's reader) and the trimmed read
    universe run.py builds for the graph stage."""
    fdb = dazzdb.DazzDB.open(os.path.join(workdir, "FIX.db"))
    trim = tracks.read_track(os.path.join(workdir, "FIX.db"), "trim")
    bounds = {}
    for i in range(fdb.ureads):
        t = trim.data[i]
        bounds[i] = ((int(t[0]), int(t[1])) if len(t) == 2
                     else (0, int(fdb.reads["rlen"][i])))
    trlen = {i: max(e - b, 0) for i, (b, e) in bounds.items()}

    def seq_of(i, comp):
        b, e = bounds[i]
        s = fdb.read_seq(i)[b:e]
        return revcomp(s) if comp else s
    path = os.path.join(workdir, "FIX.filtered.las")
    return las.read_las(path), ref_las.read_las(path), trlen, seq_of


def edges_of(g):
    """The graph as plain tuples, in its dict order."""
    return [(e.src.read, e.src.dir, e.dst.read, e.dst.dir, e.cut, e.adv,
             e.olen, e.src_end, e.reduced)
            for v in g.edges for e in g.edges[v]]


def state_of(g):
    return (edges_of(g), sorted(g.contained), sorted(g.reads),
            [(v.read, v.dir, d) for v, d in g.in_deg.items()])


def tours_of(ts):
    return [([(v.read, v.dir, c) for v, c in t.steps], t.ends, t.circular)
            for t in ts]


def one_sided(g, kept) -> tuple[int, int]:
    """(edges with no twin, edges whose read pair has a kept record one
    way and none the other: their mirror record was discarded)."""
    edges = [e for v in list(g.edges) for e in g.edges[v]]
    return (sum(1 for e in edges if g.twin_of(e) is None),
            sum(1 for e in edges if ((e.src.read, e.dst.read) in kept)
                != ((e.dst.read, e.src.read) in kept)))


@pytest.fixture(scope="module")
def graphs(inputs):
    pl, rl, trlen, _ = inputs
    return (graph.build_graph(pl, trlen, fuzz=FUZZ,
                              min_dovetail=MIN_DOVETAIL),
            ref_graph.build_graph(rl, trlen, fuzz=FUZZ,
                                  min_dovetail=MIN_DOVETAIL))


def test_build_graph_and_one_sided_edges(graphs, inputs):
    g, r = graphs
    assert state_of(g) == state_of(r)
    assert g.n_edges() == r.n_edges() > 100
    assert len(g.contained) > 0
    # fault 3i: edges whose mirror record LAfilter discarded (the graph
    # synthesizes each edge's twin from the same record, so none lacks
    # a twin)
    h = inputs[0].columns.headers
    live = (h[:, las.H_FLAGS] & 0x4) == 0
    kept = set(zip(h[live, las.H_AREAD].tolist(),
                   h[live, las.H_BREAD].tolist()))
    assert one_sided(g, kept) == one_sided(r, kept)
    assert one_sided(g, kept)[1] > 0
    for v in list(g.edges)[:50]:
        for e in g.edges[v]:
            t = g.twin_of(e)
            rt = r.twin_of(next(x for x in r.edges[ref_graph.Vertex(
                v.read, v.dir)] if x.dst.read == e.dst.read
                and x.dst.dir == e.dst.dir))
            assert (t is None) == (rt is None)


def test_cleanup_steps_and_tour(inputs):
    """transitive_reduction -> clip_spurs -> pop_bubbles -> tour_graph on
    fresh graphs, each step's count and the graph after it equal."""
    pl, rl, trlen, seq_of = inputs
    g = graph.build_graph(pl, trlen, fuzz=FUZZ, min_dovetail=MIN_DOVETAIL)
    r = ref_graph.build_graph(rl, trlen, fuzz=FUZZ,
                              min_dovetail=MIN_DOVETAIL)
    counts = []
    for step, ref_step, arg in (
            (graph.transitive_reduction, ref_graph.transitive_reduction, 100),
            (touring.clip_spurs, ref_touring.clip_spurs, 3),
            (touring.pop_bubbles, ref_touring.pop_bubbles, 8)):
        n = step(g, arg)
        assert n == ref_step(r, arg)
        assert state_of(g) == state_of(r)
        counts.append(n)
    assert counts[0] > 0
    tours, ref_tours = touring.tour_graph(g), ref_touring.tour_graph(r)
    assert tours_of(tours) == tours_of(ref_tours) and tours
    for t, rt in zip(tours, ref_tours):
        assert np.array_equal(touring.tour_to_seq(t, seq_of),
                              ref_touring.tour_to_seq(rt, seq_of))
        assert touring.tour_layout(t, seq_of) == \
            ref_touring.tour_layout(rt, seq_of)
    coords = graph.layout_coords(g)
    ref_coords = ref_graph.layout_coords(r)
    assert [(v.read, v.dir, c) for v, c in coords.items()] == \
        [(v.read, v.dir, c) for v, c in ref_coords.items()]
    assert graph.graphml(g) == ref_graph.graphml(r)
    assert graph.graphml(g, coords) == ref_graph.graphml(r, ref_coords)
    assert graph.layout_svg(g, coords) == ref_graph.layout_svg(r, ref_coords)
    assert graph.layout_svg(g, {}) == ref_graph.layout_svg(r, {})


def test_tour_las_and_assemble(inputs):
    pl, rl, trlen, seq_of = inputs
    kw = dict(fuzz=FUZZ, min_dovetail=MIN_DOVETAIL, spur_len=3, bubble_max=8)
    tours, g = touring.tour_las(pl, trlen, **kw)
    rtours, rg = ref_touring.tour_las(rl, trlen, **kw)
    assert tours_of(tours) == tours_of(rtours)
    assert state_of(g) == state_of(rg)
    contigs, ts, g2 = touring.assemble(pl, trlen, seq_of, **kw)
    rcontigs, rts, rg2 = ref_touring.assemble(rl, trlen, seq_of, **kw)
    assert len(contigs) == len(rcontigs) >= 1
    assert all(np.array_equal(x, y) for x, y in zip(contigs, rcontigs))
    assert tours_of(ts) == tours_of(rts)
    # containment dedupe, with a contained copy and a reverse complement
    extra = [contigs[0], contigs[0][1000:5000].copy(),
             revcomp(contigs[0][2000:9000]), sim.make_genome(3000, seed=9)]
    ts4 = [ts[0]] * 4
    got = touring.dedupe_contained_contigs(extra, ts4)
    want = ref_touring.dedupe_contained_contigs(extra, ts4)
    assert len(got[0]) == len(want[0]) == 2
    assert all(np.array_equal(x, y) for x, y in zip(got[0], want[0]))


def test_empty_and_object_backed_files(inputs):
    _, rl, trlen, _ = inputs
    empty = graph.build_graph(las.LasFile(100), trlen)
    assert edges_of(empty) == [] and not empty.contained
    assert touring.tour_graph(empty) == []
    # records as objects (no columns) give the reference's graph
    got = graph.build_graph(las.LasFile(rl.tspace, overlaps=rl.overlaps),
                            trlen, fuzz=FUZZ, min_dovetail=MIN_DOVETAIL)
    want = ref_graph.build_graph(rl, trlen, fuzz=FUZZ,
                                 min_dovetail=MIN_DOVETAIL)
    assert state_of(got) == state_of(want) and edges_of(got)
