"""Graph touring and contig emission (OGtour + tour2fasta equivalents):
the port of damar_tpu/pipeline/touring.py, host numpy and Python.

Tours the transitively-reduced string graph: clips short spurs, pops
simple bubbles, then walks maximal unbranched paths (and leftover
cycles: circular genomes tour into circular contigs).  Each tour is an
ordered list of (read, dir, cut) steps; tour2fasta concatenates the
first read's oriented sequence with every subsequent read's oriented
suffix [cut:], exactly the junction the overlap trace committed to.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from damar_tpu_torch.pipeline.graph import (StringGraph, Vertex,
                                           build_graph, transitive_reduction)


@dataclass
class Tour:
    steps: list[tuple[Vertex, int]]   # (vertex, cut); cut=0 for first
    circular: bool = False
    # ends[i]: oriented-src overlap END of the edge INTO step i (None
    # for step 0, or when unknown): tour2fasta clips step i-1's part
    # there — the source read's tail beyond the overlap is not covered
    # by the junction alignment and would otherwise splice junk into
    # the contig
    ends: list | None = None

    def nreads(self) -> int:
        return len(self.steps)

    def end_of(self, i: int):
        if self.ends is None or i >= len(self.ends):
            return None
        return self.ends[i]


def clip_spurs(g: StringGraph, max_len: int = 3) -> int:
    """Remove short dead-end tips hanging off branch vertices
    (sequencing-error spurs).

    A branch is clipped ONLY when (a) it dead-ends within max_len
    unbranched edges, AND (b) a sibling branch at the same vertex
    continues strictly longer — a genuine contig end is a dead end too
    and must survive.  Clipping stops when the vertex would drop below
    one live out-edge."""
    n_clip = 0
    changed = True
    while changed:
        changed = False
        ind = g.live_in_deg()

        def walk_len(e, limit):
            """(#unbranched edges reachable via e (capped), dead_end?)"""
            path = [e]
            cur = e.dst
            while len(path) <= limit:
                nxt = g.out_edges(cur)
                if len(nxt) != 1 or ind.get(cur, 0) > 1:
                    return len(path), (len(nxt) == 0), path
                path.append(nxt[0])
                cur = nxt[0].dst
            return len(path), False, path

        for v in list(g.edges):
            outs = g.out_edges(v)
            if len(outs) <= 1:
                continue
            walks = [walk_len(e, max_len) for e in outs]
            longest = max(w[0] for w in walks)
            for (ln, dead, path), e in zip(walks, outs):
                if dead and ln <= max_len and ln < longest \
                        and len(g.out_edges(v)) > 1:
                    for pe in path:
                        g.reduce_edge(pe)
                        n_clip += 1
                    changed = True
    return n_clip


def pop_bubbles(g: StringGraph, max_len: int = 8) -> int:
    """Pop simple 2-branch bubbles: each branch walks unbranched until
    the first RECONVERGENCE vertex (live in-degree >= 2); if both
    branches reach the same one within max_len edges, the branch with
    the smaller total overlap support is removed.  (Walking a fixed
    edge count instead of stopping at reconvergence mis-pairs branches
    that are offset by one edge — e.g. a triangle v->x->w vs v->w —
    and pops real edges.)"""
    n_pop = 0
    changed = True
    while changed:
        changed = False
        ind = g.live_in_deg()
        for v in list(g.edges):
            outs = g.out_edges(v)
            if len(outs) != 2:
                continue

            def walk(e):
                path = [e]
                cur = e.dst
                while len(path) <= max_len and ind.get(cur, 0) == 1:
                    nxt = g.out_edges(cur)
                    if len(nxt) != 1:
                        break
                    path.append(nxt[0])
                    cur = nxt[0].dst
                return path, cur

            p1, end1 = walk(outs[0])
            p2, end2 = walk(outs[1])
            if end1 == end2 and ind.get(end1, 0) >= 2 \
                    and len(p1) <= max_len and len(p2) <= max_len:
                w1 = sum(e.olen for e in p1)
                w2 = sum(e.olen for e in p2)
                loser = p1 if w1 < w2 else p2
                for e in loser:
                    g.reduce_edge(e)
                    n_pop += 1
                changed = True
                break  # in-degrees changed; restart with fresh counts
    return n_pop


def tour_graph(g: StringGraph) -> list[Tour]:
    """Walk maximal unbranched paths, then leftover simple cycles.
    Each contig is emitted once (its reverse-complement twin walk is
    suppressed by marking twin vertices used)."""
    ind = g.live_in_deg()
    used: set[Vertex] = set()
    tours: list[Tour] = []

    def walk_from(v: Vertex, circular: bool) -> Tour | None:
        if v in used:
            return None
        steps: list[tuple[Vertex, int]] = [(v, 0)]
        ends: list = [None]
        used.add(v)
        used.add(v.twin)
        cur = v
        while True:
            outs = [e for e in g.out_edges(cur) if e.dst not in used]
            live = g.out_edges(cur)
            if len(live) != 1:
                break
            e = live[0]
            if ind.get(e.dst, 0) != 1:
                break
            if e.dst in used:
                # closed a cycle back to the start
                if e.dst == v:
                    return Tour(steps=steps + [(v, e.cut)],
                                ends=ends + [e.src_end],
                                circular=True)
                break
            steps.append((e.dst, e.cut))
            ends.append(e.src_end)
            used.add(e.dst)
            used.add(e.dst.twin)
            cur = e.dst
        return Tour(steps=steps, ends=ends, circular=False)

    # linear path starts: out-deg >= 1, in-deg != 1 (or predecessor is a
    # branch)
    verts = set(g.edges.keys()) | {e.dst for es in g.edges.values()
                                   for e in es if not e.reduced}
    for v in sorted(verts, key=lambda u: (u.read, u.dir)):
        if v in used:
            continue
        if ind.get(v, 0) != 1 and g.out_edges(v):
            t = walk_from(v, circular=False)
            if t:
                tours.append(t)
    # leftover cycles
    for v in sorted(verts, key=lambda u: (u.read, u.dir)):
        if v not in used and g.out_edges(v):
            t = walk_from(v, circular=True)
            if t:
                tours.append(t)
    return tours


def tour_to_seq(tour: Tour, seq_of) -> np.ndarray:
    """Emit the contig sequence: seq_of(read, dir) -> oriented codes.

    Circular tours: the final step re-enters the start vertex; its
    suffix is dropped AND the first read's prefix [0, cut) — which the
    last read's tail already spells — is trimmed, so a circular contig
    has ~genome length with no duplicated closure."""
    first_v, _ = tour.steps[0]
    parts = [seq_of(first_v.read, first_v.dir)]
    prev_cut = 0
    for i, (v, cut) in enumerate(tour.steps[1:], 1):
        se = tour.end_of(i)
        if se is not None and se - prev_cut < len(parts[-1]):
            # clip the previous part at the junction overlap's end:
            # its tail beyond is not covered by the alignment (up to
            # fuzz + endpoint slop of novel junk otherwise)
            parts[-1] = parts[-1][:max(se - prev_cut, 0)]
        s = seq_of(v.read, v.dir)
        parts.append(s[cut:])
        prev_cut = cut
    trim = 0
    if tour.circular and len(tour.steps) > 1:
        parts.pop()
        trim = tour.steps[-1][1]
    seq = np.concatenate(parts) if parts else np.zeros(0, np.uint8)
    return seq[trim:]


def tour_layout(tour: Tour, seq_of) -> list[tuple[int, int, int]]:
    """Contig coordinates of each tour read: [(read, dir, start)] —
    read r oriented d aligns to contig[start : start + len(r)].
    Feeds consensus.polish_contig without any alignment search."""
    first = tour.steps[0][0]
    trim = tour.steps[-1][1] if (tour.circular and len(tour.steps) > 1) \
        else 0
    # circular contigs are emitted with the first read's [0, trim)
    # prefix removed (tour_to_seq), so every start shifts by -trim;
    # the first read's (possibly negative) start is still correct:
    # its first `trim` bases are simply not in the contig
    layout = [(first.read, first.dir, -trim)]
    steps = tour.steps[1:-1] if (tour.circular and len(tour.steps) > 1) \
        else tour.steps[1:]
    prev_start = -trim
    prev_L = len(seq_of(first.read, first.dir))
    for i, (v, cut) in enumerate(steps, 1):
        # junction clip (see tour_to_seq): part i-1 ends at the
        # incoming edge's src-side overlap end, not the read end
        se = tour.end_of(i)
        prev_end = prev_L if se is None else min(max(se, 0), prev_L)
        start = prev_start + prev_end - cut
        layout.append((v.read, v.dir, start))
        prev_start = start
        prev_L = len(seq_of(v.read, v.dir))
    return layout


def dedupe_contained_contigs(contigs: list[np.ndarray],
                             tours: list["Tour"], k: int = 16,
                             frac: float = 0.5
                             ) -> tuple[list[np.ndarray], list["Tour"]]:
    """Drop contigs whose sequence is (near-)contained in a longer
    contig: repeat branch points make touring emit alternate walks of
    the same genomic region as separate contigs (over-assembly).

    Works on POLISHED contigs (run after consensus): two ~99%-identity
    copies of a region share ~(0.99^k)^2 ~ 0.7 of exact k-mers, while
    genuinely distinct regions share ~1e-4 — frac=0.5 separates them;
    at RAW draft error exact k-mers never match and this is a no-op."""
    order = np.argsort([-len(c) for c in contigs])
    kept_idx: list[int] = []
    seen: set[bytes] = set()
    for i in order:
        c = contigs[i]
        cb = bytes(c.astype(np.uint8))
        if len(cb) > k:
            kms = [cb[p:p + k] for p in range(0, len(cb) - k, 11)]
            hits = sum(1 for x in kms if x in seen)
            if kms and hits / len(kms) >= frac:
                continue                     # contained walk: drop
        kept_idx.append(i)
        rb = bytes((c[::-1] ^ 3).astype(np.uint8))
        for p in range(len(cb) - k):
            seen.add(cb[p:p + k])
        for p in range(len(rb) - k):
            seen.add(rb[p:p + k])
    return ([contigs[i] for i in kept_idx],
            [tours[i] for i in kept_idx])


def tour_las(las, rlen_of: dict[int, int], fuzz: int = 25,
             min_dovetail: int = 1000, spur_len: int = 3,
             bubble_max: int = 8) -> tuple[list[Tour], StringGraph]:
    """Graph stage (build -> transitive reduction -> spur/bubble
    cleanup -> unbranched walks) shared by assemble() and the
    standalone ogtour CLI — one definition so the staged and one-shot
    paths cannot drift."""
    g = build_graph(las, rlen_of, fuzz=fuzz, min_dovetail=min_dovetail)
    transitive_reduction(g)
    clip_spurs(g, spur_len)
    pop_bubbles(g, bubble_max)
    return tour_graph(g), g


def assemble(las, rlen_of: dict[int, int], seq_of, fuzz: int = 25,
             min_dovetail: int = 1000, spur_len: int = 3,
             bubble_max: int = 8) -> tuple[list[np.ndarray], list[Tour],
                                           StringGraph]:
    """Full L6: graph -> reduce -> clean -> tour -> contig sequences
    (duplicate repeat-branch walks dropped)."""
    tours, g = tour_las(las, rlen_of, fuzz=fuzz,
                        min_dovetail=min_dovetail, spur_len=spur_len,
                        bubble_max=bubble_max)
    contigs = [tour_to_seq(t, seq_of) for t in tours]
    # order by length, longest first (containment dedupe happens after
    # polishing — raw drafts share no exact k-mers)
    order = np.argsort([-len(c) for c in contigs])
    return [contigs[i] for i in order], [tours[i] for i in order], g
