"""String/overlap graph construction (OGbuild equivalent): the port of
damar_tpu/pipeline/graph.py, host numpy and Python as there.

Vertices are oriented reads (read, dir); a directed edge u -> v means
"contig continues from u into v", labeled with the destination cut
position (oriented-v coordinate where the novel suffix starts) and the
advance length.  One edge is emitted per proper right-dovetail record;
the mirrored .las records supply the twin edges.

Containment removal and Myers-style transitive reduction happen here;
touring/bubble/spur logic lives in pipeline.touring.  The dict and set
containers are the reference's, whose iteration order the tour depends
on.
"""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field

import numpy as np

from damar_tpu_torch.formats.las import (H_ABPOS, H_AEPOS, H_AREAD, H_BBPOS,
                                         H_BEPOS, H_BREAD, H_FLAGS,
                                         columns_of)
from damar_tpu_torch.formats.oflags import OVL_COMP, OVL_DISCARD


@dataclass(frozen=True)
class Vertex:
    read: int
    dir: int  # 0 = forward, 1 = reverse-complement

    @property
    def twin(self) -> "Vertex":
        return Vertex(self.read, 1 - self.dir)


@dataclass
class Edge:
    src: Vertex
    dst: Vertex
    cut: int          # oriented-dst coordinate where novel suffix starts
    adv: int          # bases the edge advances (len(dst) - cut)
    olen: int         # overlap length (support/weight)
    # oriented-src coordinate where the overlap ENDS: the src read's
    # tail beyond it (<= fuzz + alignment slop) is NOT covered by the
    # overlap and would be spliced into the contig as novel junk if
    # the tour appended the full part (tour_to_seq clips here)
    src_end: int | None = None
    reduced: bool = False


@dataclass
class StringGraph:
    edges: dict[Vertex, list[Edge]] = field(default_factory=lambda:
                                            defaultdict(list))
    in_deg: dict[Vertex, int] = field(default_factory=lambda:
                                      defaultdict(int))
    contained: set[int] = field(default_factory=set)
    reads: set[int] = field(default_factory=set)

    def out_edges(self, v: Vertex) -> list[Edge]:
        return [e for e in self.edges.get(v, []) if not e.reduced]

    def add(self, e: Edge) -> None:
        self.edges[e.src].append(e)
        self.in_deg[e.dst] += 1
        self.reads.add(e.src.read)
        self.reads.add(e.dst.read)

    def live_in_deg(self) -> dict[Vertex, int]:
        d: dict[Vertex, int] = defaultdict(int)
        for es in self.edges.values():
            for e in es:
                if not e.reduced:
                    d[e.dst] += 1
        return d

    def n_edges(self) -> int:
        return sum(len(self.out_edges(v)) for v in list(self.edges))

    def twin_of(self, e: Edge) -> "Edge | None":
        """The reverse-complement counterpart (src'=dst.twin,
        dst'=src.twin) — present when the mirrored .las record produced
        it."""
        for t in self.edges.get(e.dst.twin, []):
            if t.dst == e.src.twin:
                return t
        return None

    def reduce_edge(self, e: Edge) -> None:
        """Mark an edge AND its twin reduced — all graph edits must be
        twin-symmetric or touring sees asymmetric dead ends."""
        e.reduced = True
        t = self.twin_of(e)
        if t is not None:
            t.reduced = True


def build_graph(las, rlen_of: dict[int, int], fuzz: int = 25,
                min_dovetail: int = 1000) -> StringGraph:
    """Filtered+mirrored .las -> string graph.

    Only records without DISCARD flags contribute.  Contained reads
    (fully covered by another read) are dropped with all their edges.
    An object-backed file is read through its columns (one build pass).
    """
    g = StringGraph()
    cols = columns_of(las)
    if cols.n:
        return _build_graph_columnar(g, cols, rlen_of, fuzz,
                                     min_dovetail)
    return g


def _build_graph_columnar(g: StringGraph, cols, rlen_of, fuzz: int,
                          min_dovetail: int) -> StringGraph:
    """Columnar twin of build_graph's two passes: vectorized
    containment + dovetail classification over the headers, with
    per-record Python objects only for the surviving dovetails (the
    invariant: no object materialization at block scale)."""
    h = cols.headers
    ar = h[:, H_AREAD].astype(np.int64)
    br = h[:, H_BREAD].astype(np.int64)
    rl = np.full(int(max(ar.max(), br.max())) + 1, -1, np.int64)
    for r, L in rlen_of.items():
        if 0 <= r < len(rl):
            rl[r] = L
    alen, blen = rl[ar], rl[br]
    if (alen < 0).any() or (blen < 0).any():
        # a read missing from rlen_of raises KeyError, as the
        # reference's per-record loop does (a length of 0 would silently
        # mis-mark the read contained)
        bad = int(ar[alen < 0][0]) if (alen < 0).any() \
            else int(br[blen < 0][0])
        raise KeyError(bad)
    abp, bbp = h[:, H_ABPOS], h[:, H_BBPOS]
    aep, bep = h[:, H_AEPOS], h[:, H_BEPOS]
    live = (h[:, H_FLAGS] & OVL_DISCARD) == 0
    # containment: a first, ELSE b (a record satisfying both marks
    # only aread, as the reference's per-record loop does)
    cont_a = live & (abp <= fuzz) & (aep >= alen - fuzz)
    cont_b = live & ~cont_a & (bbp <= fuzz) & (bep >= blen - fuzz)
    for r in np.unique(ar[cont_a]):
        g.contained.add(int(r))
    for r in np.unique(br[cont_b]):
        g.contained.add(int(r))
    cset = np.zeros(len(rl), bool)
    cset[list(g.contained)] = True
    olen = aep - abp
    keep = live & ~cset[ar] & ~cset[br] & (olen >= min_dovetail)
    right = keep & (aep >= alen - fuzz) & (bbp <= fuzz) \
        & (abp > fuzz) & (bep < blen - fuzz)
    left = keep & ~right & (abp <= fuzz) & (bep >= blen - fuzz) \
        & (aep < alen - fuzz) & (bbp > fuzz)
    best: dict[tuple, Edge] = {}

    def offer(e: Edge):
        key = (e.src, e.dst)
        old = best.get(key)
        if old is None or e.olen > old.olen:
            best[key] = e

    comp_all = (h[:, H_FLAGS] & OVL_COMP) != 0
    for i in np.nonzero(right | left)[0]:
        a, b = int(ar[i]), int(br[i])
        al, bl = int(alen[i]), int(blen[i])
        ol = int(olen[i])
        comp = int(comp_all[i])
        if right[i]:
            offer(Edge(src=Vertex(a, 0), dst=Vertex(b, comp),
                       cut=int(bep[i]), adv=bl - int(bep[i]), olen=ol,
                       src_end=int(aep[i])))
            offer(Edge(src=Vertex(b, 1 - comp), dst=Vertex(a, 1),
                       cut=al - int(abp[i]), adv=int(abp[i]), olen=ol,
                       src_end=bl - int(bbp[i])))
        else:
            offer(Edge(src=Vertex(b, comp), dst=Vertex(a, 0),
                       cut=int(aep[i]), adv=al - int(aep[i]), olen=ol,
                       src_end=int(bep[i])))
            offer(Edge(src=Vertex(a, 1), dst=Vertex(b, 1 - comp),
                       cut=bl - int(bbp[i]), adv=int(bbp[i]), olen=ol,
                       src_end=al - int(abp[i])))
    for e in best.values():
        g.add(e)
    return g


def transitive_reduction(g: StringGraph, fuzz: int = 100) -> int:
    """Myers 2005 mark-and-sweep: an edge v->w is transitive when some
    v->x and x->w exist with adv(v->x)+adv(x->w) ~ adv(v->w).  Returns
    the number of edges reduced."""
    n_red = 0
    for v in list(g.edges):
        outs = list(g.edges.get(v, []))
        if len(outs) < 2:
            continue
        outs.sort(key=lambda e: e.adv)
        target_adv = {(e.dst.read, e.dst.dir): e for e in outs}
        longest = outs[-1].adv
        for e_vx in outs:
            # NOTE: already-reduced edges still witness transitivity
            # (the path they certify exists regardless), so they are
            # not skipped here — skipping them leaves order-dependent
            # un-reduced transitive edges behind.
            for e_xw in g.edges.get(e_vx.dst, []):
                tot = e_vx.adv + e_xw.adv
                if tot > longest + fuzz:
                    continue
                key = (e_xw.dst.read, e_xw.dst.dir)
                e_vw = target_adv.get(key)
                if e_vw is not None and not e_vw.reduced \
                        and e_vw is not e_vx \
                        and abs(e_vw.adv - tot) <= fuzz:
                    g.reduce_edge(e_vw)
                    n_red += 1
    return n_red


def layout_coords(g: StringGraph) -> dict:
    """OGlayout-equivalent coordinates for the live graph.

    x = cumulative edge advance along a BFS spanning forest (the
    genome-like coordinate: a clean contig path lays out as a straight
    line, bubbles as short parallel arcs); y = branch lane, assigned
    when a node has several live successors; weakly-connected
    components stack vertically.  Deterministic (sorted traversal).
    """
    succ: dict = {}
    pred: dict = {}
    verts = set()
    for v in list(g.edges):
        for e in g.out_edges(v):
            succ.setdefault(e.src, []).append(e)
            pred.setdefault(e.dst, []).append(e)
            verts.add(e.src)
            verts.add(e.dst)
    order = sorted(verts, key=lambda v: (v.read, v.dir))
    coords: dict = {}
    comp_y = 0.0
    lane_h = 1.0
    for root in order:
        if root in coords:
            continue
        # prefer a source-like root within the component
        comp = []
        stack = [root]
        seen = {root}
        while stack:
            u = stack.pop()
            comp.append(u)
            for e in succ.get(u, []) + pred.get(u, []):
                for w in (e.src, e.dst):
                    if w not in seen:
                        seen.add(w)
                        stack.append(w)
        sources = sorted((u for u in comp if not pred.get(u)),
                         key=lambda v: (v.read, v.dir))
        start = sources[0] if sources else min(
            comp, key=lambda v: (v.read, v.dir))
        from collections import deque
        q = deque([start])
        coords[start] = (0.0, comp_y)
        max_lane = 0.0
        while q:
            u = q.popleft()
            x, y = coords[u]
            outs = sorted(succ.get(u, []),
                          key=lambda e: (-e.olen, e.dst.read, e.dst.dir))
            for lane, e in enumerate(outs):
                if e.dst not in coords:
                    yy = y + lane * lane_h
                    coords[e.dst] = (x + e.adv, yy)
                    max_lane = max(max_lane, yy - comp_y)
                    q.append(e.dst)
            # walk predecessors too (roots inside cycles see the
            # whole component)
            for e in sorted(pred.get(u, []),
                            key=lambda e: (e.src.read, e.src.dir)):
                if e.src not in coords:
                    coords[e.src] = (x - e.adv, y)
                    q.append(e.src)
        comp_y += max_lane + 3 * lane_h
    return coords


def graphml(g: StringGraph, coords: dict | None = None) -> str:
    """Export the live graph as GraphML (the OGbuild output format);
    pass layout_coords(g) to embed OGlayout x/y node positions."""
    lines = [
        '<?xml version="1.0" encoding="UTF-8"?>',
        '<graphml xmlns="http://graphml.graphdrawing.org/xmlns">',
        '  <key id="cut" for="edge" attr.name="cut" attr.type="int"/>',
        '  <key id="adv" for="edge" attr.name="adv" attr.type="int"/>',
        '  <key id="olen" for="edge" attr.name="olen" attr.type="int"/>',
    ]
    if coords is not None:
        lines += [
            '  <key id="x" for="node" attr.name="x" attr.type="double"/>',
            '  <key id="y" for="node" attr.name="y" attr.type="double"/>',
        ]
    lines.append('  <graph id="G" edgedefault="directed">')
    seen = set()
    def vid(v):
        return f"{v.read}{'-' if v.dir else '+'}"
    def node_line(u):
        if coords is not None and u in coords:
            x, y = coords[u]
            return (f'    <node id="{vid(u)}"><data key="x">{x:.1f}'
                    f'</data><data key="y">{y:.3f}</data></node>')
        return f'    <node id="{vid(u)}"/>'
    for v in list(g.edges):
        for e in g.out_edges(v):
            for u in (e.src, e.dst):
                if vid(u) not in seen:
                    seen.add(vid(u))
                    lines.append(node_line(u))
            lines.append(
                f'    <edge source="{vid(e.src)}" target="{vid(e.dst)}">'
                f'<data key="cut">{e.cut}</data>'
                f'<data key="adv">{e.adv}</data>'
                f'<data key="olen">{e.olen}</data></edge>')
    lines += ['  </graph>', '</graphml>']
    return "\n".join(lines)


def layout_svg(g: StringGraph, coords: dict, width: int = 1200,
               height: int = 400) -> str:
    """Render a laid-out graph as a standalone SVG (inspection aid)."""
    if not coords:
        return f'<svg xmlns="http://www.w3.org/2000/svg"/>'
    xs = [c[0] for c in coords.values()]
    ys = [c[1] for c in coords.values()]
    x0, x1 = min(xs), max(xs) or 1
    y0, y1 = min(ys), max(ys)
    sx = (width - 40) / max(x1 - x0, 1)
    sy = (height - 40) / max(y1 - y0, 1)
    def pt(v):
        x, y = coords[v]
        return 20 + (x - x0) * sx, 20 + (y - y0) * sy
    parts = [f'<svg xmlns="http://www.w3.org/2000/svg" '
             f'width="{width}" height="{height}">']
    for v in list(g.edges):
        for e in g.out_edges(v):
            if e.src in coords and e.dst in coords:
                ax, ay = pt(e.src)
                bx, by = pt(e.dst)
                parts.append(
                    f'<line x1="{ax:.1f}" y1="{ay:.1f}" x2="{bx:.1f}" '
                    f'y2="{by:.1f}" stroke="#888" stroke-width="1"/>')
    for v, (x, y) in coords.items():
        px, py = pt(v)
        parts.append(f'<circle cx="{px:.1f}" cy="{py:.1f}" r="2.5" '
                     f'fill="#1f6feb"/>')
    parts.append('</svg>')
    return "\n".join(parts)
