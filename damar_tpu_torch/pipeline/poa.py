"""Partial-order-alignment consensus for thin polish windows: the port of
damar_tpu/pipeline/poa.py (host numpy, as there).

The expanded-column MSA caller (consensus._msa_window_calls) anchors
every cover to the TEMPLATE frame, so insertion content from different
covers is never aligned.  POA (Lee, Grasso & Sharlow 2002) aligns each
cover against the GRAPH of everything seen so far, so insertion content
lines up and the heaviest path integrates indel evidence.  The
finishing polish calls it only for thin windows, under DAMAR_POA_THIN
(consensus._finish_rounds).

Determinism: covers are processed in caller order; every argmax / tie
breaks to the first candidate in a fixed enumeration order; the
consensus tie-break prefers earlier-created nodes (the template
backbone is created first).
"""
from __future__ import annotations

import numpy as np

NEG = -(1 << 30)
MATCH, MIS, GAP = 2, -2, -2


class _Graph:
    """Array/dict-backed POA graph (window scale: ~10^3 nodes)."""

    def __init__(self, backbone: np.ndarray, backbone_weight: int = 1):
        n = len(backbone)
        self.base: list[int] = [int(b) for b in backbone]
        self.pred: list[list[int]] = [[] for _ in range(n)]
        self.succ: list[list[int]] = [[] for _ in range(n)]
        self.edge_w: dict[tuple[int, int], int] = {}
        self.node_w: list[int] = [backbone_weight] * n
        # aligned-node rings: nodes occupying the same column with
        # different bases (POA's "aligned to" sets)
        self.aligned: list[list[int]] = [[] for _ in range(n)]
        for i in range(n - 1):
            self._edge(i, i + 1, backbone_weight)

    def _edge(self, u: int, v: int, w: int = 1) -> None:
        if (u, v) not in self.edge_w:
            self.edge_w[(u, v)] = 0
            self.pred[v].append(u)
            self.succ[u].append(v)
        self.edge_w[(u, v)] += w

    def _new_node(self, base: int) -> int:
        self.base.append(int(base))
        self.pred.append([])
        self.succ.append([])
        self.node_w.append(0)
        self.aligned.append([])
        return len(self.base) - 1

    def topo(self) -> list[int]:
        n = len(self.base)
        indeg = [len(p) for p in self.pred]
        from collections import deque
        q = deque(sorted(i for i in range(n) if indeg[i] == 0))
        out = []
        while q:
            u = q.popleft()
            out.append(u)
            for v in self.succ[u]:
                indeg[v] -= 1
                if indeg[v] == 0:
                    q.append(v)
        return out

    def align(self, seq: np.ndarray):
        """Semi-global alignment of seq against the graph: free
        leading/trailing skips on BOTH sides (covers may span only
        part of the window and vice versa).  Vectorized over the
        sequence axis; O(nodes * len(seq)).

        Returns path: a list of (node, j) pairs in order, where
        node == -1 means seq[j] is an insertion (no graph node) and
        j == -1 means the node is skipped (deletion in seq)."""
        order = self.topo()
        n = len(self.base)
        L = len(seq)
        s64 = np.asarray(seq, np.int64)
        j1 = np.arange(1, L + 1, dtype=np.int64)
        S = np.zeros((n, L + 1), np.int64)
        move = np.zeros((n, L + 1), np.int8)      # 0 diag 1 vert 2 horz
        psel = np.full((n, L + 1), -1, np.int16)  # pred list index
        row0 = np.zeros(L + 1, np.int64)          # virtual source row
        for v in order:
            sub = np.where(s64 == self.base[v], MATCH, MIS)
            preds = self.pred[v]
            rows = [row0] if not preds else [S[u] for u in preds]
            pidx = [-1] if not preds else list(range(len(preds)))
            best = None
            bmv = bps = None
            for pi, Su in zip(pidx, rows):
                diag = Su[:-1] + sub
                vert = Su[1:] + GAP
                cand = np.maximum(diag, vert)
                mv = np.where(diag >= vert, 0, 1).astype(np.int8)
                if best is None:
                    best, bmv = cand, mv
                    bps = np.full(L, pi, np.int16)
                else:
                    upd = cand > best
                    best = np.where(upd, cand, best)
                    bmv = np.where(upd, mv, bmv)
                    bps = np.where(upd, np.int16(pi), bps)
            # horizontal closure: row[j] = max(best[j], row[j-1]+GAP)
            #   = max(best[j], j*GAP + max_{k<=j}(best[k] - k*GAP))
            pref = np.maximum.accumulate(best - j1 * GAP)
            row = np.empty(L + 1, np.int64)
            row[0] = 0                            # free graph skip
            closed = j1 * GAP + pref
            horz = closed > best
            row[1:] = np.where(horz, closed, best)
            S[v, :] = row
            move[v, 1:] = np.where(horz, np.int8(2), bmv)
            psel[v, 1:] = np.where(horz, np.int16(-2), bps)
        # best end anywhere (free trailing on both sides); ties: lower
        # topo rank, then lower j — fixed enumeration order
        bscore, bend = NEG, (order[0] if order else -1, 0)
        for v in order:
            j = int(np.argmax(S[v]))
            if int(S[v][j]) > bscore:
                bscore, bend = int(S[v][j]), (v, j)
        path = []
        v, j = bend
        while j > 0:
            m = int(move[v, j])
            if m == 2:
                path.append((-1, j - 1))
                j -= 1
                continue
            p = int(psel[v, j])
            if m == 0:
                path.append((v, j - 1))
                j -= 1
            else:
                path.append((v, -1))
            if p == -1:
                break                  # came from the virtual source
            v = self.pred[v][p]
        path.reverse()
        return bscore, path

    def add_alignment(self, seq: np.ndarray, path, w: int = 1) -> None:
        """Thread seq into the graph along path (matched nodes gain
        weight; mismatches become aligned siblings; insertions become
        new nodes; edges follow the threaded order)."""
        prev = None
        for v, j in path:
            if j < 0:
                continue                   # deletion: seq skips node
            b = int(seq[j])
            if v >= 0 and self.base[v] == b:
                node = v
            elif v >= 0:
                node = None
                for a in self.aligned[v]:
                    if self.base[a] == b:
                        node = a
                        break
                if node is None:
                    node = self._new_node(b)
                    ring = [v] + self.aligned[v]
                    for a in ring:
                        self.aligned[a].append(node)
                    self.aligned[node] = ring
            else:
                node = self._new_node(b)
            self.node_w[node] += w
            if prev is not None and prev != node:
                self._edge(prev, node, w)
            prev = node

    def consensus(self) -> np.ndarray:
        """Heaviest path by summed edge weights over topo order.
        Positive weights make the argmax land on a sink, so the call
        always spans the backbone (ties: earlier-created node)."""
        order = self.topo()
        score = [0] * len(self.base)
        came: list[int | None] = [None] * len(self.base)
        for v in order:
            for u in self.pred[v]:
                s = score[u] + self.edge_w[(u, v)]
                if s > score[v] or (s == score[v] and came[v] is not None
                                    and u < came[v]):
                    score[v] = s
                    came[v] = u
        end = max(order, key=lambda v: (score[v], -v))
        out = []
        v: int | None = end
        while v is not None:
            out.append(self.base[v])
            v = came[v]
        return np.array(out[::-1], np.uint8)


def poa_consensus(template: np.ndarray, covers: list[np.ndarray],
                  template_weight: int = 1) -> np.ndarray:
    """POA consensus of covers over a window template.

    The template is the backbone (weight template_weight): a lone
    disagreeing cover ties the backbone and the tie breaks to the
    earlier backbone node — the min_cov=2 semantics of the column
    callers.  Covers align semi-globally (partial covers vote only
    where they reach)."""
    if not covers:
        return np.asarray(template, np.uint8).copy()
    g = _Graph(np.asarray(template, np.uint8),
               backbone_weight=template_weight)
    for c in covers:
        c = np.asarray(c, np.uint8)
        if not len(c):
            continue
        _, path = g.align(c)
        g.add_alignment(c, path)
    return g.consensus()
