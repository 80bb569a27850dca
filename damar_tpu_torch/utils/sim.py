"""Synthetic long-read simulator (PacBio-CLR-like), numpy only.

The same random draws in the same order as damar_tpu.utils.sim, so one
seed gives the same genome and the same reads in both packages: data
built here on a machine without jax is the data the reference saw.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class SimReads:
    genome: np.ndarray           # uint8 codes
    reads: list[np.ndarray]      # uint8 codes per read
    start: np.ndarray            # genome start of each read's span
    end: np.ndarray              # genome end
    strand: np.ndarray           # 0 fwd, 1 revcomp
    err: float
    # chimeric[i]: read i is a junction artifact of two unrelated
    # genome spans (start/end describe its FIRST segment only)
    chimeric: np.ndarray | None = None

    def true_overlap(self, i: int, j: int, min_olap: int = 1) -> bool:
        """Ground-truth span overlap, circular-aware: reads sampled
        across the origin wrap (end > G in the doubled coordinate), so
        each read is tested at both of its circle representatives."""
        G = len(self.genome)
        for di in (0, G):
            for dj in (0, G):
                lo = max(self.start[i] + di, self.start[j] + dj)
                hi = min(self.end[i] + di, self.end[j] + dj)
                if hi - lo >= min_olap:
                    return True
        return False


def _revcomp(codes: np.ndarray) -> np.ndarray:
    return (3 - codes[::-1]).astype(np.uint8)


def make_genome(length: int, seed: int = 0, n_repeats: int = 0,
                repeat_len: int = 2000, tandem: int = 0,
                tandem_period: int = 100, tandem_len: int = 2000
                ) -> np.ndarray:
    """Random genome; optionally plant exact repeat copies and tandems."""
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 4, size=length, dtype=np.uint8)
    if n_repeats > 0:
        unit = rng.integers(0, 4, size=repeat_len, dtype=np.uint8)
        spots = rng.choice(length - repeat_len, size=n_repeats, replace=False)
        for s in spots:
            g[s:s + repeat_len] = unit
    for _ in range(tandem):
        unit = rng.integers(0, 4, size=tandem_period, dtype=np.uint8)
        s = int(rng.integers(0, length - tandem_len))
        reps = np.tile(unit, tandem_len // tandem_period + 1)[:tandem_len]
        g[s:s + tandem_len] = reps
    return g


def mutate(seq: np.ndarray, err: float, rng: np.random.Generator,
           ins_frac: float = 0.45, del_frac: float = 0.35) -> np.ndarray:
    """Apply CLR-style errors.  err is the total per-base error rate,
    split ins/del/sub (PacBio CLR is insertion-dominated)."""
    if err <= 0:
        return seq.copy()
    n = len(seq)
    r = rng.random(n)
    p_ins = err * ins_frac
    p_del = err * del_frac
    p_sub = err - p_ins - p_del
    ops = np.zeros(n, dtype=np.uint8)  # 0 keep, 1 sub, 2 del, 3 ins-before
    ops[r < p_sub] = 1
    ops[(r >= p_sub) & (r < p_sub + p_del)] = 2
    ops[(r >= p_sub + p_del) & (r < err)] = 3
    subs = (seq + rng.integers(1, 4, size=n)) % 4
    ins_chars = rng.integers(0, 4, size=n).astype(np.uint8)
    lens = np.ones(n, np.int64)
    lens[ops == 2] = 0
    lens[ops == 3] = 2
    starts = np.cumsum(lens) - lens          # output offset per input
    out = np.empty(int(lens.sum()), np.uint8)
    keepish = ops != 2
    base = np.where(ops == 1, subs, seq)     # char emitted at the base slot
    slot = starts + (ops == 3)               # ins writes its char first
    out[slot[keepish]] = base[keepish]
    ins = ops == 3
    out[starts[ins]] = ins_chars[ins]
    return out


def sample_reads(genome: np.ndarray, coverage: float, mean_len: int,
                 err: float = 0.14, seed: int = 1, min_len: int = 500,
                 circular: bool = True,
                 chimera_frac: float = 0.0) -> SimReads:
    """Sample reads to a target coverage with gamma-distributed lengths.
    chimera_frac: fraction of reads fused from two unrelated spans."""
    rng = np.random.default_rng(seed)
    G = len(genome)
    total = int(G * coverage)
    reads, starts, ends, strands, chims = [], [], [], [], []
    acc = 0
    gg = np.concatenate([genome, genome]) if circular else genome

    def one_span(L):
        s = int(rng.integers(0, G if circular else max(1, G - L)))
        span = gg[s:s + L]
        strand = int(rng.integers(0, 2))
        r = span if strand == 0 else _revcomp(span)
        return mutate(r, err, rng), s, s + L, strand

    while acc < total:
        L = int(np.clip(rng.gamma(3.0, mean_len / 3.0), min_len, G))
        chim = chimera_frac > 0 and rng.random() < chimera_frac \
            and L >= 2 * min_len
        if chim:
            l1 = int(rng.integers(L // 4, 3 * L // 4))
            r1, s, e, strand = one_span(l1)
            r2, _, _, _ = one_span(L - l1)
            r = np.concatenate([r1, r2])
            e = s + l1
        else:
            r, s, e, strand = one_span(L)
        if len(r) < min_len:
            continue
        reads.append(r)
        starts.append(s)
        ends.append(e)
        strands.append(strand)
        chims.append(chim)
        acc += L
    return SimReads(
        genome=genome, reads=reads,
        start=np.array(starts), end=np.array(ends),
        strand=np.array(strands), err=err,
        chimeric=np.array(chims, dtype=bool),
    )


def write_sim_fasta(path: str, sim: SimReads) -> None:
    """The reads as FASTA, each header carrying its ground truth."""
    from damar_tpu_torch.formats.fasta import write_fasta
    headers = [
        f"sim/{i}/0_{len(r)} start={sim.start[i]} end={sim.end[i]} "
        f"strand={sim.strand[i]}"
        for i, r in enumerate(sim.reads)]
    write_fasta(path, headers, sim.reads)


def unit_batch(rng: np.random.Generator, S: int, min_len: int = 100,
               max_len: int = 2500):
    """Random mutated-pair extension units laid out in two block arrays,
    with mixed directions (the fuzz batches the kernel checks use).
    Returns (A, B, aorigin, borigin, alim, blim, rev)."""
    a_parts, b_parts = [], []
    for _ in range(S):
        L = int(rng.integers(min_len, max_len))
        src = rng.integers(0, 4, L).astype(np.uint8)
        a_parts.append(src)
        b_parts.append(mutate(src, float(rng.uniform(0.05, 0.25)), rng))
    a_off = np.cumsum([0] + [len(x) for x in a_parts])
    b_off = np.cumsum([0] + [len(x) for x in b_parts])
    A, B = np.concatenate(a_parts), np.concatenate(b_parts)
    ao, bo, alim, blim, rv = [], [], [], [], []
    for i in range(S):
        la = a_off[i + 1] - a_off[i]
        lb = b_off[i + 1] - b_off[i]
        pa = int(rng.integers(0, la))
        pb = int(np.clip(pa + rng.integers(-30, 30), 0, lb - 1))
        rev = bool(rng.integers(0, 2))
        ao.append(a_off[i] + pa)
        bo.append(b_off[i] + pb)
        alim.append(pa if rev else la - pa)
        blim.append(pb if rev else lb - pb)
        rv.append(rev)
    return (A, B, np.array(ao, np.int32), np.array(bo, np.int32),
            np.array(alim, np.int32), np.array(blim, np.int32),
            np.array(rv, bool))


def edge_units(rng: np.random.Generator, S: int, pool_len: int = 3001,
               max_lim: int = 4000):
    """Extension units whose windows run past both ends of a two-read
    pool: origins within 40 bases of either end, both directions, limits
    up to max_lim (so the kernels read clip-gathered words there).
    Returns (A, B, aorigin, borigin, alim, blim, rev)."""
    A = rng.integers(0, 4, pool_len).astype(np.uint8)
    B = mutate(A, 0.1, rng)
    near = np.concatenate([rng.integers(0, 40, S // 2),
                           rng.integers(pool_len - 40, pool_len,
                                        S - S // 2)])
    ao = near.astype(np.int32)
    bo = np.clip(near + rng.integers(-20, 20, S), 0, len(B)).astype(np.int32)
    rv = np.arange(S) % 2 == 0
    alim = rng.integers(1, max_lim, S).astype(np.int32)
    blim = rng.integers(1, max_lim, S).astype(np.int32)
    return A, B, ao, bo, alim, blim, rv


def wide_trace_batch(rng: np.random.Generator, S: int, min_len: int = 1,
                     max_len: int = 2500):
    """Extents for the wide trace's checks, laid out in two pools A and B.
    Four kinds in turn: mutated pairs (5-25% error); pairs whose B gains
    or loses a base every 3 to 10 of A, so the commits drift the band by
    tens of lanes; pairs whose B span is an eighth of A's, so the end
    column can fall outside the band (the d >= INF_I branch); alim = 0.
    Starts are split off word boundaries into start + offset; the first
    extent's B window starts before the pool and the last one's runs past
    its end.  Returns (A, B, astart, bstart, abpos, bbpos, alim, blim)."""
    a_parts, b_parts = [], []
    for i in range(S):
        L = int(rng.integers(min_len, max_len + 1))
        src = rng.integers(0, 4, L).astype(np.uint8)
        if i % 4 == 1:
            at = np.arange(0, L, int(rng.integers(3, 11)))
            if rng.random() < 0.5:
                b = np.insert(src, at, rng.integers(0, 4, len(at)))
            else:
                b = np.delete(src, at)
            b = mutate(b.astype(np.uint8), 0.05, rng)
        else:
            b = mutate(src, float(rng.uniform(0.05, 0.25)), rng)
        a_parts.append(src)
        b_parts.append(b)
    a_off = np.cumsum([0] + [len(x) for x in a_parts])
    b_off = np.cumsum([0] + [len(x) for x in b_parts])
    alim = np.diff(a_off)
    blim = np.diff(b_off)
    kind = np.arange(S) % 4
    blim = np.where(kind == 2, np.maximum(blim // 8, 1), blim)
    alim = np.where(kind == 3, 0, alim)
    blim[-1] += 300
    ao, bo = a_off[:-1], b_off[:-1]
    abp = np.minimum(rng.integers(1, 90, S), ao)
    bbp = np.minimum(rng.integers(1, 90, S), bo)
    i32 = lambda x: np.asarray(x, np.int32)  # noqa: E731
    return (np.concatenate(a_parts), np.concatenate(b_parts), i32(ao - abp),
            i32(bo - bbp), i32(abp), i32(bbp), i32(alim), i32(blim))


def band_batch(rng: np.random.Generator, S: int, track: bool, R: int = 100,
               W: int = 128):
    """Arguments of one wide DP rows call (dp_rows) over S random bands:
    D near the reset band with some values above INF_I and eight bands
    wholly above it, chars with 15% mismatches, random limits, and per-
    lane ([S, W], track) or per-band ([S]) trackers.  Returns (D, a_chars,
    b_tile, vb_base, p_base, blim, rows_limit, active, best_s, best_va,
    best_vb, best_d, cont) as int32 arrays."""
    INF = 1 << 20
    lane = np.arange(W)
    D = np.where(lane >= W // 2, lane - W // 2, INF)[None, :].repeat(S, 0)
    D = D + rng.integers(0, 3, (S, W)) * (D < INF)
    D[rng.random((S, W)) < 0.05] = INF + 3
    D[:8] = INF + 3        # whole bands above INF: the right edge decides
    src = rng.integers(0, 4, (S, R + W + 28))
    b = np.where(rng.random(src.shape) < 0.15,
                 rng.integers(0, 4, src.shape), src)
    a = src[:, W // 2:W // 2 + R + 28]
    vec = lambda lo, hi: rng.integers(lo, hi, S)  # noqa: E731
    tr = (S, W) if track else (S,)
    trk = [rng.integers(-50, 50, tr) for _ in range(4)]
    vals = (D, a, b, vec(-70, 10), vec(0, 500), vec(0, 400),
            vec(-3, R + 5), vec(0, 2), *trk, vec(0, 2))
    return tuple(np.ascontiguousarray(x, dtype=np.int32) for x in vals)


def kmer_hit_rate(genome: np.ndarray, contig: np.ndarray,
                  k: int = 16) -> float:
    """Identity oracle: fraction of the contig's exact k-mers present
    in the truth genome (both strands); identity ~ hit ** (1/k)."""
    cb = bytes(np.asarray(contig, dtype=np.uint8))
    if len(cb) < k + 1:
        return 0.0
    g = np.asarray(genome, dtype=np.uint8)
    gb = bytes(g)
    rb = bytes((g[::-1] ^ 3).astype(np.uint8))
    gset = {gb[i:i + k] for i in range(len(gb) - k + 1)} \
        | {rb[i:i + k] for i in range(len(rb) - k + 1)}
    return float(np.mean([cb[i:i + k] in gset
                          for i in range(len(cb) - k + 1)]))


def align_pairs_batch(rng: np.random.Generator, P: int, bands=(64, 96, 700),
                      max_len: int = 1300, semiglobal: bool = True,
                      err: float = 0.12) -> list:
    """Random (template, cover, band) pairs for the pile aligner's fuzz
    checks: templates of 0 to max_len codes; covers a mutated copy with
    margins (longer), a mutated part (shorter: n - m negative, odd ones
    among them), unrelated codes, or empty.  In global mode the cover
    length stays within half a band of the template's, so the path's end
    column lies inside the band."""
    out = []
    for _ in range(P):
        band = int(rng.choice(bands))
        m = int(rng.integers(0, max_len + 1))
        a = rng.integers(0, 4, m).astype(np.uint8)
        kind = int(rng.integers(0, 5))
        if not semiglobal:
            b = mutate(a, err, rng)
            d = len(b) - m
            lim = band // 2
            if abs(d) > lim:
                b = b[:m + lim] if d > 0 else np.concatenate(
                    [b, rng.integers(0, 4, -d - lim).astype(np.uint8)])
        elif kind == 0:                 # margins on both sides
            lo = rng.integers(0, 4, int(rng.integers(0, 300)))
            hi = rng.integers(0, 4, int(rng.integers(0, 300)))
            b = np.concatenate([lo, mutate(a, err, rng), hi])
        elif kind == 1:                 # a part: n - m < 0, often odd
            cut = int(rng.integers(0, max(m // 2, 1))) * 2 + 1
            b = mutate(a[:max(m - cut, 0)], err, rng)
        elif kind == 2:
            b = rng.integers(0, 4, int(rng.integers(0, max_len + 1)))
        elif kind == 3:
            b = np.zeros(0, np.uint8)
        else:
            b = mutate(a, err, rng)
        out.append((a, np.asarray(b, np.uint8)[:max_len + 600], band))
    return out


def polish_window_pairs(rng: np.random.Generator) -> list:
    """A polish window's pile-aligner pairs, as consensus.polish_contig
    makes them: a 500-code template, 21 covers of it at band 96, and 3
    first covers (on template slices, with margins of 200-600 codes) at
    bands 216-615."""
    tmpl = rng.integers(0, 4, 500).astype(np.uint8)
    pairs = []
    for i in range(24):
        if i % 8 == 0:
            io, mg = int(rng.integers(0, 200)), int(rng.integers(200, 600))
            cov = np.concatenate([rng.integers(0, 4, mg // 2),
                                  mutate(tmpl[io:], 0.12, rng),
                                  rng.integers(0, 4, mg // 3)])
            pairs.append((tmpl[io:], cov.astype(np.uint8), mg + 16))
        else:
            pairs.append((tmpl, mutate(tmpl, 0.12, rng), 96))
    return pairs
