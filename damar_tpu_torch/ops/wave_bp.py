"""Bit-parallel 32-diagonal band kernels: seed extension and trace points.

Port of damar_tpu/ops/wave_bp_pallas.py (extend_wave_bp_pl,
trace_wave_bp_pl) and of the algebra of damar_tpu/ops/wave_bp.py.  Each
seed's band is encoded as +1/-1 deltas in two uint32 words (VP/VN) plus
an int32 base; a DP row is ~60 integer ops (Myers/Hyyro bit-parallel
step), and the serial within-row prefix-min becomes the carry chain of
one 32-bit add.

Kernels (CUDA C++ in damar_tpu_torch/csrc/wave_bp.cu, route: nvcc ->
ctypes, see ops/_cuda.py):
  K1 bp_extend_kernel  replaces _ext_chunk_kernel   (wave_bp_pallas.py:228)
  K2 bp_trace_kernel   replaces _trace_chunk_kernel (wave_bp_pallas.py:420)
One thread per seed with all band state in registers; the chunk loop
(K1) and the segment loop (K2) run inside the kernel.  A launch covers
any number of seeds: a persistent grid hands them out to warps, 32 at a
time, longest first so that a warp's lanes stay alike (K1's wrapper
sorts the units by bound; K2 takes its input order, which the driver
lays out so).  They are bound by integer operations (chip_smoke.py
counts them from the built kernels).

Beside each kernel, its plain torch version: the same computation as
tensor ops over the seed axis, holding uint32 values in int64 tensors.
The wrappers take the plain version only for CPU tensors; for a CUDA
tensor they launch the kernel or raise.  `launches` on each wrapper
counts kernel launches.
"""
from __future__ import annotations

import torch

from damar_tpu_torch.ops import _cuda
from damar_tpu_torch.ops.words import (M32, gather_packed_words, pack_bases,
                                       u32)

BW = 32
CTR = 16
INF_I = 1 << 20
NEG_I = -(1 << 20)
NOT1 = 0xFFFFFFFE
VN0 = (1 << (CTR + 1)) - 1
VP0 = M32 ^ VN0


# --- plain torch versions ---------------------------------------------------

def _popcount(x):
    """SWAR popcount of uint32 values held in int64."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & M32) >> 24


def _row_step(VP, VN, Db, Dc, Eq):
    """One DP row (ops.wave_bp._row_step), uint32 wraparound by masks: a
    value's bits above 31 are dropped where it meets VP, VN, X or Z (all
    below 2^32) in an AND, so only the words that stand alone are
    masked.  Dc None: no centre column (the trace pass)."""
    X = Eq | (VN >> 1)
    seed = (X << 1) & VP
    G0 = X | (VP & (seed | ((seed + VP) ^ VP)))
    g = G0 ^ M32
    gp = g << 1
    nd = (g ^ gp) ^ M32
    Z = (VP | VN) ^ M32
    VPn = (VP & nd) | (Z & g & (gp ^ M32))
    VNn = (VN & nd) | (Z & gp & G0)
    Dbn = Db + 1 + (VP & 1) - (VN & 1)
    Dcn = None if Dc is None else Dc + 1 - ((G0 >> CTR) & 1)
    return VPn & NOT1, (VNn & NOT1) | (G0 & 1), Dbn, Dcn


def _band_scan(VP, VN, Db, vbb_t, blim, extra_valid, diff_cost,
               prev_vb=None, want_end=False):
    """Walk the 32 band positions reconstructing D: (smax without the +t
    term, jbest) over the score vb - diff_cost*D (first max), (jmin,
    dsel) the first minimum of the INF-masked D and the raw D there,
    dend the raw D at the end column clip(blim - vbb_t, 0, 31)."""
    D = Db
    smax = torch.full_like(Db, NEG_I)
    jbest = torch.zeros_like(Db)
    dmin = torch.full_like(Db, 1 << 30)
    jmin = torch.zeros_like(Db)
    dsel = torch.zeros_like(Db)
    dend = torch.zeros_like(Db)
    j_end = (blim - vbb_t).clamp(0, BW - 1) if want_end else None
    for j in range(BW):
        D = D + ((VP >> j) & 1) - ((VN >> j) & 1)
        vb = vbb_t + j
        in_b = (vb >= 0) & (vb <= blim)
        if extra_valid is not None:
            sc = torch.where(in_b & extra_valid, vb - diff_cost * D, NEG_I)
            upd = sc > smax
            smax = torch.where(upd, sc, smax)
            jbest = torch.where(upd, j, jbest)
        mvalid = in_b if prev_vb is None else in_b & (vb > prev_vb)
        Dm = torch.where(mvalid, D, INF_I)
        updm = Dm < dmin
        dmin = torch.where(updm, Dm, dmin)
        jmin = torch.where(updm, j, jmin)
        dsel = torch.where(updm, D, dsel)
        if want_end:
            dend = torch.where(j_end == j, D, dend)
    return smax, jbest, jmin, dsel, dend


def _low_mask(m):
    return torch.where(m >= 32, M32, (torch.ones_like(m) << m) - 1)


def _recenter(VP, VN, Db, d):
    """Recenter the delta words by per-seed drift d (variable shifts plus
    a popcount base fixup; wave_bp_pallas._recenter)."""
    du = d.clamp(min=0)
    mu = (-d).clamp(min=0)
    full = torch.full_like(VP, M32)
    VPp = (VP >> du) | ((full >> du) ^ M32)
    VNp = (VN >> du) & (full >> du)
    lowfill = (torch.full_like(mu, 2) << mu) - 2
    VPm = (VP << mu) & M32
    VNm = ((VN << mu) | lowfill) & M32
    pos = d >= 0
    VPn = torch.where(pos, VPp, VPm)
    VNn = torch.where(pos, VNp, VNm)
    mask0 = _low_mask(d.clamp(0, BW - 1) + 1)
    D0 = Db + _popcount(VP & mask0) - _popcount(VN & mask0) + mu
    idxc = (CTR + d).clamp(0, BW - 1)
    maskc = _low_mask(idxc + 1)
    Dc = (Db + _popcount(VP & maskc) - _popcount(VN & maskc)
          + (CTR + d - idxc).abs())
    return VPn | 1, VNn & NOT1, D0 - 1, Dc


def _eq_rows(a_tile, b_tile, v0b, blim, rows: int):
    """The Eq words of rows 0..rows-1 of a chunk, [S, rows]: row r's bit j
    is set iff the b char at v-index v0b + r + j (valid iff inside [0,
    blim)) equals a char r: the kernels' Peq planes of the b window,
    shifted one char a row and masked by the a char, for all rows at
    once."""
    S = a_tile.shape[0]
    k = torch.arange(16, device=a_tile.device, dtype=torch.int64)

    def chars(tile, n):
        return ((u32(tile)[:, :, None] >> (2 * k)) & 3).reshape(S, -1)[:, :n]
    ach = chars(a_tile, rows)
    bch = chars(b_tile, rows + BW)
    p = v0b[:, None] + torch.arange(rows + BW, device=a_tile.device)
    bch = torch.where((p >= 0) & (p < blim[:, None]), bch, 4)
    win = bch.unfold(1, BW, 1)[:, :rows]               # [S, rows, BW]
    return ((win == ach[:, :, None]).to(torch.int64)
            << torch.arange(BW, device=a_tile.device)).sum(-1)


def _ext_chunk(a_words, b_words, st, ao, bo, alim, blim, rv, rtot: int,
               R: int, diff_cost: int, xdrop: int):
    """One R-row chunk for active seeds (the body of _ext_chunk_kernel
    plus its wrapper's window gathers).  Returns the new state and the
    still-active mask.  Only the rows' recurrence runs row by row; the
    Eq words come before it (_eq_rows) and the score tracking after it,
    over all rows at once: the best score is a running maximum whose
    first row reaching its last value is the last improving row, and a
    seed dies where a valid row's score falls below the running maximum
    through it by more than xdrop + diff_cost."""
    VP, VN, Db, Dc, vbb, bs, bva, bvb = st
    a_tile = gather_packed_words(a_words, ao,
                                 torch.full_like(ao, rtot), R, rv)
    b_tile = gather_packed_words(b_words, bo, vbb - 1, R + BW, rv)
    Eq = _eq_rows(a_tile, b_tile, vbb - 1, blim, R)
    Dcs = torch.empty_like(Eq)
    for r in range(R):
        VP, VN, Db, Dc = _row_step(VP, VN, Db, Dc, Eq[:, r])
        Dcs[:, r] = Dc
    rr = torch.arange(R, device=VP.device)
    t = rtot + rr[None, :] + 1                        # [1, R]
    vc = vbb[:, None] + rr[None, :] + CTR             # [S, R]
    sc = t + vc - diff_cost * Dcs
    ok = (t <= alim[:, None]) & (vc >= 0) & (vc <= blim[:, None])
    run = torch.cummax(torch.cat([bs[:, None], torch.where(
        ok, sc, NEG_I * 4)], 1), 1).values
    died = (ok & (sc < run[:, 1:] - (xdrop + diff_cost))).any(1)
    top = run[:, -1]
    improved = top > bs
    r_top = torch.argmax((ok & (sc == top[:, None])).to(torch.int8), 1)
    bs = top
    bva = torch.where(improved, rtot + r_top + 1, bva)
    bvb = torch.where(improved, vbb + r_top + CTR, bvb)
    t = rtot + R
    vbb_t = vbb + R - 1
    smax, jbest, jmin, _, _ = _band_scan(VP, VN, Db, vbb_t, blim,
                                         t <= alim, diff_cost)
    smax = torch.where(smax > NEG_I, smax + t, smax)
    better = smax > bs
    bs = torch.where(better, smax, bs)
    bva = torch.where(better, t, bva)
    bvb = torch.where(better, vbb_t + jbest, bvb)
    act = (smax >= bs - xdrop) & (t < alim) & ~died
    drift = torch.where(act, jmin - CTR, 0)
    VP, VN, Db, Dc = _recenter(VP, VN, Db, drift)
    return (VP, VN, Db, Dc, vbb_t + 1 + drift, bs, bva, bvb), act


def extend_bp_plain(a_words, b_words, aorigin, borigin, alim, blim, rv,
                    R: int, max_rows: int, diff_cost: int, xdrop: int):
    """Plain torch K1, the contract of extend_bp_kernel: (bs, bva, bvb,
    active) int32.  Chunks run only over the seeds still active (an
    inactive seed's outputs never change), like the kernel's per-thread
    loop."""
    S = aorigin.shape[0]
    dev = aorigin.device
    i64 = lambda x: x.to(torch.int64)  # noqa: E731
    ao, bo, alim, blim = i64(aorigin), i64(borigin), i64(alim), i64(blim)

    def full(v):
        return torch.full((S,), v, dtype=torch.int64, device=dev)

    st = [full(VP0), full(VN0), full(CTR + 1), full(0), full(1 - CTR),
          full(0), full(0), full(0)]
    active = alim > 0
    rtot = 0
    while rtot < max_rows:
        idx = torch.nonzero(active).flatten()
        if idx.numel() == 0:
            break
        sub, act = _ext_chunk(
            a_words, b_words, [x[idx] for x in st], ao[idx], bo[idx],
            alim[idx], blim[idx], rv[idx], rtot, R, diff_cost, xdrop)
        for x, y in zip(st, sub):
            x[idx] = y
        active[idx] = act
        rtot += R
    return tuple(x.to(torch.int32) for x in (st[5], st[6], st[7], active))


def trace_bp_plain(a_words, b_words, astart, bstart, abpos, bbpos, alim,
                   blim, tspace: int, max_segs: int):
    """Plain torch K2, the contract of trace_bp_kernel: (trace [S,
    max_segs, 2], nseg, dsum) int32.  Segments run only over live seeds
    (a done seed emits (0, 0) and keeps its counts)."""
    S = abpos.shape[0]
    dev = abpos.device
    i64 = lambda x: x.to(torch.int64)  # noqa: E731
    abpos, alim, blim = i64(abpos), i64(alim), i64(blim)
    ao = i64(astart) + abpos
    bo = i64(bstart) + i64(bbpos)

    def full(v):
        return torch.full((S,), v, dtype=torch.int64, device=dev)

    VP, VN, Db, vbb = full(VP0), full(VN0), full(CTR + 1), full(1 - CTR)
    done, nseg, prev_vb, dsum = full(0), full(0), full(0), full(0)
    ds = torch.zeros((S, max_segs), dtype=torch.int64, device=dev)
    bsp = torch.zeros_like(ds)
    for k in range(max_segs):
        idx = torch.nonzero(done < alim).flatten()
        if idx.numel() == 0:
            break
        vp, vn, db, vb0 = VP[idx], VN[idx], Db[idx], vbb[idx]
        dn, al, bl, pv = done[idx], alim[idx], blim[idx], prev_vb[idx]
        a = abpos[idx] + dn
        seg_rows = torch.minimum(
            (torch.div(a, tspace, rounding_mode="floor") + 1) * tspace - a,
            al - dn)
        a_tile = gather_packed_words(a_words, ao[idx], dn, tspace, False)
        b_tile = gather_packed_words(b_words, bo[idx], vb0 - 1,
                                     tspace + BW, False)
        rows = int(seg_rows.max())
        Eq = _eq_rows(a_tile, b_tile, vb0 - 1, bl, rows)
        for r in range(rows):
            go = r < seg_rows
            VPn, VNn, Dbn, _ = _row_step(vp, vn, db, None, Eq[:, r])
            vp = torch.where(go, VPn, vp)
            vn = torch.where(go, VNn, vn)
            db = torch.where(go, Dbn, db)
        va = dn + seg_rows
        at_end = va == al
        vbb_end = vb0 + seg_rows - 1
        _, _, jmin, dsel, dend = _band_scan(vp, vn, db, vbb_end, bl, None, 0,
                                            prev_vb=pv, want_end=True)
        j_end = (bl - vbb_end).clamp(0, BW - 1)
        j_com = torch.where(at_end, j_end, jmin)
        vb_com = torch.minimum(torch.maximum(vbb_end + j_com, pv), bl)
        d_com = torch.where(at_end, dend, dsel)
        d_com = torch.where(d_com >= INF_I, al + bl, d_com)
        VP[idx], VN[idx], Db[idx] = VP0, VN0, CTR + 1
        vbb[idx] = vb_com - CTR + 1
        ds[idx, k] = d_com
        bsp[idx, k] = vb_com - pv
        done[idx] = va
        nseg[idx] += 1
        prev_vb[idx] = vb_com
        dsum[idx] += d_com
    trace = torch.stack([ds, bsp], dim=-1)
    return tuple(x.to(torch.int32) for x in (trace, nseg, dsum))


# --- CUDA launches ----------------------------------------------------------

def _i32c(x):
    return x.to(torch.int32).contiguous()


def _check_same_device(name, dev, tensors):
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: all tensors must share one CUDA "
                             "device")


def longest_first(alim, blim):
    """K1's work order: a permutation of the seeds by descending bound
    min(alim, blim), dead seeds (alim <= 0) last.  Seeds are independent,
    so the order changes no output."""
    bound = torch.where(alim > 0, torch.minimum(alim, blim), -1)
    return torch.argsort(bound, descending=True)


def extend_bp_kernel(a_words, b_words, aorigin, borigin, alim, blim, rv,
                     R: int, max_rows: int, diff_cost: int, xdrop: int):
    """Launch K1 on the current CUDA stream over all S seeds: returns
    (bs, bva, bvb, active) int32.  Warps take the seeds in
    longest_first order, which fills the card best."""
    if R <= 0 or R % 16:
        raise ValueError(f"extend_bp_kernel: R = {R} must be a positive "
                         "multiple of 16")
    lib = _cuda.lib()
    S = aorigin.shape[0]
    dev = aorigin.device
    aw, bw = _i32c(a_words), _i32c(b_words)
    ins = [_i32c(x) for x in (aorigin, borigin, alim, blim)]
    dirs = rv.to(torch.uint8).contiguous()
    _check_same_device("extend_bp_kernel", dev, (aw, bw, dirs, *ins))
    order = _i32c(longest_first(ins[2], ins[3]))
    counter = torch.zeros(1, dtype=torch.int32, device=dev)
    outs = [torch.empty(S, dtype=torch.int32, device=dev) for _ in range(4)]
    err = lib.bp_extend_launch(
        aw.data_ptr(), aw.shape[0], bw.data_ptr(), bw.shape[0],
        *[t.data_ptr() for t in ins], dirs.data_ptr(), order.data_ptr(),
        S, R, max_rows,
        diff_cost, xdrop, counter.data_ptr(), *[o.data_ptr() for o in outs],
        _cuda.stream_ptr(aorigin))
    _cuda.check(err, "bp_extend_kernel")
    _cuda.count_launch(extend_wave_bp, S)
    return tuple(outs)


def trace_bp_kernel(a_words, b_words, astart, bstart, abpos, bbpos, alim,
                    blim, tspace: int, max_segs: int):
    """Launch K2 on the current CUDA stream over all S extents: returns
    (trace [S, max_segs, 2], nseg, dsum) int32.  Warps take the extents
    in input order, so a caller that lays them out longest first fills
    the card best."""
    lib = _cuda.lib()
    S = abpos.shape[0]
    dev = abpos.device
    aw, bw = _i32c(a_words), _i32c(b_words)
    ins = [_i32c(x) for x in (astart, bstart, abpos, bbpos, alim, blim)]
    _check_same_device("trace_bp_kernel", dev, (aw, bw, *ins))
    counter = torch.zeros(1, dtype=torch.int32, device=dev)
    # the kernel writes segments [0, nseg) only
    trace = torch.zeros((S, max_segs, 2), dtype=torch.int32, device=dev)
    nseg = torch.empty(S, dtype=torch.int32, device=dev)
    dsum = torch.empty(S, dtype=torch.int32, device=dev)
    err = lib.bp_trace_launch(
        aw.data_ptr(), aw.shape[0], bw.data_ptr(), bw.shape[0],
        *[t.data_ptr() for t in ins], S, tspace, max_segs,
        counter.data_ptr(), trace.data_ptr(), nseg.data_ptr(),
        dsum.data_ptr(), _cuda.stream_ptr(abpos))
    _cuda.check(err, "bp_trace_kernel")
    _cuda.count_launch(trace_wave_bp, S)
    return trace, nseg, dsum


# --- wrappers ---------------------------------------------------------------

def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device}")


def extend_wave_bp(a_bases, b_bases, aorigin, borigin, alim, blim,
                   reverse: bool = False, R: int = 128,
                   max_rows: int = 65536, diff_cost: int = 5,
                   xdrop: int = 60, dirs=None, packed: bool = False,
                   with_active: bool = False):
    """Bidirectional-capable seed extension (damar_tpu
    extend_wave_bp_pl).  Returns (best_va, best_vb, best_d, best_score)
    int32[S], plus the final active mask when with_active (True = the
    unit hit max_rows still extending: a deeper re-run can differ).
    dirs: optional bool[S] per-seed direction (True = reverse)
    overriding `reverse`.  packed: a_bases/b_bases are already
    pack_bases words."""
    assert R % 16 == 0, "bp chunk must be word-aligned (R % 16 == 0)"
    S = aorigin.shape[0]
    rv = dirs.to(torch.bool) if dirs is not None else torch.full(
        (S,), bool(reverse), dtype=torch.bool, device=aorigin.device)
    a_words = a_bases if packed else pack_bases(a_bases)
    b_words = b_bases if packed else pack_bases(b_bases)
    run = extend_bp_kernel if _on_cuda(aorigin) else extend_bp_plain
    bs, bva, bvb, act = run(a_words, b_words, aorigin, borigin, alim, blim,
                            rv, R, max_rows, diff_cost, xdrop)
    none = bs <= 0
    d = torch.where(none, 0, torch.div(bva + bvb - bs, diff_cost,
                                       rounding_mode="floor"))
    out = (torch.where(none, 0, bva), torch.where(none, 0, bvb),
           d.to(torch.int32), torch.where(none, 0, bs))
    return out + (act != 0,) if with_active else out


def trace_wave_bp(a_bases, b_bases, astart, bstart, abpos, bbpos, alim,
                  blim, tspace: int = 100, max_segs: int = 660,
                  packed: bool = False):
    """Trace-point pass over extents (damar_tpu trace_wave_bp_pl): each
    seed advances one tspace segment per step, commits (diffs, bspan) at
    the min-distance column (the known end for its last segment) and
    restarts a fresh band there.  Returns (trace [S, max_segs, 2], nseg
    [S], dsum [S]) int32."""
    a_words = a_bases if packed else pack_bases(a_bases)
    b_words = b_bases if packed else pack_bases(b_bases)
    run = trace_bp_kernel if _on_cuda(abpos) else trace_bp_plain
    return run(a_words, b_words, astart, bstart, abpos, bbpos, alim, blim,
               tspace, max_segs)


extend_wave_bp.launches = 0
trace_wave_bp.launches = 0
# the capability flags of damar_tpu's kernel wrappers, for callers written
# against that contract (the port's own driver has one route and reads
# none of them)
extend_wave_bp.takes_packed = True
trace_wave_bp.takes_packed = True
extend_wave_bp.supports_active = True
