"""Wide banded DP (W = 128 diagonals, one lane each) and its trace pass.

Port of damar_tpu/ops/wave_pallas.py: dp_rows and the trace_wave_pl and
extend_wave_pl wrappers.  The wide band is the last retry tier of the
trace pass (it forces through extents whose alignment drifts beyond the
reach of the 32-diagonal bit-parallel band) and, under
dp_kernel="wide", the extension and the main trace.

Kernels (CUDA C++ in damar_tpu_torch/csrc/dp_rows.cu), both in place of
_dp_rows_kernel (wave_pallas.py:43):
  wide_trace_kernel  the whole trace pass of trace_wave_pl (:411) in one
                     launch: every segment of every extent, with its
                     commit, one warp per extent
  dp_rows_kernel     R rows of a batch of bands, trace mode or
                     track_best + recenter (the chunk form, which
                     extend_wave_wide drives one launch per R rows)
One warp holds a band, four lanes a thread in registers; a row's
prefix-min is a warp-shuffle scan with no barrier (the file's header
says what bounds them).  Beside each kernel, its plain torch version:
trace_wave_plain (the reference's segment loop, trace_wave_steps, over
dp_rows_plain) and dp_rows_plain; the wrappers take them only for CPU
tensors.
"""
from __future__ import annotations

import torch

from damar_tpu_torch.ops import _cuda
from damar_tpu_torch.ops.words import gather_packed, pack_bases

INF_I = 1 << 20


def _as_col(x):
    return x.reshape(-1) if x.dim() == 2 and x.shape[1] == 1 else x


def prefix_min(u):
    """The reference's log-step prefix-min along dim 1 with its INF_I
    fill (wave_pallas.py:86-91).  Lane for lane it equals
    min(INF_I, cummin(u)), which the kernels compute."""
    lane = torch.arange(u.shape[1], device=u.device)
    s = 1
    while s < u.shape[1]:
        us = torch.where(lane >= s, torch.roll(u, s, dims=1), INF_I)
        u = torch.minimum(u, us)
        s *= 2
    return u


def dp_rows_plain(D, a_chars, b_tile, vb_base, p_base, blim, rows_limit,
                  active, best_s, best_va, best_vb, best_d, R: int,
                  W: int = 128, diff_cost: int = 5, xdrop: int = 60,
                  track_best: bool = True, recenter: bool = False,
                  cont=None):
    """Plain torch K3 (the algebra of _dp_rows_kernel).  Same contract as
    dp_rows; rows past every active seed's row limit change nothing, so
    the row loop stops there."""
    S = D.shape[0]
    dev = D.device
    i64 = lambda x: x.to(torch.int64)  # noqa: E731
    col = lambda x: i64(x).reshape(S, 1)  # noqa: E731
    CTR = W // 2
    lane = torch.arange(W, device=dev)
    D = D.to(torch.int64, copy=True)         # updated in place below
    a = i64(a_chars)
    b = i64(b_tile)
    vbb, pb, blim, rows = (col(x) for x in (vb_base, p_base, blim,
                                            rows_limit))
    act = col(active) != 0
    if cont is None:
        cont = torch.zeros(S, dtype=torch.int64, device=dev)
    trk = [_as_col(x).to(torch.int64, copy=True)
           for x in (best_s, best_va, best_vb, best_d)]
    if track_best:
        bs, bva, bvb, bd = (x.reshape(S, W) for x in trk)
    # rows run only over seeds with work: a seed that is inactive or
    # past its row limit keeps its band and trackers
    sel = torch.nonzero((act & (rows > 0)).reshape(S)).flatten()
    Ds, a_s, b_s = D[sel], a[sel], b[sel]
    vbb_s, pb_s, blim_s, rows_s = vbb[sel], pb[sel], blim[sel], rows[sel]
    if track_best:
        bs_s, bva_s, bvb_s, bd_s = bs[sel], bva[sel], bvb[sel], bd[sel]
    nrows = int(rows_s.clamp(max=R).max()) if sel.numel() else 0
    for r in range(nrows):
        row_active = r < rows_s
        x = a_s[:, r:r + 1]
        bcmp = b_s[:, r:r + W]
        v_b = vbb_s + r + lane
        lane_valid = (v_b >= 0) & (v_b <= blim_s)
        diag_valid = lane_valid & (v_b >= 1)
        sub = torch.where(diag_valid, (bcmp != x).to(torch.int64), INF_I)
        Dl = torch.cat([Ds[:, 1:], torch.full_like(Ds[:, :1], INF_I)],
                       dim=1)
        # prefix_min's closed form, equal to it on DP rows
        # (tests/test_torch_wave_wide.py), in one op
        u = torch.cummin(torch.minimum(Ds + sub, Dl + 1) - lane,
                         1).values.clamp_(max=INF_I)
        Dn = torch.where(lane_valid, u + lane, INF_I)
        Ds = torch.where(row_active, Dn, Ds)
        if track_best:
            score = torch.where(lane_valid & (Ds < INF_I),
                                (pb_s + r) + v_b - diff_cost * Ds, -INF_I)
            improve = row_active & (score > bs_s)
            bs_s = torch.where(improve, score, bs_s)
            bva_s = torch.where(improve, pb_s + r, bva_s)
            bvb_s = torch.where(improve, v_b, bvb_s)
            bd_s = torch.where(improve, Ds, bd_s)
    D[sel] = Ds
    if track_best:
        bs[sel], bva[sel], bvb[sel], bd[sel] = bs_s, bva_s, bvb_s, bd_s
        v_b = vbb + (rows - 1) + lane
        lane_valid = (v_b >= 0) & (v_b <= blim)
        score_fin = torch.where(lane_valid & (D < INF_I),
                                (pb + rows - 1) + v_b - diff_cost * D,
                                -INF_I)
        smax = score_fin.max(dim=1, keepdim=True).values
        bs_glob = bs.max(dim=1, keepdim=True).values
        act = act & (smax >= bs_glob - xdrop)
        trk = [bs, bva, bvb, bd]
    drift = torch.zeros((S, 1), dtype=torch.int64, device=dev)
    if recenter:
        m = D.min(dim=1, keepdim=True).values
        jmin = torch.where(D == m, lane, INF_I).min(dim=1,
                                                    keepdim=True).values
        go = act & (col(cont) != 0) & (m < INF_I)
        drift = torch.where(go, jmin - CTR, 0)
        src = lane + drift
        ok = (src >= 0) & (src < W)
        D = torch.where(ok, torch.gather(D, 1, src.clamp(0, W - 1)), INF_I)
    i32 = lambda x: x.to(torch.int32)  # noqa: E731
    return (i32(D), i32(act.reshape(S)), *(i32(x) for x in trk),
            i32(drift.reshape(S)))


def dp_rows_kernel(D, a_chars, b_tile, vb_base, p_base, blim, rows_limit,
                   active, best_s, best_va, best_vb, best_d, R: int,
                   W: int = 128, diff_cost: int = 5, xdrop: int = 60,
                   track_best: bool = True, recenter: bool = False,
                   cont=None):
    """Launch K3 on the current CUDA stream (same contract as dp_rows)."""
    lib = _cuda.lib()
    S = D.shape[0]
    dev = D.device
    if W != 128:
        raise ValueError("dp_rows_kernel supports W = 128 only")
    c = lambda x: x.to(torch.int32).contiguous()  # noqa: E731
    Dc, a, b = c(D), c(a_chars), c(b_tile)
    if Dc.shape != (S, W):
        raise ValueError(f"D must be [S, {W}], got {tuple(Dc.shape)}")
    if a.shape[1] < R or b.shape[1] < R + W:
        raise ValueError("a_chars needs >= R columns, b_tile >= R + W")
    if cont is None:
        cont = torch.zeros(S, dtype=torch.int32, device=dev)
    vecs = [c(x).reshape(S) for x in (vb_base, p_base, blim, rows_limit,
                                      active, cont)]
    trk = [c(_as_col(x)) for x in (best_s, best_va, best_vb, best_d)]
    want = (S, W) if track_best else (S,)
    for t in trk:
        if tuple(t.shape) != want:
            raise ValueError(f"trackers must be {want}, got "
                             f"{tuple(t.shape)}")
    for t in (a, b, *vecs, *trk):
        if t.device != dev:
            raise ValueError("dp_rows_kernel: all tensors must share one "
                             "CUDA device")
    D_o = torch.empty_like(Dc)
    act_o = torch.empty(S, dtype=torch.int32, device=dev)
    trk_o = [torch.empty_like(t) for t in trk]
    drift_o = torch.empty(S, dtype=torch.int32, device=dev)
    err = lib.dp_rows_launch(
        Dc.data_ptr(), a.data_ptr(), a.shape[1], b.data_ptr(), b.shape[1],
        *[v.data_ptr() for v in vecs], *[t.data_ptr() for t in trk],
        D_o.data_ptr(), act_o.data_ptr(), *[t.data_ptr() for t in trk_o],
        drift_o.data_ptr(), S, R, W, diff_cost, xdrop, int(track_best),
        int(recenter), _cuda.stream_ptr(D))
    _cuda.check(err, "dp_rows_kernel")
    _cuda.count_launch(dp_rows, S)
    return (D_o, act_o, *trk_o, drift_o)


def dp_rows(D, a_chars, b_tile, vb_base, p_base, blim, rows_limit,
            active, best_s, best_va, best_vb, best_d, R: int, W: int = 128,
            diff_cost: int = 5, xdrop: int = 60, track_best: bool = True,
            recenter: bool = False, cont=None):
    """Run R DP rows over all seeds (damar_tpu wave_pallas.dp_rows).

    D [S, W]; a_chars [S, Ra >= R]; b_tile [S, Wb >= R + W] (chars);
    per-seed vectors for the v-space bases and limits; best_* are
    per-lane trackers [S, W] when track_best, else [S] pass-throughs.
    recenter/cont: recenter continuing seeds (cont[S]) on their first
    minimum column.  Returns (D, active, best_s, best_va, best_vb,
    best_d, drift) int32."""
    run = dp_rows_kernel if D.device.type == "cuda" else dp_rows_plain
    if D.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {D.device}")
    return run(D, a_chars, b_tile, vb_base, p_base, blim, rows_limit,
               active, best_s, best_va, best_vb, best_d, R=R, W=W,
               diff_cost=diff_cost, xdrop=xdrop, track_best=track_best,
               recenter=recenter, cont=cont)


dp_rows.launches = 0


def reduce_best_lanes(bs_l, bva_l, bvb_l, bd_l):
    """Collapse per-lane best trackers to the best per seed: max score,
    then min va, then min vb (damar_tpu ops.wave.reduce_best_lanes).
    Returns (va, vb, d, score); all 0 where the best score is <= 0."""
    s = bs_l.max(dim=1).values
    at = bs_l == s[:, None]
    va = torch.where(at, bva_l, INF_I).min(dim=1).values
    at = at & (bva_l == va[:, None])
    vb = torch.where(at, bvb_l, INF_I).min(dim=1).values
    at = at & (bvb_l == vb[:, None])
    d = torch.where(at, bd_l, INF_I).min(dim=1).values
    keep = s > 0
    return tuple(torch.where(keep, x, 0) for x in (va, vb, d, s))


# extend_wave_wide: the most bytes one step's char tiles and band state
# may take; more units than fit are run as several batches.  A unit and
# step take the a_chars [R] and b_tile [R + W] int32 tiles, their int64
# gather scratch (about five copies of each) and the [W] band with its
# four trackers, in and out.
EXT_STEP_BYTES = 1 << 30


def _ext_unit_bytes(R: int, W: int) -> int:
    return 5 * 8 * (2 * R + W + 64) + 4 * (2 * R + W) + 2 * 5 * 4 * W


def extend_wave_wide(a_bases, b_bases, aorigin, borigin, alim, blim,
                     reverse: bool = False, W: int = 128, R: int = 128,
                     max_rows: int = 65536, diff_cost: int = 5,
                     xdrop: int = 60, dirs=None, packed: bool = False):
    """Wide-band greedy extension of S units (damar_tpu extend_wave_pl,
    same returns): R rows a step through dp_rows in chunk form
    (track_best, recenter, cont), the chars of each step gathered from
    the packed pools (gather_packed); on a CUDA device every step is one
    dp_rows_kernel launch, on the CPU dp_rows_plain.

    dirs: optional bool[S] per-unit direction (True = reverse), in place
    of the static `reverse`.  packed: a_bases/b_bases are already
    pack_bases words.  A unit's outputs do not depend on its batch
    mates (every unit starts at row 0, and an inactive unit's band and
    trackers are frozen), so the units run longest first in batches of
    at most EXT_STEP_BYTES of step state, and each step takes only the
    batch's still-active units.  Returns (va, vb, d, score) int32 [S]:
    the endpoint with the best score = (va + vb) - diff_cost * d found
    before the x-drop stop."""
    if W != 128:
        raise ValueError("extend_wave_wide supports W = 128 only")
    dev = aorigin.device
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    a_words = a_bases if packed else pack_bases(a_bases)
    b_words = b_bases if packed else pack_bases(b_bases)
    S = aorigin.shape[0]
    CTR = W // 2
    i64 = lambda x: x.to(torch.int64)  # noqa: E731
    aorigin, borigin, alim, blim = (i64(x) for x in (aorigin, borigin,
                                                     alim, blim))
    lane = torch.arange(W, device=dev)
    D0 = torch.where(lane >= CTR, lane - CTR, INF_I).to(torch.int32)
    outs = [torch.zeros(S, dtype=torch.int32, device=dev) for _ in range(4)]
    live = torch.nonzero(alim > 0).flatten()
    order = live[torch.argsort(alim[live], descending=True, stable=True)]
    per = max(1, EXT_STEP_BYTES // _ext_unit_bytes(R, W))
    for lo in range(0, int(order.shape[0]), per):
        sel = order[lo:lo + per]
        n = sel.shape[0]
        ao, bo, al, bl = aorigin[sel], borigin[sel], alim[sel], blim[sel]
        rv = reverse if dirs is None else dirs[sel]
        D = D0.repeat(n, 1)
        trk = [torch.zeros((n, W), dtype=torch.int32, device=dev)
               for _ in range(4)]
        boff = torch.zeros(n, dtype=torch.int64, device=dev)
        act = torch.arange(n, device=dev)        # the still-active units
        rtot = 0
        while act.numel() and rtot < max_rows:
            rv_s = rv if isinstance(rv, bool) else rv[act]
            v0 = torch.full_like(act, rtot)
            bf = boff[act]
            a_chars = gather_packed(a_words, ao[act], v0, R, rv_s)
            b_tile = gather_packed(b_words, bo[act], rtot + bf - CTR, R + W,
                                   rv_s)
            rows = (al[act] - rtot).clamp(0, R)
            res = dp_rows(
                D[act], a_chars, _pad_cols(b_tile, 128), rtot + 1 - CTR + bf,
                v0 + 1, bl[act], rows, torch.ones_like(act),
                *[t[act] for t in trk], R=R, W=W, diff_cost=diff_cost,
                xdrop=xdrop, track_best=True, recenter=True,
                cont=(rtot + R) < al[act])
            D[act] = res[0]
            for t, r in zip(trk, res[2:6]):
                t[act] = r
            boff[act] = bf + i64(res[6])
            rtot += R
            act = act[(res[1] != 0) & (rtot < al[act])]
        for o, r in zip(outs, reduce_best_lanes(*trk)):
            o[sel] = r
    return tuple(outs)


def _pad_cols(x, m: int):
    w = x.shape[1]
    target = -(-w // m) * m
    if target == w:
        return x
    return torch.nn.functional.pad(x, (0, target - w))


def _first_argmin(x):
    """Index of the first minimum along dim 1 (jnp.argmin tie-break)."""
    lane = torch.arange(x.shape[1], device=x.device)
    m = x.min(dim=1, keepdim=True).values
    return torch.where(x == m, lane, x.shape[1]).min(dim=1).values


def _segments(abpos, alim, tspace: int):
    """Segments of each extent: the tspace boundaries of A it spans."""
    a0 = abpos.to(torch.int64)
    n = (torch.div(a0 + alim - 1, tspace, rounding_mode="floor")
         - torch.div(a0, tspace, rounding_mode="floor") + 1)
    return torch.where(alim > 0, n, 0)


def trace_wave_steps(a_words, b_words, astart, bstart, abpos, bbpos, alim,
                     blim, tspace: int, max_segs: int, rows_fn,
                     W: int = 128):
    """The reference's wide trace loop (trace_wave_pl) over packed pool
    words, with the DP rows function as an argument (dp_rows_plain, or
    dp_rows_kernel for one launch per step): every step advances each
    live extent one segment to its next absolute tspace boundary,
    commits (diffs, bspan) at the first min-distance column (the known
    end for the last segment) and resets the band there.  The step count
    is the most segments of any extent, read once before the loop.
    Returns (trace [S, max_segs, 2], nseg, dsum) int32."""
    S = abpos.shape[0]
    dev = abpos.device
    CTR = W // 2
    i64 = lambda x: x.to(torch.int64)  # noqa: E731
    lane = torch.arange(W, device=dev)
    abpos, alim, blim = i64(abpos), i64(alim), i64(blim)
    aorigin = i64(astart) + abpos
    borigin = i64(bstart) + i64(bbpos)
    D0 = torch.where(lane >= CTR, lane - CTR, INF_I)
    D = D0.repeat(S, 1)
    z = torch.zeros(S, dtype=torch.int64, device=dev)
    boff, done, nseg, prev_vb, dsum = z, z, z, z, z
    trace = torch.zeros((S, max_segs, 2), dtype=torch.int64, device=dev)
    rows_idx = torch.arange(S, device=dev)
    steps = int(_segments(abpos, alim, tspace).max()) if S else 0
    for _ in range(steps):
        live = done < alim
        a = abpos + done
        nxt = (torch.div(a, tspace, rounding_mode="floor") + 1) * tspace - a
        seg_rows = torch.where(live, torch.minimum(nxt, alim - done), 0)
        a_chars = gather_packed(a_words, aorigin, done, tspace, False)
        b_tile = gather_packed(b_words, borigin, done + boff - CTR,
                               tspace + W, False)
        D = rows_fn(D, _pad_cols(a_chars, 128), _pad_cols(b_tile, 128),
                    done + 1 - CTR + boff, z, blim, seg_rows, live,
                    z, z, z, z, R=tspace, W=W, track_best=False)[0]
        D = i64(D)
        va = done + seg_rows
        at_end = live & (va == alim)
        v_b_fin = va[:, None] + lane - CTR + boff[:, None]
        lane_valid = (v_b_fin >= 0) & (v_b_fin <= blim[:, None])
        j_min = _first_argmin(torch.where(lane_valid, D, INF_I))
        j_end = (blim - va + CTR - boff).clamp(0, W - 1)
        j_com = torch.where(at_end, j_end, j_min)
        vb_com = torch.gather(v_b_fin, 1, j_com[:, None])[:, 0]
        d_com = torch.gather(D, 1, j_com[:, None])[:, 0]
        d_com = torch.where(d_com >= INF_I, alim + blim, d_com)
        ns = torch.clamp(nseg, max=max_segs - 1)
        pair = torch.stack([d_com, vb_com - prev_vb], dim=1)
        trace[rows_idx, ns] = torch.where(live[:, None], pair,
                                          trace[rows_idx, ns])
        D = torch.where(live[:, None], D0, D)
        boff = torch.where(live, boff + (j_com - CTR), boff)
        done = done + seg_rows
        nseg = torch.where(live, nseg + 1, nseg)
        prev_vb = torch.where(live, vb_com, prev_vb)
        dsum = torch.where(live, dsum + d_com, dsum)
    i32 = lambda x: x.to(torch.int32)  # noqa: E731
    return i32(trace), i32(nseg), i32(dsum)


def trace_wave_plain(a_words, b_words, astart, bstart, abpos, bbpos, alim,
                     blim, tspace: int, max_segs: int):
    """Plain torch wide trace: trace_wave_steps over dp_rows_plain (same
    contract as trace_wide_kernel)."""
    return trace_wave_steps(a_words, b_words, astart, bstart, abpos, bbpos,
                            alim, blim, tspace, max_segs, dp_rows_plain)


def trace_wide_kernel(a_words, b_words, astart, bstart, abpos, bbpos, alim,
                      blim, tspace: int, max_segs: int):
    """Launch wide_trace_kernel on the current CUDA stream over all S
    extents: returns (trace [S, max_segs, 2], nseg, dsum) int32.  Warps
    take the extents in input order, so a caller that lays them out
    longest first fills the card best."""
    if tspace <= 0 or max_segs <= 0:
        raise ValueError(f"trace_wide_kernel: tspace {tspace} and "
                         f"max_segs {max_segs} must be positive")
    lib = _cuda.lib()
    S = abpos.shape[0]
    dev = abpos.device
    c = lambda x: x.to(torch.int32).contiguous()  # noqa: E731
    aw, bw = c(a_words), c(b_words)
    ins = [c(x) for x in (astart, bstart, abpos, bbpos, alim, blim)]
    for t in (aw, bw, *ins):
        if t.device != dev:
            raise ValueError("trace_wide_kernel: all tensors must share "
                             "one CUDA device")
    for t in ins:
        if tuple(t.shape) != (S,):
            raise ValueError(f"trace_wide_kernel: per-extent vectors must "
                             f"be [{S}], got {tuple(t.shape)}")
    counter = torch.zeros(1, dtype=torch.int32, device=dev)
    # the kernel writes segments [0, nseg) only
    trace = torch.zeros((S, max_segs, 2), dtype=torch.int32, device=dev)
    nseg = torch.empty(S, dtype=torch.int32, device=dev)
    dsum = torch.empty(S, dtype=torch.int32, device=dev)
    err = lib.wide_trace_launch(
        aw.data_ptr(), aw.shape[0], bw.data_ptr(), bw.shape[0],
        *[t.data_ptr() for t in ins], S, tspace, max_segs,
        counter.data_ptr(), trace.data_ptr(), nseg.data_ptr(),
        dsum.data_ptr(), _cuda.stream_ptr(abpos))
    _cuda.check(err, "wide_trace_kernel")
    _cuda.count_launch(trace_wave, S)
    return trace, nseg, dsum


def trace_wave(a_bases, b_bases, astart, bstart, abpos, bbpos, alim, blim,
               tspace: int = 100, W: int = 128, max_segs: int = 660,
               packed: bool = False):
    """Wide-band trace pass (damar_tpu trace_wave_pl) over extents: on a
    CUDA device one wide_trace_kernel launch, on the CPU
    trace_wave_plain.  packed: a_bases/b_bases are already pack_bases
    words.  Returns (trace [S, max_segs, 2], nseg, dsum) int32."""
    if W != 128:
        raise ValueError("trace_wave supports W = 128 only")
    if abpos.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {abpos.device}")
    a_words = a_bases if packed else pack_bases(a_bases)
    b_words = b_bases if packed else pack_bases(b_bases)
    run = (trace_wide_kernel if abpos.device.type == "cuda"
           else trace_wave_plain)
    return run(a_words, b_words, astart, bstart, abpos, bbpos, alim, blim,
               tspace, max_segs)


trace_wave.launches = 0
trace_wave.takes_packed = True
