"""The pile aligner (K4): banded edit alignment with traceback over a
ragged batch of (template, cover) pairs.

The port's counterpart of damar_tpu's host C band_align and
band_align_batch (damar_tpu/native/damar_native.c:218, :322), which the
reference's consensus calls through native.band_align_paths
(damar_tpu/pipeline/consensus.py:153-180); not a TPU kernel.  Each pair
gives its path's ops (0 = match/sub consuming a template and a cover
char, 1 = del consuming a template char, 2 = ins consuming a cover char)
in forward order and jstart, the cover position the path starts at.  The
results are the C's in both modes: the band frame off = floor((n-m)/2)
with floor division, the BA_INF sentinel, the traceback's order of
preference and the first-min start column of a semiglobal last row.  In
global mode the C gives up (and the reference falls back to numpy) when
the path's end column lies outside the band; here that raises.

Kernel: band_align_kernel in damar_tpu_torch/csrc/band_align.cu, a warp
for a narrow pair and a block of warps for a wide one, in one launch
(the file's header says what bounds it); plan_launch sorts the pairs
into the two classes on the host.  Beside it the plain torch version,
band_align_plain, which batches the pairs over the rows with the same
prefix-minimum identity and walks all pairs' flags together; the
wrapper band_align takes it only for CPU tensors.  align_pairs, the
pipeline's entry, makes one sync a call on the card (align_packed).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from damar_tpu_torch.ops import _cuda

# the plain version's sentinel in place of the C's BA_INF (0x3FFFFFFF)
# and its "no candidate" value (see _plain_chunk)
PLAIN_INF, PLAIN_BIG = (1 << 29) - 1, (1 << 29) + (1 << 12)
# the kernel's groups (csrc/band_align.cu): 8 cells a thread, 256 a warp;
# a narrow pair (width <= 256) on a warp, six to a block; a wide pair on
# a block of up to six warps, so the largest band is 767
WARP_CELLS, MAX_WARPS, NARROW_PER_BLOCK = 256, 6, 6
MAX_BAND = (MAX_WARPS * WARP_CELLS - 1) // 2
# the most dynamic shared memory a block takes for a wide pair's codes
# (of the 227 KB a block can have, less the kernel's 12.5 KB static)
SMEM_CAP = 212 * 1024
# cells (rows x band columns x pairs) of one chunk of the plain version
PLAIN_CHUNK_CELLS = 1 << 23

# the plain walk: a cell's flag bits (1 diag-equal, 2 up-equal, 4
# left-equal) give its op and step in the C's order of preference (diag,
# up, left, then the fallback: a deletion, i - 1); row 0's byte is 4 (a
# left step) or one of these two
_TERMINAL, _OUT_OF_BAND = 255, 254
_FLAG_OP = tuple(0 if f & 1 else 1 if f & 2 else 2 if f & 4 else 1
                 for f in range(8))
_FLAG_STEP = tuple(-1 if f & 1 or f & 2 or not f & 4 else 0
                   for f in range(8))             # rows
_FLAG_DK = tuple(0 if f & 1 else 1 if f & 2 else -1 if f & 4 else 0
                 for f in range(8))               # columns


def _lengths(a_off, b_off):
    m = (a_off[1:] - a_off[:-1]).to(torch.int64)
    n = (b_off[1:] - b_off[:-1]).to(torch.int64)
    return m, n


def _check(a, a_off, b, b_off, band):
    P = band.shape[0]
    if tuple(a_off.shape) != (P + 1,) or tuple(b_off.shape) != (P + 1,):
        raise ValueError(f"band_align: offsets must be [{P + 1}], got "
                         f"{tuple(a_off.shape)} and {tuple(b_off.shape)}")
    if a.dtype != torch.uint8 or b.dtype != torch.uint8:
        raise ValueError("band_align: templates and covers must be uint8")
    for t in (a_off, b_off, band, b):
        if t.device != a.device:
            raise ValueError("band_align: all tensors must share one device")
    if P and int(band.min()) < 0:
        raise ValueError("band_align: negative band")


def _plain_chunk(a, a_off, b, b_off, band, semiglobal: bool):
    """band_align_plain over one chunk of pairs: (ops, lens, jstart).

    int32 throughout, with INF in place of the C's BA_INF: every finite
    value is at most m+n, far below INF, so each comparison the C makes
    (its equalities with BA_INF and BA_INF + 1 among them) comes out the
    same.  A candidate holding BIG (>= INF + 2) never wins a cell.  The
    rows are kept as E = D - k (as K3 keeps D - lane), so the insertion
    chain is a plain prefix minimum and the three traceback tests are
    E_prev + sub == E, E_prev[k+1] + 2 == E and E[k-1] == E."""
    INF, BIG = PLAIN_INF, PLAIN_BIG
    i32, u8 = torch.int32, torch.uint8
    dev = a.device
    P = band.shape[0]
    m, n = _lengths(a_off, b_off)
    bd = band.to(torch.int64)
    width = 2 * bd + 1
    W = int(width.max())
    M = int(m.max())
    off = torch.div(n - m, 2, rounding_mode="floor")
    base = off - bd                                    # j(0, 0)
    kk = torch.arange(W, dtype=torch.int64, device=dev)
    kout = kk[None, :] >= width[:, None]               # [P, W]
    j0 = base[:, None] + kk[None, :]                   # [P, W]: j at row 0
    nn = n[:, None]
    # a cell's j depends on i + k only: per pair, the cover char (4 where
    # j is outside [1, n]) and "j outside [0, n]" as functions of t = i + k,
    # seen as [row, pair, column] through a strided view
    L = M + W + 1
    jt = base[:, None] + torch.arange(L, dtype=torch.int64,
                                      device=dev)[None, :]
    bpad = torch.cat([b, torch.zeros(1, dtype=u8, device=dev)])
    bt = bpad[(b_off[:-1].to(torch.int64)[:, None] + jt - 1)
              .clamp_(0, bpad.numel() - 1)]
    bt.masked_fill_((jt < 1) | (jt > nn), 4)
    out_t = (jt < 0) | (jt > nn)
    rows3 = lambda x: x.as_strided((M, P, W), (1, L, 1), 1)  # noqa: E731
    apad = torch.cat([a, torch.zeros(1, dtype=u8, device=dev)])
    ach = apad[(a_off[:-1].to(torch.int64)[None, :]
                + torch.arange(M, dtype=torch.int64, device=dev)[:, None])
               .clamp_(0, apad.numel() - 1)]
    # per row and cell: A the diagonal's addend (the mismatch inside
    # 1 <= j <= n, else BIG), U2 the up term's (2, or BIG outside the band
    # or outside 0 <= j <= n), FLOOR what such cells hold (INF - k)
    bv = rows3(bt)
    A = (bv != ach[:, :, None]).to(i32).masked_fill_(bv == 4, BIG)
    OUT = rows3(out_t) | kout[None]
    U2 = torch.full((M, P, W), 2, dtype=i32, device=dev).masked_fill_(OUT, BIG)
    infk = (INF - kk).to(i32)
    FLOOR = torch.where(OUT, infk, -BIG)
    del bt, bv, out_t, OUT
    # the row buffer: column 0 the left neighbour of k = 0 (never equal),
    # columns 1..W the row, column W+1 the up term past the band
    buf = torch.empty((P, W + 2), dtype=i32, device=dev)
    buf[:, 0] = INF + 1
    buf[:, W + 1] = INF - W
    v0 = ~kout & (j0 >= 0) & (j0 <= nn)
    D0 = torch.where(v0, j0.clamp(min=0) * (0 if semiglobal else 1), INF)
    buf[:, 1:W + 1] = (D0 - kk).to(i32)
    # each cell's traceback tests as flag bits (1 diag-equal, 2 up-equal,
    # 4 left-equal); row 0 holds its move instead: a left step (4) or the
    # end of the walk (_TERMINAL; _OUT_OF_BAND where a global walk would
    # step past column 0)
    FL = torch.empty((M + 1, P, W), dtype=u8, device=dev)
    term0 = torch.ones_like(j0, dtype=torch.bool) if semiglobal \
        else j0 <= 0
    FL[0] = torch.where(term0, _TERMINAL, torch.where(
        kk[None, :] >= 1, 4, _OUT_OF_BAND)).to(u8)
    last = buf[:, 1:W + 1].clone()
    ends = {}
    for p_, mm in enumerate(m.tolist()):
        ends.setdefault(mm, []).append(p_)
    # views made once: the row (written in place), its left neighbours
    # and up terms, and each row's addends and flag bytes
    row, left, upr = buf[:, 1:W + 1], buf[:, :W], buf[:, 2:]
    for i, (a_i, u_i, f_i, fl_i) in enumerate(zip(
            A.unbind(0), U2.unbind(0), FLOOR.unbind(0), FL[1:].unbind(0)),
            1):
        diag = torch.add(row, a_i)
        upu = torch.add(upr, u_i)
        cm = torch.cummin(torch.minimum(diag, upu), 1).values
        torch.maximum(torch.minimum(cm, infk, out=cm), f_i, out=row)
        f = torch.add(torch.eq(diag, row).view(u8),
                      torch.eq(upu, row).view(u8), alpha=2)
        torch.add(f, torch.eq(left, row).view(u8), alpha=4, out=fl_i)
        if i in ends:
            sel = torch.tensor(ends[i], device=dev)
            last[sel] = row[sel]
    last = last.to(torch.int64) + kk                   # D of each last row
    # start column
    if semiglobal:
        lo, arg = torch.min(last, 1)
        kstart = torch.where(lo < INF, arg, 0)
    else:
        kstart = n - m + bd - off
        bad = (kstart < 0) | (kstart >= width)
        if bool(bad.any()):
            p = int(torch.nonzero(bad)[0])
            raise ValueError(f"band_align: global path end outside the band "
                             f"(pair {p}: m {int(m[p])}, n {int(n[p])}, band "
                             f"{int(bd[p])})")
    # one walk over all pairs: each step reads its cell's byte
    mv = FL.flatten()
    PW = P * W
    step = torch.zeros(256, dtype=torch.int64, device=dev)
    step[:8] = (torch.tensor(_FLAG_STEP, device=dev) * PW
                + torch.tensor(_FLAG_DK, device=dev))
    cur = (m * P + torch.arange(P, device=dev)) * W + kstart
    S = int((m + n).max()) + 1
    cols = []
    for t in range(S):
        o = torch.take(mv, cur)
        cols.append(o)
        cur.add_(torch.take(step, o.to(torch.int64)))
        if t % 64 == 63 and bool((o == _TERMINAL).all()):
            break
    O = torch.full((P, S), _TERMINAL, dtype=torch.uint8, device=dev)
    O[:, :len(cols)] = torch.stack(cols, 1)
    if bool((O == _OUT_OF_BAND).any()):
        raise ValueError("band_align: the traceback left the band (global "
                         "mode)")
    lens = (O != _TERMINAL).sum(1)
    jstart = (cur % W + base).to(torch.int32)
    lut = torch.zeros(256, dtype=torch.uint8, device=dev)
    lut[:8] = torch.tensor(_FLAG_OP, dtype=torch.uint8, device=dev)
    ops_rev = lut[O.to(torch.int64)]
    # reverse each pair's first lens steps into forward order
    idx = (lens[:, None] - 1
           - torch.arange(S, device=dev)[None, :]).clamp(min=0)
    fwd = ops_rev.gather(1, idx)
    keep = torch.arange(S, device=dev)[None, :] < lens[:, None]
    return fwd[keep], lens, jstart


def band_align_plain(a, a_off, b, b_off, band, semiglobal: bool = True):
    """Plain torch version of band_align_kernel (same contract): the
    rows of every pair of a chunk in one loop, the insertion chain as
    k + cummin(best - k), each cell's three traceback tests as flag bits,
    then one walk over all pairs' flags.  Returns (ops uint8 [sum of
    lengths], offs int64 [P+1], jstart int32 [P])."""
    _check(a, a_off, b, b_off, band)
    dev = a.device
    P = band.shape[0]
    m, n = _lengths(a_off, b_off)
    offs = torch.zeros(P + 1, dtype=torch.int64, device=dev)
    if P == 0:
        return torch.zeros(0, dtype=torch.uint8, device=dev), offs, \
            torch.zeros(0, dtype=torch.int32, device=dev)
    if int((m + n).max()) >= PLAIN_INF // 2:
        raise ValueError("band_align_plain: pairs too long for its sentinel")
    # chunks of pairs of one band (a chunk's rows run to its longest
    # template and its columns to its widest band for every pair), in
    # order of band and template length; the results go back in input
    # order
    order = torch.from_numpy(np.lexsort((m.cpu().numpy(),
                                         band.cpu().numpy()))).to(dev)
    ao, bo = a_off.tolist(), b_off.tolist()
    cells = ((m + 1) * (2 * band.to(torch.int64) + 1))[order].tolist()
    bands = band[order].tolist()
    lens = torch.zeros(P, dtype=torch.int64, device=dev)
    jst = torch.zeros(P, dtype=torch.int32, device=dev)
    ops = [None] * P
    q0 = 0
    while q0 < P:
        q1, acc = q0, 0
        while q1 < P and (q1 == q0 or (
                bands[q1] == bands[q0]
                and acc + cells[q1] <= PLAIN_CHUNK_CELLS)):
            acc += cells[q1]
            q1 += 1
        sel = order[q0:q1]
        idx = sel.tolist()
        ta, tao = _gather(a, ao, idx)
        tb, tbo = _gather(b, bo, idx)
        o, ln, js = _plain_chunk(ta, tao, tb, tbo, band[sel], semiglobal)
        lens[sel] = ln
        jst[sel] = js
        ends = np.cumsum(ln.tolist())
        for r, p in enumerate(idx):
            ops[p] = o[ends[r - 1] if r else 0:ends[r]]
        q0 = q1
    offs[1:] = torch.cumsum(lens, 0)
    return torch.cat(ops), offs, jst


def _gather(x, x_off: list, sel: list):
    """The slices x[x_off[p]:x_off[p+1]] for p in sel, concatenated, with
    their offsets."""
    parts = [x[x_off[p]:x_off[p + 1]] for p in sel]
    off = np.zeros(len(parts) + 1, np.int64)
    np.cumsum([len(t) for t in parts], out=off[1:])
    return torch.cat(parts), torch.from_numpy(off).to(x.device)



class Plan(NamedTuple):
    """One band_align_kernel launch, planned on the host from the pairs'
    lengths and bands (numpy int64 arrays [P])."""
    m: np.ndarray
    n: np.ndarray
    band: np.ndarray
    order: np.ndarray      # int32 [P]: the narrow pairs, then the wide
    n_narrow: int
    per_block: int         # narrow pairs a block
    n_wide: int
    c_off: np.ndarray      # int64 [P]: codes in the global scratch, -1
    code_bytes: int        # in shared memory; the scratch's size
    smem: int              # dynamic shared memory a block (bytes)
    o_end: np.ndarray      # int64 [P]: the end of each pair's op region
    ops_bytes: int
    cells: np.ndarray      # int64 [P]: (m+1) x (2 band + 1)
    wide: np.ndarray       # bool [P]

    @property
    def blocks(self) -> tuple[int, int]:
        """(narrow blocks, wide blocks) of the launch."""
        return -(-self.n_narrow // self.per_block), self.n_wide


def plan_launch(m, n, band, sms: int = 132) -> Plan:
    """The launch of band_align_kernel over pairs with these template and
    cover lengths and bands (see csrc/band_align.cu): each pair's class
    (narrow: width <= WARP_CELLS, a warp; wide: a block of
    ceil(width / WARP_CELLS) warps), the order (each class longest
    first), the narrow pairs a block (NARROW_PER_BLOCK, or fewer where
    the launch would leave some of the card's `sms` SMs idle, so that
    the few pairs of a polish window each have an SM), where each pair's
    2-bit codes go (a wide pair's into the block's dynamic shared memory
    when they fit SMEM_CAP, sized to the call's largest such pair; the
    rest into 16-byte aligned global scratch) and the op regions.
    Raises on a band above MAX_BAND."""
    m, n, band = (np.asarray(x, np.int64) for x in (m, n, band))
    P = len(band)
    if P and int(band.min()) < 0:
        raise ValueError("band_align_kernel: negative band")
    if P and int(band.max()) > MAX_BAND:
        raise ValueError(f"band_align_kernel: band {int(band.max())} > "
                         f"{MAX_BAND}")
    width = 2 * band + 1
    wide = width > WARP_CELLS
    cbytes = (m + 1) * (16 * -(-width // 64))
    in_smem = wide & (cbytes <= SMEM_CAP)
    glob = np.where(in_smem, 0, cbytes)
    c_off = np.cumsum(glob) - glob
    c_off[in_smem] = -1
    cells = (m + 1) * width
    key = np.lexsort((-cells, wide))          # narrow first, longest first
    o_end = np.cumsum(m + n)
    n_narrow, n_wide = int((~wide).sum()), int(wide.sum())
    per_block = min(NARROW_PER_BLOCK,
                    max(1, -(-n_narrow // max(1, sms - n_wide))))
    return Plan(m, n, band, key.astype(np.int32), n_narrow, per_block,
                n_wide, c_off, int(glob.sum()),
                int(cbytes[in_smem].max()) if in_smem.any() else 0,
                o_end, int(o_end[-1]) if P else 0, cells, wide)


def _sms(device) -> int:
    """The card's SM count."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def _layout(parts: list) -> tuple[list, int]:
    """Byte offsets of the arrays `parts` packed one after another, each
    at a 16-byte boundary, and the total size."""
    offs, pos = [], 0
    for x in parts:
        offs.append(pos)
        pos += -(-x.nbytes // 16) * 16
    return offs, max(pos, 16)


def _launch(a, a_off, b, b_off, band, plan: Plan, meta, semiglobal: bool):
    """One band_align_kernel launch on the current stream of the tensors'
    device: a, b uint8 and a_off, b_off int64 [P+1], band int32 [P] on
    the card, `meta` the byte tensor on the card holding plan.order,
    plan.c_off and plan.o_end (at the offsets _layout gives them).
    Returns the result bytes on the card: the op regions (plan.ops_bytes,
    then up to 16-byte alignment), lengths int32 [P], jstart int32 [P]."""
    lib = _cuda.lib()
    dev = a.device
    P = len(plan.band)
    (o_order, o_coff, o_oend), _ = _layout(
        [plan.order, plan.c_off, plan.o_end])
    nops, size = _result_layout(P, plan.ops_bytes)
    res = torch.empty(size, dtype=torch.uint8, device=dev)
    codes = torch.empty(max(plan.code_bytes, 16), dtype=torch.uint8,
                        device=dev)
    base = meta.data_ptr()
    timed = band_align.events is not None and P > 0
    if timed:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
    err = lib.band_align_launch(
        a.data_ptr(), a_off.data_ptr(), b.data_ptr(), b_off.data_ptr(),
        band.data_ptr(), base + o_order, base + o_coff, base + o_oend,
        plan.n_narrow, plan.per_block, plan.n_wide, int(bool(semiglobal)),
        plan.smem, codes.data_ptr(), res.data_ptr(), res.data_ptr() + nops,
        res.data_ptr() + nops + 4 * P, _cuda.stream_ptr(a))
    _cuda.check(err, "band_align_kernel")
    _cuda.count_launch(band_align, P)
    if timed:
        ev[1].record()
        band_align.events.append(ev)
    return res


def _result_layout(P: int, ops_bytes: int) -> tuple[int, int]:
    """(where the lengths start, total bytes) of _launch's result bytes:
    the op regions, lengths int32 [P] at a 16-byte boundary, jstart int32
    [P] after them."""
    nops = -(-ops_bytes // 16) * 16
    return nops, nops + 8 * P + 16


def _results(res, P: int, ops_bytes: int):
    """(op regions, lengths, jstart) views of _launch's result bytes
    (copied to the host)."""
    nops, _ = _result_layout(P, ops_bytes)
    return (res[:ops_bytes], res[nops:nops + 4 * P].view(torch.int32),
            res[nops + 4 * P:nops + 8 * P].view(torch.int32))


def band_align_kernel(a, a_off, b, b_off, band, semiglobal: bool = True):
    """Launch band_align_kernel on the card over all P pairs: returns
    (ops uint8, offs int64 [P+1], jstart int32 [P]) on the card.  Reads
    the pairs back to the host and goes through align_packed, the
    pipeline's own launch, so the two share their packing and unpacking;
    align_pairs starts from its host arrays instead."""
    _check(a, a_off, b, b_off, band)
    dev = a.device
    host = tuple(np.ascontiguousarray(x.cpu().numpy()) for x in (
        a, a_off.to(torch.int64), b, b_off.to(torch.int64),
        band.to(torch.int32)))
    ops, o_end, lens, jst = align_packed(host, semiglobal, dev)
    lens = lens.astype(np.int64)
    offs = np.zeros(len(lens) + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    src = np.repeat(o_end - lens - offs[:-1], lens) + np.arange(offs[-1])
    return tuple(torch.from_numpy(x).to(dev) for x in (ops[src], offs, jst))


def band_align(a, a_off, b, b_off, band, semiglobal: bool = True):
    """Banded alignments of P (template, cover) pairs: templates
    a[a_off[p]:a_off[p+1]], covers b[b_off[p]:b_off[p+1]] (uint8 codes
    0-3), band[p] diagonals each side.  On a CUDA device one
    band_align_kernel launch, on the CPU band_align_plain.  Returns (ops
    uint8, offs int64 [P+1], jstart int32 [P])."""
    if a.device.type == "cuda":
        return band_align_kernel(a, a_off, b, b_off, band, semiglobal)
    if a.device.type == "cpu":
        return band_align_plain(a, a_off, b, b_off, band, semiglobal)
    raise ValueError(f"band_align: unsupported device {a.device}")


band_align.launches = 0
# a list that band_align_kernel appends each launch's pair of CUDA events
# (around the kernel alone) to, or None
band_align.events = None


def pack_pairs(pairs: list, device) -> tuple:
    """[(template, cover, band)] numpy pairs -> the tensors of one
    band_align call on `device`: (a, a_off, b, b_off, band)."""
    return tuple(torch.from_numpy(x).to(torch.device(device))
                 for x in _host_pairs(pairs))


def align_pairs(pairs: list, semiglobal: bool = True, *, device
                ) -> list[tuple[np.ndarray, int]]:
    """[(template, cover, band)] numpy pairs -> [(ops, jstart)] through one
    band_align call on `device`.  On the card (align_packed) the launch
    is planned from the host arrays, the inputs go up in one copy and the
    results come back in one: one sync a call."""
    if not pairs:
        return []
    if torch.device(device).type == "cuda":
        ops, o_end, lens, jst = align_packed(_host_pairs(pairs), semiglobal,
                                             torch.device(device))
        return [(ops[o_end[i] - lens[i]:o_end[i]], int(jst[i]))
                for i in range(len(pairs))]
    ops, o_off, jst = band_align(*pack_pairs(pairs, device), semiglobal)
    ops, o_off, jst = ops.cpu().numpy(), o_off.cpu().numpy(), \
        jst.cpu().numpy()
    return [(ops[o_off[i]:o_off[i + 1]], int(jst[i]))
            for i in range(len(pairs))]


def _host_pairs(pairs: list) -> tuple:
    """[(template, cover, band)] -> numpy (a, a_off, b, b_off, band)."""
    def cat(xs):
        return np.concatenate(xs) if xs else np.zeros(0, np.uint8)

    def offs(xs):
        o = np.zeros(len(xs) + 1, np.int64)
        np.cumsum([len(x) for x in xs], out=o[1:])
        return o
    ts = [np.asarray(p[0], np.uint8) for p in pairs]
    cs = [np.asarray(p[1], np.uint8) for p in pairs]
    return (cat(ts), offs(ts), cat(cs), offs(cs),
            np.array([p[2] for p in pairs], np.int32))


def align_packed(host: tuple, semiglobal: bool, device) -> tuple:
    """One band_align_kernel launch over the numpy pairs `host` (a, a_off,
    b, b_off, band as _host_pairs gives them): the arrays and the plan go
    up in one pinned buffer and one copy, the op regions, lengths and
    jstart come back in one copy (the call's one sync).  Returns numpy
    (ops, o_end, lens, jstart): pair p's ops are ops[o_end[p] - lens[p]:
    o_end[p]].  Raises on a global path that leaves the band."""
    a, a_off, b, b_off, band = host
    P = len(band)
    plan = plan_launch(np.diff(a_off), np.diff(b_off), band, _sms(device))
    parts = [plan.order, plan.c_off, plan.o_end, a_off, b_off, band, a, b]
    offs, size = _layout(parts)
    pinned = torch.empty(size, dtype=torch.uint8, pin_memory=True)
    buf = pinned.numpy()
    for x, o in zip(parts, offs):
        buf[o:o + x.nbytes] = x.view(np.uint8)
    up = pinned.to(device, non_blocking=True)
    view = lambda i, dt: up[offs[i]:offs[i] + parts[i].nbytes].view(dt)  # noqa: E731
    res = _launch(view(6, torch.uint8), view(3, torch.int64),
                  view(7, torch.uint8), view(4, torch.int64),
                  view(5, torch.int32), plan, up, semiglobal)
    back = torch.empty(res.numel(), dtype=torch.uint8, pin_memory=True)
    back.copy_(res, non_blocking=True)
    torch.cuda.current_stream(device).synchronize()
    ops, lens, jst = (x.numpy().copy()
                      for x in _results(back, P, plan.ops_bytes))
    if (lens < 0).any():
        raise ValueError("band_align_kernel: a global path leaves the band")
    return ops, plan.o_end, lens, jst
