"""Block-pair overlap pipeline (daligner equivalent), device route.

Torch port of the device half of damar_tpu/pipeline/overlap.py:

  canonical seeding (ops.seeding)  ->  device-resident two-phase
  bidirectional extension (K1)     ->  columnar dedupe (host numpy)  ->
  trace pass (K2, retries on the wide band K3)  ->  .las columns

For a block pair (A, B) both orientations of B are processed (the COMP
pass aligns A against the per-read reverse-complemented B block; .las B
coordinates are in complement space).  Mirrored records (B as A-read)
are traced by a swapped-role pass, so a self-block comparison yields the
full pile of every read.  Read ids in emitted records are absolute DB
read ids.

The trace follows the reference's all-device route: the bit-parallel
trace kernel first, then the wide-band kernel for the extents it could
not force through (no host C tiers: the port has none).  Results are
byte-identical to damar_tpu on that route.

The masking and scrub stages reach the same kernels through
extend_seeds (K1 on the datander search's seeds) and retrace_rows (K3's
wide trace on stitched records).

Device arrays live in each block's `cache` (uploads, packed words, the
A-side index, the trace pool) until release_device_buffers drops them
or the block object goes.  A sweep over many pairs runs
overlap_pairs_pipelined: pair N's trace and emit on a worker thread with
its own CUDA stream while the caller's thread seeds and extends pair
N + 1.
"""
from __future__ import annotations

import concurrent.futures
import logging
import time
from functools import partial

import numpy as np
import torch

from damar_tpu_torch.core.blocks import ReadBlock, revcomp_block
from damar_tpu_torch.core.config import OverlapConfig
from damar_tpu_torch.formats.las import (H_ABPOS, H_AEPOS, H_AREAD,
                                         H_BBPOS, H_BEPOS, H_BREAD, H_DIFFS,
                                         H_FLAGS, H_TLEN, TRACE_XOVR,
                                         LasColumns, LasFile, Overlap,
                                         encode_trace_columns)
from damar_tpu_torch.formats.oflags import OVL_COMP, OVL_DISCARD
from damar_tpu_torch.ops.seeding import (bias_weight_lut,
                                         canonical_index_dev,
                                         find_seeds_canonical_dev,
                                         quantize_bits)
from damar_tpu_torch.ops.sort import pack_fields, radix_sort_packed
from damar_tpu_torch.ops.wave_bp import extend_wave_bp, trace_wave_bp
from damar_tpu_torch.ops.wave_wide import extend_wave_wide, trace_wave
from damar_tpu_torch.ops.words import pack_bases

EXT_KEYS = ("aread", "bread", "abpos", "aepos", "bbpos", "bepos",
            "diffs")
# trace rounds (K2, and K3 for the wide retries): the most bytes one
# launch's [S, max_segs, 2] int32 trace buffer may take; a larger bucket
# is split into several launches
TRACE_BUF_BYTES = 1 << 30
# a sweep prefetches the next pair's uploads only for blocks up to this
# capacity
PREFETCH_CAP = 1 << 27
# the first seed buffer when seed_cap is None (damar_tpu's default cap);
# it grows to the banding's exact total
SEED_CAP_START = 1 << 17

log = logging.getLogger(__name__)


def _dp_kernel(cfg: OverlapConfig) -> str:
    """cfg.dp_kernel, checked: "bp" (K1 extends, K2 traces, K3 retries)
    or "wide" (K3 extends and traces)."""
    if cfg.dp_kernel not in ("bp", "wide"):
        raise ValueError(f"dp_kernel must be 'bp' or 'wide', got "
                         f"{cfg.dp_kernel!r}")
    return cfg.dp_kernel


def _mask_fp(mask) -> bytes | None:
    """Cheap fingerprint of a soft-mask vector (cache key part)."""
    if mask is None:
        return None
    import hashlib
    return hashlib.blake2b(np.ascontiguousarray(mask).tobytes(),
                           digest_size=8).digest()


def _cached_a_index(blk: ReadBlock, kind: str, k: int, mask, build):
    """A-side canonical index, memoized on the block (one entry, replaced
    when k/mask change): a sweep builds it once per A row."""
    key = (kind, k, _mask_fp(mask))
    ent = blk.cache.get("a_index")
    if ent is not None and ent[0] == key:
        return ent[1]
    idx = build()
    blk.cache["a_index"] = (key, idx)
    return idx


def _rc_cached(blk: ReadBlock) -> ReadBlock:
    """Per-read reverse complement of a block, memoized on the block."""
    rc = blk.cache.get("rc_block")
    if rc is None:
        rc = revcomp_block(blk)
        blk.cache["rc_block"] = rc
    return rc


def release_device_buffers(blk: ReadBlock) -> None:
    """Drop a block's cached device buffers (the bases/read_id uploads,
    packed words and starts, the trace pool, the device A-side index,
    and the same on its cached rc twin).  The caches pin device memory
    for as long as the block object lives, so a sweep over many blocks
    bounds how many stay resident.  Host-side caches (the rc twin's
    bases) are kept.  A pair state that overlap_pair_device returned
    holds its own references, so its emit is not affected."""
    blk.cache.pop("dev_arrs", None)
    blk.cache.pop("trace_pool", None)
    ent = blk.cache.get("a_index")
    if ent is not None and ent[0][0].startswith("dev3"):
        blk.cache.pop("a_index", None)
    rc = blk.cache.get("rc_block")
    if rc is not None:
        rc.cache.pop("dev_arrs", None)
        rc.cache.pop("trace_pool", None)


def _dev_arr(blk: ReadBlock, name: str, device):
    """Upload-once device residency for a block array (bases/read_id)."""
    d = blk.cache.setdefault("dev_arrs", {})
    arr = d.get((name, str(device)))
    if arr is None:
        arr = torch.as_tensor(getattr(blk, name), device=device)
        d[(name, str(device))] = arr
    return arr


def _packed_words_of(blk: ReadBlock, device):
    """Block bases as device-resident packed words, memoized."""
    d = blk.cache.setdefault("dev_arrs", {})
    w = d.get(("words", str(device)))
    if w is None:
        w = pack_bases(_dev_arr(blk, "bases", device))
        d[("words", str(device))] = w
    return w


def _starts_dev(blk: ReadBlock, device):
    d = blk.cache.setdefault("dev_arrs", {})
    s = d.get(("starts", str(device)))
    if s is None:
        s = torch.as_tensor(np.asarray(blk.starts, dtype=np.int64),
                            device=device)
        d[("starts", str(device))] = s
    return s


def empty_extents() -> dict:
    out = {k: np.zeros(0, np.int32) for k in EXT_KEYS}
    out["n"] = 0
    return out


def _take_extents(ext: dict, idx) -> dict:
    out = {k: ext[k][idx] for k in EXT_KEYS}
    out["n"] = len(out["aread"])
    return out


def _round_slice(n: int, q: int = 1024) -> int:
    """Round a prefix length up to a q multiple."""
    return max(q, -(-n // q) * q)


# ---------------------------------------------------------------------------
# Device-resident extension: seeds -> units -> extents stay on the device;
# the host sees a few counts and one download of the extents.  K1 runs
# one launch per phase and orientation over every unit slot (the kernel's
# warps take the units longest first).
# ---------------------------------------------------------------------------

def _prep_units_dev(ar, br, ap, bp, cmp_, n: int, a_starts, b_starts,
                    rb: int, pb: int):
    """Anchor dedupe + comp split + unit building, on the device.

    The dedupe keeps the first of each identical-anchor group under a
    stable sort by (aread, bread, comp, apos_local, bpos_local), and the
    survivors in ascending original order.  Per orientation: the
    bidirectional unit arrays ([fwd | rev], ap/bp in read-local frames;
    dead slots have alim = 0)."""
    dev = ar.device
    n_pad = ar.shape[0]
    idx = torch.arange(n_pad, device=dev)
    live = idx < n
    nA = a_starts.shape[0] - 1
    nB = b_starts.shape[0] - 1
    a0 = a_starts[ar.clamp(0, nA - 1)]
    a1 = a_starts[(ar + 1).clamp(0, nA)]
    b0 = b_starts[br.clamp(0, nB - 1)]
    b1 = b_starts[(br + 1).clamp(0, nB)]
    ap_l = ap - a0
    bp_l = bp - b0
    fmax = (1 << pb) - 1
    rmax = (1 << rb) - 1
    key_fields = (torch.where(live, bp_l, fmax),
                  torch.where(live, ap_l, fmax),
                  torch.where(live, cmp_, 1),
                  torch.where(live, br, rmax),
                  torch.where(live, ar, rmax))
    widths = (pb, pb, 1, rb, rb)
    words = pack_fields(key_fields, widths)
    srt, (sidx,) = radix_sort_packed(words, (idx,), sum(widths))
    neq = torch.zeros(n_pad - 1, dtype=torch.bool, device=dev)
    for w in srt:
        neq |= w[1:] != w[:-1]
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), neq])
    kb = torch.zeros(n_pad, dtype=torch.bool, device=dev)
    kb[sidx] = first & live[sidx]

    parts = []
    for comp in (0, 1):
        is_c = kb & (cmp_ == comp)
        chosen = torch.nonzero(is_c).flatten()
        m = int(chosen.shape[0])
        sel = torch.zeros(n_pad, dtype=torch.int64, device=dev)
        sel[:m] = chosen
        aps_l = ap_l[sel]
        bps_l = bp_l[sel]
        half = idx < m
        al_f = (a1 - ap)[sel]
        bl_f = (b1 - bp)[sel]
        u_alim = torch.cat([torch.where(half, al_f, 0),
                            torch.where(half, aps_l, 0)])
        u_blim = torch.cat([torch.where(half, bl_f, 0),
                            torch.where(half, bps_l, 0)])
        u_ao = torch.cat([ap[sel], ap[sel]])
        u_bo = torch.cat([bp[sel], bp[sel]])
        u_rev = torch.cat([torch.zeros(n_pad, dtype=torch.bool, device=dev),
                           torch.ones(n_pad, dtype=torch.bool, device=dev)])
        parts.append(dict(u_ao=u_ao, u_bo=u_bo, u_alim=u_alim,
                          u_blim=u_blim, u_rev=u_rev, ap_l=aps_l,
                          bp_l=bps_l, ar_s=ar[sel], br_s=br[sel]))
    return int(kb.sum()), parts[0], parts[1]


def _assemble_extents_dev(va_u, vb_u, vd_u, ap_l, bp_l, ar_s, br_s,
                          pack16: bool):
    """Per-seed extent assembly + compaction of the non-empty spans, on
    the device.  Unit i (fwd) and unit n_pad+i (rev) combine into seed
    i's extent.  pack16 (nreads and read lengths fit 16 bits) packs the
    survivors as [ar<<16|br, abp<<16|aep, bbp<<16|bep, diffs] u32 rows;
    otherwise 7 rows [ar, br, abp, aep, bbp, bep, diffs].  Returns the
    [rows, g] int64 buffer of the g survivors in seed order."""
    n_pad = ap_l.shape[0]
    va_f, va_r = va_u[:n_pad], va_u[n_pad:2 * n_pad]
    vb_f, vb_r = vb_u[:n_pad], vb_u[n_pad:2 * n_pad]
    vd = vd_u[:n_pad] + vd_u[n_pad:2 * n_pad]
    abp = ap_l - va_r
    aep = ap_l + va_f
    bbp = bp_l - vb_r
    bep = bp_l + vb_f
    good = (aep - abp > 0) & (bep - bbp > 0)
    if pack16:
        rows = [(ar_s << 16) | br_s, (abp << 16) | aep,
                (bbp << 16) | bep, vd]
    else:
        rows = [ar_s, br_s, abp, aep, bbp, bep, vd]
    return torch.stack(rows)[:, good]


def _run_phases(run, alim, blim, P1: int, max_rows: int) -> list:
    """K1's two-phase form, when 0 < P1 < max_rows: every unit to row
    P1, then the still-active units again from row 0 at full depth
    (dead units' phase-1 results are final, so the outputs equal a
    single full-depth pass; the others get alim = 0).  run(alim, blim,
    **kw) launches the extension.  Returns its first three outputs."""
    if not 0 < P1 < max_rows:
        return list(run(alim, blim)[:3])
    r1 = run(alim, blim, max_rows=P1, with_active=True)
    act = r1[4]
    r2 = run(torch.where(act, alim, 0), blim)
    return [torch.where(act, x2, x1) for x1, x2 in zip(r1[:3], r2[:3])]


def extend_bidir(a_words, b_words, aorg, borg, ap_l, bp_l, alen, blen,
                 cfg: OverlapConfig):
    """Bidirectional K1 extension of n seeds: the 2n units [fwd | rev],
    one launch per phase (_run_phases).  a_words/b_words: packed words
    of the pools the seeds lie in; aorg/borg: each seed's position in
    them; ap_l/bp_l: its read-local positions; alen/blen: its reads'
    lengths (int64 tensors [n]).  Returns [5, n] int64 rows abpos,
    aepos, bbpos, bepos, diffs in read-local coordinates."""
    n = aorg.shape[0]
    rev = torch.arange(2 * n, device=aorg.device) >= n
    run = partial(extend_wave_bp, a_words, b_words, torch.cat([aorg, aorg]),
                  torch.cat([borg, borg]), dirs=rev, R=cfg.bp_chunk,
                  max_rows=cfg.max_read_len, diff_cost=cfg.diff_cost,
                  xdrop=cfg.xdrop, packed=True)
    va, vb, vd = [x.to(torch.int64) for x in _run_phases(
        run, torch.cat([alen - ap_l, ap_l]), torch.cat([blen - bp_l, bp_l]),
        cfg.ext_phase1_rows, cfg.max_read_len)]
    return torch.stack([ap_l - va[n:], ap_l + va[:n], bp_l - vb[n:],
                        bp_l + vb[:n], vd[:n] + vd[n:]])


def _extend_all_dev(blk_a: ReadBlock, blk_b: ReadBlock,
                    blk_b_rc: ReadBlock, sd: dict, cfg: OverlapConfig,
                    stats: dict, device) -> list[dict]:
    """Device-resident dedupe + split + extension for BOTH orientations
    of a find_seeds_canonical_dev result `sd`; returns [fwd_exts,
    comp_exts] host dicts."""
    n = sd["nseeds"]
    empty = [dict(empty_extents(), comp=False),
             dict(empty_extents(), comp=True)]
    if n == 0:
        return empty
    cap = sd["aread"].shape[0]
    n_pad = min(_round_slice(n, 8192), cap)
    ar, br = sd["aread"][:n_pad], sd["bread"][:n_pad]
    ap, bp = sd["apos"][:n_pad], sd["bpos"][:n_pad]
    cmp_ = sd["comp"][:n_pad]
    a_st = _starts_dev(blk_a, device)
    b_st = a_st if blk_b is blk_a else _starts_dev(blk_b, device)
    maxr = int(max(blk_a.rlen.max(initial=1), blk_b.rlen.max(initial=1)))
    rb = quantize_bits(max(blk_a.nreads, blk_b.nreads) + 1)
    pb = quantize_bits(maxr + 1)
    m_d, part0, part1 = _prep_units_dev(ar, br, ap, bp, cmp_, n, a_st,
                                        b_st, rb=rb, pb=pb)
    stats["seeds"] += m_d
    a_words = _packed_words_of(blk_a, device)
    wide = _dp_kernel(cfg) == "wide"
    res = []
    # bp: one K1 launch per phase and orientation, over every unit slot;
    # wide: one extension per orientation, a K3 chunk launch per R rows
    # (it reports no still-active units: one phase)
    for u, blk in ((part0, blk_b), (part1, blk_b_rc)):
        kw = dict(dirs=u["u_rev"], max_rows=cfg.max_read_len,
                  diff_cost=cfg.diff_cost, xdrop=cfg.xdrop, packed=True)
        if wide:
            kw["W"] = cfg.band_width
        else:
            kw["R"] = cfg.bp_chunk
        run = partial(extend_wave_wide if wide else extend_wave_bp, a_words,
                      _packed_words_of(blk, device), u["u_ao"], u["u_bo"],
                      **kw)
        res.append(_run_phases(run, u["u_alim"], u["u_blim"],
                               0 if wide else cfg.ext_phase1_rows,
                               cfg.max_read_len))
    pack16 = (max(blk_a.nreads, blk_b.nreads) < 65536 and maxr < 65536)
    out = []
    for c, u in enumerate((part0, part1)):
        d = _assemble_extents_dev(*[x.to(torch.int64) for x in res[c]],
                                  u["ap_l"], u["bp_l"],
                                  u["ar_s"], u["br_s"],
                                  pack16=pack16).cpu().numpy()
        if pack16:
            ext = {"aread": d[0] >> 16, "bread": d[0] & 0xFFFF,
                   "abpos": d[1] >> 16, "aepos": d[1] & 0xFFFF,
                   "bbpos": d[2] >> 16, "bepos": d[2] & 0xFFFF,
                   "diffs": d[3]}
        else:
            ext = {k: d[i] for i, k in enumerate(EXT_KEYS)}
        ext = {k: v.astype(np.int32) for k, v in ext.items()}
        ext["n"] = d.shape[1]
        ext["comp"] = bool(c)
        stats["extents"] += ext["n"]
        out.append(ext)
    return out


def extend_seeds(blk_a: ReadBlock, blk_b: ReadBlock, seeds: dict,
                 cfg: OverlapConfig, *, device) -> dict:
    """Bidirectional extension of seeds with block-absolute apos/bpos
    (one orientation: blk_b is already the seeds' orientation of the B
    block) -> host columnar extents in read-local
    coordinates, rows with an empty span dropped.  The datander search's
    extension (damar_tpu extend_seeds): the nseeds seeds become 2 *
    nseeds units [fwd | rev], and K1 runs one launch per phase over all
    of them (extend_bidir).  device
    (keyword-only, no default): where the blocks' words and the units
    live."""
    n = int(seeds["nseeds"])
    if n == 0:
        return empty_extents()
    device = torch.device(device)
    dev_t = lambda x: torch.as_tensor(  # noqa: E731
        x[:n], device=device).to(torch.int64)
    sa = _starts_dev(blk_a, device)
    sb = _starts_dev(blk_b, device)
    ar, br, ap, bp = (dev_t(seeds[k]) for k in ("aread", "bread", "apos",
                                                  "bpos"))
    a0, b0 = sa[ar], sb[br]
    e = extend_bidir(_packed_words_of(blk_a, device),
                     _packed_words_of(blk_b, device), ap, bp, ap - a0,
                     bp - b0, sa[ar + 1] - a0, sb[br + 1] - b0, cfg)
    d = torch.cat([torch.stack([ar, br]), e])
    d = d[:, (d[3] > d[2]) & (d[5] > d[4])].cpu().numpy()
    out = {k: d[i].astype(np.int32) for i, k in enumerate(EXT_KEYS)}
    out["n"] = d.shape[1]
    return out


def dedupe_extents(ext: dict, min_len: int,
                   max_err: float | None = None) -> dict:
    """Drop short alignments, alignments over the -e error bound, exact
    duplicates, and alignments whose A and B intervals are both contained
    in another alignment of the same (aread, bread) group (host numpy,
    the reference's columnar dedupe).  Under a (group, -alen, abpos,
    bbpos) sort every dominator precedes what it dominates, and
    containment nests, so 'dominated by any earlier row' equals
    'dominated by a kept row'."""
    alen = ext["aepos"] - ext["abpos"]
    ok = alen >= min_len
    if max_err is not None and ext["n"]:
        span = (alen + (ext["bepos"] - ext["bbpos"])) / 2.0
        ok &= ext["diffs"] <= max_err * np.maximum(span, 1)
    if not ok.any():
        return empty_extents()
    e = _take_extents(ext, np.nonzero(ok)[0])
    alen = e["aepos"] - e["abpos"]
    gkey = (e["aread"].astype(np.int64) << 32) | e["bread"].astype(
        np.uint32).astype(np.int64)
    order = np.lexsort((e["bbpos"], e["abpos"],
                        int(alen.max()) - alen if len(alen) else alen,
                        gkey))
    e = _take_extents(e, order)
    gkey = gkey[order]
    n = e["n"]
    new_g = np.concatenate([[True], gkey[1:] != gkey[:-1]])
    g_start = np.nonzero(new_g)[0]
    g_size = np.diff(np.concatenate([g_start, [n]]))

    drop = np.zeros(n, bool)
    GCAP = 64
    same = np.zeros(n, bool)
    same[1:] = ((gkey[1:] == gkey[:-1])
                & (e["abpos"][1:] == e["abpos"][:-1])
                & (e["aepos"][1:] == e["aepos"][:-1])
                & (e["bbpos"][1:] == e["bbpos"][:-1])
                & (e["bepos"][1:] == e["bepos"][:-1]))
    drop |= same
    sm_g = np.nonzero((g_size <= GCAP) & (g_size > 1))[0]
    if len(sm_g):
        G = int(g_size[sm_g].max())
        idx = g_start[sm_g][:, None] + np.arange(G)[None, :]
        valid = np.arange(G)[None, :] < g_size[sm_g][:, None]
        idxc = np.minimum(idx, n - 1)
        ab = np.where(valid, e["abpos"][idxc], 0)
        ae = np.where(valid, e["aepos"][idxc], -1)
        bb = np.where(valid, e["bbpos"][idxc], 0)
        be = np.where(valid, e["bepos"][idxc], -1)
        earlier = (np.arange(G)[:, None] < np.arange(G)[None, :])
        dom = ((ab[:, :, None] <= ab[:, None, :])
               & (ae[:, :, None] >= ae[:, None, :])
               & (bb[:, :, None] <= bb[:, None, :])
               & (be[:, :, None] >= be[:, None, :])
               & earlier[None] & valid[:, :, None]
               & valid[:, None, :])
        drop[idxc[valid & dom.any(axis=1)]] = True
    for g in np.nonzero(g_size > GCAP)[0]:
        s, z = g_start[g], g_size[g]
        ab = e["abpos"][s:s + z]
        ae = e["aepos"][s:s + z]
        bb = e["bbpos"][s:s + z]
        be = e["bepos"][s:s + z]
        earlier = np.arange(z)[:, None] < np.arange(z)[None, :]
        dom = ((ab[:, None] <= ab[None, :]) & (ae[:, None] >= ae[None, :])
               & (bb[:, None] <= bb[None, :])
               & (be[:, None] >= be[None, :]) & earlier)
        drop[s:s + z] |= dom.any(axis=0)
    return _take_extents(e, np.nonzero(~drop)[0])


def _n_segments_vec(abp: np.ndarray, aep: np.ndarray, tspace: int):
    return np.where(aep > abp,
                    (aep - 1) // tspace - abp // tspace + 1, 0
                    ).astype(np.int32)


def _cap_segs(cfg: OverlapConfig) -> int:
    return cfg.max_read_len // cfg.tspace + 2


def _segs_bucket(expect: np.ndarray, cap_segs: int) -> np.ndarray:
    """The trace buffer's segment count for each extent: the smallest
    8 * 2^k >= expect + 2, capped at cap_segs (what trace_launch picks
    for a batch, applied to one extent)."""
    need = np.minimum(expect.astype(np.int64) + 2, cap_segs)
    b = np.full(need.shape, 8, np.int64)
    while (b < need).any():
        b = np.where(b < need, 2 * b, b)
    return np.minimum(b, cap_segs)


def _trace_plan(spans: np.ndarray, expect: np.ndarray, cap_segs: int,
                buf_bytes: int = TRACE_BUF_BYTES) -> list:
    """A trace round's launch plan (the bp trace K2 and the wide retries
    K3 alike): one launch per _segs_bucket value, split only
    where its [S, max_segs, 2] int32 trace buffer would pass buf_bytes,
    extents longest span first inside each (the kernel's warps take them
    in that order).  Returns the launches' index arrays; together they
    hold every extent exactly once."""
    bucket = _segs_bucket(expect, cap_segs)
    out = []
    for ms in np.unique(bucket):
        idx = np.nonzero(bucket == ms)[0]
        idx = idx[np.argsort(-spans[idx], kind="stable")]
        per = max(1, buf_bytes // (int(ms) * 8))
        out += [idx[i:i + per] for i in range(0, len(idx), per)]
    return out


def _pack_trace(tr, expect, total_cap: int):
    """Compact a padded trace buffer [S, segs, 2] into a ragged concat
    [total_cap, 2] using the host-known per-row segment counts `expect`
    (the reference's _pack_trace_jit, with its clips); rows past the
    total are -1."""
    dev = tr.device
    S = expect.shape[0]
    expect = torch.as_tensor(expect, dtype=torch.int64, device=dev)
    starts = torch.cumsum(expect, 0) - expect
    total = starts[-1] + expect[-1]
    ind = torch.zeros(total_cap, dtype=torch.int64, device=dev)
    ind.index_add_(0, starts.clamp(max=total_cap - 1),
                   (expect > 0).to(torch.int64))
    row = (torch.cumsum(ind, 0) - 1).clamp(0, S - 1)
    j = torch.arange(total_cap, device=dev)
    seg = (j - starts[row]).clamp(0, tr.shape[1] - 1)
    out = tr[row, seg]
    return torch.where((j < total)[:, None], out, -1)


def trace_launch(pool_words, coords: dict, cfg: OverlapConfig,
                 kernel=None, *, b_words=None, max_segs: int | None = None):
    """Launch the trace pass for a batch of extents.

    coords: columnar int arrays abp, aep, bbp, bep in the role of THIS
    pass plus absolute starts ast/bst into the oriented pool.  Returns a
    pending handle for trace_harvest_all.  kernel: trace kernel override
    (the wide tier).  b_words: B's own pool (default: pool_words holds
    both).  max_segs: the trace buffer's segments (default: the batch's
    segment need, bucketed)."""
    S = len(coords["abp"])
    if S == 0:
        return None
    abp, aep = coords["abp"], coords["aep"]
    bbp, bep = coords["bbp"], coords["bep"]
    expect = _n_segments_vec(abp, aep, cfg.tspace)
    if max_segs is None:
        # trace buffer bucketed to the batch's real segment need
        # (batches are length-sorted); power-of-two buckets
        need = int(expect.max()) + 2
        cap_segs = _cap_segs(cfg)
        max_segs = 8
        while max_segs < min(need, cap_segs):
            max_segs *= 2
        max_segs = min(max_segs, cap_segs)
    trace_fn = kernel if kernel is not None else trace_wave_bp
    dev = pool_words.device
    t = lambda x: torch.as_tensor(np.asarray(x, dtype=np.int32),  # noqa
                                  device=dev)
    tr, nseg, dsum = trace_fn(
        pool_words, pool_words if b_words is None else b_words,
        t(coords["ast"]), t(coords["bst"]),
        t(abp), t(bbp), t(aep - abp), t(bep - bbp), tspace=cfg.tspace,
        max_segs=max_segs, packed=True)
    total_cap = _round_slice(int(expect.sum()), 2048)
    packed = _pack_trace(tr, expect, total_cap)
    return dict(packed=packed, nseg=nseg, dsum=dsum, expect=expect,
                abp=abp, aep=aep, bbp=bbp, bep=bep, S=S)


def _finish_from_host(packed, nseg, dsum, pend, cfg: OverlapConfig):
    """Validate fetched trace arrays; returns (offs [S+1], ok bool[S],
    packed [total, 2], dsum [S]): per-extent slices are
    packed[offs[i]:offs[i+1]] for rows with ok[i]."""
    expect = pend["expect"]
    offs = np.concatenate([[0], np.cumsum(expect)])
    bbp, bep = pend["bbp"], pend["bep"]
    nz = offs[:-1] < offs[1:]
    bsum = np.zeros(pend["S"], np.int64)
    tmin = np.zeros(pend["S"], np.int64)
    tmax = np.zeros(pend["S"], np.int64)
    if offs[-1] > 0:
        bsum[nz] = np.add.reduceat(packed[:offs[-1], 1], offs[:-1][nz])
        tmin[nz] = np.minimum.reduceat(packed[:offs[-1], :].min(axis=1),
                                       offs[:-1][nz])
        tmax[nz] = np.maximum.reduceat(packed[:offs[-1], :].max(axis=1),
                                       offs[:-1][nz])
    # trace values must fit the file encoding (u8 for small tspace);
    # over-range records go to the wide retry, then count as dropped
    enc_max = 255 if cfg.tspace <= TRACE_XOVR else 32767
    ok = (nseg == expect) & (bsum == (bep - bbp)) & (tmin >= 0) \
        & (tmax <= enc_max)
    return offs, ok, packed, np.asarray(dsum)


def trace_harvest_all(pends: list, cfg: OverlapConfig) -> list:
    """Harvest many trace_launch handles with two device->host
    transfers in all (packed traces, counts)."""
    live = [p for p in pends if p is not None]
    if not live:
        return [None for _ in pends]
    packed_all = torch.cat([p["packed"] for p in live]).cpu().numpy()
    counts_all = torch.cat([torch.stack([p["nseg"], p["dsum"]], dim=1)
                            for p in live]).cpu().numpy()
    out, po, co = [], 0, 0
    for p in pends:
        if p is None:
            out.append(None)
            continue
        tc = p["packed"].shape[0]
        packed = packed_all[po:po + tc].astype(np.int32)
        nseg = counts_all[co:co + p["S"], 0]
        dsum = counts_all[co:co + p["S"], 1]
        po += tc
        co += p["S"]
        out.append(_finish_from_host(packed, nseg, dsum, p, cfg))
    return out


def _trace_pool(blk_a, blk_b, blk_b_rc, blk_a_rc, emit_mirrors, device):
    """The oriented base pool [A fwd | B fwd | B rc | A rc] (identity-
    deduped for self pairs) as packed device words, memoized on blk_a.
    Returns (words, offsets OA, OBF, OBC, OAR)."""
    srcs = [blk_a.bases, blk_b.bases, blk_b_rc.bases]
    if emit_mirrors:
        srcs.append(blk_a_rc.bases)
    uniq: list = []
    uniq_off: dict[int, int] = {}
    offs: list[int] = []
    for arr in srcs:
        o = uniq_off.get(id(arr))
        if o is None:
            o = sum(len(u) for u in uniq)
            uniq_off[id(arr)] = o
            uniq.append(arr)
        offs.append(o)
    pkey = (tuple(id(u) for u in uniq), str(device))
    ent = blk_a.cache.get("trace_pool")
    if ent is None or ent[0] != pkey:
        by_id = {}
        for b in (blk_a, blk_b, blk_b_rc, blk_a_rc):
            if b is not None:
                by_id[id(b.bases)] = b
        parts = [_dev_arr(by_id[id(u)], "bases", device) for u in uniq]
        cat = torch.cat(parts) if len(parts) > 1 else parts[0]
        # strong refs to the source arrays keep the id() key valid
        ent = (pkey, list(uniq), pack_bases(cat))
        blk_a.cache["trace_pool"] = ent
    return ent[2], offs[0], offs[1], offs[2], (offs[3] if emit_mirrors
                                                 else 0)


# a record's header fields for las_columns
REC_KEYS = ("abp", "aep", "bbp", "bep", "comp", "hdr_ar", "hdr_br", "dsum")


def las_columns(rec: dict, seg_lens, trace_rows, tspace: int
                ) -> LasColumns:
    """The .las columns of n records: rec holds their REC_KEYS columns
    (.las coordinates, comp nonzero for the complement orientation,
    absolute read ids, trace diffs), seg_lens their trace segments,
    whose rows lie one after another in trace_rows [sum(seg_lens), 2]."""
    n = len(seg_lens)
    h = np.zeros((n, 10), np.int32)
    h[:, 0] = 2 * np.asarray(seg_lens)
    h[:, 1] = rec["dsum"]
    h[:, 2], h[:, 3] = rec["abp"], rec["bbp"]
    h[:, 4], h[:, 5] = rec["aep"], rec["bep"]
    h[:, 6] = np.where(np.asarray(rec["comp"]) != 0, OVL_COMP, 0)
    h[:, 7], h[:, 8] = rec["hdr_ar"], rec["hdr_br"]
    offs = np.zeros(n + 1, np.int64)
    np.cumsum(seg_lens, out=offs[1:])
    payload, boffs = encode_trace_columns(trace_rows, offs,
                                          tspace <= TRACE_XOVR)
    return LasColumns(h, payload, boffs)


def las_from_extents(blk_a: ReadBlock, blk_b: ReadBlock,
                     kept_parts: list[dict], cfg: OverlapConfig,
                     emit_mirrors: bool = True, stats: dict | None = None,
                     blk_b_rc=None, blk_a_rc=None, *, pool, device
                     ) -> tuple[LasFile, LasFile]:
    """Trace pass + columnar .las assembly for deduped extents.

    kept_parts: columnar extent dicts (aread/bread LOCAL ids, .las
    coordinates, a per-dict 'comp' flag).  Returns (las_a, mirrored
    las_b); las_b is empty unless emit_mirrors.  pool: the _trace_pool
    result to trace over (the caller's, never rebuilt here: the blocks'
    caches may be gone by now).  Extents the main
    trace kernel cannot force through are retried on the wide band;
    those that fail again are dropped (counted in stats)."""
    t_fs = time.time()
    if stats is None:
        stats = {}
    stats.setdefault("dropped_trace", 0)
    if blk_b_rc is None:
        blk_b_rc = _rc_cached(blk_b)
    if emit_mirrors and blk_a_rc is None:
        blk_a_rc = blk_b_rc if blk_a is blk_b else _rc_cached(blk_a)
    sa = blk_a.starts.astype(np.int64)
    sb = blk_b.starts.astype(np.int64)
    alen = blk_a.rlen.astype(np.int32)
    blen = blk_b.rlen.astype(np.int32)
    pool, OA, OBF, OBC, OAR = pool

    def units_of(kept: dict, mirrored: bool) -> dict:
        """Per-record trace-unit arrays for one (part, role) group."""
        comp = kept["comp"]
        n = kept["n"]
        if not mirrored:
            u = dict(ar=kept["aread"], br=kept["bread"],
                     abp=kept["abpos"], aep=kept["aepos"],
                     bbp=kept["bbpos"], bep=kept["bepos"])
            u["ast"] = (OA + sa[kept["aread"]]).astype(np.int64)
            u["bst"] = ((OBC if comp else OBF)
                        + sb[kept["bread"]]).astype(np.int64)
            u["hdr_ar"] = blk_a.ids[kept["aread"]].astype(np.int32)
            u["hdr_br"] = blk_b.ids[kept["bread"]].astype(np.int32)
        else:
            if not comp:
                u = dict(ar=kept["bread"], br=kept["aread"],
                         abp=kept["bbpos"], aep=kept["bepos"],
                         bbp=kept["abpos"], bep=kept["aepos"])
            else:
                bl = blen[kept["bread"]]
                al = alen[kept["aread"]]
                u = dict(ar=kept["bread"], br=kept["aread"],
                         abp=bl - kept["bepos"], aep=bl - kept["bbpos"],
                         bbp=al - kept["aepos"], bep=al - kept["abpos"])
            u["ast"] = (OBF + sb[kept["bread"]]).astype(np.int64)
            u["bst"] = ((OAR if comp else OA)
                        + sa[kept["aread"]]).astype(np.int64)
            u["hdr_ar"] = blk_b.ids[kept["bread"]].astype(np.int32)
            u["hdr_br"] = blk_a.ids[kept["aread"]].astype(np.int32)
        u["comp"] = np.full(n, comp, np.int32)
        u["mir"] = np.full(n, int(mirrored), np.int32)
        return u

    # uid links the primary and mirrored roles of one extent, so trace
    # failures are discarded symmetrically
    base = 0
    groups = []
    bases_of = []
    for kp in kept_parts:
        if kp["n"]:
            g = units_of(kp, False)
            g["uid"] = (base + np.arange(kp["n"])).astype(np.int32)
            groups.append(g)
            bases_of.append(base)
            base += kp["n"]
    if emit_mirrors:
        for kp, b0 in zip([k for k in kept_parts if k["n"]], bases_of):
            g = units_of(kp, True)
            g["uid"] = (b0 + np.arange(kp["n"])).astype(np.int32)
            groups.append(g)
    cols_a: list[LasColumns] = []
    cols_b: list[LasColumns] = []
    uids_a: list[np.ndarray] = []
    uids_b: list[np.ndarray] = []
    UKEYS = ("ar", "br", "abp", "aep", "bbp", "bep", "ast", "bst",
             "hdr_ar", "hdr_br", "comp", "mir", "uid")

    def emit(chunk, res, retry_sink=None):
        """Append one trace batch's surviving records as .las columns;
        send the others to the retry sink, or count them as dropped."""
        offs_t, okv, packed, dsum = res
        bad = np.nonzero(~okv)[0]
        if len(bad):
            if retry_sink is not None:
                retry_sink.append({k: v[bad] for k, v in chunk.items()})
            else:
                stats["dropped_trace"] += len(bad)
        seg_lens_all = offs_t[1:] - offs_t[:-1]
        for mir, sink, usink in ((0, cols_a, uids_a), (1, cols_b, uids_b)):
            ok_idx = np.nonzero(okv & (chunk["mir"] == mir))[0]
            if not len(ok_idx):
                continue
            usink.append(chunk["uid"][ok_idx])
            seg_lens = seg_lens_all[ok_idx]
            starts = offs_t[:-1][ok_idx].astype(np.int64)
            new_off = np.concatenate([[0], np.cumsum(seg_lens)])
            rowpos = (np.arange(int(new_off[-1]), dtype=np.int64)
                      - np.repeat(new_off[:-1], seg_lens)
                      + np.repeat(starts, seg_lens))
            rec = {k: chunk[k][ok_idx] for k in REC_KEYS[:-1]}
            rec["dsum"] = dsum[ok_idx]
            sink.append(las_columns(rec, seg_lens, packed[rowpos],
                                    cfg.tspace))

    def launch_stream(units: dict, kernel=None):
        """Launch a round (the bp trace K2, or with `kernel` the wide
        retries K3): one launch per segment-count bucket (_trace_plan),
        extents longest first."""
        plan = _trace_plan(units["aep"] - units["abp"],
                           _n_segments_vec(units["abp"], units["aep"],
                                           cfg.tspace), _cap_segs(cfg))
        out = []
        for sel in plan:
            chunk = {k: units[k][sel] for k in UKEYS}
            out.append((trace_launch(pool, chunk, cfg, kernel=kernel),
                        chunk))
        return out

    def run_round(rows: list | dict, kernel, sink):
        units = rows if isinstance(rows, dict) else {
            k: np.concatenate([p[k] for p in rows]) for k in rows[0]}
        pend = launch_stream(units, kernel=kernel)
        res_all = trace_harvest_all([p[0] for p in pend], cfg)
        for (_, chunk), res in zip(pend, res_all):
            if res is not None:
                emit(chunk, res, retry_sink=sink)

    stats["t_trace_setup"] = round(time.time() - t_fs, 3)
    retries: list = []
    t0 = time.time()
    wide_kernel = partial(trace_wave, W=cfg.band_width)
    # the main trace: the bp trace kernel (K2), or under dp_kernel="wide"
    # the wide trace itself
    main_kernel = wide_kernel if _dp_kernel(cfg) == "wide" else None
    if groups:
        run_round({k: np.concatenate([g[k] for g in groups])
                   for k in UKEYS}, main_kernel, retries)
    stats["t_trace_main"] = round(time.time() - t0, 3)
    # extents the main trace could not force through: retry on the wide
    # 128-lane band (the device route's only retry tier; under
    # dp_kernel="wide" the same kernel again, as in the reference, so
    # they fail again and count as dropped)
    t_rt = time.time()
    stats["trace_retries"] = sum(len(p["ar"]) for p in retries)
    if retries:
        stats["trace_retries_wide"] = stats["trace_retries"]
        run_round(retries, wide_kernel, None)
    stats["t_trace_retry"] = round(time.time() - t_rt, 3)
    t_fin = time.time()
    ca = LasColumns.concat(cols_a)
    cb = LasColumns.concat(cols_b)
    if emit_mirrors:
        # symmetric discard: a record survives only if its mirror did
        ua = np.concatenate(uids_a) if uids_a else np.zeros(0, np.int32)
        ub = np.concatenate(uids_b) if uids_b else np.zeros(0, np.int32)
        both = np.intersect1d(ua, ub)
        ka = np.nonzero(np.isin(ua, both))[0]
        kb = np.nonzero(np.isin(ub, both))[0]
        if len(ka) != ca.n:
            stats["dropped_trace"] += ca.n - len(ka)
            ca = ca.permute(ka)
        if len(kb) != cb.n:
            stats["dropped_trace"] += cb.n - len(kb)
            cb = cb.permute(kb)
    las_a = LasFile(tspace=cfg.tspace, columns=ca)
    las_a.sort()
    las_b = LasFile(tspace=cfg.tspace, columns=cb)
    las_b.sort()
    stats["t_trace_final"] = round(time.time() - t_fin, 3)
    return las_a, las_b


def wide_retry(blk_a: ReadBlock, blk_b: ReadBlock, units: dict,
               cfg: OverlapConfig, device) -> dict:
    """The wide-band trace of extents on K3's wide_trace_kernel, over a
    pool [A fwd | B fwd | B rc] of the two blocks: one launch per
    segment-count bucket, both orientations together (extents are
    independent, so the plan does not change an extent's result).
    units: columns ar, br (local read ordinals), comp (bool), abp, aep,
    bbp, bep (.las coordinates) and row (the caller's key of each
    extent).  Returns {row: (trace [nseg, 2] int32, diffs)}, or (None,
    0) for an extent whose trace fails the trace checks."""
    out: dict[int, tuple] = {}
    if not len(units["row"]):
        return out
    device = torch.device(device)
    pool, OA, OBF, OBC, _ = _trace_pool(
        blk_a, blk_b, _rc_cached(blk_b), None, emit_mirrors=False,
        device=device)
    ar = np.asarray(units["ar"], np.int64)
    br = np.asarray(units["br"], np.int64)
    u = {k: np.asarray(units[k], np.int32)
         for k in ("abp", "aep", "bbp", "bep")}
    u.update(ast=OA + blk_a.starts.astype(np.int64)[ar],
             bst=(np.where(units["comp"], OBC, OBF)
                  + blk_b.starts.astype(np.int64)[br]),
             ar=ar, row=np.asarray(units["row"]))
    plan = _trace_plan(u["aep"] - u["abp"],
                       _n_segments_vec(u["abp"], u["aep"], cfg.tspace),
                       _cap_segs(cfg))
    wide = partial(trace_wave, W=cfg.band_width)
    chunks = [{k: v[sel] for k, v in u.items()} for sel in plan]
    res_all = trace_harvest_all(
        [trace_launch(pool, ch, cfg, kernel=wide) for ch in chunks], cfg)
    for ch, (offs, okv, packed, dsum) in zip(chunks, res_all):
        for i, r in enumerate(ch["row"]):
            out[int(r)] = ((packed[offs[i]:offs[i + 1]], int(dsum[i]))
                           if okv[i] else (None, 0))
    return out


def _retrace(h: np.ndarray, rows: np.ndarray, blk_a: ReadBlock,
             blk_b: ReadBlock, a_local: dict, b_local: dict,
             cfg: OverlapConfig, device) -> dict:
    """The wide-band retrace of header rows `rows` (their reads in the
    blocks) by wide_retry: {row: (trace [nseg, 2] int32, diffs)}, or
    (None, 0) for a row whose retrace fails the trace checks."""
    hr = h[rows]
    return wide_retry(blk_a, blk_b, dict(
        ar=[a_local[int(r)] for r in hr[:, H_AREAD]],
        br=[b_local[int(r)] for r in hr[:, H_BREAD]],
        comp=(hr[:, H_FLAGS] & OVL_COMP) != 0, abp=hr[:, H_ABPOS],
        aep=hr[:, H_AEPOS], bbp=hr[:, H_BBPOS], bep=hr[:, H_BEPOS],
        row=rows), cfg, device)


def retrace_las(las: LasFile, blk_a: ReadBlock, blk_b: ReadBlock,
                cfg: OverlapConfig, only: list[Overlap] | None = None, *,
                device) -> int:
    """Recompute the trace and diffs of Overlap records in place (the
    object form of retrace_rows, damar_tpu retrace_las: after LAstitch
    merges fragments, whose traces must span the merged extent).
    blk_a/blk_b hold the records' A and B reads (absolute ids through
    blk.ids; a read they lack raises KeyError).  only: the records to
    retrace (default every record of las.overlaps).  A record whose
    retrace fails the trace checks is flagged OVL_DISCARD and keeps its
    trace.  Returns the number so flagged.  The retrace is
    retrace_rows': K3's wide_trace_kernel on `device` (keyword-only, no
    default)."""
    targets = only if only is not None else las.overlaps
    a_local = {int(i): j for j, i in enumerate(blk_a.ids)}
    b_local = {int(i): j for j, i in enumerate(blk_b.ids)}
    for o in targets:
        if o.aread not in a_local:
            raise KeyError(o.aread)
        if o.bread not in b_local:
            raise KeyError(o.bread)
    h = np.zeros((len(targets), 10), np.int32)
    for i, o in enumerate(targets):
        h[i, [H_ABPOS, H_AEPOS, H_BBPOS, H_BEPOS, H_AREAD, H_BREAD]] = (
            o.abpos, o.aepos, o.bbpos, o.bepos, o.aread, o.bread)
        h[i, H_FLAGS] = o.flags & OVL_COMP
    res = _retrace(h, np.arange(len(targets)), blk_a, blk_b, a_local,
                   b_local, cfg, device)
    dropped = 0
    for i, o in enumerate(targets):
        tr, d = res[i]
        if tr is None:
            o.flags |= OVL_DISCARD
            dropped += 1
        else:
            o.trace = tr.copy()
            o.diffs = d
    return dropped


def retrace_rows(las: LasFile, rows, blk_a: ReadBlock, blk_b: ReadBlock,
                 cfg: OverlapConfig, *, device) -> int:
    """Recompute the trace and diffs of the given row indices of a
    columnar las in place, splicing the payload (damar_tpu
    retrace_rows; after LAstitch, whose chains with overlapping
    fragments need a real trace across the junction).  blk_a/blk_b hold
    the rows' A and B reads (absolute ids through blk.ids).  Every row
    runs on the wide band (K3's wide_trace_kernel, see _retrace).  Rows
    whose retrace fails the trace
    checks, and rows whose reads the blocks lack, get OVL_DISCARD and an
    empty trace (tlen 0).  Returns the number so dropped.  device
    (keyword-only, no default): where the pool and the launches go."""
    cols = las.columns
    rows = np.asarray(rows, dtype=np.int64)
    if not len(rows):
        return 0
    h = cols.headers
    a_local = {int(i): j for j, i in enumerate(blk_a.ids)}
    b_local = {int(i): j for j, i in enumerate(blk_b.ids)}
    known = np.array([int(a) in a_local and int(b) in b_local
                      for a, b in zip(h[rows, H_AREAD], h[rows, H_BREAD])],
                     bool)
    failed = [int(r) for r in rows[~known]]
    new_rows: dict[int, np.ndarray] = {}
    for r, (tr, d) in _retrace(h, rows[known], blk_a, blk_b, a_local,
                               b_local, cfg, device).items():
        if tr is None:
            failed.append(r)
        else:
            h[r, H_TLEN] = 2 * len(tr)
            h[r, H_DIFFS] = d
            new_rows[r] = tr
    for r in failed:
        h[r, H_FLAGS] = np.int32(np.uint32(h[r, H_FLAGS]) | OVL_DISCARD)
        h[r, H_TLEN] = 0
        new_rows[r] = np.zeros((0, 2), np.int32)
    # splice the payload: the rows' new lengths, untouched rows' bytes
    # copied in bulk, then the recomputed traces written
    small = cfg.tspace <= TRACE_XOVR
    width = 2 if small else 4
    lens = np.diff(cols.offsets)
    new_lens = lens.copy()
    for r, tr in new_rows.items():
        new_lens[r] = tr.shape[0] * width
    offs2 = np.zeros(cols.n + 1, np.int64)
    np.cumsum(new_lens, out=offs2[1:])
    buf = np.zeros(int(offs2[-1]), np.uint8)
    untouched = np.ones(cols.n, bool)
    untouched[list(new_rows)] = False
    if cols.offsets[-1]:
        src = np.arange(int(cols.offsets[-1]), dtype=np.int64)[
            np.repeat(untouched, lens)]
        if len(src):
            u = np.nonzero(untouched)[0]
            ul = lens[u]
            dst = (np.arange(int(ul.sum()), dtype=np.int64)
                   - np.repeat(np.cumsum(ul) - ul, ul)
                   + np.repeat(offs2[:-1][u], ul))
            buf[dst] = cols.trace[src]
    for r, tr in new_rows.items():
        if tr.shape[0]:
            buf[offs2[r]:offs2[r + 1]] = encode_trace_columns(
                tr, np.array([0, tr.shape[0]]), small)[0]
    cols.trace = buf
    cols.offsets = offs2
    return len(failed)


def _sync(device) -> None:
    """Wait for the calling thread's stream only: in a sweep the other
    thread's stream is busy with another pair."""
    if torch.device(device).type == "cuda":
        torch.cuda.current_stream(device).synchronize()


def grow_seeds(run_seeding, kw: dict, hit_cap: int | None,
               seed_cap_max: int | None) -> tuple[dict, int]:
    """Seeding run again while it overflowed a buffer that may still
    grow: the raw hit buffer (up to hit_cap; sized from the exact total
    already when hit_cap is None), the seed buffer (up to seed_cap_max,
    without a limit when it is None) and the fill's emitting-tuple
    partition.  run_seeding(kw) seeds with kw's buffers.  Returns (the
    last run's seeds, the number of runs)."""
    seeds, runs = run_seeding(kw), 1
    while seeds["overflow"] and (
            (seeds["total_hits"] > seeds["raw_cap"]
             and hit_cap is not None and seeds["raw_cap"] < hit_cap)
            or (seeds["total_seeds"] > kw["seed_cap"]
                and (seed_cap_max is None
                     or kw["seed_cap"] < seed_cap_max))
            or (seeds["total_emit"] > seeds["tcap"]
                and seeds["tcap"] < seeds["raw_cap"])):
        if seeds["total_hits"] > seeds["raw_cap"]:
            kw = dict(kw, raw_hint=seeds["total_hits"])
        if seeds["total_seeds"] > kw["seed_cap"]:
            sc = kw["seed_cap"]
            want = (seeds["total_seeds"] if seed_cap_max is None
                    else min(2 * seeds["total_seeds"], seed_cap_max))
            while sc < want:
                sc *= 2
            kw = dict(kw, seed_cap=sc)
        if seeds["total_emit"] > seeds["tcap"]:
            kw = dict(kw, emit_hint=seeds["total_emit"])
        seeds = run_seeding(kw)
        runs += 1
    return seeds, runs


def overlap_pair_device(blk_a: ReadBlock, blk_b: ReadBlock,
                        cfg: OverlapConfig, self_block: bool,
                        mask_a=None, mask_b=None,
                        hit_cap: int | None = None,
                        seed_cap: int | None = None,
                        emit_mirrors: bool = True,
                        size_hints: dict | None = None, *, device) -> dict:
    """The device phases of a block pair: seeding -> extension ->
    extent dedupe.  Returns a state dict for overlap_pair_emit, which
    holds its own references to every device tensor the emit reads (the
    trace pool), so a caller may release or clear the blocks' caches
    before the emit has run.  mask_a/mask_b: optional bool[cap] soft
    masks (numpy).  hit_cap/seed_cap and size_hints: see
    overlap_block_pair.  device: required, as in overlap_block_pair."""
    device = torch.device(device)
    blk_b_rc = _rc_cached(blk_b)
    blk_a_rc = _rc_cached(blk_a) if emit_mirrors else None
    stats = dict(seeds=0, extents=0, kept=0, dropped_trace=0)
    t_ph = time.time()
    to_dev = lambda m: (None if m is None  # noqa: E731
                        else torch.as_tensor(np.asarray(m, dtype=bool),
                                             device=device))
    am, bm = to_dev(mask_a), to_dev(mask_b)

    def _build_dev():
        ab = _dev_arr(blk_a, "bases", device)
        rid = _dev_arr(blk_a, "read_id", device)
        return ab, rid, canonical_index_dev(ab, rid, blk_a, cfg.kmer, am)

    a_bases_d, a_rid_d, a_index = _cached_a_index(
        blk_a, f"dev3:{device}", cfg.kmer, mask_a, _build_dev)

    def run_seeding(kw):
        # self pairs never touch the B arrays
        if self_block or blk_b is blk_a:
            bb_d, br_d = a_bases_d, a_rid_d
        else:
            bb_d = _dev_arr(blk_b, "bases", device)
            br_d = _dev_arr(blk_b, "read_id", device)
        kw = dict(kw, dev_arrays=(a_bases_d, a_rid_d, bb_d, br_d))
        return find_seeds_canonical_dev(blk_a, blk_b, cfg, **kw)

    # -b: composition weights of the A block (host numpy, as damar_tpu)
    bias_lut = bias_weight_lut(blk_a.bases) if cfg.bias else None
    kw = dict(mask_a=am, mask_b=bm, upper_only=self_block,
              hit_cap=hit_cap,
              seed_cap=SEED_CAP_START if seed_cap is None else seed_cap,
              a_index=a_index, self_pair=self_block, bias_lut=bias_lut)
    # hints are a running max of exact measured totals, passed unpadded:
    # the buffer caps are pow2-bucketed downstream, and an undershoot
    # costs one exact grow-retry
    if size_hints and size_hints.get("raw"):
        kw["raw_hint"] = size_hints["raw"]
    if size_hints and size_hints.get("nnz"):
        kw["emit_hint"] = size_hints["nnz"]
    # up to 4x an explicit seed_cap, without a limit when it is None
    seeds, stats["seed_runs"] = grow_seeds(
        run_seeding, kw, hit_cap, None if seed_cap is None else seed_cap * 4)
    if size_hints is not None:
        size_hints["raw"] = max(seeds["total_hits"],
                                size_hints.get("raw", 0) // 2)
        if seeds["total_emit"]:
            size_hints["nnz"] = max(seeds["total_emit"],
                                    size_hints.get("nnz", 0) // 2)
    if seeds["overflow"] and hit_cap is None and seed_cap is None:
        raise RuntimeError(
            f"seeding overflowed its sized buffers: total_hits "
            f"{seeds['total_hits']}, total_seeds {seeds['total_seeds']}")
    stats["seed_overflow"] = seeds["overflow"]
    stats["seed_path"] = seeds["path"]
    if "slices" in seeds:
        stats["seed_slices"] = seeds["slices"]
    stats["total_hits"] = int(seeds["total_hits"])
    stats["total_seeds"] = int(seeds["total_seeds"])
    _sync(device)
    stats["t_seed"] = round(time.time() - t_ph, 3)
    t_ph = time.time()
    ext_parts = _extend_all_dev(blk_a, blk_b, blk_b_rc, seeds, cfg, stats,
                                device)
    stats["t_extend"] = round(time.time() - t_ph, 3)
    t_ph = time.time()
    # dedupe within each orientation (comp partitions the groups)
    kept_parts = [dedupe_extents(p, cfg.min_len, max_err=1.0 - cfg.err)
                  for p in ext_parts]
    for kp, p in zip(kept_parts, ext_parts):
        kp["comp"] = p["comp"]
    stats["kept"] = sum(p["n"] for p in kept_parts)
    stats["t_dedupe"] = round(time.time() - t_ph, 3)
    t_ph = time.time()
    pool = _trace_pool(blk_a, blk_b, blk_b_rc, blk_a_rc, emit_mirrors,
                       device)
    _sync(device)
    stats["t_pool"] = round(time.time() - t_ph, 3)
    # what this thread's stream queued (the pool's pack) must be done
    # before another stream reads it
    ready = None
    if device.type == "cuda":
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(device))
    return dict(blk_a=blk_a, blk_b=blk_b, kept_parts=kept_parts, cfg=cfg,
                emit_mirrors=emit_mirrors, stats=stats, blk_b_rc=blk_b_rc,
                blk_a_rc=blk_a_rc, pool=pool, ready=ready, device=device)


def overlap_pair_emit(state: dict, stream=None
                      ) -> tuple[LasFile, LasFile, dict]:
    """Trace + .las emission for an overlap_pair_device state.  stream:
    a CUDA stream to run on (a sweep's emit thread has its own); it
    first waits for what the device phases queued, and is drained before
    the state's tensors can be let go."""
    if stream is not None:
        with torch.cuda.stream(stream):
            stream.wait_event(state["ready"])
            out = overlap_pair_emit(state)
            stream.synchronize()
        return out
    stats = state["stats"]
    t0 = time.time()
    las_a, las_b = las_from_extents(
        state["blk_a"], state["blk_b"], state["kept_parts"], state["cfg"],
        emit_mirrors=state["emit_mirrors"], stats=stats,
        blk_b_rc=state["blk_b_rc"], blk_a_rc=state["blk_a_rc"],
        pool=state["pool"], device=state["device"])
    stats["t_trace"] = round(time.time() - t0, 3)
    return las_a, las_b, stats


def overlap_block_pair(blk_a: ReadBlock, blk_b: ReadBlock,
                       cfg: OverlapConfig, self_block: bool,
                       mask_a=None, mask_b=None,
                       hit_cap: int | None = None,
                       seed_cap: int | None = None,
                       emit_mirrors: bool = True,
                       size_hints: dict | None = None, *, device
                       ) -> tuple[LasFile, LasFile, dict]:
    """Overlap all reads of block A against block B (both orientations)
    on `device`, which has no default: "cuda" runs the CUDA kernels,
    "cpu" their plain torch versions (orders of magnitude slower, for
    tests at small sizes).

    Returns (las_a, las_b, stats): las_a holds records with A-block
    reads as aread; las_b the mirrored records (B-block reads as aread),
    empty unless emit_mirrors.  For a self block, callers merge las_a +
    las_b.  The device arrays a pass builds (uploads, the A-side index,
    the reverse-complement block, the trace pool) stay in the blocks'
    caches, so a second pass over the same block objects skips them.

    hit_cap/seed_cap: the seeding buffers' caps.  None (the default)
    sizes them from the count phase's exact totals, so no hit or seed is
    ever cut off (a hit total above ops.seeding._SLICE_CAP is seeded by
    slices of B reads; stats["seed_path"] names the path, "packed",
    "sliced" or "legacy", and stats["seed_slices"] the slices' tuples,
    hits and buffers).  An explicit cap reproduces damar_tpu's
    buffers, which cut the seeding short when the totals pass them
    (4 x seed_cap for the seeds): stats["seed_overflow"] is then true,
    and run_overlap_plan refuses such a pair.

    size_hints: optional mutable dict carried across pairs by a sweep.
    Hit totals are similar between pairs of one dataset, so the previous
    pairs' measured totals size this pair's hit buffers (a running max,
    halved per pair); the overflow retry keeps an undersized guess
    correct, so hints never change the output."""
    state = overlap_pair_device(
        blk_a, blk_b, cfg, self_block, mask_a=mask_a, mask_b=mask_b,
        hit_cap=hit_cap, seed_cap=seed_cap, emit_mirrors=emit_mirrors,
        size_hints=size_hints, device=device)
    return overlap_pair_emit(state)


def _prefetch(job: dict, device) -> None:
    """Upload the next pair's blocks ahead of their pair (into the
    residency cache the pair will hit), for blocks up to PREFETCH_CAP.
    A failure is logged, not raised: the same upload then fails again,
    loudly, in the pair itself."""
    try:
        for b in (job.get("blk_a"), job.get("blk_b")):
            if b is not None and b.cap <= PREFETCH_CAP:
                _dev_arr(b, "bases", device)
                _dev_arr(b, "read_id", device)
    except Exception:
        log.warning("prefetch of the next pair's blocks failed",
                    exc_info=True)


def overlap_pairs_pipelined(jobs, cfg: OverlapConfig, *, device):
    """Pipelined sweep over block pairs: pair N's trace + .las emit
    (overlap_pair_emit) runs on a one-thread pool, on a CUDA stream of
    its own, while the caller's thread runs pair N + 1's device phases
    (overlap_pair_device).  The outputs are those of a plain loop of
    overlap_block_pair.

    jobs: iterable of dicts with blk_a, blk_b, self_block and optional
    overlap_pair_device keyword arguments, plus an optional "tag" passed
    through.  Yields (tag, las_a, las_b, stats) in submission order.
    The next job is pulled only after the current pair's device phases:
    a job generator may clear or evict block caches as a side effect of
    iteration (planner.run_overlap_plan does)."""
    device = torch.device(device)

    def device_phases(job):
        job = dict(job)
        tag = job.pop("tag", None)
        return tag, overlap_pair_device(
            job.pop("blk_a"), job.pop("blk_b"), cfg, job.pop("self_block"),
            device=device, **job)

    stream = torch.cuda.Stream(device) if device.type == "cuda" else None
    ex = concurrent.futures.ThreadPoolExecutor(max_workers=1)
    try:
        pending = None
        it = iter(jobs)
        job = next(it, None)
        while job is not None:
            tag, state = device_phases(job)
            nxt = next(it, None)
            if nxt is not None:
                _prefetch(nxt, device)
            if pending is not None:
                ptag, fut = pending
                yield (ptag,) + fut.result()
            pending = (tag, ex.submit(overlap_pair_emit, state, stream))
            del state
            job = nxt
        if pending is not None:
            ptag, fut = pending
            yield (ptag,) + fut.result()
    finally:
        ex.shutdown(wait=True)
