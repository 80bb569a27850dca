"""The work of the overlap kernels, counted from the records a pass
emitted, and the peak it is held against.  Nothing here reads a launch
shape, a kernel's own counter or its compiled code, so a kernel that is
rewritten is judged by the same work.

Peak (H100 SXM5, NVIDIA H100 Tensor Core GPU Architecture whitepaper and
CUDA C++ Programming Guide, compute capability 9.0):
  132 SMs x 4 warp schedulers x 32 lanes = 16,896 thread instructions a
  clock, at the 1,980 MHz boost clock; an integer instruction yields at
  most two two-input results (IADD3 and LOP3 take three inputs; IMAD is
  a multiply and an add), so at most 2 x 16,896 x 1.98e9 = 66.9e12
  two-input 32-bit integer operations a second.  The programming guide's
  per-SM rates (64 results a clock for 32-bit add, logic, shift and
  compare on the integer pipe, 64 for IMAD on the FMA pipe) lie under it.
  It is an upper bound at the card's full 700 W.
Bytes: 3.35 TB/s of HBM3.  Each kernel reads its reads' bases packed at
two bits and writes a few words an extent, far under its operations'
time at that rate, so the operations bind.

Operations a DP row, the algorithms' own counts (two-input operations):
  bit-parallel banded row (Myers 1999, Hyyro 2003), 32 diagonals in one
  word pair VP/VN:
    match mask of the row's A base over the band, the band sliding one
    B base a row: four shifts and one or                          5
    X = Eq | VN                                                   1
    D0 = (((VP & X) + VP) ^ VP) | X                               4
    HP = VN | ~(D0 | VP)                                          3
    HN = VP & D0                                                  1
    band-edge distance: test the edge bits, add                   2
    next row: X2 = D0 >> 1, VN = X2 & HP, VP = HN | ~(X2 | HP)    5
                                                            total 21
  K2 (bp_trace_kernel, the trace points) runs that row: 21.
  K1 (bp_extend_kernel, the extension) adds its stop test (the row's
  best score against the running best and the X-drop): 3, so 24.
  K3 (wide_trace_kernel), one lane a diagonal over a 128-lane band, the
  plain recurrence per cell: a compare of the two bases, the diagonal
  plus it, the two neighbours plus one, two minimums: 6 a cell, 128
  cells a row.

Rows, from the emitted records:
  K1: the A span of every alignment once (each was extended from a seed
      across its span; duplicates and alignments shorter than -l, which
      the dedupe drops, are left out, so the count is low if anything).
  K2: the A span of every record, primary and mirror: each is traced.
  K3: the A span of the records that the 32-diagonal band cannot have
      traced: a trace segment whose B span differs from its A span by
      more than the band reaches (16 bases to either side); those
      went to the 128-lane retry.  Others may have gone too, so this is a
      low count.
"""
from __future__ import annotations

import numpy as np

SMS = 132
LANES_PER_CLOCK = 4 * 32
OPS_PER_INSTRUCTION = 2
BOOST_HZ = 1.98e9
PEAK_OPS = SMS * LANES_PER_CLOCK * OPS_PER_INSTRUCTION * BOOST_HZ

OPS_PER_ROW = {"bp_extend_kernel": 24, "bp_trace_kernel": 21,
               "wide_trace_kernel": 6 * 128}
BAND_REACH = (-16, 16)


def _spans(h: np.ndarray) -> np.ndarray:
    return h[:, 4].astype(np.int64) - h[:, 2]


def wide_rows(parsed: tuple, tspace: int) -> int:
    """A rows of the records whose trace leaves the 32-diagonal band."""
    _, h, pairs, soff = parsed
    n = h.shape[0]
    if n == 0 or pairs.shape[0] == 0:
        return 0
    nseg = soff[1:] - soff[:-1]
    rid = np.repeat(np.arange(n), nseg)
    k = np.arange(pairs.shape[0]) - np.repeat(soff[:-1], nseg)
    abp, aep = h[rid, 2].astype(np.int64), h[rid, 4].astype(np.int64)
    a0 = np.maximum(abp, (abp // tspace + k) * tspace)
    a1 = np.minimum((abp // tspace + k + 1) * tspace, aep)
    drift = pairs[:, 1].astype(np.int64) - (a1 - a0)
    out = (drift < BAND_REACH[0]) | (drift > BAND_REACH[1])
    wide = np.zeros(n, bool)
    wide[rid[out]] = True
    return int(_spans(h)[wide].sum())


def rows(files: list[tuple], mirrors: str) -> dict:
    """DP rows of each kernel for one unit's records.  files: parsed
    (tspace, headers, pairs, seg_offsets); mirrors "within" (one file
    holds every alignment twice) or "across" (files[1] holds the
    mirrors of files[0])."""
    every = sum(int(_spans(f[1]).sum()) for f in files)
    primary = every // 2 if mirrors == "within" else int(
        _spans(files[0][1]).sum())
    wide = sum(wide_rows(f, f[0]) for f in files)
    return {"bp_extend_kernel": primary, "bp_trace_kernel": every,
            "wide_trace_kernel": wide}


def roofline_pct(kernel: str, rows_total: int, device_s: float):
    """100 x least time / device time, or None when the kernel did not
    run or did no counted work."""
    if device_s <= 0 or rows_total <= 0:
        return None
    least = rows_total * OPS_PER_ROW[kernel] / PEAK_OPS
    return 100.0 * least / device_s


def aligned_bp(files: list[tuple], mirrors: str) -> int:
    """Aligned bp of one unit: the A spans of its primary records (the
    mirrors repeat them)."""
    return rows(files, mirrors)["bp_extend_kernel"]


def gbp_per_s(aligned: list[int], t0: float, t_end: float) -> float:
    """A window's rate: all its units' aligned bp over the time from the
    window's start to the last unit's end, stalls included."""
    return sum(aligned) / (t_end - t0) / 1e9
