"""The reference on tiny inputs: its .las reader against bytes written
by hand, its edit distance against a plain Python DP, each layout check
against a record broken on purpose, the mirror rule, the recall count;
the work formulas on hand-made records; the window's rate."""
import struct

import numpy as np
import pytest

from benchmark import reference as ref
from benchmark import work

TS = 100
CFG = {"tspace": TS, "min_len": 150, "err": 0.7}


def rec(ar, br, abp, aep, bbp, bep, trace, comp=0):
    """One record's header row and trace [(diffs, bspan)]."""
    h = np.zeros(10, np.int32)
    h[:] = [2 * len(trace), sum(d for d, _ in trace), abp, bbp, aep, bep,
            comp, ar, br, 0]
    return h, np.array(trace, np.int32).reshape(-1, 2)


def parsed(recs):
    h = np.stack([r[0] for r in recs])
    pairs = np.concatenate([r[1] for r in recs])
    soff = np.zeros(len(recs) + 1, np.int64)
    np.cumsum([len(r[1]) for r in recs], out=soff[1:])
    return (TS, h, pairs, soff)


def write_las(path, recs):
    with open(path, "wb") as f:
        f.write(struct.pack("<qi", len(recs), TS))
        for h, tr in recs:
            f.write(h.astype("<i4").tobytes())
            f.write(tr.astype(np.uint8).tobytes())


def py_edit(a, b):
    d = list(range(len(b) + 1))
    for i, x in enumerate(a, 1):
        prev, d[0] = d[0], i
        for j, y in enumerate(b, 1):
            prev, d[j] = d[j], min(d[j] + 1, d[j - 1] + 1, prev + (x != y))
    return d[-1]


def test_parse_las_reads_what_was_written(tmp_path):
    recs = [rec(0, 1, 50, 250, 10, 215, [(3, 52), (5, 100), (2, 53)]),
            rec(1, 0, 10, 215, 50, 250, [(4, 92), (6, 108)])]
    p = str(tmp_path / "x.las")
    write_las(p, recs)
    ts, h, pairs, soff = ref.parse_las(p)
    assert ts == TS and np.array_equal(h, np.stack([r[0] for r in recs]))
    assert pairs.tolist() == [[3, 52], [5, 100], [2, 53], [4, 92], [6, 108]]
    assert soff.tolist() == [0, 3, 5]
    with open(p, "ab") as f:
        f.write(b"\0")
    with pytest.raises(ValueError):
        ref.parse_las(p)


def test_edit_distances_match_a_plain_dp():
    rng = np.random.default_rng(1)
    a = [rng.integers(0, 4, rng.integers(0, 30)).astype(np.uint8)
         for _ in range(40)]
    b = [rng.integers(0, 4, rng.integers(0, 30)).astype(np.uint8)
         for _ in range(40)]
    b[3] = a[3].copy()
    got = ref.edit_distances(a, b, "cpu", batch=16)
    assert got.tolist() == [py_edit(x, y) for x, y in zip(a, b)]
    assert got[3] == 0


def test_mirror_of_is_an_involution():
    rlen = np.array([300, 400])
    h = np.stack([rec(0, 1, 50, 250, 10, 215, [(0, 1)] * 3, comp=c)[0]
                  for c in (0, 1)])
    m = ref.mirror_of(h, rlen)
    back = np.zeros_like(h)
    back[:, [7, 8, 6, 2, 4, 3, 5]] = m
    assert np.array_equal(ref.mirror_of(back, rlen), ref.identity_of(h))
    assert m[1].tolist() == [1, 0, 1, 400 - 215, 400 - 10, 300 - 250,
                             300 - 50]


def good_pair():
    """A record and its mirror, consistent in every check."""
    a = rec(0, 1, 50, 250, 10, 215, [(3, 52), (5, 100), (2, 53)])
    b = rec(1, 0, 10, 215, 50, 250, [(4, 90), (6, 100), (0, 10)])
    return a, b


@pytest.mark.parametrize("kind", [None, "read_ids", "coordinates",
                                  "under_min_len", "flags",
                                  "trace_segments", "trace_sums",
                                  "sort_order", "duplicates", "mirrors"])
def test_each_format_fault_is_counted(kind):
    rlen = np.array([300, 400, 500])
    a, b = good_pair()
    ra, rb = [a], [b]
    if kind == "read_ids":
        ra[0][0][8] = 2
    elif kind == "coordinates":
        ra[0][0][4] = 301
    elif kind == "under_min_len":
        ra = [rec(0, 1, 100, 200, 10, 110, [(1, 100)])]
        rb = [rec(1, 0, 10, 110, 100, 200, [(1, 90), (0, 10)])]
    elif kind == "flags":
        ra[0][0][6] = 4
    elif kind == "trace_segments":
        ra = [rec(0, 1, 50, 250, 10, 215, [(3, 52), (7, 153)])]
    elif kind == "trace_sums":
        ra[0][1][0, 1] += 1
    elif kind == "sort_order":
        ra = [rec(0, 1, 60, 250, 20, 215, [(3, 42), (5, 100), (2, 53)]), a]
        rb = [rec(1, 0, 20, 215, 60, 250, [(0, 80), (6, 100), (0, 15)]), b]
    elif kind == "duplicates":
        ra, rb = [a, a], [b, b]
    elif kind == "mirrors":
        rb = [rec(1, 0, 11, 215, 50, 250, [(4, 91), (6, 108), (0, 5)])]
    out = ref.format_faults([parsed(ra), parsed(rb)], rlen, np.array([0]),
                            np.array([1]), CFG, "across")
    if kind is None:
        assert out["total"] == 0, out
    else:
        assert out[kind] > 0, out
        assert out["total"] > 0


def test_segment_faults_count_diffs_below_the_edit_distance():
    rng = np.random.default_rng(2)
    A = rng.integers(0, 4, 300).astype(np.uint8)
    B = A.copy()
    B[[10, 120, 230]] = (B[[10, 120, 230]] + 1) % 4
    seqs = {0: A, 1: B}
    good = parsed([rec(0, 1, 0, 300, 0, 300, [(1, 100), (1, 100),
                                              (1, 100)])])
    got = ref.segment_faults(good, np.array([0]), seqs.__getitem__, "cpu")
    assert got == {"segment_faults": 0, "segments": 3, "excess": 0}
    low = parsed([rec(0, 1, 0, 300, 0, 300, [(0, 100), (1, 100),
                                             (1, 100)])])
    got = ref.segment_faults(low, np.array([0]), seqs.__getitem__, "cpu")
    assert got["segment_faults"] == 1
    # a complement record aligns A with B reverse-complemented
    C = (3 - A[::-1]).astype(np.uint8)
    comp = parsed([rec(0, 1, 0, 300, 0, 300, [(0, 100)] * 3, comp=1)])
    got = ref.segment_faults(comp, np.array([0]), {0: A, 1: C}.__getitem__,
                             "cpu")
    assert got["segment_faults"] == 0


def test_missed_true_counts_pairs_without_a_record():
    h = np.stack([rec(0, 2, 0, 100, 0, 100, [(0, 100)])[0],
                  rec(0, 3, 0, 100, 0, 100, [(0, 100)], comp=1)[0]])

    def truth(i, js):
        return np.array([5000, 5000, 5000, 10])[js], np.array([0, 0, 1, 1])[js]

    out = ref.missed_true(h, truth, np.array([0]), np.array([1, 2, 3]),
                          np.random.default_rng(0), 5, 2000, False)
    # partners 1 and 2 are true (>= 2000); 2 has a record in the wrong
    # orientation, 1 none; 3 is not true
    assert out["true_pairs"] == 2 and out["missed"] == 2


def test_work_rows_and_wide_records():
    a = rec(0, 1, 50, 250, 10, 215, [(3, 52), (5, 100), (2, 53)])
    wide = rec(0, 1, 0, 200, 0, 240, [(9, 100), (30, 140)])
    b = rec(1, 0, 10, 215, 50, 250, [(4, 92), (6, 108), (0, 5)])
    rows = work.rows([parsed([a, wide]), parsed([b])], "across")
    assert rows == {"bp_extend_kernel": 400, "bp_trace_kernel": 605,
                    "wide_trace_kernel": 200}
    # one file holding each alignment twice: half its A spans are primary
    within = work.rows([parsed([a, b])], "within")
    assert within["bp_extend_kernel"] == (200 + 205) // 2
    assert within["bp_trace_kernel"] == 405


def test_peak_and_share():
    assert abs(work.PEAK_OPS - 66.9e12) < 0.1e12
    secs = 1e9 * 21 / work.PEAK_OPS
    assert abs(work.roofline_pct("bp_trace_kernel", 10 ** 9, secs * 4)
               - 25.0) < 1e-9
    assert work.roofline_pct("bp_trace_kernel", 0, 1.0) is None
    assert work.roofline_pct("bp_trace_kernel", 10, 0.0) is None


def test_rate_spans_the_whole_window_with_its_stall():
    # three units of 1 Gbp; a 4 s stall before the last: 3 Gbp / 10 s
    assert work.gbp_per_s([10 ** 9] * 3, 100.0, 110.0) == pytest.approx(0.3)


def truth_reads():
    """Three error-free reads on a 10 kbp genome with two planted repeat
    copies of 1 kbp at 500 and 6500: read 0 forward over [1000, 3000),
    read 1 reverse over [2000, 4000), read 2 forward over [6000, 8000)."""
    from benchmark.traffic import Reads
    return Reads(np.zeros(6000, np.uint8), np.array([0, 2000, 4000, 6000]),
                 np.array([1000, 2000, 6000]), np.array([2000, 2000, 2000]),
                 np.array([0, 1, 0], np.int8), 10_000,
                 np.array([500, 6500]), 1000)


def steps(n, b=100):
    return [(10, b)] * n


def test_misplaced_holds_records_to_the_generators_truth():
    reads = truth_reads()
    recs = [
        # the true overlap [2000, 3000): read 1 in its reverse complement
        rec(0, 1, 1000, 2000, 0, 1000, steps(10), comp=1),
        # the same A interval against read 2, which shares no genome
        rec(0, 2, 1000, 2000, 0, 1000, steps(10)),
        # read 0's end of copy 0 against read 2's end of copy 1: the
        # repeat's offsets 500..1000 on both
        rec(0, 2, 0, 500, 1000, 1500, steps(5)),
        # run 600 bases past the true overlap on B
        rec(0, 1, 1000, 2000, 0, 1600, steps(9) + [(10, 700)], comp=1),
        # true ends, but the path leaves the diagonal in between
        rec(0, 1, 1000, 2000, 0, 1000, [(10, 900)] + steps(8, 0)
            + [(10, 100)], comp=1),
    ]
    p = parsed(recs)
    assert ref.misplaced(p, reads, 300, np.array([])).tolist() == [
        False, True, False, True, False]
    assert ref.misplaced(p, reads, 300, np.arange(5)).tolist() == [
        False, True, False, True, True]
    assert ref.misplaced(p, reads, 700, np.array([])).tolist() == [
        False, True, False, False, False]


def test_same_place_wraps_the_circle():
    reads = truth_reads()
    ok = ref.same_place(reads, np.array([9990.0, 100.0]),
                        np.array([20.0, 600.0]), 50)
    assert ok.tolist() == [True, False]


def test_over_e_counts_records_above_daligners_bound():
    h = np.stack([rec(0, 1, 0, 1000, 0, 1000, [(300, 1000)])[0],
                  rec(0, 1, 0, 1000, 0, 1200, [(331, 1200)])[0],
                  rec(0, 1, 0, 1000, 0, 1200, [(330, 1200)])[0]])
    assert ref.over_e(h, 0.7).tolist() == [False, True, False]
