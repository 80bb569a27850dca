"""The generator: the same seed gives the same reads, another seed other
reads; coverage, length mean and the error split as the configuration
states; DBsplit's block rule; circular ground truth."""
import numpy as np
import pytest
import torch

from benchmark import traffic

CFG = {"genome": {"bp": 200_000, "repeat_copies": 3, "repeat_bp": 2000},
       "reads": {"coverage": 10, "mean_bp": 3000, "min_bp": 500,
                 "max_bp": None, "error": 0.14, "ins_share": 0.45,
                 "del_share": 0.35}}


def test_same_seed_same_reads_other_seed_other_reads():
    a = traffic.make_reads(CFG, 2 ** 31 + 12345, "cpu")
    b = traffic.make_reads(CFG, 2 ** 31 + 12345, "cpu")
    c = traffic.make_reads(CFG, 2 ** 31 + 12346, "cpu")
    assert np.array_equal(a.bases, b.bases)
    assert np.array_equal(a.offsets, b.offsets)
    assert np.array_equal(a.start, b.start)
    assert not np.array_equal(a.start[:10], c.start[:10])


def test_coverage_and_length_mean():
    r = traffic.make_reads(CFG, 7, "cpu")
    target = CFG["genome"]["bp"] * CFG["reads"]["coverage"]
    assert target <= r.span.sum() < target + r.span.max()
    assert abs(r.span.mean() / 3000 - 1) < 0.08
    assert r.lengths.min() >= 500
    # errors lengthen reads by ins - del = 14% x (0.45 - 0.35)
    assert abs(r.lengths.sum() / r.span.sum() - 1.014) < 0.004


@pytest.mark.parametrize("ins,dele,ratio", [(1.0, 0.0, 1.14),
                                            (0.0, 1.0, 0.86),
                                            (0.0, 0.0, 1.0)])
def test_error_split(ins, dele, ratio):
    gen = torch.Generator().manual_seed(3)
    src = torch.randint(0, 4, (400_000,), generator=gen, dtype=torch.uint8)
    spec = dict(error=0.14, ins_share=ins, del_share=dele)
    out, per = traffic._mutate(src, torch.tensor([400_000]), gen, spec)
    assert int(per.sum()) == out.numel()
    assert abs(out.numel() / src.numel() - ratio) < 0.003
    if ins == dele == 0.0:       # substitutions alone: mismatches at 14%
        assert abs(float((out != src).float().mean()) - 0.14) < 0.003


def test_reads_are_their_spans_with_errors():
    cfg = {**CFG, "reads": {**CFG["reads"], "error": 0.0}}
    r = traffic.make_reads(cfg, 11, "cpu")
    gen = torch.Generator().manual_seed(11)
    g = traffic.make_genome(gen, cfg["genome"], "cpu").numpy()
    gg = np.concatenate([g, g])
    for i in range(20):
        span = gg[r.start[i]:r.start[i] + r.span[i]]
        want = span if r.strand[i] == 0 else 3 - span[::-1]
        assert np.array_equal(r.read(i), want)


def test_repeat_copies_are_planted():
    from collections import Counter
    gen = torch.Generator().manual_seed(5)
    g = traffic.make_genome(gen, CFG["genome"], "cpu").numpy()
    k = Counter(g[i:i + 64].tobytes() for i in range(0, len(g) - 64))
    # every 64-mer of the 2 kbp unit occurs in each of the three copies
    assert sum(v >= 3 for v in k.values()) >= 2000 - 64


def test_dbsplit_blocks():
    lens = np.array([400, 600, 500, 300, 700, 200])
    # 1 kbp blocks (block_mb 0.001), cutoff 450: 400, 300 and 200 skip
    assert traffic.dbsplit_blocks(lens, 0.001, 450) == [(0, 2), (2, 4),
                                                        (4, 6)]
    assert traffic.dbsplit_blocks(lens, 200, 0) == [(0, 6)]


def test_true_overlap_wraps_the_circle():
    r = traffic.Reads(np.zeros(0, np.uint8), np.zeros(4, np.int64),
                      np.array([990, 5, 500]), np.array([30, 40, 10]),
                      np.zeros(3, np.int8), 1000)
    ov = traffic.true_overlap(r, np.array([0, 0, 1]), np.array([1, 2, 2]))
    assert ov.tolist() == [15, 0, 0]
