"""The port's launch plans for K1 (extension), K2 (bp trace) and K3 (the
wide trace retries).

K1 runs one launch per phase and orientation over every unit slot, its
work order longest bound first; K2 and the wide retries one launch per
segment-count bucket (split only above the trace-buffer cap), extents
longest first.  These tests check that the plans cover every unit and
extent exactly once, that the order and bucket rules hold, and that the
.las bytes still equal damar_tpu's all-device route on a pair whose read
lengths spread more than 10x.  Tolerance: exact equality.  CPU (plain
versions)."""
import numpy as np
import pytest
import torch

from damar_tpu.core.blocks import block_from_reads as ref_block
from damar_tpu.utils.sim import make_genome, sample_reads
from damar_tpu_torch.core.blocks import block_from_reads
from damar_tpu_torch.core.config import OverlapConfig
from damar_tpu_torch.ops import wave_bp
from damar_tpu_torch.pipeline import overlap as ov
from test_torch_slice import assert_same_las, reference_las

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def reads():
    g = make_genome(16_000, seed=41)
    return sample_reads(g, coverage=8.0, mean_len=2000, err=0.14, seed=42,
                        min_len=300).reads


def _record(monkeypatch, name):
    """Wrap ov.<name> so every call's arguments are kept (the call goes
    through unchanged)."""
    calls = []
    real = getattr(ov, name)

    def spy(*a, **kw):
        out = real(*a, **kw)
        calls.append((a, kw, out))
        return out
    monkeypatch.setattr(ov, name, spy)
    return calls


@pytest.mark.parametrize("phase1_rows", [128, 0])
def test_k1_one_launch_per_phase_covers_every_unit(reads, monkeypatch,
                                                   phase1_rows):
    """Two phases: 4 launches (phase 1 and 2 per orientation), else 2;
    each over every unit slot; the kernel's work order is a permutation
    of the slots with units by non-increasing bound min(alim, blim) and
    dead slots (alim = 0) last.  Phase 2 gives
    alim = 0 to every unit phase 1 finished.  The extents equal those of
    the other phase setting."""
    pb = block_from_reads(reads)
    cfg = OverlapConfig(ext_phase1_rows=phase1_rows)
    calls = _record(monkeypatch, "extend_wave_bp")
    state = ov.overlap_pair_device(pb, pb, cfg, True, device="cpu")
    two = phase1_rows > 0
    assert len(calls) == (4 if two else 2)
    for i, (a, kw, out) in enumerate(calls):
        alim, blim = a[4].numpy(), a[5].numpy()
        order = wave_bp.longest_first(a[4], a[5]).numpy()
        S = len(alim)
        np.testing.assert_array_equal(np.sort(order), np.arange(S))
        bound = np.where(alim > 0, np.minimum(alim, blim), -1)[order]
        assert (np.diff(bound) <= 0).all()
        assert (bound > 0).any() and (alim == 0).any()
        if two and i % 2 == 1:      # phase 2 after its phase 1
            a1, _, out1 = calls[i - 1]
            np.testing.assert_array_equal(
                alim, np.where(out1[4].numpy(), a1[4].numpy(), 0))
            assert kw["max_rows"] == cfg.max_read_len
        elif two:
            assert kw["max_rows"] == phase1_rows and kw["with_active"]
    other = ov.overlap_pair_device(
        pb, pb, OverlapConfig(ext_phase1_rows=0 if two else 128), True,
        device="cpu")
    for x, y in zip(state["kept_parts"], other["kept_parts"]):
        for k in ov.EXT_KEYS:
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)


def _trace_launch_segs(expect, cap_segs):
    """max_segs as _trace_launch picks it for a batch."""
    need = int(expect.max()) + 2
    m = 8
    while m < min(need, cap_segs):
        m *= 2
    return min(m, cap_segs)


@pytest.mark.parametrize("tspace,buf_bytes", [(100, 1 << 30),
                                              (126, 1 << 30),
                                              (250, 1 << 30),
                                              (100, 40_000)])
def test_k2_plan_covers_every_extent_once(tspace, buf_bytes):
    """Every extent in exactly one launch; one launch per bucket unless
    the buffer cap splits it; each launch's buffer within the cap; spans
    non-increasing inside a launch; and the bucket is the max_segs that
    _trace_launch picks for the launch."""
    rng = np.random.default_rng(tspace + buf_bytes % 7)
    n = 5000
    abp = rng.integers(0, 3000, n)
    aep = abp + np.concatenate([rng.integers(0, 400, n // 2),
                                rng.integers(400, 70_000, n - n // 2)])
    expect = ov._n_segments_vec(abp, aep, tspace)
    cfg = OverlapConfig(tspace=tspace)
    cap = ov._cap_segs(cfg)
    plan = ov._trace_plan(aep - abp, expect, cap, buf_bytes)
    allidx = np.concatenate(plan)
    np.testing.assert_array_equal(np.sort(allidx), np.arange(n))
    bucket = ov._segs_bucket(expect, cap)
    for idx in plan:
        ms = int(bucket[idx[0]])
        assert (bucket[idx] == ms).all()
        assert len(idx) == 1 or len(idx) * ms * 8 <= buf_bytes
        assert (np.diff((aep - abp)[idx]) <= 0).all()
        assert _trace_launch_segs(expect[idx], cap) == ms
    if buf_bytes == 1 << 30:
        assert len(plan) == len(np.unique(bucket))
    else:
        assert len(plan) > len(np.unique(bucket))
    assert (bucket >= np.minimum(expect + 2, cap)).all()


def test_spread_pair_las_bytes_and_trace_launches(reads, monkeypatch,
                                                  tmp_path):
    """Read lengths spread more than 10x: the .las bytes still equal the
    reference's (mirrors on); the bp trace ran one launch per bucket and
    traced every record of the main round exactly once."""
    lens = np.array([len(r) for r in reads])
    assert lens.max() >= 10 * lens.min()
    ref = reference_las(monkeypatch, ref_block(reads), ref_block(reads),
                        True, True)
    calls = _record(monkeypatch, "trace_wave_bp")
    pb = block_from_reads(reads)
    got = ov.overlap_block_pair(pb, pb, OverlapConfig(), True,
                                emit_mirrors=True, device="cpu")
    assert got[0].novl > 0
    assert_same_las(ref, got, tmp_path, pb.rlen)
    spans = np.concatenate([a[6].numpy() for a, _, _ in calls])
    assert len(spans) == 2 * got[2]["kept"]          # primary + mirror
    cap = ov._cap_segs(OverlapConfig())
    segs = [kw["max_segs"] for _, kw, _ in calls]
    assert len(set(segs)) == len(segs) and set(segs) <= {
        8, 16, 32, 64, 128, 256, 512, cap}


def test_wide_retry_plan_covers_every_retry_once(monkeypatch):
    """The wide retry round: one launch per segment-count bucket of the
    retried extents, each retried extent in exactly one launch, spans
    non-increasing inside a launch, and as many extents as the stats
    count; the .las bytes of this pair stay the reference's
    (tests/test_torch_slice.py)."""
    g = make_genome(20_000, seed=7)
    reads = sample_reads(g, coverage=8.0, mean_len=2500, err=0.14,
                         seed=8).reads
    calls = _record(monkeypatch, "trace_wave")
    pb = block_from_reads(reads)
    cfg = OverlapConfig()
    _, _, stats = ov.overlap_block_pair(pb, pb, cfg, True,
                                        emit_mirrors=True, device="cpu")
    assert stats["trace_retries"] > 0 and calls
    keys, segs = [], []
    for a, kw, _ in calls:
        spans = a[6].numpy()
        assert (np.diff(spans) <= 0).all()
        keys += list(zip(*(x.numpy() for x in a[2:8])))
        segs.append(kw["max_segs"])
    assert len(keys) == len(set(keys)) == stats["trace_retries"]
    abp = np.array([k[2] for k in keys])
    expect = ov._n_segments_vec(abp, abp + np.array([k[4] for k in keys]),
                                cfg.tspace)
    bucket = ov._segs_bucket(expect, ov._cap_segs(cfg))
    assert sorted(segs) == sorted(set(bucket.tolist()))
