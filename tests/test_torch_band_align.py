"""The pile aligner's plain version (damar_tpu_torch/ops/band_align.py
band_align_plain, the CPU side of K4) against damar_tpu's two aligners:
the host C band_align_paths (damar_tpu/native, which the reference's
consensus runs) and the numpy row loop _banded_align_path_np, on seeded
fuzz pairs: templates of 0-1,300 codes, bands 64, 96 and 700, covers
with margins, shorter covers (n - m negative and odd), unrelated and
empty covers, both modes.  Tolerance: exact equality of every op and
jstart.

The two references disagree with each other where the band leaves the
cover entirely (the numpy loop carries INF + 1, INF + 2, ... through
unreachable cells, the C clips them to BA_INF): there the port follows
the C, which the reference's pipeline runs, and the numpy loop is held
only on the pairs where the two agree (counted, so most pairs are).  The
numpy loop also cannot take an empty cover (it indexes b[-1])."""
import numpy as np
import pytest
import torch

from damar_tpu import native
from damar_tpu.pipeline.consensus import _banded_align_path_np, _path_to_ops
from damar_tpu_torch.ops import band_align as ba
from damar_tpu_torch.utils.sim import align_pairs_batch

torch.set_num_threads(2)


@pytest.fixture(scope="module", autouse=True)
def need_native():
    if not native.available():
        pytest.skip("needs damar_tpu's native library (a C compiler)")


def _native(pairs, semi):
    out = []
    for a, b, band in pairs:
        ops, offs, jst = native.band_align_paths(a, [b], band, semi)
        out.append((ops[:offs[1]], int(jst[0])))
    return out


def _same(x, y):
    return np.array_equal(x[0], y[0]) and x[1] == y[1]


@pytest.mark.parametrize("seed,semi", [(1, True), (2, True), (3, False),
                                       (4, False)])
def test_plain_equals_native(seed, semi):
    """One band_align call over a ragged batch of mixed bands equals the
    C, pair by pair."""
    rng = np.random.default_rng(seed)
    pairs = align_pairs_batch(rng, 40, semiglobal=semi)
    got = ba.align_pairs(pairs, semi, device="cpu")
    want = _native(pairs, semi)
    assert all(_same(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("seed", [5, 6])
def test_plain_equals_numpy_where_the_references_agree(seed):
    rng = np.random.default_rng(seed)
    pairs = [p for p in align_pairs_batch(rng, 40) if len(p[1])]
    got = ba.align_pairs(pairs, device="cpu")
    agree = 0
    for (a, b, band), g, w in zip(pairs, got, _native(pairs, True)):
        npy = _path_to_ops(_banded_align_path_np(a, b, band, True))
        if _same(npy, w):
            agree += 1
            assert _same(g, npy)
    assert agree >= len(pairs) // 2


def test_band_edges_and_odd_negative_offsets():
    """n - m from -2*band-3 to 2*band+3 (every parity) at bands 1-6, the
    whole band frame out of [0, n] included, both modes where the C
    gives a path."""
    rng = np.random.default_rng(7)
    pairs, gl = [], []
    for band in range(1, 7):
        for d in range(-2 * band - 3, 2 * band + 4):
            m = int(rng.integers(0, 14))
            n = max(0, m + d)
            a = rng.integers(0, 4, m).astype(np.uint8)
            b = rng.integers(0, 4, n).astype(np.uint8)
            pairs.append((a, b, band))
            if native.band_align_paths(a, [b], band, False) is not None:
                gl.append((a, b, band))
    got = ba.align_pairs(pairs, True, device="cpu")
    assert all(_same(g, w) for g, w in zip(got, _native(pairs, True)))
    got = ba.align_pairs(gl, False, device="cpu")
    assert all(_same(g, w) for g, w in zip(got, _native(gl, False)))


def test_pipeline_shapes_one_template():
    """A polish window's shape: 20 covers with margins against one
    500-code template at band 96 (native band_align_batch in one call)."""
    rng = np.random.default_rng(8)
    tmpl = rng.integers(0, 4, 500).astype(np.uint8)
    covers = [b for _, b, _ in align_pairs_batch(rng, 20, bands=(96,),
                                                 max_len=500)]
    covers = [np.concatenate([rng.integers(0, 4, 40), tmpl,
                              rng.integers(0, 4, 30)]).astype(np.uint8)
              if i % 2 else c for i, c in enumerate(covers)]
    got = ba.align_pairs([(tmpl, c, 96) for c in covers], device="cpu")
    ops, offs, jst = native.band_align_paths(tmpl, covers, 96, True)
    for i, (o, j) in enumerate(got):
        assert np.array_equal(o, ops[offs[i]:offs[i + 1]]) and j == jst[i]


def test_global_outside_band_raises_and_empty_batch():
    a = np.zeros(50, np.uint8)
    with pytest.raises(ValueError, match="band"):
        ba.align_pairs([(a, np.zeros(10, np.uint8), 8)], False,
                       device="cpu")
    assert ba.align_pairs([], device="cpu") == []
    e = torch.zeros(0, dtype=torch.uint8)
    z = torch.zeros(1, dtype=torch.int64)
    ops, offs, jst = ba.band_align(e, z, e, z,
                                   torch.zeros(0, dtype=torch.int32))
    assert ops.numel() == 0 and offs.tolist() == [0] and jst.numel() == 0


def test_wrapper_counts_only_cuda_launches():
    """On CPU tensors the wrapper takes the plain version and counts no
    launch."""
    rng = np.random.default_rng(9)
    n0 = ba.band_align.launches
    ba.align_pairs(align_pairs_batch(rng, 3), device="cpu")
    assert ba.band_align.launches == n0
