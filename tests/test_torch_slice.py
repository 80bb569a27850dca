"""Port vs reference, end to end on a self block pair: the .las bytes
written from damar_tpu_torch's overlap_block_pair must equal damar_tpu's
on its all-device trace route (bp trace kernel, then the wide kernel for
retries, no host C tiers), with emit_mirrors off and on.  Tolerance:
byte equality.  The reference is forced onto that route from the test
side: DAMAR_BP=jax (conftest), damar_tpu.native.available -> False, and
overlap_pair_device + overlap_pair_emit(trace_host=False).

Also confirms fault 3f of the reference (_slice_unit_batch clamps its
window back when lo + w runs past the unit slots).  The port has no
batch slice to copy it into: K1 runs one launch per phase and
orientation over every unit slot (tests/test_torch_plan.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from damar_tpu.core.blocks import block_from_reads as ref_block
from damar_tpu.core.config import OverlapConfig as RefConfig
from damar_tpu.formats.las import write_las as ref_write_las
from damar_tpu.pipeline import overlap as ref_ov
from damar_tpu.utils.sim import make_genome, sample_reads
from damar_tpu_torch.core.blocks import block_from_reads
from damar_tpu_torch.core.config import OverlapConfig
from damar_tpu_torch.formats.las import check_las, write_las
from damar_tpu_torch.pipeline import overlap as ov

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def reads():
    g = make_genome(20_000, seed=7)
    return sample_reads(g, coverage=8.0, mean_len=2500, err=0.14,
                        seed=8).reads


def reference_las(monkeypatch, blk_a, blk_b, self_block, emit_mirrors):
    """damar_tpu on its all-device route (see module docstring)."""
    from damar_tpu import native
    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setenv("DAMAR_BP", "jax")
    st = ref_ov.overlap_pair_device(blk_a, blk_b, RefConfig(), self_block,
                                    emit_mirrors=emit_mirrors)
    return ref_ov.overlap_pair_emit(st, trace_host=False)


def las_bytes(write, las, path):
    write(str(path), las)
    return path.read_bytes()


def assert_same_las(ref, got, tmp_path, rlen):
    for tag, r, p in (("a", ref[0], got[0]), ("b", ref[1], got[1])):
        want = las_bytes(ref_write_las, r, tmp_path / f"ref_{tag}.las")
        have = las_bytes(write_las, p, tmp_path / f"port_{tag}.las")
        assert have == want, f"las_{tag}: {p.novl} vs {r.novl} records"
        assert check_las(p, rlen) == []
    for k in ("seeds", "extents", "kept", "dropped_trace",
              "trace_retries"):
        assert ref[2].get(k) == got[2].get(k), k


@pytest.mark.parametrize("emit_mirrors", [False, True])
def test_self_pair_las_bytes(reads, monkeypatch, tmp_path, emit_mirrors):
    rb = ref_block(reads)
    ref = reference_las(monkeypatch, rb, rb, True, emit_mirrors)
    pb = block_from_reads(reads)
    got = ov.overlap_block_pair(pb, pb, OverlapConfig(), True,
                                emit_mirrors=emit_mirrors, device="cpu")
    assert got[0].novl > 0
    assert got[2]["trace_retries"] > 0        # the wide tier ran (K3)
    assert_same_las(ref, got, tmp_path, pb.rlen)


def test_device_has_no_default(reads):
    """A caller that leaves out device gets an error, not a silent run of
    the plain versions on the host."""
    pb = block_from_reads(reads[:4])
    for fn in (ov.overlap_block_pair, ov.overlap_pair_device):
        with pytest.raises(TypeError, match="device"):
            fn(pb, pb, OverlapConfig(), True)


def _units(N):
    rng = np.random.default_rng(N)
    order = rng.permutation(N).astype(np.int32)
    cols = [rng.integers(1, 1000, N).astype(np.int32) for _ in range(4)]
    return order, cols, rng.integers(0, 2, N).astype(bool)


def test_reference_slice_unit_batch_clamp_fault():
    """Fault 3f: with lo + w past the unit slots, jax's dynamic_slice
    moves the window back, so live lanes re-take earlier units and
    order[lo:lo+m] is never extended."""
    N, lo, m, w = 8, 6, 2, 4
    order, (ao, bo, al, bl), rev = _units(N)
    ref = ref_ov._slice_unit_batch(*map(jnp.asarray, (order, ao, bo, al,
                                                      bl, rev)),
                                   jnp.int32(lo), jnp.int32(m), w)
    ref_tgt = np.asarray(ref[5])
    np.testing.assert_array_equal(ref_tgt[:m], order[N - w:N - w + m])
    assert not np.isin(order[lo:lo + m], ref_tgt).any()   # units lost
