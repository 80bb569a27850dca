"""Port vs reference end to end on each seeding path: the .las bytes of
damar_tpu_torch's overlap_block_pair (mirrors on) equal damar_tpu's
all-device route (DAMAR_BP=jax, damar_tpu.native.available -> False,
overlap_pair_device + overlap_pair_emit(trace_host=False)) on a
self pair with the sliced path forced (_SLICE_CAP lowered in both
packages), with the legacy path forced (packed_payload_host returning
None in both; tests/test_torch_seed_legacy.py holds distinct pairs' legacy
seeds) and with OverlapConfig(bias=True) over AT-rich reads.
Tolerance: byte equality.  The three cases share one file so that the
reference's compiles of the extension and the trace serve them all (the
blocks' capacity buckets give them the same shapes)."""
import numpy as np
import pytest
import torch

from damar_tpu.core.blocks import block_from_reads as ref_block
from damar_tpu.core.config import OverlapConfig as RefConfig
from damar_tpu.ops import seeding as ref_seeding
from damar_tpu.pipeline import overlap as ref_ov
from damar_tpu.utils.sim import make_genome, sample_reads
from damar_tpu_torch.core.blocks import block_from_reads
from damar_tpu_torch.core.config import OverlapConfig
from damar_tpu_torch.ops import seeding
from damar_tpu_torch.pipeline import overlap as ov
from test_torch_slice import assert_same_las

torch.set_num_threads(2)


def _reads(case):
    if case == "bias":     # 40% A, 10% C, 10% G, 40% T: weights differ
        g = np.random.default_rng(73).choice(
            4, 30_000, p=[0.4, 0.1, 0.1, 0.4]).astype(np.uint8)
        seed = 74
    else:
        g, seed = make_genome(30_000, seed=71), 72
    reads = sample_reads(g, coverage=8.0, mean_len=3000, err=0.13,
                         seed=seed).reads
    return reads[:len(reads) // 2]


@pytest.mark.parametrize("case", ["sliced", "legacy", "bias"])
def test_las_bytes(monkeypatch, tmp_path, case):
    from damar_tpu import native
    monkeypatch.setattr(native, "available", lambda: False)
    reads = _reads(case)
    cfg, rcfg = OverlapConfig(), RefConfig()
    if case == "sliced":
        for mod in (seeding, ref_seeding):
            monkeypatch.setattr(mod, "_SLICE_CAP", 1 << 10)
            monkeypatch.setattr(mod, "_SLICE_CHUNK", 1 << 19)
    if case == "legacy":
        for mod in (seeding, ref_seeding):
            monkeypatch.setattr(mod, "packed_payload_host", lambda blk: None)
    if case == "bias":
        cfg, rcfg = OverlapConfig(bias=True), RefConfig(bias=True)
    rb, pb = ref_block(reads), block_from_reads(reads)
    st = ref_ov.overlap_pair_device(rb, rb, rcfg, True, emit_mirrors=True)
    ref = ref_ov.overlap_pair_emit(st, trace_host=False)
    got = ov.overlap_block_pair(pb, pb, cfg, True, emit_mirrors=True,
                                device="cpu")
    assert got[2]["seed_path"] == ("packed" if case == "bias" else case)
    assert got[0].novl > 0
    assert_same_las(ref, got, tmp_path, pb.rlen)
