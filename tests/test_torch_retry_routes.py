"""Fault 3p of the reference, a divergence between its own routes: on the
CPU with its host C library (its default there, which examples/do.py
--cpu and scripts/soak.py take) a record whose trace fails is retried
first by the host C 64-diagonal tier (_native_bp64_trace), while its
device route (DAMAR_BP=jax, native.available -> False, as on the TPU)
retries it on the 128-lane wide band.  The two can trace the same
record with other diffs.  The port follows the device route (K3's
wide_trace_kernel), so its .las bytes are the device route's.

The case: the worked example's reads 41 and 67 (examples/do.py's 50 kbp
genome, seeds 7 and 8) as a self block of two reads.  The mirrored
record (67 against 41, comp) fails its main trace; the host C tier
traces it with 534 diffs, the wide band with 533.  At the example's
full size this is the one record of RAW.1.las (and of FIX.1.las) that
differs between the reference's routes; the contigs are the same.
Tolerance: exact equality of the .las columns."""
import numpy as np
import torch

from damar_tpu import native
from damar_tpu.core.blocks import block_from_reads as ref_block_from_reads
from damar_tpu.core.config import OverlapConfig as RefConfig
from damar_tpu.pipeline.overlap import overlap_block_pair as ref_pair
from damar_tpu_torch.core.blocks import block_from_reads
from damar_tpu_torch.core.config import OverlapConfig
from damar_tpu_torch.pipeline.overlap import overlap_block_pair
from damar_tpu_torch.utils import sim

torch.set_num_threads(2)
IDS = np.array([41, 67])


def reads():
    g = sim.make_genome(50_000, seed=7)
    s = sim.sample_reads(g, coverage=12, mean_len=4000, err=0.13, seed=8)
    return [s.reads[i] for i in IDS]


def columns(las_a, las_b):
    return [np.concatenate([x.columns.headers for x in (las_a, las_b)]),
            np.concatenate([x.columns.trace for x in (las_a, las_b)])]


def reference(monkeypatch, route: str):
    monkeypatch.setenv("DAMAR_BP", route)
    if route == "jax":
        monkeypatch.setattr(native, "available", lambda: False)
    else:
        assert native.available(), "the reference's host C library"
    blk = ref_block_from_reads(reads(), ids=IDS)
    la, lb, st = ref_pair(blk, blk, RefConfig(), self_block=True)
    assert st["trace_retries"] == 1
    return columns(la, lb)


def test_the_reference_routes_retry_to_other_diffs(monkeypatch):
    host = reference(monkeypatch, "native")
    device = reference(monkeypatch, "jax")
    blk = block_from_reads(reads(), ids=IDS)
    la, lb, st = overlap_block_pair(blk, blk, OverlapConfig(), True,
                                    device="cpu")
    assert st["trace_retries"] == 1
    port = columns(la, lb)
    for a, b in zip(port, device):
        np.testing.assert_array_equal(a, b)
    # the mirrored record: 67 against 41, comp; header column 1: diffs
    mirror = [h[np.nonzero(h[:, 7] == 67)[0][0]] for h in (host[0],
                                                             device[0])]
    assert mirror[0][8] == mirror[1][8] == 41
    assert (mirror[0][1], mirror[1][1]) == (534, 533)
    np.testing.assert_array_equal(host[0][:, [0, 2, 3, 4, 5, 6, 7, 8]],
                                  device[0][:, [0, 2, 3, 4, 5, 6, 7, 8]])
