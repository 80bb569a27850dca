"""The ring against the block sweep: on tests/test_torch_sweep.py's
3-block DB (db_split at 1 Mbp, reads of 500-1,300 bp), the records of
each ring shard i whose B read lies in block j > i, written as a .las
file, must be the bytes of overlap_block_pair's A side with mirrors off
(the pair driver tests/test_parallel.py compares the reference's ring
with) and of run_overlap_plan's pair file E.i.E.j.las (mirrors on, which
tests/test_torch_sweep.py holds byte-equal to damar_tpu's).  The two are
equal here; where a record's mirror fails its trace the pair file drops
the record too, and chip_smoke.py's phase 13a, which holds the same
gates at full size, checks the ring's part holds the pair file there.
The ring runs as 1 rank in this process and as 3 ranks spawned over
gloo; the blocks are the DB's, at one common cap.  Tolerance: byte
equality."""
import numpy as np
import pytest
import torch

from damar_tpu_torch.core.blocks import block_from_db
from damar_tpu_torch.core.config import OverlapConfig
from damar_tpu_torch.formats.las import LasFile, read_las, write_las
from damar_tpu_torch.pipeline.overlap import overlap_block_pair
from damar_tpu_torch.pipeline.planner import run_overlap_plan
from test_torch_ring import port_runs
from test_torch_sweep import MIN_LEN, make_db, sweep_reads

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    w = str(tmp_path_factory.mktemp("ringsweep"))
    db = make_db(w, sweep_reads())
    cfg = OverlapConfig(min_len=MIN_LEN)
    run_overlap_plan(f"{w}/E.db", cfg, verbose=False, device="cpu")
    caps = [block_from_db(db, b).cap for b in range(1, db.nblocks + 1)]
    blocks = [block_from_db(db, b, cap=max(caps))
              for b in range(1, db.nblocks + 1)]
    port = port_runs(f"{w}/ring", [("sweep", blocks, cfg, {}, "las")],
                     worlds=(1, 3))
    for i in range(len(blocks)):
        for j in range(i + 1, len(blocks)):
            la, _, _ = overlap_block_pair(blocks[i], blocks[j], cfg, False,
                                          emit_mirrors=False, device="cpu")
            write_las(f"{w}/pair.{i + 1}.{j + 1}.las", la)
    return w, blocks, port


@pytest.mark.parametrize("world", (1, 3))
def test_ring_records_equal_the_sweeps_pair_files(runs, world):
    w, blocks, port = runs
    n = len(blocks)
    assert n == 3
    for i in range(n):
        path = f"{w}/ring.{world}.{i}.las"
        with open(path, "wb") as f:
            f.write(port[(world, "sweep")]["shards"][i])
        shard = read_las(path)
        bread = shard.columns.headers[:, 8]
        for j in range(i + 1, n):
            rows = np.nonzero(np.isin(bread, blocks[j].ids))[0]
            part = LasFile(shard.tspace, columns=shard.columns.permute(rows))
            out = f"{w}/ring.{world}.{i}.{j}.las"
            write_las(out, part)
            with open(out, "rb") as f:
                got = f.read()
            for want in (f"{w}/E.{i + 1}.E.{j + 1}.las",
                         f"{w}/pair.{i + 1}.{j + 1}.las"):
                with open(want, "rb") as g:
                    assert len(rows) > 0 and got == g.read(), (i, j, want)
