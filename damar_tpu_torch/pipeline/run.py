"""Helpers of damar_tpu/pipeline/run.py's phases that the ported stages
need.  run_pipeline itself is not ported: its phase 7 (graph, tour,
consensus) waits for those modules."""
from __future__ import annotations

import numpy as np

from damar_tpu_torch.core.blocks import block_from_reads
from damar_tpu_torch.formats.las import H_AREAD, H_BREAD


def _reads_subset_block(db, las, rows, side: str):
    """A ReadBlock holding exactly the reads the given columnar rows
    reference on one side ("a" or "b"): the retrace of merged piles
    whose B (or A) reads span blocks, without loading the whole DB."""
    col = H_AREAD if side == "a" else H_BREAD
    ids = np.unique(las.columns.headers[np.asarray(rows), col])
    return block_from_reads([db.read_seq(int(r)) for r in ids], ids=ids)
