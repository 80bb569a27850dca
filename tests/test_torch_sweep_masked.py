"""Port vs reference for the block sweep with a soft-mask track (the
daligner -m input): run_overlap_plan(mask_names=...) over the 3-block DB
of tests/test_torch_sweep.py must write the reference's bytes in every
pair file and merged file.  Tolerance: byte equality; the reference on
its all-device route, as there."""
import numpy as np
import torch

from test_torch_sweep import device_route, reads, run_both  # noqa: F401

torch.set_num_threads(2)


def mask_track(db, seed=5):
    """Intervals that cover two reads in three whole and a stretch of the
    others (some running past the read's end: the vector clips them)."""
    rng = np.random.default_rng(seed)
    data = []
    for i, rl in enumerate(db.reads["rlen"]):
        if i % 3:
            data.append(np.array([0, rl], np.int32))
        else:
            b = int(rng.integers(0, rl))
            data.append(np.array([b, b + int(rng.integers(50, 400))],
                                 np.int32))
    return data


def test_masked_sweep_files_byte_equal(reads, device_route,  # noqa: F811
                                       tmp_path):
    run_both(reads, tmp_path, mask_data=mask_track)
