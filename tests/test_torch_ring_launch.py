"""The ring's launcher and its refusals, with no reference to hold: a
rank that raises while the others wait in a collective, and ranks that
outlive the launcher's timeout, end the launch with an error within its
timeout, every rank stopped; NCCL asked for two ranks on one card, and
the ring without a card unless the CPU is asked for, raise.  A ring's
card becomes its rank's current device (the kernels launch on the
current one, and a launch on another card raises).  A ring over a gloo
group smaller than the world gives the world-1 ring's bytes; an NCCL
one needs a gloo group of its ranks made by every rank.  This module
imports no jax: the spawned ranks import it for their targets."""
import os
import time

import numpy as np
import pytest
import torch

from damar_tpu_torch.core.blocks import block_from_reads
from damar_tpu_torch.core.config import OverlapConfig
from damar_tpu_torch.formats.las import write_las
from damar_tpu_torch.ops import _cuda
from damar_tpu_torch.parallel import distributed as dd


def fail_on_rank_1(group) -> None:
    """Rank 1 raises; the others wait for it in a barrier."""
    import torch.distributed as dist
    if dist.get_rank(group) == 1:
        raise RuntimeError("rank 1 fails on purpose")
    dist.barrier(group)


def sleep_long(group) -> None:
    time.sleep(600)


def test_a_failing_rank_ends_the_launch():
    """The first rank to end in an error is reported (rank 1, or a rank
    whose barrier lost it: gloo says the connection was closed or reset
    by its peer), long before the timeout."""
    from torch.multiprocessing import ProcessRaisedException
    t0 = time.time()
    with pytest.raises(ProcessRaisedException,
                       match="rank 1 fails on purpose|(closed|reset) by "
                             "peer"):
        dd.spawn_ranks(fail_on_rank_1, 3, timeout=120.0)
    assert time.time() - t0 < 60.0


def test_ranks_past_the_timeout_are_stopped():
    t0 = time.time()
    with pytest.raises(TimeoutError):
        dd.spawn_ranks(sleep_long, 2, timeout=15.0)
    assert time.time() - t0 < 45.0


def test_nccl_refuses_two_ranks_on_one_card():
    dd.check_devices("nccl", [("h", "cuda", 0), ("h", "cuda", 1),
                              ("g", "cuda", 0)])
    with pytest.raises(ValueError, match="two ranks on one card"):
        dd.check_devices("nccl", [("h", "cuda", 0), ("h", "cuda", 0)])
    with pytest.raises(ValueError, match="needs a CUDA device"):
        dd.check_devices("nccl", [("h", "cpu", None)])
    # gloo stages CUDA tensors through host memory: ranks may share one
    dd.check_devices("gloo", [("h", "cuda", 0), ("h", "cuda", 0)])


def test_no_card_raises_unless_the_cpu_is_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = np.random.default_rng(3).integers(0, 4, 3000).astype(np.uint8)
    blocks = [block_from_reads([g[o:o + 1500]], cap=1 << 12)
              for o in (0, 1000)]
    cfg = OverlapConfig(min_len=300)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dd.make_mesh()
    for fn in (dd.distributed_overlap, dd.distributed_overlap_las):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn(blocks, cfg)
    las, counts, total = dd.distributed_overlap_las(blocks, cfg,
                                                    device="cpu")
    assert sorted(las) == [0, 1] and total[1] > 0


def test_blocks_must_share_one_cap():
    a = block_from_reads([np.zeros(100, np.uint8)], cap=1 << 12)
    b = block_from_reads([np.zeros(100, np.uint8)], cap=1 << 13)
    with pytest.raises(ValueError, match="share one capacity"):
        dd.distributed_overlap([a, b], OverlapConfig(), device="cpu")


def test_payload_widths_raise_above_32_bits():
    wide = block_from_reads([np.zeros(1 << 17, np.uint8)] * 2)
    assert dd.payload_widths([wide]) == (2, 18)
    many = block_from_reads([np.zeros(4, np.uint8)] * (1 << 14))
    with pytest.raises(ValueError, match="> 32"):
        dd.payload_widths([wide, many])


def test_the_rings_card_becomes_the_current_device(monkeypatch):
    chosen = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "set_device", chosen.append)
    ring = dd.make_mesh(device="cuda:1")
    assert ring.device == torch.device("cuda", 1)
    assert chosen == [torch.device("cuda", 1)]
    # no device given: LOCAL_RANK's card (torchrun's contract)
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert dd.make_mesh().device == torch.device("cuda", 3)
    assert chosen[-1] == torch.device("cuda", 3)
    dd.make_mesh(device="cpu")
    assert len(chosen) == 2


def test_a_launch_on_another_card_raises(monkeypatch):
    class OnCard1:
        device = torch.device("cuda", 1)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    with pytest.raises(RuntimeError, match="set_device"):
        _cuda.stream_ptr(OnCard1())


def ring_blocks() -> list:
    g = np.random.default_rng(5).integers(0, 4, 4000).astype(np.uint8)
    return [block_from_reads([g[o:o + 1500]], ids=np.array([k]),
                             cap=1 << 12)
            for k, o in enumerate((0, 800, 1600, 2400))]


def ring_on_ranks_0_and_2(group, out: str) -> None:
    """Every rank makes the subgroup; ranks 0 and 2 sweep over it."""
    import torch.distributed as dist
    sub = dist.new_group([0, 2], backend="gloo")
    if dist.get_rank() in (0, 2):
        ring = dd.make_mesh(sub, device="cpu")
        assert (ring.rank, ring.right, ring.left) == (
            dist.get_rank() // 2, 2 - dist.get_rank(), 2 - dist.get_rank())
        las, _, _ = dd.distributed_overlap_las(ring_blocks(),
                                               OverlapConfig(min_len=300),
                                               ring)
        for i, lf in las.items():
            write_las(f"{out}/shard.{i}.las", lf)
    dist.barrier()


def test_a_ring_over_a_subgroup(tmp_path):
    """Three ranks, the ring over global ranks 0 and 2 (neighbours of
    each other): its shards are the world-1 ring's bytes."""
    dd.spawn_ranks(ring_on_ranks_0_and_2, 3, (str(tmp_path),),
                   timeout=120.0)
    las, _, total = dd.distributed_overlap_las(
        ring_blocks(), OverlapConfig(min_len=300), device="cpu")
    assert total[1] > 0
    for i, lf in las.items():
        write_las(f"{tmp_path}/one.{i}.las", lf)
        with open(f"{tmp_path}/one.{i}.las", "rb") as f, \
                open(f"{tmp_path}/shard.{i}.las", "rb") as g:
            assert f.read() == g.read(), f"shard {i}"
    assert sorted(os.listdir(tmp_path)) == sorted(
        [f"shard.{i}.las" for i in las] + [f"one.{i}.las" for i in las])


def test_an_nccl_subgroup_needs_a_gloo_group_of_its_ranks(monkeypatch):
    """dist.new_group is collective over the world, so the ring cannot
    make the gloo group of a smaller NCCL group on its ranks alone."""
    import torch.distributed as dist
    sub = object()
    monkeypatch.setattr(dist, "get_rank", lambda g=None: 0)
    monkeypatch.setattr(dist, "get_world_size",
                        lambda g=None: 2 if g is sub else 4)
    monkeypatch.setattr(dist, "get_backend", lambda g=None: "nccl")
    with pytest.raises(ValueError, match="meta="):
        dd.make_mesh(sub, device="cpu")
