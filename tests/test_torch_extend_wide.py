"""Port vs reference for the wide extension: extend_wave_wide (on the
CPU, over dp_rows_plain) must equal damar_tpu's extend_wave_pl (Pallas
in interpret mode, as tests/test_wave_pallas.py runs it) and extend_wave
at the same chunk (R = 128), on utils.sim batches: forward, reverse and
mixed directions, origins off word boundaries, windows past both pool
edges, alim = 0 slots, x-drop stops, a max_rows cut, and several batches
under a small byte cap.  And the .las bytes of a small self pair with
dp_kernel="wide" against the reference's wide route.  Tolerance: exact
equality (integers, bytes)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from damar_tpu.core.blocks import block_from_reads as ref_block
from damar_tpu.core.config import OverlapConfig as RefConfig
from damar_tpu.ops.wave import extend_wave
from damar_tpu.ops.wave import reduce_best_lanes as ref_reduce
from damar_tpu.ops.wave_pallas import extend_wave_pl
from damar_tpu.pipeline import overlap as ref_ov
from damar_tpu.utils.sim import make_genome, sample_reads
from damar_tpu_torch.core.blocks import block_from_reads
from damar_tpu_torch.core.config import OverlapConfig
from damar_tpu_torch.ops import wave_wide
from damar_tpu_torch.pipeline import overlap as ov
from damar_tpu_torch.utils import sim
from test_torch_slice import assert_same_las

torch.set_num_threads(2)
NAMES = ("va", "vb", "d", "score")


def port(batch, **kw):
    A, B, ao, bo, alim, blim = (torch.as_tensor(x) for x in batch[:6])
    return [x.numpy() for x in wave_wide.extend_wave_wide(
        A, B, ao, bo, alim, blim, **kw)]


def reference(fn, batch, **kw):
    if kw.get("dirs") is not None:
        kw = dict(kw, dirs=jnp.asarray(kw["dirs"]))
    return [np.asarray(x) for x in fn(*map(jnp.asarray, batch[:6]), **kw)]


def same(got, want, what):
    for name, x, y in zip(NAMES, got, want):
        np.testing.assert_array_equal(x, y, err_msg=f"{what}: {name}")


def directions(rev):
    """(reference kwargs, port kwargs) for all-forward, all-reverse (the
    static flag) and the batch's own mixed directions."""
    return {"forward": (dict(reverse=False), dict(reverse=False)),
            "reverse": (dict(reverse=True), dict(reverse=True)),
            "mixed": (dict(dirs=rev), dict(dirs=torch.as_tensor(rev)))}


@pytest.mark.parametrize("mode", ["forward", "reverse", "mixed"])
def test_matches_pallas_interpret(mode):
    """40 units (not a multiple of the reference's seed block) against
    the Pallas kernel in interpret mode."""
    batch = sim.unit_batch(np.random.default_rng(21), 40, max_len=900)
    rk, pk = directions(batch[6])[mode]
    same(port(batch, **pk), reference(extend_wave_pl, batch, **rk), mode)


@pytest.mark.parametrize("case", ["mixed-300", "long", "edges", "dead",
                                  "noise", "max_rows", "batches"])
def test_matches_extend_wave_same_chunk(case, monkeypatch):
    """Against the pure-JAX extension at R = 128 (the chunk the Pallas
    wrapper uses, so x-drop stops and recentres fall on the same rows).
    Past the pool's ends the two reference forms read different clipped
    chars (by byte, by word), so that case takes the Pallas wrapper,
    whose word clip is the port's."""
    rng = np.random.default_rng(31)
    kw, pkw = {}, {}
    if case == "mixed-300":
        batch = sim.unit_batch(rng, 300)
    elif case == "long":            # many chunks, recentring drift
        batch = sim.unit_batch(rng, 24, min_len=3000, max_len=6000)
    elif case == "edges":           # windows past both pool ends
        batch = sim.edge_units(rng, 64)
    elif case == "dead":            # alim = 0 slots among live ones
        batch = list(sim.unit_batch(rng, 120))
        batch[4] = np.where(np.arange(120) % 3 == 0, 0, batch[4])
    elif case == "noise":           # unrelated sequence: x-drop stops
        A, B, ao, bo, alim, blim, rv = sim.unit_batch(rng, 80)
        B = rng.integers(0, 4, len(B)).astype(np.uint8)
        batch = (A, B, ao, bo, alim, blim, rv)
    elif case == "max_rows":
        batch = sim.unit_batch(rng, 100)
        kw = pkw = dict(max_rows=256)
    else:                           # several batches under a byte cap
        batch = sim.unit_batch(rng, 150)
        monkeypatch.setattr(wave_wide, "EXT_STEP_BYTES",
                            40 * wave_wide._ext_unit_bytes(128, 128))
    rv = batch[6]
    got = port(batch, dirs=torch.as_tensor(rv), **pkw)
    if case == "edges":
        want = reference(extend_wave_pl, batch, dirs=rv)
    else:
        want = reference(extend_wave, batch, dirs=rv, R=128, **kw)
    same(got, want, case)
    if case == "noise":
        assert (got[0] < batch[4]).mean() > 0.9      # most stopped early
    if case == "dead":
        dead = batch[4] == 0
        assert all((g[dead] == 0).all() for g in got)


def test_reduce_best_lanes_matches():
    rng = np.random.default_rng(5)
    t = [rng.integers(-3, 4, (200, 128)).astype(np.int32) for _ in range(4)]
    t[0][:10] = -5                                  # best score <= 0
    got = wave_wide.reduce_best_lanes(*map(torch.as_tensor, t))
    want = ref_reduce(*map(jnp.asarray, t))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_cuda_tensor_never_takes_the_plain_version(monkeypatch):
    """On a CUDA tensor dp_rows launches the kernel or raises: here, with
    no card, the kernel build must be what is reached."""
    def kernel(*a, **k):
        raise RuntimeError("kernel reached")
    monkeypatch.setattr(wave_wide, "dp_rows_kernel", kernel)

    class FakeCuda:
        type = "cuda"

    class D:
        device = FakeCuda()
    with pytest.raises(RuntimeError, match="kernel reached"):
        wave_wide.dp_rows(D(), *[None] * 11, R=128)


def test_bad_dp_kernel_raises():
    with pytest.raises(ValueError, match="dp_kernel"):
        ov._dp_kernel(OverlapConfig(dp_kernel="pallas"))


@pytest.fixture(scope="module")
def reads():
    g = make_genome(8_000, seed=17)
    return sample_reads(g, coverage=6.0, mean_len=1200, err=0.14,
                        seed=18).reads


def test_wide_self_pair_las_bytes(reads, monkeypatch, tmp_path):
    """dp_kernel="wide" end to end: one wide extension phase per
    orientation and the wide trace as the main trace.  The reference
    runs its wide route (use_pallas=False: ops.wave) with the extension
    at the Pallas wrapper's chunk of 128 rows, which is the port's.
    seed_cap bounds the reference's padded unit slots (2 x 512 wide
    rows a chunk in place of 2 x 8192), which is what its time goes to."""
    from functools import partial
    from damar_tpu import native
    from damar_tpu.ops import wave as ref_wave
    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setenv("DAMAR_BP", "jax")
    ref_cfg = RefConfig(dp_kernel="wide", use_pallas=False, min_len=400)
    monkeypatch.setattr(
        ref_ov, "_kernels",
        lambda cfg: (partial(ref_wave.extend_wave, R=128),
                     ref_wave.trace_wave))
    rb = ref_block(reads)
    st = ref_ov.overlap_pair_device(rb, rb, ref_cfg, True, emit_mirrors=True,
                                    seed_cap=512)
    ref = ref_ov.overlap_pair_emit(st, trace_host=False)
    pb = block_from_reads(reads)
    cfg = OverlapConfig(dp_kernel="wide", min_len=400)
    got = ov.overlap_block_pair(pb, pb, cfg, True, emit_mirrors=True,
                                seed_cap=512, device="cpu")
    assert got[0].novl > 50
    assert_same_las(ref, got, tmp_path, pb.rlen)
