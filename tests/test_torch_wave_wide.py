"""Port vs reference: the plain torch K3 behind damar_tpu_torch.ops.
wave_wide.dp_rows must equal damar_tpu's Pallas dp_rows (interpret mode
on the CPU) in trace mode and in track_best+recenter mode, and the port's
wide trace (trace_wave on the CPU = trace_wave_plain, and
trace_wave_steps over dp_rows_plain) must equal trace_wave_pl.  The
kernels' closed-form prefix-min is held against the reference's 7-step
scan.  Tolerance: exact equality (integer outputs); inputs from numpy
seeds."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from damar_tpu.ops.wave_pallas import dp_rows as dp_rows_ref
from damar_tpu.ops.wave_pallas import trace_wave_pl
from damar_tpu.utils.sim import mutate
from damar_tpu_torch.ops import wave_wide
from damar_tpu_torch.ops.words import pack_bases
from damar_tpu_torch.utils.sim import wide_trace_batch

torch.set_num_threads(2)
T = torch.as_tensor
W = 128
INF = 1 << 20


def _dp_inputs(seed, S=40, R=100, track=True):
    rng = np.random.default_rng(seed)
    lane = np.arange(W)
    D = np.where(lane >= W // 2, lane - W // 2, INF)[None, :].repeat(S, 0)
    D = (D + rng.integers(0, 3, (S, W)) * (D < INF)).astype(np.int32)
    D[rng.random((S, W)) < 0.05] = INF + 3        # values above INF too
    src = rng.integers(0, 4, (S, 256))          # >= R + W columns
    b = np.where(rng.random(src.shape) < 0.15,
                 rng.integers(0, 4, src.shape), src).astype(np.int32)
    a = src[:, W // 2:W // 2 + 128].astype(np.int32)
    vec = lambda lo, hi: rng.integers(lo, hi, S).astype(np.int32)  # noqa
    tr = (S, W) if track else (S,)
    trk = [rng.integers(-50, 50, tr).astype(np.int32) for _ in range(4)]
    return dict(D=D, a_chars=a, b_tile=b, vb_base=vec(-70, 10),
                p_base=vec(0, 500), blim=vec(0, 400),
                rows_limit=vec(-3, R + 5), active=vec(0, 2),
                best_s=trk[0], best_va=trk[1], best_vb=trk[2],
                best_d=trk[3], cont=vec(0, 2))


@pytest.mark.parametrize("seed", [1, 2])
@pytest.mark.parametrize("track,recenter", [(False, False), (True, True),
                                            (True, False), (False, True)])
def test_dp_rows_vs_pallas(seed, track, recenter):
    R = 100
    inp = _dp_inputs(seed, R=R, track=track)
    kw = dict(R=R, W=W, diff_cost=5, xdrop=60, track_best=track,
              recenter=recenter)
    cont = inp.pop("cont")
    ref = dp_rows_ref(*map(jnp.asarray, inp.values()),
                      cont=jnp.asarray(cont), SB=256, **kw)
    got = wave_wide.dp_rows(*map(T, inp.values()), cont=T(cont), **kw)
    names = "D act bs bva bvb bd drift".split()
    for n, x, y in zip(names, ref, got):
        np.testing.assert_array_equal(np.asarray(x), y.numpy(),
                                      err_msg=f"{n} s{seed}")


@pytest.fixture(scope="module")
def noisy_pair():
    rng = np.random.default_rng(3)
    core = rng.integers(0, 4, 1500).astype(np.uint8)
    A = np.concatenate([rng.integers(0, 4, 300).astype(np.uint8),
                        mutate(core, 0.14, rng)])
    B = np.concatenate([mutate(core, 0.14, rng),
                        rng.integers(0, 4, 300).astype(np.uint8)])
    return A, B


@pytest.mark.parametrize("tspace", [100, 126])
def test_trace_wave_vs_pallas(noisy_pair, tspace):
    A, B = noisy_pair
    S = 12
    z = np.zeros(S, np.int32)
    abp = np.full(S, 310, np.int32)
    abp[6:] = 377
    bbp = np.full(S, 12, np.int32)
    al = np.zeros(S, np.int32)
    bl = np.zeros(S, np.int32)
    al[:4] = min(len(A) - 310, 1200)
    bl[:4] = min(len(B) - 12, 1230)
    al[6:9] = 700
    bl[6:9] = 690
    args = (A, B, z, z, abp, bbp, al, bl)
    ref = trace_wave_pl(*map(jnp.asarray, args), tspace=tspace,
                        max_segs=24)
    got = wave_wide.trace_wave(*map(T, args), tspace=tspace, max_segs=24)
    for n, x, y in zip(("trace", "nseg", "dsum"), ref, got):
        np.testing.assert_array_equal(np.asarray(x), y.numpy(),
                                      err_msg=f"trace {n}")


def test_trace_wave_no_launch_on_cpu(noisy_pair):
    A, B = noisy_pair
    before = wave_wide.dp_rows.launches, wave_wide.trace_wave.launches
    z = np.zeros(2, np.int32)
    wave_wide.trace_wave(T(A), T(B), T(z), T(z), T(z + 300), T(z + 10),
                         T(z + 250), T(z + 240), max_segs=8)
    assert (wave_wide.dp_rows.launches,
            wave_wide.trace_wave.launches) == before


_REF = {}


def _batch_ref(tspace, max_segs, S):
    """A wide_trace_batch and trace_wave_pl's result on it (memoized: the
    routes below share it)."""
    key = (tspace, max_segs, S)
    if key not in _REF:
        batch = wide_trace_batch(np.random.default_rng(tspace + S), S,
                                 max_len=1500)
        ref = trace_wave_pl(*map(jnp.asarray, batch), tspace=tspace,
                            max_segs=max_segs)
        _REF[key] = batch, [np.asarray(x) for x in ref]
    return _REF[key]


@pytest.mark.parametrize("route", ["plain", "steps", "trace_wave"])
@pytest.mark.parametrize("tspace,max_segs", [(100, 24), (126, 24), (100, 6)])
def test_trace_wave_batch_vs_pallas(tspace, max_segs, route):
    """Extents that start and end off word boundaries, windows past both
    pool edges, commits that drift the band by tens of lanes, the
    d >= INF_I commit, alim = 0 rows, and (max_segs 6) the last slot
    overwritten past max_segs."""
    S = 24
    (A, B, *vecs), ref = _batch_ref(tspace, max_segs, S)
    aw, bw = pack_bases(T(A)), pack_bases(T(B))
    if route == "plain":
        got = wave_wide.trace_wave_plain(aw, bw, *map(T, vecs), tspace,
                                         max_segs)
    elif route == "steps":
        got = wave_wide.trace_wave_steps(aw, bw, *map(T, vecs), tspace,
                                         max_segs, wave_wide.dp_rows_plain)
    else:
        got = wave_wide.trace_wave(T(A), T(B), *map(T, vecs),
                                   tspace=tspace, max_segs=max_segs)
    for n, x, y in zip(("trace", "nseg", "dsum"), ref, got):
        np.testing.assert_array_equal(x, y.numpy(), err_msg=f"trace {n}")
    alim, blim = vecs[4], vecs[5]
    assert (alim == 0).any() and (ref[1][alim == 0] == 0).all()
    assert (ref[0][..., 0] == (alim + blim)[:, None]).any()
    if max_segs == 6:
        assert (ref[1] > max_segs).sum() > S // 4


def test_closed_form_scan_equals_reference_scan():
    """prefix_min (the reference's 7-step scan with its INF_I fill) equals
    min(INF_I, cummin(u)) lane for lane on rows that straddle INF_I,
    lanes 0-126 on any row; lane 127 never takes the fill, so it equals
    the closed form on DP rows, where u_127 <= D_128 + 1 - 127 =
    INF_I - 126 (the kernels' case), and may not on other rows."""
    rng = np.random.default_rng(12)
    n = 2000
    u = np.where(rng.random((n, W)) < 0.5,
                 rng.integers(INF - 300, INF + 300, (n, W)),
                 rng.integers(-200, 400, (n, W)))
    u[n // 2:] = rng.integers(INF - 300, INF + 300, (n - n // 2, W))
    u[-20:] = rng.integers(INF + 1, INF + 300, (20, W))
    closed = np.minimum(INF, np.minimum.accumulate(u, axis=1))
    got = wave_wide.prefix_min(T(u)).numpy()
    np.testing.assert_array_equal(got[:, :W - 1], closed[:, :W - 1])
    assert (got[:, W - 1] != closed[:, W - 1]).any()   # rows all above INF
    u[:, W - 1] = np.minimum(u[:, W - 1], INF - 126)
    closed = np.minimum(INF, np.minimum.accumulate(u, axis=1))
    np.testing.assert_array_equal(wave_wide.prefix_min(T(u)).numpy(),
                                  closed)
