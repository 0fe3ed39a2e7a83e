"""Many streams on one card: the port's batched replay and the kernels'
vmap rules, on the CPU.

* The slice as a whole: the port's make_batched_e2e_replay against the
  JAX package's (``jax.vmap`` of its replay under ``jax.jit``), B = 2
  streams with tracker seeds 0 and 1, in float64, on
  tests/test_torch_e2e.py's stream (120x160) cut to T = 30 frames, row
  b's filter starting from (1 + b) times the initial covariance (the
  stream is clean: its RANSAC draws pick the same inliers, so the seeds
  alone would give equal rows, which could not show a row mixed into
  another). The port gets each row's JAX Gumbel draws injected and runs
  with KLT_EPS = 0. Per row: the same init frame, identical update counts
  and ZUPT flags, and p within 1e-6 m (P_TOL). Each port row also equals
  the port's single-stream replay within 1e-9 m: vmap batches the
  products (CPU bmm against mm), which rounds some sums in another order.
* Rows whose trackers differ: row b (seed b) starts its stream on frame
  2 b, so from frame 4, where the batch starts, the rows track other
  features under other ids. The batch draws each row's RANSAC noise from
  the row's own generator (stack_tracker_states): the draws are the
  single stream's, frame by frame. Each row's tracker state (ids,
  positions, descriptors, generator) and outs equal its single-stream
  replay's, within 1e-8.
* A batched vio_step with one row initialized and one not (the init step
  and the filter step both run, each row takes its own) against
  vio_step row by row.
* Each kernel's vmap rule against a loop of single calls, exactly: K4
  (cov_update) with P, K, HP batched, with HP or P shared, with nb < D;
  K2's level route (lk_level_src) with the levels batched, shared, and
  shared through a batch stride of 0 (what vmap hands back for an
  unbatched output); K1 (dma_gather_tiles) with the images batched and
  shared. Each batched call reaches the plain version once: no loop over
  rows.
* No window that window_origins places straddles two images stacked on
  their first axis, which K2's rule relies on.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orcvio_tpu.config.core import FilterConfig as JaxFilterConfig
from orcvio_tpu.eval import staged as jstaged
from orcvio_tpu.frontend.tracker import TrackerConfig as JaxTrackerConfig
from orcvio_tpu.frontend.tracker import TrackerState as JaxTrackerState
from orcvio_tpu.vio import VioState as JaxVioState
from orcvio_tpu_torch.config.core import FilterConfig
from orcvio_tpu_torch.dataio import euroc_writer as pwriter
from orcvio_tpu_torch.dataio import synthetic as psyn
from orcvio_tpu_torch.eval import staged as pstaged
from orcvio_tpu_torch.eval.staged import (make_batched_e2e_replay,
                                          make_e2e_replay, make_tracker_scan,
                                          stage_sequence)
from orcvio_tpu_torch.filter.pipeline import FrameInput, build_chi2_table
from orcvio_tpu_torch.tree import tree_index, tree_stack
from orcvio_tpu_torch.frontend import klt as pklt
from orcvio_tpu_torch.frontend import ransac as pransac
from orcvio_tpu_torch.frontend.image import build_pyramid
from orcvio_tpu_torch.frontend.tracker import (TrackerConfig, TrackerState,
                                               stack_tracker_states)
from orcvio_tpu_torch.ops import cov_update as k4
from orcvio_tpu_torch.ops import dma_gather as k1
from orcvio_tpu_torch.ops import lk_pallas as k2
from orcvio_tpu_torch.ops.window_gather import (prepare_image, window_offsets,
                                                window_origins)
from orcvio_tpu_torch.vio import VioState, batched_vio_step, vio_step
from tests.test_torch_e2e import (FILTER, N, P_TOL, SIM, TRACKER, WC,
                                  _gumbels, init_frame)

torch.set_num_threads(1)

T = 30
SEEDS = (0, 1)
ROW_TOL = 1e-9  # a batched row against its single-stream replay (port)
R_B2C, T_C_B = pwriter.R_B2C_DOWN, np.asarray(WC.t_c_b)


@pytest.fixture(scope="module")
def stream():
    sim = psyn.SimConfig(n_frames=T, **SIM)
    return pwriter.make_stream(sim, WC, device="cpu")


@pytest.fixture(scope="module")
def inputs(stream):
    import chip_smoke as cs

    return cs.bench_inputs(stream)


@pytest.fixture(scope="module")
def gumbels():
    """Each row's JAX RANSAC draws, (B, T, 128, 8, N)."""
    jtc = JaxTrackerConfig(**TRACKER)
    return torch.stack([_gumbels(JaxTrackerState.create(
        jtc, jnp.float64, seed=s).rng, T) for s in SEEDS])


def _prior(vs, b):
    """Row b's filter state: the initial covariance times 1 + b."""
    return vs.replace(filter=vs.filter.replace(P=vs.filter.P * (1 + b)))


@pytest.fixture(scope="module")
def jax_outs(inputs):
    jtc, jcfg = JaxTrackerConfig(**TRACKER), JaxFilterConfig(**FILTER)
    stack = lambda *xs: jnp.stack(xs)  # noqa: E731
    jts = jax.tree.map(stack, *(JaxTrackerState.create(jtc, jnp.float64,
                                                       seed=s) for s in SEEDS))
    jvs = jax.tree.map(stack, *(_prior(JaxVioState.create(
        jcfg, N, jnp.float64), b) for b in range(len(SEEDS))))
    replay = jax.jit(jstaged.make_batched_e2e_replay(jcfg, jtc, R_B2C, T_C_B,
                                                     jnp.float64))
    _, outs = replay(jts, jvs, jstaged.stage_sequence(*inputs, jnp.float64))
    return {k: np.asarray(v) for k, v in outs.items()}


@pytest.fixture(scope="module")
def port(inputs, gumbels):
    """The port's batched replay, and each row's single-stream replay, with
    the rows' JAX draws."""
    mp = pytest.MonkeyPatch()
    mp.setattr(pklt, "KLT_EPS", 0.0)
    try:
        tc, cfg = TrackerConfig(**TRACKER), FilterConfig(**FILTER)
        staged = stage_sequence(*inputs, torch.float64, device="cpu")
        replay = make_batched_e2e_replay(cfg, tc, R_B2C, T_C_B,
                                         torch.float64, device="cpu")
        (tsb, vsb), outs = replay(
            stack_tracker_states([TrackerState.create(
                tc, torch.float64, seed=s, device="cpu") for s in SEEDS]),
            tree_stack([_prior(VioState.create(cfg, N, torch.float64,
                                               device="cpu"), b)
                        for b in range(len(SEEDS))]),
            staged, ransac_gumbel=gumbels)
        single = make_e2e_replay(cfg, tc, R_B2C, T_C_B, torch.float64,
                                 device="cpu")
        singles = [single(
            TrackerState.create(tc, torch.float64, device="cpu"),
            _prior(VioState.create(cfg, N, torch.float64, device="cpu"), b),
            staged, ransac_gumbel=gumbels[b])[1] for b in range(len(SEEDS))]
    finally:
        mp.undo()
    return ({k: v.numpy() for k, v in outs.items()}, vsb, tsb,
            [{k: v.numpy() for k, v in o.items()} for o in singles])


def test_rows_init_on_jax_frames(jax_outs, port):
    outs, vsb, tsb, _ = port
    assert outs["p"].shape == jax_outs["p"].shape == (len(SEEDS), T, 3)
    for b in range(len(SEEDS)):
        k0 = init_frame(jax_outs["R"][b])
        assert k0 is not None and 5 <= k0 < T - 10, k0
        assert init_frame(outs["R"][b]) == k0
        np.testing.assert_array_equal(outs["initialized"][b],
                                      np.arange(T) >= k0)
    assert vsb.host_initialized
    assert len(tsb.rng) == len(SEEDS) and tsb.fid.shape == (len(SEEDS), N)


@pytest.mark.parametrize("field", ["n_upd", "zupt"])
def test_row_decisions_identical(jax_outs, port, field):
    outs = port[0]
    np.testing.assert_array_equal(outs[field], jax_outs[field])
    if field == "n_upd":
        assert (jax_outs["n_upd"].sum(axis=1) > 0).all()


@pytest.mark.parametrize("field", ["p", "R", "v"])
def test_row_poses_match_jax(jax_outs, port, field):
    outs = port[0]
    err = np.abs(outs[field] - jax_outs[field]).reshape(len(SEEDS), T, -1)
    assert err.max() < P_TOL, np.unravel_index(err.argmax(), err.shape)


def test_rows_differ(jax_outs, port, gumbels):
    """The rows' draws and their filters' estimates differ."""
    assert not torch.equal(gumbels[0], gumbels[1])
    for outs in (jax_outs, port[0]):
        assert np.abs(outs["p"][0] - outs["p"][1]).max() > 1e-4


@pytest.mark.parametrize("b", range(len(SEEDS)))
def test_row_equals_single_stream_replay(port, b):
    outs, _, _, singles = port
    one = singles[b]
    for field in ("initialized", "n_upd", "zupt"):
        np.testing.assert_array_equal(outs[field][b], one[field])
    for field in ("p", "R", "v"):
        assert np.abs(outs[field][b] - one[field]).max() < ROW_TOL, field


# --- rows whose trackers differ ---

# The frame each row's stream starts on: even frames. The tracker detects
# on even frames only (detect_every = 2), and a stream whose first frame
# holds no features never initializes: static init keeps its first frame
# as the reference until a frame is static against it.
STARTS = (0, 2, 4)
S0 = max(STARTS)  # the frame the batch starts on
# A staggered row against its single stream: its filter carries vmap's
# reordered sums (1e-16 relative) through more frames than the rows above
# do, to some 1e-9.
STAGGER_TOL = 1e-8


@pytest.fixture(scope="module")
def staggered(inputs):
    """Rows whose trackers differ: row b (seed b) starts its stream on
    frame STARTS[b], so when the batch starts on frame S0 each row has
    tracked other frames, with other features and ids. The batch draws
    each row's RANSAC noise from the row's own generator
    (stack_tracker_states). Returns, for the batched replay over [S0, T)
    and each row's single-stream replay over [STARTS[b], T): the final
    tracker state, the outs, the tracker's (fid, xy, uvn) after each
    frame, and the noise drawn, frame by frame."""
    import chip_smoke as cs

    tc, cfg = TrackerConfig(**TRACKER), FilterConfig(**FILTER)
    f64 = torch.float64
    staged = stage_sequence(*inputs, f64, device="cpu")
    single = make_e2e_replay(cfg, tc, R_B2C, T_C_B, f64, device="cpu")
    batched = make_batched_e2e_replay(cfg, tc, R_B2C, T_C_B, f64,
                                      device="cpu")

    def fresh(b):
        return (TrackerState.create(tc, f64, seed=b, device="cpu"),
                VioState.create(cfg, N, f64, device="cpu"))

    pre = [fresh(b) if s == S0 else
           single(*fresh(b), staged, frames=range(s, S0))[0]
           for b, s in enumerate(STARTS)]
    draws = {"batched": [], "single": []}
    mp = pytest.MonkeyPatch()
    for module, key in ((pstaged, "batched"), (pransac, "single")):
        fn = module.draw_gumbel
        mp.setattr(module, "draw_gumbel",
                   lambda *a, _fn=fn, _key=key, **kw:
                   draws[_key].append(_fn(*a, **kw)) or draws[_key][-1])
    try:
        (tsb, _), outs, tracks = cs.frame_by_frame(batched, (
            stack_tracker_states([p[0] for p in pre]),
            tree_stack([p[1] for p in pre])), staged, range(S0, T))
        singles = []
        for b, s in enumerate(STARTS):
            n0 = len(draws["single"])
            (ts, _), one, one_tracks = cs.frame_by_frame(
                single, fresh(b), staged, range(s, T))
            singles.append((ts, one, one_tracks[S0 - s:],
                            draws["single"][n0:][S0 - s:]))
    finally:
        mp.undo()
    return (tsb, outs, tracks, draws["batched"]), singles


@pytest.mark.parametrize("b", range(len(STARTS)))
def test_staggered_row_tracks_as_its_single_stream(staggered, b):
    """Row b's tracker, frame by frame, equals its single stream's: ids,
    positions and normalized coordinates; and after the last frame its
    descriptors, next id and generator state."""
    (tsb, _, tracks, _), singles = staggered
    ts, _, one_tracks, _ = singles[b]
    assert len(tracks) == len(one_tracks) == T - S0
    for (fid, xy, uvn), (fid1, xy1, uvn1) in zip(tracks, one_tracks):
        assert torch.equal(fid[b], fid1)
        assert (xy[b] - xy1).abs().max() < STAGGER_TOL
        assert (uvn[b] - uvn1).abs().max() < STAGGER_TOL
    for name in ("next_id", "desc"):
        assert torch.equal(getattr(tsb, name)[b], getattr(ts, name)), name
    assert torch.equal(tsb.rng[b].get_state(), ts.rng.get_state())


@pytest.mark.parametrize("b", range(len(STARTS)))
def test_staggered_row_draws_its_own_noise(staggered, b):
    """Each frame the batch draws row b's noise from row b's generator:
    the draws a row gets over [S0, T) are its single stream's."""
    (_, _, _, batched_draws), singles = staggered
    own = singles[b][3]
    assert len(own) == T - S0
    assert len(batched_draws) == len(STARTS) * (T - S0)
    got = batched_draws[b::len(STARTS)]
    assert all(torch.equal(g, w) for g, w in zip(got, own))


@pytest.mark.parametrize("b", range(len(STARTS)))
def test_staggered_row_equals_single_stream_replay(staggered, b):
    (_, outs, _, _), singles = staggered
    one = {k: v[S0 - STARTS[b]:] for k, v in singles[b][1].items()}
    for field in ("initialized", "n_upd", "zupt"):
        assert torch.equal(outs[field][b], one[field]), field
    for field in ("p", "R", "v"):
        err = (outs[field][b] - one[field]).abs().max()
        assert err < STAGGER_TOL, (field, float(err))
    assert bool(one["initialized"][-1]) and int(one["n_upd"].sum()) > 0


def test_staggered_rows_differ(staggered):
    """The rows' trackers hold other features under other ids, from the
    batch's first frame on and on a third of its frames at least (the
    clean stream's detections then converge to the same corners), so a
    row mixed into another would fail its parity."""
    (tsb, outs, tracks, _), _ = staggered
    for a in range(len(STARTS)):
        for b in range(a + 1, len(STARTS)):
            apart = [not torch.equal(fid[a], fid[b])
                     and not torch.equal(xy[a], xy[b])
                     for fid, xy, _ in tracks]
            assert apart[0] and sum(apart) >= len(tracks) // 3, (a, b,
                                                                 apart)
            assert not torch.equal(tsb.next_id[a], tsb.next_id[b])
            assert (outs["p"][a] - outs["p"][b]).abs().max() > 1e-4


# --- a batched vio_step, one row initialized and one not ---

@pytest.fixture(scope="module")
def vio_frames(inputs, gumbels):
    """FrameInputs of the stream (row 0's draws) and the states vio_step
    reaches on them, after each frame."""
    tc, cfg = TrackerConfig(**TRACKER), FilterConfig(**FILTER)
    mp = pytest.MonkeyPatch()
    mp.setattr(pklt, "KLT_EPS", 0.0)
    try:
        _, frames = make_tracker_scan(tc, R_B2C, torch.float64, device="cpu")(
            TrackerState.create(tc, torch.float64, device="cpu"),
            stage_sequence(*inputs, torch.float64, device="cpu"),
            ransac_gumbel=gumbels[0])
    finally:
        mp.undo()
    chi2 = build_chi2_table(cfg, torch.float64, "cpu")
    vs = VioState.create(cfg, N, torch.float64, device="cpu")
    vs = vs.replace(filter=vs.filter.replace(
        R_b2c=torch.as_tensor(R_B2C), t_c_b=torch.as_tensor(T_C_B)))
    states = [vs]
    for k in range(T):
        vs, _ = vio_step(cfg, vs, FrameInput(*(x[k] for x in frames)), chi2)
        states.append(vs)
    return cfg, chi2, frames, states


@pytest.mark.parametrize("lag", [0, 1], ids=["inits_now", "waits"])
def test_mixed_init_rows_take_their_own_branch(vio_frames, lag):
    """Row 0 is not initialized (it initializes on this frame, or waits);
    row 1 runs the filter. Each equals vio_step on its own row."""
    cfg, chi2, frames, states = vio_frames
    k0 = next(k for k, s in enumerate(states) if bool(s.filter.initialized))
    ks = (k0 - 1 - lag, k0 + 3)  # states before frame k: states[k]
    rows = [states[k].replace(host_initialized=False) for k in ks]
    assert [bool(r.filter.initialized) for r in rows] == [False, True]
    fr = [FrameInput(*(x[k] for x in frames)) for k in ks]
    bst, bout = batched_vio_step(cfg, tree_stack(rows), tree_stack(fr), chi2)
    assert not bst.host_initialized
    for b, (row, f) in enumerate(zip(rows, fr)):
        st, out = vio_step(cfg, row, f, chi2)
        got = tree_index(bout, b)
        assert bool(got.zupt == out.zupt)
        assert bool(got.n_update_features == out.n_update_features)
        for name in ("p", "R", "v"):
            assert torch.allclose(getattr(got, name), getattr(out, name),
                                  rtol=0, atol=1e-12), (b, name)
        assert bool(tree_index(bst, b).filter.initialized
                    == st.filter.initialized)
        assert torch.allclose(tree_index(bst, b).filter.P, st.filter.P,
                              rtol=0, atol=1e-12)
    assert [bool(x) for x in bst.filter.initialized] == [lag == 0, True]


def test_all_initialized_rows_stop_reading_the_flag(vio_frames):
    cfg, chi2, frames, states = vio_frames
    ks = (T - 2, T - 1)
    rows = tree_stack([states[k].replace(host_initialized=False)
                       for k in ks])
    fr = tree_stack([FrameInput(*(x[k] for x in frames)) for k in ks])
    bst, _ = batched_vio_step(cfg, rows, fr, chi2)
    assert bst.host_initialized


# --- the kernels' vmap rules against loops of single calls ---

def _count_calls(monkeypatch, module, name):
    calls = []
    fn = getattr(module, name)

    def spy(*a, **kw):
        calls.append(1)
        return fn(*a, **kw)

    monkeypatch.setattr(module, name, spy)
    return calls


def _k4_rows(B, D, q, seed):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(B, D, D))
    P = A @ A.transpose(0, 2, 1) / D
    K = rng.normal(size=(B, D, q)) * 0.1
    H = rng.normal(size=(B, q, D)) * 0.1
    return [torch.as_tensor(x) for x in (P, K, H @ P)]


@pytest.mark.parametrize("case", ["batched", "HP_shared", "P_shared",
                                  "nb"])
def test_cov_update_rule_equals_single_calls(monkeypatch, case):
    B, D, q = 3, 20, 7
    P, K, HP = _k4_rows(B, D, q, 5)
    nb = 14 if case == "nb" else D
    dims = [0, 0, 0]
    if case == "HP_shared":
        HP, dims[2] = HP[0], None
    if case == "P_shared":
        P, dims[0] = P[0], None
    calls = _count_calls(monkeypatch, k4, "cov_update_plain")
    got = torch.func.vmap(lambda p, k, hp: k4.cov_update(p, k, None, hp, nb),
                          in_dims=tuple(dims))(P, K, HP)
    assert len(calls) == 1
    row = lambda x, d, b: x if d is None else x[b]  # noqa: E731
    want = torch.stack([k4.cov_update(*(row(x, d, b) for x, d in
                                         zip((P, K), dims[:2])), None,
                                      row(HP, dims[2], b), nb)
                        for b in range(B)])
    assert torch.equal(got, want)
    assert torch.equal(got, got.mT)
    if case == "nb":
        assert torch.equal(got[:, nb:, nb:], P[:, nb:, nb:])


def _levels(B, seed, H=96, W=128):
    """B smooth random (Hp, Wp) padded levels, and their AlignedImage."""
    rng = np.random.default_rng(seed)
    imgs = []
    for _ in range(B):
        base = np.kron(rng.normal(size=(H // 8, W // 8)), np.ones((8, 8)))
        k = np.ones(5) / 5.0
        for ax in (0, 1):
            base = np.apply_along_axis(lambda v: np.convolve(v, k, "same"),
                                       ax, base)
        imgs.append(base * 50.0 + 128.0)
    return [prepare_image(torch.as_tensor(im, dtype=torch.float32)[None],
                          pklt.MARGIN) for im in imgs]


def _k2_rows(B, N, seed):
    """Per row: both levels' padded images, offsets and aux, as the
    tracker's level route forms them for a 1.5 px shift."""
    ais0, ais1 = _levels(B, seed), _levels(B, seed + 1)
    rng = np.random.default_rng(seed)
    out = []
    for ai0, ai1 in zip(ais0, ais1):
        xy = torch.as_tensor(rng.uniform([10, 10], [118, 86], size=(N, 2)),
                             dtype=torch.float32)
        lw0 = pklt.gather_level(ai0, xy, cut=False)
        lw1 = pklt.gather_level(ai1, xy + 1.5, cut=False)
        aux, _, _ = pklt._level_aux(lw0, lw1, xy, xy + 1.5, 15)
        out.append((ai0.padded[0], lw0.offset, ai1.padded[0], lw1.offset,
                    aux))
    return [torch.stack(x) for x in zip(*out)]


@pytest.mark.parametrize("case", ["batched", "img0_shared", "both_shared",
                                  "stride0"])
def test_lk_level_src_rule_equals_single_calls(monkeypatch, case):
    B, N = 3, 12
    img0, off0, img1, off1, aux = _k2_rows(B, N, 7)
    dims = [0, 0, 0, 0, 0]
    if case in ("img0_shared", "both_shared"):
        img0, dims[0] = img0[0], None
    if case == "both_shared":
        img1, dims[2] = img1[0], None
    if case == "stride0":  # as vmap hands back an unbatched output
        img0 = img0[0].expand(B, *img0.shape[1:])
    calls = _count_calls(monkeypatch, k2, "lk_level_src_plain")
    args = (img0, off0, img1, off1, aux)
    got = torch.func.vmap(lambda *a: k2.lk_level_src(*a, 10, 15, 0.01),
                          in_dims=tuple(dims))(*args)
    assert len(calls) == 1
    want = torch.stack([k2.lk_level_src(
        *(x if d is None else x[b] for x, d in zip(args, dims)), 10, 15,
        0.01) for b in range(B)])
    assert got.shape == (B, N, 8) and torch.equal(got, want)
    assert bool(torch.isfinite(got).all())


@pytest.mark.parametrize("shared", [False, True], ids=["batched", "shared"])
def test_dma_gather_rule_equals_single_calls(monkeypatch, shared):
    B, C, N = 3, 2, 9
    rng = np.random.default_rng(11)
    imgs = torch.as_tensor(rng.normal(size=(B, C, 64, 512)),
                           dtype=torch.float32)
    r0 = torch.as_tensor(rng.integers(-1, 8, size=(B, N)), dtype=torch.int32)
    c0 = torch.as_tensor(rng.integers(-1, 4, size=(B, N)), dtype=torch.int32)
    bidx = torch.as_tensor(rng.integers(-1, C + 1, size=(B, N)),
                           dtype=torch.int32)
    if shared:
        imgs = imgs[0]
    calls = _count_calls(monkeypatch, k1, "dma_gather_tiles_plain")
    got = torch.func.vmap(lambda *a: k1.dma_gather_tiles(*a, 6, 2),
                          in_dims=(None if shared else 0, 0, 0, 0))(
        imgs, r0, c0, bidx)
    assert len(calls) == 1
    want = torch.stack([k1.dma_gather_tiles(imgs if shared else imgs[b],
                                            r0[b], c0[b], bidx[b], 6, 2)
                        for b in range(B)])
    assert got.shape == (B, N, 48, 256) and torch.equal(got, want)


@pytest.mark.parametrize("margin", [pklt.MARGIN, 4])
def test_windows_never_straddle_stacked_images(margin):
    """Every (48, 256) window window_origins places, for centres inside,
    on and far beyond the image's edges, lies inside its own padded image:
    read from the images stacked as (B Hp, Wp) at offset b Hp Wp + off, it
    stays in rows [b Hp, (b + 1) Hp)."""
    H, W = 240, 320
    img = torch.as_tensor(np.random.default_rng(2).normal(size=(1, H, W)),
                          dtype=torch.float32)
    for lv_img in build_pyramid(img[0], 3):
        ai = prepare_image(lv_img[None], margin)
        h, w = ai.shape
        xy = torch.as_tensor(np.random.default_rng(3).uniform(
            [-3 * w, -3 * h], [4 * w, 4 * h], size=(400, 2)),
            dtype=torch.float32)
        r0, c0, _ = window_origins(ai, xy, -(pklt.SEARCH_WD // 2), pklt.ROWS,
                                   2 * pklt.LANES)
        off = window_offsets(ai, r0, c0)
        Hp, Wp = ai.padded.shape[-2:]
        row, col = off // Wp, off % Wp
        assert bool((row >= 0).all() and (row + pklt.ROWS <= Hp).all())
        assert bool((col >= 0).all() and (col + 2 * pklt.LANES <= Wp).all())
