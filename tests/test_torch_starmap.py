"""The StarMap network, its weights and its post-processing: the port
(orcvio_tpu_torch/models/) against the JAX package (orcvio_tpu/models/
starmap.py) on the CPU.

* The network at small widths (2 stacks, 16 features, hourglass depth 2
  and 1, and two modules a residual), 64 px: the JAX package's params
  (its init, BN entries redrawn from a seed) go through
  convert.starmap_state_dict_from_flax; both run in float64, within 1e-9.
* The shipped weights: the port's msgpack reader gives flax's arrays bit
  for bit; the converter takes every flax leaf once and fills every
  parameter and buffer; on 3 rendered crops the float32 outputs agree
  within 1e-5 and the detections match.
* Each post-processing function slot by slot, on heatmaps with plateaus
  (ties for top_k) and with fewer peaks than slots.
* The renderer, bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orcvio_tpu.dataio import render_object as jro
from orcvio_tpu.models import starmap as js
from orcvio_tpu_torch.convert import starmap_state_dict_from_flax
from orcvio_tpu_torch.dataio import render_object as pro
from orcvio_tpu_torch.models import starmap as ps
from orcvio_tpu_torch.models.flax_msgpack import restore
from starmap_world import jax_pretrained

torch.set_num_threads(2)
SMALL = [dict(n_stack=2, n_feats=16, n_out=5, hg_depth=2, n_modules=1),
         dict(n_stack=2, n_feats=16, n_out=5, hg_depth=1, n_modules=1),
         dict(n_stack=2, n_feats=16, n_out=5, hg_depth=2, n_modules=2)]
F64 = torch.float64


def _numpy_tree(tree):
    return jax.tree.map(lambda x: np.asarray(x), tree)


def _small_net(cfg, seed=0, size=64):
    """(JAX model, f64 variables as numpy trees, the port's model in f64,
    input NHWC)."""
    rng = np.random.default_rng(seed)
    m = js.StarMapNet(**cfg)
    x = rng.uniform(0, 1, (2, size, size, 3))
    v = m.init(jax.random.PRNGKey(seed), jnp.asarray(x, jnp.float32))
    params = _numpy_tree(v["params"])
    stats = _numpy_tree(v["batch_stats"])

    def redraw(path, a):
        name = path[-1].key
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, a.shape)
        if name in ("bias", "mean"):
            return rng.normal(0, 0.2, a.shape)
        return a.astype(np.float64)

    params = jax.tree_util.tree_map_with_path(redraw, params)
    stats = jax.tree_util.tree_map_with_path(redraw, stats)
    net = ps.StarMapNet(**cfg).to(F64).eval()
    net.load_state_dict(starmap_state_dict_from_flax(params, stats, cfg))
    return m, params, stats, net, x


def _apply(m):
    return jax.jit(lambda v, x: m.apply(v, x, train=False))


def _detect(m, params, stats, canon):
    """The JAX package's detect_keypoints on one crop, jitted."""
    return jax.jit(lambda crop: js.detect_keypoints(params, stats, m, crop,
                                                    canon))


def _nchw(x, dtype=F64):
    return torch.as_tensor(np.ascontiguousarray(np.moveaxis(x, -1, -3)),
                           dtype=dtype)


@pytest.mark.parametrize("cfg", SMALL, ids=lambda c: (
    f"depth{c['hg_depth']}_modules{c['n_modules']}"))
def test_small_network_float64_within_1e9(cfg):
    m, params, stats, net, x = _small_net(cfg)
    # eagerly: XLA compiles each op once for all three widths, faster
    # than a whole float64 program for each
    jo = m.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                 train=False)
    with torch.no_grad():
        po = net(_nchw(x))
    assert len(po) == len(jo) == cfg["n_stack"]
    for j, p in zip(jo, po):
        j = np.asarray(j)
        assert j.dtype == np.float64 and j.shape == (2, 16, 16, 5)
        np.testing.assert_allclose(np.moveaxis(p.numpy(), 1, -1), j,
                                   rtol=0, atol=1e-9)


def test_same_pad_is_xla_same():
    """The stem's stride-2 7x7 "SAME" padding: (2, 3) at 96 and 64 px, as
    flax pads; odd sizes too."""
    assert ps.same_pad(96, 7, 2) == (2, 3)
    assert ps.same_pad(64, 7, 2) == (2, 3)
    assert ps.same_pad(95, 7, 2) == (3, 3)


@pytest.fixture(scope="module")
def shipped():
    path = str(ps.WEIGHTS)
    with open(path + ".msgpack", "rb") as f:
        raw = f.read()
    return raw, jax_pretrained(), ps.load_pretrained(device="cpu")


def _leaves(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        out.update(_leaves(v, prefix + (k,)) if isinstance(v, dict)
                   else {prefix + (k,): v})
    return out


def test_msgpack_reader_matches_flax(shipped):
    import flax.serialization

    raw = shipped[0]
    ours = _leaves(restore(raw))
    theirs = _leaves(flax.serialization.msgpack_restore(raw))
    assert ours.keys() == theirs.keys() and len(ours) > 300
    for k, v in theirs.items():
        assert ours[k].dtype == v.dtype and ours[k].shape == v.shape, k
        assert np.array_equal(ours[k], v), k


def test_msgpack_reader_refuses_other_extensions():
    with pytest.raises(ValueError, match="extension type 2"):
        restore(bytes([0xD4, 0x02, 0x00]))
    with pytest.raises(ValueError, match="ends inside"):
        restore(bytes([0x92, 0x01]))


def test_converter_takes_every_leaf_and_fills_every_tensor(shipped):
    v = restore(shipped[0])
    cfg = shipped[2][1]["model"]
    sd = starmap_state_dict_from_flax(v["params"], v["batch_stats"], cfg)
    net = ps.StarMapNet(**cfg)
    assert set(sd) == set(net.state_dict())
    for k, t in net.state_dict().items():
        assert sd[k].shape == t.shape, k
    n_leaves = len(_leaves(v))
    n_taken = sum(1 for k in sd if not k.endswith("num_batches_tracked"))
    assert n_taken == n_leaves
    # a leaf too many, or one missing, raises
    extra = {**v["params"], "Conv_99": v["params"]["Conv_0"]}
    with pytest.raises(KeyError, match="not taken"):
        starmap_state_dict_from_flax(extra, v["batch_stats"], cfg)
    short = {k: x for k, x in v["params"].items() if k != "Conv_6"}
    with pytest.raises(KeyError, match="missing"):
        starmap_state_dict_from_flax(short, v["batch_stats"], cfg)


def _render_crops(n=3, seed=3, size=96):
    rng = np.random.default_rng(seed)
    crops = []
    for _ in range(n):
        R, cam, K = pro.random_view(rng, size)
        crops.append(pro.render_car(R, cam, K, size, rng=rng).image)
    return np.repeat(np.stack(crops)[..., None], 3, axis=-1)


def test_shipped_weights_float32_within_1e5(shipped):
    (model, params, stats, _), (net, meta) = shipped[1], shipped[2]
    assert meta["input_size"] == 96 and meta["model"]["hg_depth"] == 3
    assert all(not p.requires_grad or p.dtype == torch.float32
               for p in net.parameters()) and not net.training
    x = _render_crops()
    jo = _apply(model)({"params": params, "batch_stats": stats},
                       jnp.asarray(x, jnp.float32))
    with torch.no_grad():
        po = net(_nchw(x, torch.float32))
    for j, p in zip(jo, po):
        np.testing.assert_allclose(np.moveaxis(p.numpy(), 1, -1),
                                   np.asarray(j), rtol=0, atol=1e-5)
    canon = np.asarray(jro.CAR_KEYPOINTS)
    detect = _detect(model, params, stats, jnp.asarray(canon, jnp.float32))
    for i in range(len(x)):
        jd = detect(jnp.asarray(x[i], jnp.float32))
        pd = ps.detect_keypoints(net, _nchw(x[i:i + 1], torch.float32),
                                 torch.as_tensor(canon, dtype=torch.float32))
        for k in ("found", "peaks_valid"):
            assert np.array_equal(pd[k][0].numpy(), np.asarray(jd[k])), k
        assert int(np.asarray(jd["peaks_valid"]).sum()) >= 3
        for k in ("kp_xy", "peaks_xy", "kp_score", "peaks_score",
                  "peaks_cvf", "kp_depth", "kp_cov"):
            np.testing.assert_allclose(pd[k][0].numpy(), np.asarray(jd[k]),
                                       rtol=0, atol=5e-5, err_msg=k)


def _heatmaps():
    """Heatmaps in (0, 1): smooth blobs, the same quantized to quarters
    (plateaus: equal neighbours and equal scores), one peak only, and
    none over threshold."""
    rng = np.random.default_rng(7)
    yy, xx = np.mgrid[0:24, 0:24]
    out = []
    for n in (20, 6):
        h = np.zeros((24, 24))
        for _ in range(n):
            c = rng.uniform(0, 24, 2)
            h = np.maximum(h, rng.uniform(0.2, 1.0) * np.exp(
                -((xx - c[0]) ** 2 + (yy - c[1]) ** 2) / rng.uniform(1, 6)))
        out += [h, np.round(h * 4) / 4]
    one = np.full((24, 24), 0.1)
    one[5, 17] = 0.9
    out += [one, np.full((24, 24), 0.2)]
    return np.stack(out)


def test_extract_peaks_slot_by_slot():
    H = _heatmaps()
    pxy, psc, pva = ps.extract_peaks(torch.as_tensor(H), 16)
    counts = []
    for i, h in enumerate(H):
        jxy, jsc, jva = (np.asarray(a) for a in js.extract_peaks(
            jnp.asarray(h), 16))
        assert np.array_equal(pva[i].numpy(), jva)
        assert np.array_equal(psc[i].numpy(), jsc)
        # every slot, the invalid ones too: same cells, same refinement
        np.testing.assert_allclose(pxy[i].numpy(), jxy, rtol=0, atol=1e-12)
        counts.append(int(jva.sum()))
    assert counts[-2:] == [1, 0] and max(counts) == 16
    assert any(0 < c < 16 for c in counts)


def test_cov_and_parts_slot_by_slot():
    rng = np.random.default_rng(8)
    H = _heatmaps()
    xy = rng.uniform(-2, 26, (len(H), 16, 2))  # edges clip, truncation
    pc = ps.cov_from_heatmap(torch.as_tensor(H), torch.as_tensor(xy))
    for i in range(len(H)):
        jc = np.asarray(js.cov_from_heatmap(jnp.asarray(H[i]),
                                            jnp.asarray(xy[i])))
        np.testing.assert_allclose(pc[i].numpy(), jc, rtol=0, atol=1e-12)
    canon = rng.normal(size=(12, 3))
    cvf = np.concatenate([canon[rng.integers(0, 12, 10)]
                          + rng.normal(0, 0.1, (10, 3)),
                          rng.normal(size=(6, 3))])
    pid, pdist = ps.assign_parts(torch.as_tensor(cvf), torch.as_tensor(canon))
    jid, jdist = (np.asarray(a) for a in js.assign_parts(
        jnp.asarray(cvf), jnp.asarray(canon)))
    assert np.array_equal(pid.numpy(), jid)
    np.testing.assert_allclose(pdist.numpy(), jdist, rtol=0, atol=1e-14)
    # duplicate labels, equal scores, invalid slots
    part = np.array([3, 3, 1, 0, 3, 1, 7, 7, 2, 2, 5, 11, 11, 0, 4, 4])
    score = np.array([.5, .9, .8, .8, .9, .8, .4, .6, .7, .7, .3, .9, .9,
                      .2, .6, .95])
    valid = np.array([1, 1, 1, 1, 1, 1, 1, 0, 1, 1, 0, 1, 1, 1, 0, 1], bool)
    pb, pf = ps.merge_duplicate_parts(torch.as_tensor(part),
                                      torch.as_tensor(score),
                                      torch.as_tensor(valid), 12)
    jb, jf = (np.asarray(a) for a in js.merge_duplicate_parts(
        jnp.asarray(part), jnp.asarray(score), jnp.asarray(valid), 12))
    assert np.array_equal(pb.numpy(), jb) and np.array_equal(pf.numpy(), jf)
    assert 0 < jf.sum() < 12


def test_detect_keypoints_small_net_float64():
    cfg = SMALL[0]
    m, params, stats, net, x = _small_net(cfg, seed=4)
    canon = np.random.default_rng(1).normal(size=(5, 3))
    pd = ps.detect_keypoints(net, _nchw(x), torch.as_tensor(canon))
    detect = _detect(m, params, stats, jnp.asarray(canon))
    for i in range(len(x)):
        jd = detect(jnp.asarray(x[i]))
        for k, v in jd.items():
            v = np.asarray(v)
            got = pd[k][i].numpy()
            if v.dtype.kind in "biu":
                assert np.array_equal(got, v), k
            else:
                np.testing.assert_allclose(got, v, rtol=0, atol=1e-9,
                                           err_msg=k)


def test_renderer_bit_for_bit():
    for seed in (0, 1):
        rj, rp = np.random.default_rng(seed), np.random.default_rng(seed)
        vj, vp = jro.random_view(rj, 96), pro.random_view(rp, 96)
        for a, b in zip(vj, vp):
            assert np.array_equal(np.asarray(a), np.asarray(b))
        bg = np.random.default_rng(9).uniform(0, 1, (96, 96)).astype(
            np.float32)
        a = jro.render_car(*vj, 96, background=bg, rng=rj, albedo=0.7)
        b = pro.render_car(*vp, 96, background=bg, rng=rp, albedo=0.7)
        for f in a._fields:
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype and np.array_equal(x, y), f
        assert b.kp_visible.sum() >= 3
    for f in ("car_faces", "light_patches"):
        assert np.array_equal(np.asarray(getattr(jro, f)()),
                              np.asarray(getattr(pro, f)()))
    assert np.array_equal(jro.look_at([3.0, 1.0, 2.0], [0, 0, 0.7]),
                          pro.look_at([3.0, 1.0, 2.0], [0, 0, 0.7]))
    assert all(np.array_equal(c0, c1) and s0 == s1 for (c0, s0), (c1, s1)
               in zip(jro.wheel_discs(), pro.wheel_discs()))
