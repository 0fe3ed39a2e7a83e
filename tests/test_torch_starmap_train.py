"""StarMap training: the port (orcvio_tpu_torch/scripts/train_starmap.py,
models/starmap.py's train mode and losses, dataio/render_object.py's
training batches, convert.py and models/flax_msgpack.py's writer)
against the JAX package (scripts/train_starmap.py, orcvio_tpu/models/
starmap.py, orcvio_tpu/dataio/render_object.py) and cv2 on the CPU.

* The blur augment's resizes against cv2.resize at every s in 30..95 on
  float32 images, within 2e-6 (INTER_AREA down, INTER_LINEAR up).
* make_training_batch against the JAX function, 8 images from a seed that
  takes both the blur branch and the other: targets and masks equal,
  images within 2e-6; build_dataset's uint8 levels against the JAX
  script's on 128 renders: at most 12 of 1,179,648 pixels differ (a
  resized value a rounding away from an integer level), each by one.
* Batch norm in train mode at tests/test_starmap.py's tiny widths (16
  features, hourglass depth 2), 32 px, batch 4, float64: the outputs,
  the updated batch_stats, heatmap_loss and train_loss against flax's
  within 1e-10.
* Three training steps of that network in float64 against the JAX
  package's, the loss and the step written as scripts/train_starmap.py
  writes them (optax.adam under warmup_cosine_decay_schedule), from the
  same flax init: losses, gradients, batch_stats and parameters within
  1e-9; and one step at the shipped widths from the shipped checkpoint,
  batch 2.
* The schedule against optax's at steps 0..300; init_like_flax's
  statistics against lecun_normal's; flax_msgpack.dump against flax's
  bytes (the shipped checkpoint, and the port's save of the shipped
  network, byte for byte); flax reads a checkpoint the port wrote, and
  the JAX package's load_pretrained on it gives the port's heatmaps.
* The trainer's main on the CPU at a tiny run (20 steps of 4): its
  checkpoint, read back by the port's load_pretrained, gives its
  network's outputs bit for bit.

Run as a script with ``--jax-train [--parts ...]``, it prints the JAX
package's figures that chip_smoke.py's phase 15 holds the port to
(``JAX_TRAIN``, CPU, some 7 min): the first 5 losses of a --steps 3000
run from the shipped checkpoint in float64 on the port's renders
("parity"), the loss at step 199 of the JAX trainer's own float32 run at
--steps 200 --dataset 512 ("short_run"), and the shipped checkpoint's
evaluation on the trainer's 32 renders in float32 ("eval_shipped").
"""
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from orcvio_tpu_torch.convert import (  # noqa: E402
    starmap_flax_from_state_dict, starmap_state_dict_from_flax)
from orcvio_tpu_torch.dataio import render_object as pro  # noqa: E402
from orcvio_tpu_torch.models import starmap as ps  # noqa: E402
from orcvio_tpu_torch.models.flax_msgpack import dump, restore  # noqa: E402
from orcvio_tpu_torch.scripts import train_starmap as ts  # noqa: E402

torch.set_num_threads(4)
F64 = torch.float64
TINY = dict(n_stack=2, n_feats=16, n_out=5, hg_depth=2, n_modules=1)
SHIPPED = str(ps.WEIGHTS)


def jax_script():
    """The JAX package's scripts/train_starmap.py as a module (its
    build_dataset and MODEL_KW); main() is not run."""
    spec = importlib.util.spec_from_file_location(
        "jax_train_starmap", ROOT / "scripts" / "train_starmap.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _nchw(a, dtype=F64):
    return torch.as_tensor(np.ascontiguousarray(np.moveaxis(a, -1, 1)),
                           dtype=dtype)


# ---------------------------------------------------------------------------
# The data
# ---------------------------------------------------------------------------

def test_area_resize_is_cv2_inter_area():
    import cv2

    rng = np.random.default_rng(0)
    for s in range(30, 96):
        img = rng.uniform(0, 1, (96, 96)).astype(np.float32)
        want = cv2.resize(img, (s, s), interpolation=cv2.INTER_AREA)
        got = pro.area_resize(img, s)
        assert got.dtype == np.float32 and got.shape == (s, s)
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-6,
                                   err_msg=f"s={s}")


def test_linear_resize_is_cv2_inter_linear():
    import cv2

    rng = np.random.default_rng(1)
    for s in range(30, 96):
        img = rng.uniform(0, 1, (s, s)).astype(np.float32)
        want = cv2.resize(img, (96, 96), interpolation=cv2.INTER_LINEAR)
        got = pro.linear_resize(img, 96)
        assert got.dtype == np.float32 and got.shape == (96, 96)
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-6,
                                   err_msg=f"s={s}")


def test_make_training_batch_matches_jax(monkeypatch):
    from orcvio_tpu.dataio import render_object as jro

    sizes = []
    area = pro.area_resize
    monkeypatch.setattr(pro, "area_resize",
                        lambda im, s: (sizes.append(s), area(im, s))[1])
    got = pro.make_training_batch(np.random.default_rng(2), 8)
    want = jro.make_training_batch(np.random.default_rng(2), 8)
    assert 0 < len(sizes) < 8, sizes  # both branches taken
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float32 and g.shape == w.shape
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=2e-6)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])


def test_build_dataset_matches_jax():
    n = 128
    got = ts.build_dataset(n)
    want = jax_script().build_dataset(n)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    d = got[0].astype(np.int16) - want[0].astype(np.int16)
    assert (d == d[..., :1]).all()  # the three channels alike
    off = np.count_nonzero(d[..., 0])
    assert off <= 12 and np.abs(d).max() <= 1, (off, np.abs(d).max())


# ---------------------------------------------------------------------------
# The network in train mode and the step, float64, against flax and optax
# ---------------------------------------------------------------------------

def _f64(tree):
    import jax

    return jax.tree.map(lambda x: np.asarray(x, np.float64), tree)


def tiny_start(seed=0, size=32, batch=4):
    """The tiny network from flax's init (BN entries redrawn so that the
    running statistics are not the init's 0 and 1), as (JAX model,
    params, batch_stats) in float64 and the port's network from them; a
    training batch of `batch` renders at `size` px, NHWC numpy."""
    import jax
    import jax.numpy as jnp

    from orcvio_tpu.models.starmap import StarMapNet

    rng = np.random.default_rng(seed)
    m = StarMapNet(**TINY)
    v = m.init(jax.random.PRNGKey(seed), jnp.zeros((1, size, size, 3),
                                                   jnp.float32), train=True)
    params, stats = _f64(v["params"]), _f64(v["batch_stats"])

    def redraw(path, a):
        name = path[-1].key
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, a.shape)
        if name == "mean" or (name == "bias" and a.ndim == 1
                              and "BatchNorm" in str(path[-2])):
            return rng.normal(0, 0.2, a.shape)
        return a

    params = jax.tree_util.tree_map_with_path(redraw, params)
    stats = jax.tree_util.tree_map_with_path(redraw, stats)
    net = ps.StarMapNet(**TINY).to(F64)
    net.load_state_dict(starmap_state_dict_from_flax(params, stats, TINY))
    data = pro.make_training_batch(rng, batch, size=size)
    return m, params, stats, net, data


def jax_loss_fn(model):
    """scripts/train_starmap.py:82-107's loss_fn of `model`."""
    import jax.numpy as jnp

    def loss_fn(p, bs, img, tgt, msk):
        outs, mut = model.apply({"params": p, "batch_stats": bs}, img,
                                train=True, mutable=["batch_stats"])
        loss = 0.0
        for o in outs:
            heat = o[..., 0]
            l_heat = jnp.mean(jnp.maximum(heat, 0) - heat * tgt[..., 0]
                              + jnp.log1p(jnp.exp(-jnp.abs(heat))))
            l_cvf = jnp.sum(msk * (o[..., 1:4] - tgt[..., 1:4]) ** 2) / (
                jnp.maximum(jnp.sum(msk), 1.0) * 3)
            l_dep = jnp.sum(msk[..., 0] * (o[..., 4] - tgt[..., 4]) ** 2) / (
                jnp.maximum(jnp.sum(msk), 1.0))
            loss = loss + l_heat + 1.0 * l_cvf + 0.3 * l_dep
        return loss / len(outs), mut["batch_stats"]

    return loss_fn


def jax_trainer(model, lr, steps):
    """(optax transform, jitted step) as scripts/train_starmap.py:75-113
    builds them; the step also returns the gradients."""
    import jax
    import optax

    warmup = min(100, steps // 2)
    tx = optax.adam(optax.warmup_cosine_decay_schedule(
        0.0, lr, warmup, max(steps, warmup + 1)))
    loss_fn = jax_loss_fn(model)

    @jax.jit
    def step(p, bs, opt_state, img, tgt, msk):
        (loss, bs2), g = jax.value_and_grad(loss_fn, has_aux=True)(
            p, bs, img, tgt, msk)
        updates, opt_state = tx.update(g, opt_state)
        return optax.apply_updates(p, updates), bs2, opt_state, loss, g

    return tx, step


def _port_leaves(net, grads=True):
    """({state-dict name: numpy} of the parameters and running statistics
    of the port's network, the same of its gradients or None)."""
    sd = {k: v.detach().numpy() for k, v in net.state_dict().items()
          if not k.endswith("num_batches_tracked")}
    return sd, ({k: p.grad.numpy() for k, p in net.named_parameters()}
                if grads else None)


def _flax_leaves(params, stats, cfg, grads=None):
    """The same names from flax's trees (the gradients read through the
    params' layout)."""
    def to_sd(p):
        return {k: v.numpy() for k, v in starmap_state_dict_from_flax(
            _f64(p), _f64(stats), cfg).items()
            if not k.endswith("num_batches_tracked")}

    sd = to_sd(params)
    if grads is None:
        return sd, None
    g = to_sd(grads)
    return sd, {k: g[k] for k in g if "running" not in k}


def _assert_leaves(got, want, tol, what):
    assert got.keys() == want.keys()
    worst = max((float(np.abs(got[k] - want[k]).max()), k) for k in got)
    assert worst[0] <= tol, f"{what}: {worst[1]} off by {worst[0]:.3e}"


def test_batch_norm_train_mode_matches_flax():
    """One forward in train mode: the outputs, the updated batch_stats
    and both losses within 1e-10 of flax's."""
    import jax.numpy as jnp

    from orcvio_tpu.models.starmap import heatmap_loss

    m, params, stats, net, (img, tgt, msk) = tiny_start()
    outs, mut = m.apply({"params": params, "batch_stats": stats},
                        jnp.asarray(img, jnp.float64), train=True,
                        mutable=["batch_stats"])
    net.train()
    x, t, k = _nchw(img), _nchw(tgt), _nchw(msk)
    pouts = net(x)
    assert all(o.dtype == F64 for o in pouts)
    for j, p in zip(outs, pouts):
        np.testing.assert_allclose(np.moveaxis(p.detach().numpy(), 1, -1),
                                   np.asarray(j), rtol=0, atol=1e-10)
    sd, _ = _port_leaves(net, grads=False)
    want, _ = _flax_leaves(params, mut["batch_stats"], TINY)
    _assert_leaves(sd, want, 1e-10, "batch_stats after one forward")
    jl = float(heatmap_loss(outs, jnp.asarray(tgt)))
    assert abs(float(ps.heatmap_loss(pouts, t).detach()) - jl) <= 1e-10
    jt = float(jax_loss_fn(m)(params, stats, jnp.asarray(img), jnp.asarray(
        tgt), jnp.asarray(msk))[0])
    assert abs(float(ps.train_loss(pouts, t, k).detach()) - jt) <= 1e-10


def test_running_variance_is_biased_fast_variance():
    """The running variance takes E[x^2] - E[x]^2 (biased), where torch's
    BatchNorm2d takes the unbiased n / (n - 1) of it: at the innermost
    level (n = 4 x 2 x 2 = 16) that is 6.7 %."""
    x = torch.randn(4, 3, 2, 2, dtype=F64, generator=torch.Generator(
    ).manual_seed(3)) * 2 + 1
    bn = ps.BatchNorm(3).to(F64).train()
    bn(x)
    var = (x * x).mean((0, 2, 3)) - x.mean((0, 2, 3)) ** 2
    torch.testing.assert_close(bn.running_var, 0.99 + 0.01 * var, rtol=0,
                               atol=1e-15)
    ref = torch.nn.BatchNorm2d(3, momentum=0.01).to(F64).train()
    ref(x)
    ratio = (ref.running_var - 0.99) / (bn.running_var - 0.99)
    torch.testing.assert_close(ratio, torch.full_like(ratio, 16 / 15))


def _train_both(m, params, stats, net, batches, lr, steps, n_run, tol):
    """n_run steps of a `steps`-step schedule in both packages: after each
    the loss, gradients, batch_stats and parameters within tol."""
    import jax.numpy as jnp

    tx, step = jax_trainer(m, lr, steps)
    opt_state = tx.init(params)
    opt = ts.make_optimizer(net, lr, steps)
    p, bs = params, stats
    for i, (img, tgt, msk) in enumerate(batches[:n_run]):
        p, bs, opt_state, jl, g = step(p, bs, opt_state,
                                       *(jnp.asarray(a, jnp.float64)
                                         for a in (img, tgt, msk)))
        pl = ts.train_step(net, opt, _nchw(img), _nchw(tgt), _nchw(msk))
        assert pl.dtype == F64
        assert abs(float(pl) - float(jl)) <= tol, (i, float(pl), float(jl))
        sd, grads = _port_leaves(net)
        want_sd, want_g = _flax_leaves(p, bs, m_cfg(m), g)
        _assert_leaves(grads, want_g, tol, f"gradients of step {i}")
        _assert_leaves(sd, want_sd, tol, f"parameters after step {i}")


def m_cfg(m):
    return dict(n_stack=m.n_stack, n_feats=m.n_feats, n_out=m.n_out,
                hg_depth=m.hg_depth, n_modules=m.n_modules)


@pytest.mark.parametrize("steps", [3, 7], ids=["cosine", "warmup"])
def test_three_steps_tiny_float64_match_jax(steps):
    """Three steps on three batches of 4 renders at 32 px, of a 3-step
    schedule (warm-up 1: lr 0, 1e-3, then 5e-4 on the cosine) and of a
    7-step one (warm-up 3: lr 0, then 1/3 and 2/3 of 1e-3 in optax's
    float32 warm-up)."""
    m, params, stats, net, first = tiny_start()
    rng = np.random.default_rng(11)
    batches = [first] + [pro.make_training_batch(rng, 4, size=32)
                         for _ in range(2)]
    _train_both(m, params, stats, net, batches, 1e-3, steps, 3, 1e-9)


def test_one_step_shipped_widths_float64_matches_jax():
    """One step of a --steps 3000 schedule at the shipped widths from the
    shipped checkpoint, batch 2 (lr 0: the gradients, the moments' first
    effect is in the next step)."""
    from starmap_world import jax_pretrained

    m, params, stats, _ = jax_pretrained()
    params, stats = _f64(params), _f64(stats)
    net, meta = ps.load_pretrained(device="cpu", dtype=F64)
    batch = [ts.build_dataset(2, seed=5)]
    img = batch[0][0].astype(np.float64) / 255.0
    _train_both(m, params, stats, net, [(img, *batch[0][1:])], 1e-3, 3000,
                1, 1e-9)


# ---------------------------------------------------------------------------
# The optimizer, the init, the checkpoint
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("peak,warmup,decay", [(1e-3, 100, 3000),
                                               (1e-3, 100, 200),
                                               (2e-3, 1, 3), (1e-3, 0, 50),
                                               (3e-4, 7, 40)])
def test_schedule_matches_optax(peak, warmup, decay):
    """optax's schedule, jitted as in the JAX trainer's step, at adam's
    int32 count, against the port's as its optimizer takes it (rounded to
    float32): equal at every step 0..300 under x64."""
    import jax
    import jax.numpy as jnp
    import optax

    sched = jax.jit(optax.warmup_cosine_decay_schedule(0.0, peak, warmup,
                                                       decay))
    for k in range(301):
        want = np.float32(sched(jnp.asarray(k, jnp.int32)))
        got = np.float32(ts.warmup_cosine_decay(k, peak, warmup, decay))
        assert got == want, (k, got, want)
    assert ts.warmup_cosine_decay(0, peak, warmup, decay) == (
        0.0 if warmup else peak)
    assert ts.warmup_cosine_decay(decay + 5, peak, warmup, decay) == 0.0


def test_first_adam_update_is_zero_and_moves_the_moments():
    net = ps.StarMapNet(**TINY).to(F64)
    ps.init_like_flax(net, torch.Generator().manual_seed(1))
    opt = ts.make_optimizer(net, 1e-3, 3000)
    before = {k: v.clone() for k, v in net.state_dict().items()}
    img, tgt, msk = pro.make_training_batch(np.random.default_rng(4), 2,
                                            size=32)
    ts.train_step(net, opt, _nchw(img), _nchw(tgt), _nchw(msk))
    for k, p in net.named_parameters():
        assert torch.equal(p, before[k]), k
        assert opt.state[p]["exp_avg"].abs().sum() > 0 or k.endswith("bias")
    assert opt.count == 1 and opt.param_groups[0]["lr"] == 0.0
    ts.train_step(net, opt, _nchw(img), _nchw(tgt), _nchw(msk))
    assert opt.param_groups[0]["lr"] == float(np.float32(
        ts.warmup_cosine_decay(1, 1e-3, 100, 3000)))
    assert opt.param_groups[0]["lr"] == pytest.approx(1e-5, rel=2e-6)
    assert not torch.equal(net.stacks[1].out.weight,
                           before["stacks.1.out.weight"])


def test_init_like_flax_is_lecun_normal():
    """Each convolution: std within 5 % of sqrt(1 / fan_in) where it has
    4096 elements or more, no value beyond 2 sigma / 0.8796 (the
    truncation), bias 0; BN at flax's init. The same seed gives the same
    init, another seed another."""
    net = ps.StarMapNet(**ts.MODEL_KW)
    ps.init_like_flax(net, torch.Generator().manual_seed(0))
    n_checked = 0
    for name, mod in net.named_modules():
        if isinstance(mod, torch.nn.Conv2d):
            o, i, kh, kw = mod.weight.shape
            std = (1.0 / (i * kh * kw)) ** 0.5
            w = mod.weight.detach().double()
            assert float(w.abs().max()) <= 2 * std / ps.LECUN_STD, name
            if w.numel() >= 4096:
                assert abs(float(w.std()) / std - 1) <= 0.05, name
                n_checked += 1
            assert not mod.bias.any(), name
        elif isinstance(mod, ps.BatchNorm):
            assert bool((mod.weight == 1).all() and (mod.bias == 0).all())
            assert bool((mod.running_mean == 0).all()
                        and (mod.running_var == 1).all())
    assert n_checked >= 30
    again = ps.StarMapNet(**ts.MODEL_KW)
    ps.init_like_flax(again, torch.Generator().manual_seed(0))
    assert torch.equal(again.stem.weight, net.stem.weight)
    ps.init_like_flax(again, torch.Generator().manual_seed(1))
    assert not torch.equal(again.stem.weight, net.stem.weight)


def test_msgpack_dump_writes_flax_bytes(tmp_path):
    """dump(restore(b)) == b for the shipped checkpoint, the port's save
    of the shipped network is that file byte for byte, and dump writes
    what flax.serialization.to_bytes writes for trees of other sizes."""
    import flax.serialization

    raw = Path(SHIPPED + ".msgpack").read_bytes()
    assert dump(restore(raw)) == raw
    net, meta = ps.load_pretrained(device="cpu")
    assert meta["model"] == ts.MODEL_KW
    path = ts.save(net, tmp_path / "again", recall=meta["recall_at_2px"])
    assert path.read_bytes() == raw
    assert json.loads((tmp_path / "again.json").read_text()) == meta
    rng = np.random.default_rng(0)
    tree = {"a": {"x": rng.normal(size=(3, 200)).astype(np.float32),
                  "y": np.arange(70000, dtype=np.int64)},
            "b" * 40: {"k" * 300: np.zeros((0,)), "s": np.ones((1,))},
            "c": {str(i): np.full((2,), i, np.int32) for i in range(20)},
            "d": {"u": np.ones((1,), np.uint8), "v": np.ones((2,), np.uint8),
                  "w": np.ones((300, 1), np.float16)}}
    assert dump(tree) == flax.serialization.to_bytes(tree)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The trainer's main on the CPU: 20 steps of batch 4 on 8 renders.
    (After 2 steps the running statistics that eval mode uses are still
    near their init, the activations unnormalized and the second stack's
    logits up to 7: float32 rounding then moves the heat by up to 1.3e-6
    between the packages, against 3e-7 at 20 steps and 6e-7 for the
    shipped weights.)"""
    out = tmp_path_factory.mktemp("train") / "car"
    report, net = ts.main(["--steps", "20", "--dataset", "8", "--batch",
                           "4", "--device", "cpu", "--out", str(out)])
    return out, report, net


def test_trainer_checkpoint_reads_back_bit_for_bit(trained):
    out, report, net = trained
    assert report["params"] == 460938 and len(report["losses"]) == 20
    assert all(np.isfinite(report["losses"]))
    back, meta = ps.load_pretrained(str(out), device="cpu")
    assert meta["model"] == ts.MODEL_KW and meta["input_size"] == ts.SIZE
    x = torch.rand(3, 3, 96, 96, generator=torch.Generator().manual_seed(0))
    net.eval()
    with torch.no_grad():
        for a, b in zip(net(x), back(x)):
            assert torch.equal(a, b)
    # the checkpoint is not the shipped one, nor the init
    assert Path(str(out) + ".msgpack").read_bytes() != Path(
        SHIPPED + ".msgpack").read_bytes()


def test_jax_reads_a_checkpoint_the_port_wrote(trained):
    """flax's from_bytes reads the port's save leaf for leaf, and the JAX
    package's load_pretrained(path) gives the port's heatmaps (the sigmoid
    of each stack's heat channel) within 1e-6 in float32, the raw
    outputs within 1e-5, as the shipped weights' in test_torch_starmap."""
    import flax.serialization
    import jax
    import jax.numpy as jnp

    from orcvio_tpu.models.starmap import load_pretrained

    out, _, net = trained
    raw = Path(str(out) + ".msgpack").read_bytes()
    params, stats = starmap_flax_from_state_dict(net.state_dict(),
                                                 ts.MODEL_KW)
    want = {"params": params, "batch_stats": stats}
    tree = flax.serialization.from_bytes(
        jax.tree.map(lambda a: np.zeros(a.shape, np.float32), want), raw)

    def leaves(t, pre=()):
        for k, v in t.items():
            yield from (leaves(v, pre + (k,)) if isinstance(v, dict)
                        else [(pre + (k,), v)])

    got = dict(leaves(tree))
    assert got.keys() == dict(leaves(want)).keys()
    for k, v in leaves(want):
        assert got[k].dtype == np.float32 and got[k].shape == v.shape
        np.testing.assert_array_equal(got[k], v.astype(np.float32))
    m, jp, jbs, meta = load_pretrained(str(out))
    img = pro.make_training_batch(np.random.default_rng(6), 2)[0]
    jout = m.apply({"params": jp, "batch_stats": jbs},
                   jnp.asarray(img, jnp.float32), train=False)
    back, _ = ps.load_pretrained(str(out), device="cpu")
    with torch.no_grad():
        pout = back(_nchw(img, torch.float32))
    for j, p in zip(jout, pout):
        heat = torch.sigmoid(p[:, 0]).numpy()
        np.testing.assert_allclose(heat, np.asarray(jax.nn.sigmoid(
            j[..., 0])), rtol=0, atol=1e-6)
        np.testing.assert_allclose(np.moveaxis(p.numpy(), 1, -1),
                                   np.asarray(j), rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# --jax-train: the JAX package's figures for chip_smoke.py's phase 15
# ---------------------------------------------------------------------------

def _jax_eval(m, params, stats, seed=ts.EVAL_SEED, n=32):
    """scripts/train_starmap.py:124-162's evaluation, float32."""
    import jax
    import jax.numpy as jnp

    from orcvio_tpu.dataio.render_object import (CAR_KEYPOINTS,
                                                 make_training_batch)
    from orcvio_tpu.models.starmap import detect_keypoints

    im, tg, _ = make_training_batch(np.random.default_rng(seed), n, ts.SIZE)
    canon = jnp.asarray(CAR_KEYPOINTS, jnp.float32)
    det_fn = jax.jit(lambda crop: detect_keypoints(params, stats, m, crop,
                                                   canon))
    hits = tot = lbl_hits = lbl_tot = 0
    for b in range(n):
        det = det_fn(jnp.asarray(im[b], jnp.float32))
        heat_t = tg[b, ..., 0]
        gt_peaks = np.argwhere(heat_t > 0.95)
        det_xy = np.asarray(det["kp_xy"])[np.asarray(det["found"])]
        for gy, gx in gt_peaks:
            tot += 1
            if len(det_xy) and np.min(np.hypot(det_xy[:, 0] - gx,
                                               det_xy[:, 1] - gy)) <= 2.0:
                hits += 1
        pk = np.asarray(det["peaks_xy"])
        pv = np.asarray(det["peaks_valid"])
        pcvf = np.asarray(det["peaks_cvf"])
        gt_cvf = tg[b, ..., 1:4]
        H, W = heat_t.shape
        for p in range(len(pk)):
            if not pv[p]:
                continue
            gx, gy = int(round(pk[p, 0])), int(round(pk[p, 1]))
            if heat_t[min(gy, H - 1), min(gx, W - 1)] < 0.7:
                continue
            true_lbl = np.argmin(np.linalg.norm(
                gt_cvf[min(gy, H - 1), min(gx, W - 1)][None]
                - np.asarray(canon), axis=1))
            pred_lbl = np.argmin(np.linalg.norm(
                pcvf[p][None] - np.asarray(canon), axis=1))
            lbl_tot += 1
            lbl_hits += int(pred_lbl == true_lbl)
    return {"recall_at_2px": hits / max(tot, 1), "peaks": [hits, tot],
            "label_accuracy": lbl_hits / max(lbl_tot, 1),
            "labels": [lbl_hits, lbl_tot]}


def _jax_run(m, params, stats, data, steps, n_run, dtype):
    """The JAX trainer's loop (scripts/train_starmap.py:115-122) for n_run
    steps of a `steps`-step schedule in `dtype`: the losses."""
    import jax
    import jax.numpy as jnp

    imgs, tgts, msks = data
    tx, step = jax_trainer(m, 1e-3, steps)
    params = jax.tree.map(lambda x: jnp.asarray(x, dtype), params)
    stats = jax.tree.map(lambda x: jnp.asarray(x, dtype), stats)
    opt_state = tx.init(params)
    rng = np.random.default_rng(ts.DATA_SEED)
    losses = []
    for _ in range(n_run):
        idx = rng.integers(0, len(imgs), 32)
        img = jnp.asarray(imgs[idx], jnp.float32).astype(dtype) / 255.0
        params, stats, opt_state, loss, _ = step(
            params, stats, opt_state, img, jnp.asarray(tgts[idx], dtype),
            jnp.asarray(msks[idx], dtype))
        losses.append(float(loss))
    return losses


def jax_train_figures(parts=("eval_shipped", "short_run", "parity")):
    import time

    import jax
    import jax.numpy as jnp

    from orcvio_tpu.models.starmap import StarMapNet
    from starmap_world import jax_pretrained

    out, t0 = {}, time.perf_counter()
    jts = jax_script()
    m, params, stats, _ = jax_pretrained()
    # (c) the shipped checkpoint's evaluation, float32
    if "eval_shipped" in parts:
        out["eval_shipped"] = _jax_eval(m, params, stats)
    # (b) the trainer's own float32 run: --steps 200 --dataset 512
    if "short_run" in parts:
        data = jts.build_dataset(512)
        model = StarMapNet(**jts.MODEL_KW)
        v = model.init(jax.random.PRNGKey(0), jnp.zeros(
            (1, 96, 96, 3), jnp.float32), train=True)
        losses = _jax_run(model, v["params"], v["batch_stats"], data, 200,
                          200, jnp.float32)
        out["short_run"] = {"steps": 200, "dataset": 512,
                            "loss_0": losses[0], "loss_199": losses[199],
                            "losses_every_20": losses[::20]}
    if "parity" not in parts:
        out["seconds"] = time.perf_counter() - t0
        return out
    # (a) the first 5 steps of a --steps 3000 run from the shipped
    # checkpoint, float64, on the port's 256 renders (the JAX script's
    # uint8 levels differ on a few pixels, which moves a loss by 1e-6)
    jax.config.update("jax_enable_x64", True)
    data = ts.build_dataset(256)
    out["parity"] = {"steps": 3000, "dataset": 256, "renders": "port's",
                     "losses_f64": _jax_run(m, params, stats, data, 3000, 5,
                                            jnp.float64)}
    out["seconds"] = time.perf_counter() - t0
    return out


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    if "--jax-train" not in sys.argv:
        sys.exit("usage: python tests/test_torch_starmap_train.py "
                 "--jax-train [--parts eval_shipped,short_run,parity]")
    parts = (sys.argv[sys.argv.index("--parts") + 1].split(",")
             if "--parts" in sys.argv else
             ("eval_shipped", "short_run", "parity"))
    print(json.dumps({"JAX_TRAIN": jax_train_figures(parts)}))
