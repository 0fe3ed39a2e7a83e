"""Kernel K6's routes on the CPU (``ops/triangulate.py``): the custom op and
its vmap rule against the plain version called row by row, bit for bit
(in float64, the outputs rounded to float32 for float32 tensors, as the
kernel computes).

Under torch.func.vmap a batch of triangulations reaches the plain version
once, over every row's features joined on one axis with each row's slots
shifted to its own cameras (``_plain_rows``): the per-feature arithmetic
is the row's own, so the results are the per-row plain calls' bits. This
holds with and without the object layer's prior point, with the cameras
shared by the rows (in_dim None), under a vmap nested in another, and for
the filter's entry (``filter/triangulation.py:triangulate``) called
outside vmap, and for the loop's step count, Huber threshold and
damping; float32 arithmetic, which the route does not use, is shown to
differ at a static start's baseline. The inputs (``tests/tri_cases.py``)
hold tracks with fewer than 2 observations, outliers, holes in the mask
and a row masked out whole. The
JAX parity of the plain version is ``test_torch_filter_ops.py``'s
``case_triangulation``; the kernel itself is ``test_torch_cuda.py``'s.
"""
import pytest
import torch

from orcvio_tpu_torch.config.core import FilterConfig
from orcvio_tpu_torch.filter import triangulation as ftri
from orcvio_tpu_torch.filter.tracks import CompactTracks
from orcvio_tpu_torch.ops import triangulate as k6
from tri_cases import tri_rows

torch.set_num_threads(1)

CFG = FilterConfig()
KW = dict(huber=CFG.huber_epsilon, iters=CFG.tri_max_iters,
          damping=CFG.tri_initial_damping)
NAMES = ("p_anchor", "p_world", "anchor_slot", "valid", "inv_param")


def _same(got, want):
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True,
                                   msg=name)


def _per_row(rows, shared=(), kw=KW):
    """The plain version row by row in float64, stacked, each output
    rounded to the inputs' type."""
    B, dtype = rows[0].shape[0], rows[0].dtype
    rows = [x.double() if x is not None and x.is_floating_point() else x
            for x in rows]
    outs = [k6.triangulate_plain(*(None if x is None else x if i in shared
                                   else x[b] for i, x in enumerate(rows)),
                                 **kw) for b in range(B)]
    return [torch.stack(x).to(dtype) if x[0].is_floating_point()
            else torch.stack(x) for x in zip(*outs)]


def _spy(monkeypatch):
    calls = []
    plain = k6.triangulate_plain

    def spy(*a, **kw):
        calls.append(a[0].shape)
        return plain(*a, **kw)

    monkeypatch.setattr(k6, "triangulate_plain", spy)
    return calls


@pytest.mark.parametrize("prior", [False, True], ids=["two_view", "prior"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_rule_equals_per_row_plain(monkeypatch, dtype, prior):
    B, F, T, S = 4, 16, 6, 20
    rows = tri_rows(B, F, T, S, 3, dtype=dtype, prior=prior, dead_row=True)
    assert bool((rows[3] < 2).any()) and not bool(rows[1][-1].any())
    want = _per_row(rows)
    calls = _spy(monkeypatch)
    args = [x for x in rows if x is not None]
    got = torch.func.vmap(lambda *a: k6.triangulate(*a, **KW))(*args)
    assert calls == [(B * F, T, 2)]  # one plain call over every row
    _same(got, want)
    assert not bool(got[3][-1].any()) and not bool(got[3][rows[3] < 2].any())


def test_rule_reads_shared_cameras(monkeypatch):
    """The rows' tracks batched, the camera poses shared (in_dim None)."""
    B, F, T, S = 3, 12, 6, 20
    rows = list(tri_rows(B, F, T, S, 5, prior=True))
    rows[4], rows[5] = rows[4][0], rows[5][0]
    want = _per_row(rows, shared=(4, 5))
    calls = _spy(monkeypatch)
    got = torch.func.vmap(lambda *a: k6.triangulate(*a, **KW),
                          in_dims=(0, 0, 0, 0, None, None, 0))(*rows)
    assert len(calls) == 1
    _same(got, want)


def test_nested_vmap_is_one_call(monkeypatch):
    """vmap over 2 x 3 rows (the object path's T, with a prior): one plain
    call over the 6 rows, each the row's own."""
    V, B, F, T, S = 2, 3, 12, 32, 32
    rows = tri_rows(V * B, F, T, S, 9, prior=True, holes=True, dead_row=True)
    want = [x.reshape(V, B, *x.shape[1:]) for x in _per_row(rows)]
    calls = _spy(monkeypatch)
    inner = torch.func.vmap(lambda *a: k6.triangulate(*a, **KW))
    got = torch.func.vmap(inner)(*(x.reshape(V, B, *x.shape[1:])
                                   for x in rows))
    assert calls == [(V * B * F, T, 2)]
    _same(got, want)


@pytest.mark.parametrize("prior", [False, True], ids=["two_view", "prior"])
def test_filter_entry_is_the_plain_version(prior):
    """filter/triangulation.py:triangulate outside vmap: the plain
    version's bits, as a TriResult."""
    uv, mask, slot, n_obs, R, t, p = (None if x is None else x[0] for x in
                                      tri_rows(1, 24, 6, 20, 4, prior=prior))
    ct = CompactTracks(uv=uv, uv_vel=torch.zeros_like(uv), slot=slot,
                       mask=mask, n_obs=n_obs)
    got = ftri.triangulate(CFG, ct, R, t, p_init_world=p)
    assert isinstance(got, ftri.TriResult)
    _same(got, k6.triangulate_plain(uv, mask, slot, n_obs, R, t, p, **KW))


@pytest.mark.parametrize("iters", [0, 1, 3])
def test_rule_takes_the_loop_settings(iters):
    """The step count, Huber threshold and damping reach the plain version
    through the rule: after 0, 1 and 3 steps on tracks with outliers past
    the threshold, each with its own threshold and damping, the per-row
    calls' bits, and the step count moves the answer."""
    kw = dict(huber=0.02, iters=iters, damping=1e-2)
    rows = tri_rows(3, 16, 6, 20, 11, outliers=True, dead_row=True)
    got = torch.func.vmap(lambda *a: k6.triangulate(*a, **kw))(
        *(x for x in rows if x is not None))
    _same(got, _per_row(rows, kw=kw))
    more = _per_row(rows, kw={**kw, "iters": iters + 1})
    moved = (got[4] - more[4]).norm(dim=-1)[rows[3] >= 2]
    assert float(moved.max()) > 1e-6


def test_float32_tensors_compute_in_float64():
    """float32 tensors take the float64 arithmetic, as on the card: at a
    static start's baseline (cameras within some 3 mm) the route gives the
    float64 answer rounded, bit for bit, where float32 arithmetic (the
    plain version run on the float32 tensors) is 1e-4 or more off it."""
    rows = tri_rows(8, 32, 6, 20, 22, dtype=torch.float32, baseline=0.02)
    got = torch.func.vmap(lambda *a: k6.triangulate(*a, **KW))(*rows[:6])
    want = _per_row(rows)
    _same(got, want)
    f32 = [torch.stack(x) for x in zip(*(
        k6.triangulate_plain(*(x[b] for x in rows[:6]), None, **KW)
        for b in range(8)))]
    v = want[3] & f32[3]
    off = (f32[1] - want[1]).norm(dim=-1) / want[1].norm(dim=-1)
    assert int(v.sum()) > 32 and float(off[v].max()) > 1e-4
