"""StarMap semantic-keypoint network: a stacked hourglass and its peak
post-processing.

Counterpart of ``orcvio_tpu/models/starmap.py`` (reference:
``ros_wrapper/src/StarMap/python/models/hg.py``, the stacked hourglass with
intermediate supervision; ``src/starmap.cpp``, TorchScript inference, the
peak extraction of ``parse_keypoints_from_heatmap`` at heat threshold 0.3,
``cov_from_heatmap`` and the part labels by canonical view feature). The
network gives 5 channels a stack: the visibility heatmap, the canonical
view feature xyz and depth.

The layout is NCHW. In eval mode batch norm uses its running statistics
with flax's eps (1e-5); in train mode (``BatchNorm``) it normalizes by
the batch's statistics as flax computes them and updates the running
ones in the forward pass, as ``mutable=["batch_stats"]`` does. The
stem's 7x7 stride-2 "SAME" convolution pads as XLA does, (2, 3) at 96
px; every other convolution is 1x1 or 3x3 at stride 1, the pools are 2x2
VALID and the upsample is an exact 2x repeat. The shipped checkpoint is
the JAX package's flax file (``orcvio_tpu/models/weights/
starmap_car.*``), read by path with ``flax_msgpack.restore`` and renamed
by ``convert.py:starmap_state_dict_from_flax``. Training
(``scripts/train_starmap.py``) starts from ``init_like_flax`` and
minimizes ``train_loss``, the loss the JAX package's trainer minimizes;
``heatmap_loss`` is the JAX package's plain intermediate-supervision MSE.

The post-processing works on a batch of heatmaps (..., H, W). Ties among
the top-k scores go to the lower flat index, as ``jax.lax.top_k``'s do;
casts to integer truncate toward zero, as XLA's do.
"""
from __future__ import annotations

import json
from pathlib import Path

import torch
import torch.nn.functional as F
from torch import nn

from .. import no_tf32, resolve_device

HEAT_THRESH = 0.3  # starmap.cpp:622
BN_EPS = 1e-5  # flax.linen.BatchNorm's default
BN_MOMENTUM = 0.99  # flax's: running = 0.99 running + 0.01 batch
LECUN_STD = 0.87962566103423978  # std of a unit normal truncated at +-2
WEIGHTS = (Path(__file__).resolve().parents[2] / "orcvio_tpu" / "models"
           / "weights" / "starmap_car")


class BatchNorm(nn.BatchNorm2d):
    """flax.linen.BatchNorm over the channels of NCHW, under torch's names
    (weight, bias, running_mean, running_var). Eval mode is torch's. Train
    mode is flax's (use_fast_variance): the batch variance E[x^2] -
    E[x]^2, clipped at 0 and biased, normalizes the batch and feeds the
    running variance, running = 0.99 running + 0.01 batch, updated in the
    forward pass (torch's own train mode stores the unbiased variance)."""

    def __init__(self, c: int):
        super().__init__(c, eps=BN_EPS)

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        mean = x.mean((0, 2, 3))
        var = torch.clamp((x * x).mean((0, 2, 3)) - mean * mean, min=0.0)
        with torch.no_grad():
            for run, batch in ((self.running_mean, mean),
                               (self.running_var, var)):
                run.copy_(BN_MOMENTUM * run + (1 - BN_MOMENTUM) * batch)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((x - mean[:, None, None]) * mul[:, None, None]
                + self.bias[:, None, None])


def max_pool2x2(x):
    """The network's 2x2 stride-2 VALID max pool, looked up by name at each
    call, so that a check can record which input each window takes (or
    set it: the training check of chip_smoke.py's phase 15)."""
    return F.max_pool2d(x, 2, 2)


class Residual(nn.Module):
    """The hourglass's pre-activation bottleneck (layers/Residual.py); the
    skip is a 1x1 convolution only where the channel count changes."""

    def __init__(self, c_in: int, features: int):
        super().__init__()
        f = features
        self.bn0, self.conv0 = BatchNorm(c_in), nn.Conv2d(c_in, f // 2, 1)
        self.bn1 = BatchNorm(f // 2)
        self.conv1 = nn.Conv2d(f // 2, f // 2, 3, padding=1)
        self.bn2, self.conv2 = BatchNorm(f // 2), nn.Conv2d(f // 2, f, 1)
        self.skip = nn.Conv2d(c_in, f, 1) if c_in != f else None

    def forward(self, x):
        r = self.conv0(F.relu(self.bn0(x)))
        r = self.conv1(F.relu(self.bn1(r)))
        r = self.conv2(F.relu(self.bn2(r)))
        return r + (x if self.skip is None else self.skip(x))


class Hourglass(nn.Module):
    """The recursive hourglass (hg.py:8-60)."""

    def __init__(self, depth: int, features: int, n_modules: int = 1):
        super().__init__()
        f, n = features, n_modules
        self.depth = depth
        self.up1 = nn.ModuleList(Residual(f, f) for _ in range(n))
        self.low1 = nn.ModuleList(Residual(f, f) for _ in range(n))
        if depth > 1:
            self.inner = Hourglass(depth - 1, f, n)
        else:
            self.low2 = nn.ModuleList(Residual(f, f) for _ in range(n))
        self.low3 = nn.ModuleList(Residual(f, f) for _ in range(n))

    def forward(self, x):
        up1 = x
        for m in self.up1:
            up1 = m(up1)
        low = max_pool2x2(x)
        for m in self.low1:
            low = m(low)
        if self.depth > 1:
            low = self.inner(low)
        else:
            for m in self.low2:
                low = m(low)
        for m in self.low3:
            low = m(low)
        return up1 + F.interpolate(low, scale_factor=2, mode="nearest")


class Stack(nn.Module):
    """One stack's head: hourglass, residuals, a 1x1 convolution with BN,
    the output convolution and (but on the last stack) the two 1x1
    convolutions that feed the next stack."""

    def __init__(self, depth: int, features: int, n_out: int,
                 n_modules: int, last: bool):
        super().__init__()
        f = features
        self.hg = Hourglass(depth, f, n_modules)
        self.res = nn.ModuleList(Residual(f, f) for _ in range(n_modules))
        self.lin, self.bn = nn.Conv2d(f, f, 1), BatchNorm(f)
        self.out = nn.Conv2d(f, n_out, 1)
        self.ll_ = None if last else nn.Conv2d(f, f, 1)
        self.out_ = None if last else nn.Conv2d(n_out, f, 1)

    def forward(self, x):
        ll = self.hg(x)
        for m in self.res:
            ll = m(ll)
        ll = F.relu(self.bn(self.lin(ll)))
        tmp = self.out(ll)
        nxt = None if self.ll_ is None else x + self.ll_(ll) + self.out_(tmp)
        return tmp, nxt


def same_pad(size: int, k: int, stride: int):
    """XLA's "SAME" padding (before, after) of one spatial axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


class StarMapNet(nn.Module):
    """The stacked hourglass (hg.py:62-120): (B, 3, H, W) in [0, 1] to a
    list of (B, n_out, H/4, W/4), one a stack; channels [heatmap, cvf_x,
    cvf_y, cvf_z, depth]."""

    def __init__(self, n_stack: int = 2, n_feats: int = 256, n_out: int = 5,
                 hg_depth: int = 4, n_modules: int = 1):
        super().__init__()
        self.stem = nn.Conv2d(3, 64, 7, stride=2)
        self.stem_bn = BatchNorm(64)
        self.res0 = Residual(64, 128)
        self.res1 = Residual(128, 128)
        self.res2 = Residual(128, n_feats)
        self.stacks = nn.ModuleList(
            Stack(hg_depth, n_feats, n_out, n_modules, i == n_stack - 1)
            for i in range(n_stack))

    def forward(self, x):
        py, px = (same_pad(s, 7, 2) for s in x.shape[-2:])
        x = self.stem(F.pad(x, (*px, *py)))
        x = self.res0(F.relu(self.stem_bn(x)))
        x = self.res2(self.res1(max_pool2x2(x)))
        outs = []
        for s in self.stacks:
            tmp, x = s(x)
            outs.append(tmp)
        return outs


def init_like_flax(net: nn.Module, generator: torch.Generator) -> nn.Module:
    """Initialize `net` in place as flax initializes StarMapNet: each
    convolution's weight lecun_normal (a normal truncated at +-2 sigma,
    sigma = sqrt(1 / fan_in) / 0.8796, fan_in = kh kw c_in), its bias 0;
    batch norm's scale 1, bias 0, running mean 0 and variance 1. Drawn on
    the CPU from `generator` (a CPU torch.Generator), so one seed gives
    one init on every device. Returns `net`."""
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, nn.Conv2d):
                o, i, kh, kw = m.weight.shape
                std = (1.0 / (i * kh * kw)) ** 0.5 / LECUN_STD
                w = torch.empty(m.weight.shape, dtype=torch.float64)
                torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0,
                                            generator=generator)
                m.weight.copy_(w * std)
                m.bias.zero_()
            elif isinstance(m, BatchNorm):
                m.reset_parameters()
    return net


def heatmap_loss(outs, target):
    """The intermediate-supervision MSE over all stacks: outs a list of
    (B, C, H, W), target (B, C, H, W)."""
    loss = 0.0
    for o in outs:
        loss = loss + torch.mean((o - target) ** 2)
    return loss / len(outs)


def train_loss(outs, target, mask):
    """The loss the trainer minimizes (the JAX package's
    scripts/train_starmap.py:82-107), averaged over the stacks: BCE with
    logits on the heatmap, max(h, 0) - h t + log1p(exp(-|h|)), plus the
    cvf squared error and 0.3 x the depth's, both masked to the keypoint
    neighbourhoods and divided by max(sum mask, 1) (x 3 for cvf's three
    channels). outs a list of (B, 5, H, W), target (B, 5, H, W), mask (B,
    1, H, W)."""
    n = torch.clamp(mask.sum(), min=1.0)
    loss = 0.0
    for o in outs:
        h = o[:, 0]
        l_heat = torch.mean(torch.clamp(h, min=0) - h * target[:, 0]
                            + torch.log1p(torch.exp(-h.abs())))
        l_cvf = torch.sum(mask * (o[:, 1:4] - target[:, 1:4]) ** 2) / (n * 3)
        l_dep = torch.sum(mask[:, 0] * (o[:, 4] - target[:, 4]) ** 2) / n
        loss = loss + l_heat + 1.0 * l_cvf + 0.3 * l_dep
    return loss / len(outs)


# ---------------------------------------------------------------------------
# Post-processing (starmap.cpp), over a batch of heatmaps
# ---------------------------------------------------------------------------

def _grid_offsets(r: int, ref):
    """(S, 2) integer (x, y) offsets of the (2r+1)^2 window, rows of y."""
    o = torch.arange(-r, r + 1, device=ref.device)
    oy, ox = torch.meshgrid(o, o, indexing="ij")
    return torch.stack([ox.reshape(-1), oy.reshape(-1)], dim=1)


def _take(heatmap, px, py):
    """heatmap[..., py, px]: the maps (L..., H, W) read at index tensors
    (L..., I...), broadcast over L."""
    lead = heatmap.shape[:-2]
    idx = (py * heatmap.shape[-1] + px).long()
    idx = idx.expand(*lead, *idx.shape[len(lead):])
    return torch.gather(heatmap.reshape(*lead, -1), -1,
                        idx.reshape(*lead, -1)).reshape(idx.shape)


def extract_peaks(heatmap, max_peaks: int, thresh: float = HEAT_THRESH):
    """Local maxima above threshold (parse_keypoints_from_heatmap,
    starmap.h:133). heatmap (..., H, W); returns (xy (..., P, 2) in
    heatmap pixels, refined by the weighted centroid of the 5x5 patch,
    score (..., P), valid (..., P)), P = max_peaks, strongest first. A
    slot without a peak takes the lowest-index cell not yet taken, as
    top_k does with the -inf scores."""
    H, W = heatmap.shape[-2:]
    lead = heatmap.shape[:-2]
    m = F.max_pool2d(heatmap.reshape(-1, 1, H, W), 3, 1, 1).reshape(
        heatmap.shape)
    is_peak = (heatmap >= m) & (heatmap > thresh)
    score = torch.where(is_peak, heatmap, -torch.inf).reshape(*lead, H * W)
    top, idx = torch.sort(score, dim=-1, descending=True, stable=True)
    top, idx = top[..., :max_peaks], idx[..., :max_peaks]
    valid = torch.isfinite(top)
    xy = torch.stack([idx % W, idx // W], dim=-1).to(heatmap.dtype)
    offs = _grid_offsets(2, heatmap)
    p = xy.to(torch.int32)
    px = torch.clamp(p[..., 0:1] + offs[:, 0], 0, W - 1)
    py = torch.clamp(p[..., 1:2] + offs[:, 1], 0, H - 1)
    w = torch.clamp(_take(heatmap, px, py) - thresh * 0.5, min=0.0)
    wsum = torch.clamp(w.sum(-1, keepdim=True), min=1e-6)
    xy = xy + (w[..., None] * offs.to(w.dtype)).sum(-2) / wsum
    return xy, torch.where(valid, top, 0.0), valid


def cov_from_heatmap(heatmap, xy, radius: int = 4):
    """Each peak's 2x2 covariance from the weighted second moments of the
    (2r+1)^2 patch around it (starmap.h:32). heatmap (..., H, W), xy
    (..., P, 2); returns (..., P, 2, 2)."""
    H, W = heatmap.shape[-2:]
    offs = _grid_offsets(radius, heatmap)
    pts = xy[..., None, :] + offs.to(xy.dtype)
    px = torch.clamp(pts[..., 0].to(torch.int32), 0, W - 1)
    py = torch.clamp(pts[..., 1].to(torch.int32), 0, H - 1)
    w = torch.clamp(_take(heatmap, px, py), min=0.0)
    wsum = torch.clamp(w.sum(-1), min=1e-6)
    offs = offs.to(w.dtype)
    mean = (w[..., None] * offs).sum(-2) / wsum[..., None]
    d = offs - mean[..., None, :]
    cov = torch.einsum("...s,...si,...sj->...ij", w, d, d) / wsum[..., None,
                                                                  None]
    return cov + 1e-3 * torch.eye(2, dtype=cov.dtype, device=cov.device)


def assign_parts(cvf, canonical_points):
    """Each peak's nearest canonical part (starmap.cpp:640-659): cvf (..., P,
    3), canonical (K, 3); returns (part_id (..., P), dist (..., P))."""
    d = torch.linalg.vector_norm(cvf[..., :, None, :] - canonical_points,
                                 dim=-1)
    return torch.argmin(d, dim=-1), torch.amin(d, dim=-1)


def merge_duplicate_parts(part_id, score, valid, n_parts: int):
    """The highest-scoring peak of each part label, the first of equal
    scores (starmap.cpp:652-659). Returns (best_peak_idx (..., K) int32,
    part_found (..., K))."""
    P = part_id.shape[-1]
    lead = part_id.shape[:-1]
    s = torch.where(valid, score, -torch.inf)
    slot = torch.where(valid, part_id, n_parts).long()
    best = torch.full((*lead, n_parts + 1), -torch.inf, dtype=s.dtype,
                      device=s.device).scatter_reduce(-1, slot, s, "amax")
    is_best = valid & (s == torch.gather(
        best, -1, torch.clamp(part_id, 0, n_parts - 1).long()))
    order = torch.where(is_best, torch.arange(P, device=s.device), P).to(
        torch.int32)
    first = torch.full((*lead, n_parts + 1), P, dtype=torch.int32,
                       device=s.device).scatter_reduce(
        -1, torch.where(is_best, part_id, n_parts).long(), order, "amin")
    best_idx = first[..., :n_parts]
    return torch.clamp(best_idx, 0, P - 1), best_idx < P


def _pick(x, idx):
    """x[..., idx[..., k], ...] along the peak axis (-1 of idx)."""
    i = idx.long().reshape(*idx.shape, *([1] * (x.dim() - idx.dim())))
    return torch.gather(x, idx.dim() - 1,
                        i.expand(*idx.shape, *x.shape[idx.dim():]))


def detect_keypoints(model: StarMapNet, crops, canonical_points,
                     max_peaks: int = 16):
    """Inference on a batch of bbox crops (starmap.cpp:606-696): crops (B,
    3, S, S) in [0, 1]. Returns a dict of (B, ...) tensors: each part's
    keypoint (heatmap pixels), score, covariance, depth and found mask,
    and the raw peaks before the part merge (xy, score, valid, cvf), which
    the detector relabels by joint geometry."""
    with torch.no_grad():
        pred = model(crops)[-1]  # (B, 5, S/4, S/4)
    heat = torch.sigmoid(pred[:, 0])
    xy, score, valid = extract_peaks(heat, max_peaks)
    H, W = heat.shape[-2:]
    px = torch.clamp(xy[..., 0].to(torch.int32), 0, W - 1)
    py = torch.clamp(xy[..., 1].to(torch.int32), 0, H - 1)
    feats = _take(pred[:, 1:5], px[:, None], py[:, None])  # (B, 4, P)
    cvf = feats[:, :3].transpose(1, 2)
    depth = feats[:, 3]
    canon = canonical_points.to(pred.dtype)
    part_id, _ = assign_parts(cvf, canon)
    best_idx, found = merge_duplicate_parts(part_id, score, valid,
                                            canon.shape[0])
    cov = cov_from_heatmap(heat, xy)
    return dict(
        kp_xy=_pick(xy, best_idx), kp_score=_pick(score, best_idx),
        kp_cov=_pick(cov, best_idx), kp_depth=_pick(depth, best_idx),
        found=found, peaks_xy=xy, peaks_score=score, peaks_valid=valid,
        peaks_cvf=cvf)


def load_pretrained(path=None, device=None, dtype=torch.float32):
    """The shipped synthetic-car checkpoint: (model in eval mode on
    `device`, meta). `path` is the checkpoint's stem (``.json`` for the
    configuration, ``.msgpack`` for flax's variables), by default the JAX
    package's file, read as bytes; nothing of that package is imported."""
    from ..convert import starmap_state_dict_from_flax
    from .flax_msgpack import restore

    device = resolve_device(device)
    no_tf32()
    path = str(WEIGHTS if path is None else path)
    with open(path + ".json") as f:
        meta = json.load(f)
    with open(path + ".msgpack", "rb") as f:
        variables = restore(f.read())
    model = StarMapNet(**meta["model"])
    model.load_state_dict(starmap_state_dict_from_flax(
        variables["params"], variables["batch_stats"], meta["model"]))
    return model.to(device=device, dtype=dtype).eval(), meta

