"""Train the StarMap hourglass on synthetic car renders, and write a
checkpoint that both packages' ``load_pretrained`` read.

Counterpart of ``scripts/train_starmap.py``: the shipped widths (2
stacks, 64 features, hourglass depth 3, one module: 460,938 parameters)
at 96 px, batches of 32 drawn from a dataset of renders quantized to
uint8 (``build_dataset``), Adam (b1 0.9, b2 0.999, eps 1e-8) under
optax's warmup_cosine_decay_schedule (``warmup_cosine_decay``, warm-up
min(100, steps / 2), lr 0 on the first update), the loss
``models/starmap.py:train_loss``, batch norm in train mode with its
running statistics updated in the forward pass. The network starts from
``init_like_flax`` with a seeded generator. At the end the recall@2px of
the peaks and the accuracy of the cvf labels on 32 fresh renders
(``evaluate``), then ``<out>.msgpack`` in flax's {"params",
"batch_stats"} layout and ``<out>.json`` (``save``).

    python -m orcvio_tpu_torch.scripts.train_starmap [--steps 3000]
        [--batch 32] [--dataset 6144] [--lr 1e-3] [--out PATH]
        [--device cpu]

Runs on the card unless ``--device cpu`` is given (it raises where there
is none), with TF32 off. The default ``--out`` is ``train_out/starmap_car``
under the repository's root.
"""
from __future__ import annotations

import argparse
import json
import math
import time
from pathlib import Path

import numpy as np
import torch

from .. import no_tf32, resolve_device
from ..convert import starmap_flax_from_state_dict
from ..dataio.render_object import CAR_KEYPOINTS, make_training_batch
from ..models.flax_msgpack import dump
from ..models.starmap import (StarMapNet, detect_keypoints, init_like_flax,
                              train_loss)

MODEL_KW = dict(n_stack=2, n_feats=64, n_out=5, hg_depth=3, n_modules=1)
SIZE = 96
DEFAULT_OUT = Path(__file__).resolve().parents[2] / "train_out" / "starmap_car"
INIT_SEED = 0
DATA_SEED = 1  # the generator that draws each step's batch
EVAL_SEED = 99
ADAM = dict(betas=(0.9, 0.999), eps=1e-8)


def build_dataset(n: int, seed: int = 0):
    """(images (n, S, S, 3) uint8, targets (n, S/4, S/4, 5), masks (n,
    S/4, S/4, 1)) float32, NHWC: make_training_batch in chunks of 64 from
    one generator, the images' 255 x clipped to [0, 255] and truncated to
    uint8."""
    rng = np.random.default_rng(seed)
    imgs = np.empty((n, SIZE, SIZE, 3), np.uint8)
    tgts = np.empty((n, SIZE // 4, SIZE // 4, 5), np.float32)
    msks = np.empty((n, SIZE // 4, SIZE // 4, 1), np.float32)
    chunk = 64
    for i in range(0, n, chunk):
        im, tg, mk = make_training_batch(rng, min(chunk, n - i), SIZE)
        imgs[i:i + chunk] = np.clip(im * 255, 0, 255).astype(np.uint8)
        tgts[i:i + chunk] = tg
        msks[i:i + chunk] = mk
    return imgs, tgts, msks


def _fma32(a, b, c) -> np.float32:
    """a b + c rounded once to float32 (a, b, c float32; their product is
    exact in float64)."""
    return np.float32(np.float64(a) * np.float64(b) + np.float64(c))


def warmup_cosine_decay(step: int, peak: float, warmup: int,
                        decay_steps: int, init: float = 0.0,
                        end: float = 0.0) -> float:
    """optax.warmup_cosine_decay_schedule(init, peak, warmup, decay_steps,
    end) at `step` (an int count, as adam's), as the JAX trainer's jitted
    step evaluates it: linear from init to peak over the warm-up, then a
    cosine from peak to end over decay_steps - warmup steps. optax keeps
    the warm-up in float32, (init - peak) (1 - k / warmup) + peak, which
    XLA compiles to two fused multiply-adds with 1 / warmup as a float32
    constant: so does this (the form cancels: 1e-5 comes out as
    9.99999e-6). The cosine is in float64, as optax's under x64 (without
    x64 XLA evaluates it in float32, some float32 ulps away)."""
    f = np.float32
    if warmup > 0 and step < warmup:
        frac = _fma32(f(-min(max(step, 0), warmup)), f(1.0 / warmup), f(1))
        return float(_fma32(f(init - peak), frac, f(peak)))
    alpha = 0.0 if peak == 0.0 else end / peak
    n = decay_steps - warmup
    count = min(float(step - warmup), float(n))
    cosine = 0.5 * (1 + math.cos(math.pi * count / n))
    return peak * ((1 - alpha) * cosine + alpha)


class ScheduledAdam(torch.optim.Adam):
    """optax.adam(schedule): Adam whose k-th update (k from 0) takes the
    learning rate schedule(k), set before the step, as optax's
    scale_by_learning_rate reads its count, and rounded to float32, as
    optax's schedule returns it at adam's int32 count (under x64 too).
    schedule(0) = 0 makes the first update zero while the moments still
    move."""

    def __init__(self, params, schedule):
        super().__init__(params, lr=0.0, **ADAM)
        self.schedule = schedule
        self.count = 0

    def step(self, closure=None):
        for group in self.param_groups:
            group["lr"] = float(np.float32(self.schedule(self.count)))
        out = super().step(closure)
        self.count += 1
        return out


def make_optimizer(net, lr: float, steps: int) -> ScheduledAdam:
    """The trainer's Adam for a run of `steps` steps: warm-up min(100,
    steps // 2), decay over max(steps, warm-up + 1), peak `lr`."""
    warmup = min(100, steps // 2)
    decay = max(steps, warmup + 1)
    return ScheduledAdam(net.parameters(), lambda k: warmup_cosine_decay(
        k, lr, warmup, decay))


def train_step(net, opt, img, tgt, msk):
    """One step in train mode: img (B, 3, S, S) in [0, 1], tgt (B, 5, S/4,
    S/4), msk (B, 1, S/4, S/4). The running statistics update in the
    forward pass. Returns the loss (a 0-d tensor, not read back); each
    parameter's .grad holds this step's gradient until the next."""
    net.train()
    opt.zero_grad(set_to_none=True)
    loss = train_loss(net(img), tgt, msk)
    loss.backward()
    opt.step()
    return loss.detach()


def stage(data, device, dtype=torch.float32):
    """The dataset (build_dataset's arrays) on `device`, NCHW: the images
    as uint8, the targets and masks in `dtype`."""
    imgs, tgts, msks = data

    def nchw(a, dt):
        return torch.as_tensor(np.ascontiguousarray(
            np.moveaxis(a, -1, 1))).to(device=device, dtype=dt)

    return nchw(imgs, torch.uint8), nchw(tgts, dtype), nchw(msks, dtype)


def batches(staged, batch: int, steps: int, dtype=torch.float32,
            seed: int = DATA_SEED):
    """Each step's (img, tgt, msk): `batch` rows drawn with replacement by
    numpy's default_rng(seed), one draw a step as the JAX package's
    trainer draws them, the images scaled by 1 / 255 in `dtype`. The
    indices of all steps go to the device at once: a copy a step would
    wait for the steps queued before it."""
    imgs, tgts, msks = staged
    rng = np.random.default_rng(seed)
    idx = torch.as_tensor(np.stack([rng.integers(0, imgs.shape[0], batch)
                                    for _ in range(steps)])).to(imgs.device)
    for k in range(steps):
        yield imgs[idx[k]].to(dtype) / 255.0, tgts[idx[k]], msks[idx[k]]


def evaluate(net, seed: int = EVAL_SEED, n: int = 32) -> dict:
    """Peak recall@2px and cvf-label accuracy of `net` (in eval mode) on n
    fresh renders from default_rng(seed), as the JAX package's trainer
    scores them: every ground-truth peak (heat > 0.95) needs a found part
    within 2 heatmap px; every valid raw peak on a keypoint (heat >= 0.7)
    must carry that keypoint's nearest-canonical label."""
    p = next(net.parameters())
    im, tg, _ = make_training_batch(np.random.default_rng(seed), n, SIZE)
    crops = torch.as_tensor(np.ascontiguousarray(np.moveaxis(im, -1, 1)),
                            dtype=p.dtype, device=p.device)
    canon = np.asarray(CAR_KEYPOINTS, np.float32)
    net.eval()
    det = {k: v.cpu().numpy() for k, v in detect_keypoints(
        net, crops, torch.as_tensor(canon, device=p.device)).items()}
    hits = tot = lbl_hits = lbl_tot = 0
    for b in range(n):
        heat_t = tg[b, ..., 0]
        H, W = heat_t.shape
        det_xy = det["kp_xy"][b][det["found"][b]]
        for gy, gx in np.argwhere(heat_t > 0.95):
            tot += 1
            if len(det_xy) and np.min(np.hypot(det_xy[:, 0] - gx,
                                               det_xy[:, 1] - gy)) <= 2.0:
                hits += 1
        pk, pcvf = det["peaks_xy"][b], det["peaks_cvf"][b]
        for q in np.nonzero(det["peaks_valid"][b])[0]:
            gx, gy = int(round(pk[q, 0])), int(round(pk[q, 1]))
            y, x = min(gy, H - 1), min(gx, W - 1)
            if heat_t[y, x] < 0.7:
                continue
            true_lbl = np.argmin(np.linalg.norm(tg[b, y, x, 1:4][None]
                                                - canon, axis=1))
            pred_lbl = np.argmin(np.linalg.norm(pcvf[q][None] - canon,
                                                axis=1))
            lbl_tot += 1
            lbl_hits += int(pred_lbl == true_lbl)
    return {"recall_at_2px": hits / max(tot, 1), "peaks": [hits, tot],
            "label_accuracy": lbl_hits / max(lbl_tot, 1),
            "labels": [lbl_hits, lbl_tot]}


def save(net, out, recall: float | None = None) -> Path:
    """Write <out>.msgpack (flax's {"params", "batch_stats"} variables,
    float32, as flax.serialization.to_bytes writes them) and <out>.json
    (the model's widths, input size and recall). Returns the msgpack's
    path."""
    out = Path(out)
    out.parent.mkdir(parents=True, exist_ok=True)
    sd = {k: v.float() if v.is_floating_point() else v
          for k, v in net.state_dict().items()}
    params, stats = starmap_flax_from_state_dict(sd, MODEL_KW)
    path = out.with_name(out.name + ".msgpack")
    path.write_bytes(dump({"params": params, "batch_stats": stats}))
    meta = {"model": MODEL_KW, "input_size": SIZE}
    if recall is not None:
        meta["recall_at_2px"] = round(recall, 4)
    out.with_name(out.name + ".json").write_text(json.dumps(meta))
    return path


def main(argv=None):
    """Train, evaluate and save. Returns (report, the trained network);
    the report is printed as one JSON line."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--dataset", type=int, default=6144)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    no_tf32()

    print("building dataset...", flush=True)
    t0 = time.perf_counter()
    staged = stage(build_dataset(args.dataset), device)
    build_s = time.perf_counter() - t0
    print(f"  {args.dataset} renders in {build_s:.1f}s", flush=True)
    net = StarMapNet(**MODEL_KW)
    init_like_flax(net, torch.Generator().manual_seed(INIT_SEED))
    net.to(device)
    n_params = sum(p.numel() for p in net.parameters())
    print(f"model: {n_params / 1e6:.2f}M params", flush=True)
    opt = make_optimizer(net, args.lr, args.steps)
    losses = []
    t0 = time.perf_counter()
    for i, (img, tgt, msk) in enumerate(batches(staged, args.batch,
                                                args.steps)):
        losses.append(train_step(net, opt, img, tgt, msk))
        if i % 200 == 0 or i == args.steps - 1:
            print(f"step {i}: loss {float(losses[-1]):.4f} "
                  f"({time.perf_counter() - t0:.0f}s)", flush=True)
    train_s = time.perf_counter() - t0
    losses = torch.stack(losses).double().cpu().tolist()
    ev = evaluate(net)
    print(f"eval: peak recall@2px = {ev['peaks'][0]}/{ev['peaks'][1]} = "
          f"{ev['recall_at_2px']:.3f}")
    print(f"eval: cvf label accuracy = {ev['labels'][0]}/{ev['labels'][1]} "
          f"= {ev['label_accuracy']:.3f}")
    path = save(net, args.out, ev["recall_at_2px"])
    report = {"steps": args.steps, "batch": args.batch,
              "dataset": args.dataset, "params": n_params,
              "device": str(device), "build_s": build_s, "train_s": train_s,
              "losses": losses, "eval": ev, "checkpoint": str(path)}
    print(json.dumps({k: v for k, v in report.items() if k != "losses"}
                     | {"final_loss": losses[-1]}), flush=True)
    return report, net


if __name__ == "__main__":
    main()
