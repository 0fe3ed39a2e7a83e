"""Shared inputs of the StarMap and config-B tests.

``jax_pretrained()`` is the JAX package's ``models/starmap.py:
load_pretrained()`` without its eager ``model.init`` (some 9 s on the
CPU): flax's ``from_bytes`` into a tree of dicts restores the same
arrays as ``msgpack_restore``, so the checkpoint is read that way
(tests/test_torch_starmap.py holds the port's reader to it bit for bit).
``config_b_frames(ks)`` renders config B's frames ks with the port's
numpy renderer (bit for bit the JAX package's), as
``orcvio_tpu_torch/eval/object_map_cnn.py`` does: the frames, their
boxes, and the VIO inputs.
"""
from __future__ import annotations

import json

import numpy as np
import torch

from orcvio_tpu_torch.models.starmap import WEIGHTS


def jax_pretrained():
    import flax.serialization

    from orcvio_tpu.models.starmap import StarMapNet

    path = str(WEIGHTS)
    with open(path + ".json") as f:
        meta = json.load(f)
    with open(path + ".msgpack", "rb") as f:
        v = flax.serialization.msgpack_restore(f.read())
    return StarMapNet(**meta["model"]), v["params"], v["batch_stats"], meta


def config_b_frames(n_frames: int):
    """Config B's first n_frames frames: (images (T, 240, 240) float32 in
    [0, 1], boxes (T, 4, 4), valid (T, 4), the world, the generated VIO
    data on the CPU in float64)."""
    from orcvio_tpu_torch.dataio.synthetic import generate
    from orcvio_tpu_torch.eval import object_map_cnn as cb
    from orcvio_tpu_torch.eval.object_map_sim import make_world

    wc = cb.world_config()
    objs = make_world(wc)
    data = generate(cb.world_sim(wc), R_b2c=cb.R_B2C, t_c_b=cb.T_C_B,
                    dtype=torch.float64, device="cpu")
    gt_R, gt_p = data.gt_R.numpy(), data.gt_p.numpy()
    rng = np.random.default_rng(5)
    imgs, boxes, valid = [], [], []
    for k in range(n_frames):
        img, bx = cb.render_frame(wc, objs, cb.camera_pose(gt_R[k], gt_p[k]),
                                  rng)
        b, v = cb.frame_boxes(bx)
        imgs.append(img)
        boxes.append(b)
        valid.append(v)
    return np.stack(imgs), np.stack(boxes), np.stack(valid), wc, objs, data
