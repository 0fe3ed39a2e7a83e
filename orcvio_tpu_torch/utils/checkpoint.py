"""Filter-state checkpoint and resume with torch.save.

Counterpart of ``orcvio_tpu/utils/checkpoint.py`` (orbax there). The
reference keeps no checkpoints; here a state is a tree of tensors
(``tree.py``), so a long replay can stop and resume exactly: the tree's
tensors are saved under ``path/step``, and a restore puts them in the
template's layout, dtypes and devices. Fields kept outside the tree's
leaves (a ``Tree``'s ``_static``: the tracker's generator, VioState's
host flag) are the template's.
"""
from __future__ import annotations

import os

import torch
import torch.utils._pytree as pytree

_FILE = "state.pt"


def save_state(path: str, state, step: int = 0) -> str:
    """Save a tree of tensors (FilterState, VioState, ...) to path/step;
    returns that directory."""
    out = os.path.join(os.path.abspath(path), str(step))
    os.makedirs(out, exist_ok=True)
    torch.save([x.detach().cpu() for x in pytree.tree_leaves(state)],
               os.path.join(out, _FILE))
    return out


def restore_state(path: str, template, step: int = 0):
    """The tree saved by save_state at path/step, in `template`'s layout,
    with its leaves' dtypes and devices. Raises ValueError where the
    number of leaves or a leaf's shape differs from the template's."""
    saved = torch.load(os.path.join(os.path.abspath(path), str(step), _FILE),
                       weights_only=True)
    leaves, spec = pytree.tree_flatten(template)
    if len(saved) != len(leaves) or any(
            a.shape != b.shape for a, b in zip(saved, leaves)):
        raise ValueError("restore_state: the checkpoint's leaves are not "
                         "the template's")
    return pytree.tree_unflatten(
        [a.to(device=b.device, dtype=b.dtype) for a, b in zip(saved, leaves)],
        spec)


def latest_step(path: str):
    """The highest step saved under path, or None."""
    if not os.path.isdir(path):
        return None
    steps = [int(d) for d in os.listdir(path) if d.isdigit()]
    return max(steps) if steps else None
