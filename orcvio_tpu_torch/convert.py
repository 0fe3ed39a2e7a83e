"""Carry state from the JAX package into the port.

The system's state is the tracker's (the previous frame's prepared
pyramid and the track table), the VIO state (filter and static
initializer) and the object layer's (SORT's tracks, the object table, the
pose history, the staged replay's map and carry).
``tracker_state_from_numpy``, ``vio_state_from_numpy`` and the object
converters take that state as numpy arrays (the JAX states read out field
by field with ``state_to_numpy``) and return the port's, so both packages
can run onward from the same mid-sequence state. Its one set of weights,
the StarMap keypoint network's, comes from flax's variables through
``starmap_state_dict_from_flax`` and goes back to them, for a checkpoint
the port trained, through ``starmap_flax_from_state_dict``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import resolve_device
from .filter.state import (CloneStates, FeatureTable, FilterState, ImuState,
                           NuiClones)
from .frontend.klt import MARGIN
from .frontend.tracker import TrackerConfig, TrackerState, level_shapes
from .init.static_init import StaticInitState
from .objects.kf import Kf4State, Kf7State
from .objects.manager import ObjectTable, PoseHistory
from .objects.sort import SortState
from .objects.staged import MapTable, ObjectsCarry
from .ops.dma_gather import BL, BR
from .ops.window_gather import AlignedImage

_IMU = {k: ImuState for k in ("imu", "imu_old", "imu_fej_now", "imu_fej_old")}
_FIELD_TYPES = {FilterState: {**_IMU, "clones": CloneStates,
                              "features": FeatureTable, "nui": NuiClones},
                SortState: {"kf": Kf7State},
                ObjectTable: {"kp_kf": Kf4State}}


def tracker_state_from_numpy(d: dict, tc: TrackerConfig, dtype=torch.float32,
                             device=None, seed: int = 0) -> TrackerState:
    """d: {"pyr": [(1, Hp, Wp) padded level images], "xy", "uvn",
    "desc" (uint32 (N, 8)), "fid", "t", "next_id"} as numpy arrays.

    The RANSAC generator starts from `seed`: the JAX key stream cannot be
    carried into torch."""
    device = resolve_device(device)

    def put(x, dt):
        x = np.require(x, requirements="W")  # torch wants writable arrays
        return torch.as_tensor(x).to(device=device, dtype=dt)

    pyr = []
    for padded, shape in zip(d["pyr"], level_shapes(tc)):
        p = put(padded, dtype)
        if p.dim() != 3 or p.shape[1] % BR or p.shape[2] % BL:
            raise ValueError(f"pyramid level {tuple(p.shape)} is not a "
                             "(C, Hp, Wp) tile-aligned padded image")
        pyr.append(AlignedImage(p, p.shape[1] // BR, p.shape[2] // BL,
                                MARGIN, shape))
    return TrackerState(
        pyr=tuple(pyr),
        xy=put(d["xy"], dtype),
        uvn=put(d["uvn"], dtype),
        desc=put(np.asarray(d["desc"], np.uint32).astype(np.int64),
                 torch.int64),
        fid=put(d["fid"], torch.int32),
        t=put(d["t"], dtype),
        next_id=put(d["next_id"], torch.int32),
        rng=torch.Generator(device=device).manual_seed(seed),
    )


def _state_from_numpy(cls, d, dtype, device):
    """A state dataclass from a nested dict of numpy arrays: floating
    fields take `dtype`, integer fields int32, boolean fields bool."""
    kw = {}
    for f in dataclasses.fields(cls):
        v = d[f.name]
        if isinstance(v, dict):
            kw[f.name] = _state_from_numpy(_FIELD_TYPES[cls][f.name], v, dtype,
                                           device)
            continue
        a = np.require(np.asarray(v), requirements="W")
        dt = (dtype if a.dtype.kind == "f" else
              torch.bool if a.dtype.kind == "b" else torch.int32)
        kw[f.name] = torch.as_tensor(a).to(device=device, dtype=dt)
    return cls(**kw)


def filter_state_from_numpy(d: dict, dtype=torch.float32, device=None):
    """d: the JAX ``FilterState`` as nested dicts of numpy arrays."""
    return _state_from_numpy(FilterState, d, dtype, resolve_device(device))


def vio_state_from_numpy(d: dict, dtype=torch.float32, device=None):
    """d: the JAX ``VioState`` as nested dicts of numpy arrays, one key per
    field ({"filter": {"t", "imu": {"R", ...}, ..., "P", ...}, "sinit":
    {...}}). Returns the port's ``VioState``; ``host_initialized`` is
    read from the filter's ``initialized`` flag."""
    from .vio import VioState

    device = resolve_device(device)
    vs = VioState(
        filter=filter_state_from_numpy(d["filter"], dtype, device),
        sinit=_state_from_numpy(StaticInitState, d["sinit"], dtype, device))
    return vs.replace(host_initialized=bool(np.asarray(
        d["filter"]["initialized"])))


def sort_state_from_numpy(d: dict, dtype=torch.float32, device=None):
    """d: the JAX ``SortState`` as nested dicts of numpy arrays."""
    return _state_from_numpy(SortState, d, dtype, resolve_device(device))


def object_table_from_numpy(d: dict, dtype=torch.float32, device=None):
    """d: the JAX ``ObjectTable`` as nested dicts of numpy arrays."""
    return _state_from_numpy(ObjectTable, d, dtype, resolve_device(device))


def pose_history_from_numpy(d: dict, dtype=torch.float32, device=None):
    """d: the JAX ``PoseHistory`` as a dict of numpy arrays."""
    return _state_from_numpy(PoseHistory, d, dtype, resolve_device(device))


def map_table_from_numpy(d: dict, dtype=torch.float32, device=None):
    """d: the JAX staged replay's ``MapTable`` as a dict of numpy arrays."""
    return _state_from_numpy(MapTable, d, dtype, resolve_device(device))


def objects_carry_from_numpy(d: dict, dtype=torch.float32, device=None):
    """d: the JAX staged replay's ``ObjectsCarry`` as nested dicts of numpy
    arrays ({"vio", "sort", "table", "poses", "pending", "omap"})."""
    device = resolve_device(device)
    return ObjectsCarry(
        vio=vio_state_from_numpy(d["vio"], dtype, device),
        sort=sort_state_from_numpy(d["sort"], dtype, device),
        table=object_table_from_numpy(d["table"], dtype, device),
        poses=pose_history_from_numpy(d["poses"], dtype, device),
        pending=torch.as_tensor(np.array(d["pending"], bool),
                                device=device),
        omap=map_table_from_numpy(d["omap"], dtype, device))


def _fields(tree):
    """(name, value) of a dataclass's fields or a NamedTuple's."""
    if dataclasses.is_dataclass(tree):
        return [(f.name, getattr(tree, f.name))
                for f in dataclasses.fields(tree)]
    return list(tree._asdict().items())


def _is_tree(v):
    return dataclasses.is_dataclass(v) or (isinstance(v, tuple)
                                           and hasattr(v, "_fields"))


def state_to_numpy(tree) -> dict:
    """A JAX flax struct or NamedTuple, or a port state dataclass, as
    nested dicts of numpy arrays (the layout the converters read)."""
    out = {}
    for name, v in _fields(tree):
        if _is_tree(v):
            out[name] = state_to_numpy(v)
        elif not isinstance(v, bool):
            out[name] = (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                         else np.asarray(v))
    return out


def _flax_leaves(tree, prefix=()):
    """{path tuple: array} of a nested dict of arrays."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flax_leaves(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _starmap_modules(cfg: dict):
    """(flax module path, torch module name, "conv" or "bn") of every
    layer of StarMapNet(**cfg), in flax's creation order: its compact
    modules number each type by creation, so StarMapNet's convolutions
    run across the stacks (Conv_1 to Conv_4 in stack 0, Conv_5 and Conv_6
    in the last), a Residual's skip is its Conv_3 (only where the channel
    count changes) and an Hourglass makes up1, low1, then its inner
    Hourglass_0 (or, at depth 1, the low2 residuals), then low3."""
    n, nf = cfg.get("n_modules", 1), cfg["n_feats"]
    out = []

    def residual(fp, tp, c_in, f):
        for i in range(3):
            out.append((fp + (f"BatchNorm_{i}",), f"{tp}.bn{i}", "bn"))
            out.append((fp + (f"Conv_{i}",), f"{tp}.conv{i}", "conv"))
        if c_in != f:
            out.append((fp + ("Conv_3",), f"{tp}.skip", "conv"))

    def hourglass(fp, tp, depth):
        names = ["up1", "low1"] + ([] if depth > 1 else ["low2"]) + ["low3"]
        r = 0
        for name in names:
            if name == "low3" and depth > 1:
                hourglass(fp + ("Hourglass_0",), f"{tp}.inner", depth - 1)
            for k in range(n):
                residual(fp + (f"Residual_{r}",), f"{tp}.{name}.{k}", nf, nf)
                r += 1

    out += [(("Conv_0",), "stem", "conv"), (("BatchNorm_0",), "stem_bn", "bn")]
    for i, (c_in, f) in enumerate(((64, 128), (128, 128), (128, nf))):
        residual((f"Residual_{i}",), f"res{i}", c_in, f)
    r, c = 3, 1
    for i in range(cfg["n_stack"]):
        tp = f"stacks.{i}"
        hourglass((f"Hourglass_{i}",), f"{tp}.hg", cfg["hg_depth"])
        for k in range(n):
            residual((f"Residual_{r}",), f"{tp}.res.{k}", nf, nf)
            r += 1
        heads = ["lin", "out"] + (["ll_", "out_"] if i < cfg["n_stack"] - 1
                                  else [])
        for name in heads:
            out.append(((f"Conv_{c}",), f"{tp}.{name}", "conv"))
            c += 1
        out.append(((f"BatchNorm_{i + 1}",), f"{tp}.bn", "bn"))
    return out


def starmap_state_dict_from_flax(params: dict, batch_stats: dict,
                                 cfg: dict) -> dict:
    """The state dict of ``models/starmap.py:StarMapNet(**cfg)`` from the
    JAX package's flax variables (nested dicts of numpy arrays): HWIO
    kernels become OIHW weights, BN's scale, bias, mean and var its
    weight, bias, running_mean and running_var. Raises unless every flax
    leaf is taken exactly once."""
    leaves = {("params",) + k: v for k, v in _flax_leaves(params).items()}
    leaves.update({("batch_stats",) + k: v
                   for k, v in _flax_leaves(batch_stats).items()})
    taken = {}

    def take(path):
        if path in taken or path not in leaves:
            raise KeyError(f"flax leaf {'/'.join(path)} "
                           f"{'taken twice' if path in taken else 'missing'}")
        taken[path] = True
        return torch.from_numpy(np.array(leaves[path]))

    sd = {}
    for fp, tp, kind in _starmap_modules(cfg):
        if kind == "conv":
            sd[f"{tp}.weight"] = take(("params",) + fp + ("kernel",)).permute(
                3, 2, 0, 1).contiguous()
            sd[f"{tp}.bias"] = take(("params",) + fp + ("bias",))
        else:
            sd[f"{tp}.weight"] = take(("params",) + fp + ("scale",))
            sd[f"{tp}.bias"] = take(("params",) + fp + ("bias",))
            sd[f"{tp}.running_mean"] = take(("batch_stats",) + fp + ("mean",))
            sd[f"{tp}.running_var"] = take(("batch_stats",) + fp + ("var",))
            sd[f"{tp}.num_batches_tracked"] = torch.tensor(0)
    left = sorted("/".join(k) for k in leaves if k not in taken)
    if left:
        raise KeyError(f"flax leaves not taken: {left}")
    return sd


def _nest(leaves: dict) -> dict:
    """Nested dicts of {path tuple: array}, each level's keys sorted (the
    order jax.device_get gives flax's variables, so to_bytes writes):
    paths taken in sorted order insert each level's keys in order."""
    out = {}
    for path in sorted(leaves):
        d = out
        for k in path[:-1]:
            d = d.setdefault(k, {})
        d[path[-1]] = leaves[path]
    return out


def starmap_flax_from_state_dict(sd: dict, cfg: dict):
    """(params, batch_stats), flax's variables of StarMapNet(**cfg) as
    nested dicts of numpy arrays, from the port's state dict: the inverse
    of ``starmap_state_dict_from_flax`` (OIHW weights become HWIO kernels;
    BN's weight, bias, running_mean and running_var its scale, bias, mean
    and var). Raises unless every weight and statistic is taken exactly
    once (``num_batches_tracked``, which flax has not, is left)."""
    params, stats, taken = {}, {}, set()

    def take(name):
        if name in taken or name not in sd:
            raise KeyError(f"state dict entry {name} "
                           f"{'taken twice' if name in taken else 'missing'}")
        taken.add(name)
        return sd[name].detach().cpu().numpy()

    for fp, tp, kind in _starmap_modules(cfg):
        if kind == "conv":
            params[fp + ("kernel",)] = np.ascontiguousarray(
                take(f"{tp}.weight").transpose(2, 3, 1, 0))
            params[fp + ("bias",)] = take(f"{tp}.bias")
        else:
            params[fp + ("scale",)] = take(f"{tp}.weight")
            params[fp + ("bias",)] = take(f"{tp}.bias")
            stats[fp + ("mean",)] = take(f"{tp}.running_mean")
            stats[fp + ("var",)] = take(f"{tp}.running_var")
    left = sorted(k for k in sd if k not in taken
                  and not k.endswith("num_batches_tracked"))
    if left:
        raise KeyError(f"state dict entries not taken: {left}")
    return _nest(params), _nest(stats)
