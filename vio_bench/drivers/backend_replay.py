"""Driver of the fleet back end: B robots' filters, each on its own
feature-message sequence, through ``orcvio_tpu_torch.parallel.replay.
sharded_replay_fn`` over a one-card mesh, one frame a call. No images and
no front end: the filter alone.

Set-up builds every row's start, the default prior at the trajectory's
pose at t = 0, initialized (``dataio/synthetic.py:initialized_run``'s
set-up), and keeps it as the snapshot; the window runs passes of the
mix's frames, each pass from the snapshot. The check follows sampled
rows through sampled frames with the plain reference's frame
(``vio_bench/reference/msckf.py``) from the program's state before it,
and holds the start against the reference's own.
"""
from __future__ import annotations

import numpy as np
import torch

from orcvio_tpu_torch.config.core import FilterConfig
from orcvio_tpu_torch.filter.pipeline import FrameInput, build_chi2_table
from orcvio_tpu_torch.filter.state import FilterState
from orcvio_tpu_torch.parallel.replay import make_mesh, sharded_replay_fn
from orcvio_tpu_torch.tree import tree_map, tree_stack

from .. import check, generate
from ..reference import msckf as ref
from .common import Sampler


def _np(x):
    return x.detach().cpu().numpy()


def state_dict(fs, r: int) -> dict:
    """Row r of the program's batched FilterState as the reference's dict
    of arrays (``reference/msckf.py:STATE_KEYS``)."""
    imu, c, ft = fs.imu, fs.clones, fs.features
    return {"t": _np(fs.t[r]), "R": _np(imu.R[r]), "v": _np(imu.v[r]),
            "p": _np(imu.p[r]), "bg": _np(imu.bg[r]), "ba": _np(imu.ba[r]),
            "last_gyro": _np(fs.last_gyro[r]),
            "last_acc": _np(fs.last_acc[r]), "cR": _np(c.R[r]),
            "cp": _np(c.p[r]), "ct": _np(c.t[r]),
            "corder": _np(c.order[r]).astype(np.int64),
            "cvalid": _np(c.valid[r]), "uv": _np(ft.uv[r]),
            "uv_valid": _np(ft.uv_valid[r]),
            "fid": _np(ft.fid[r]).astype(np.int64),
            "active": _np(ft.active[r]), "P": _np(fs.P[r]),
            "next_order": int(fs.next_order[r])}


def frame_dict(frames: FrameInput, r: int, k: int) -> dict:
    """Frame k of row r: the IMU slab and the feature messages."""
    return {"imu_t": _np(frames.imu_t[r, k]), "gyro": _np(frames.imu_gyro[r, k]),
            "acc": _np(frames.imu_acc[r, k]),
            "imu_mask": _np(frames.imu_mask[r, k]),
            "fids": _np(frames.fids[r, k]).astype(np.int64),
            "uvs": _np(frames.uvs[r, k]),
            "meas_mask": _np(frames.meas_mask[r, k])}


class Driver:
    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        self.cfg, self.mix, self.device = cfg, mix, device
        self.dtype = dt = getattr(torch, cfg["filter_dtype"])
        self.rows = B = mix["rows"]
        inp = generate.make(cfg, mix, seed, device)
        self.frames = FrameInput(
            t=inp["t"].to(dt), imu_t=inp["imu_t"].to(dt),
            imu_gyro=inp["gyro"].to(dt), imu_acc=inp["acc"].to(dt),
            imu_mask=inp["imu_mask"], fids=inp["fids"], uvs=inp["uvs"].to(dt),
            uv_vels=inp["uv_vels"].to(dt), meas_mask=inp["meas_mask"])
        self.start_pose = tuple(_np(inp[k]) for k in ("R0", "p0", "v0"))
        self.fc = FilterConfig(**cfg["filter"])
        ext = cfg["extrinsics"]
        st = FilterState.create(self.fc, dt, device=device)
        imu = st.imu.replace(R=inp["R0"].to(dt), p=inp["p0"].to(dt),
                             v=inp["v0"].to(dt))
        st = st.replace(
            imu=imu, imu_fej_now=imu, imu_old=imu,
            R_b2c=torch.as_tensor(ext["R_b2c"], dtype=dt, device=device),
            t_c_b=torch.as_tensor(ext["t_c_b"], dtype=dt, device=device),
            initialized=torch.ones((), dtype=torch.bool, device=device))
        self.snapshot = tree_stack([st] * B)
        mesh = (make_mesh(1) if torch.device(device).type == "cuda"
                else [torch.device(device)])
        self.replay = sharded_replay_fn(self.fc, mesh)
        self.chi2 = build_chi2_table(self.fc, dt, device)
        self.state, self.frame = self.snapshot, 0
        self.collected = {"n_upd": [], "p": []}
        self.collecting = False
        self.sampler = None

    def tick(self):
        """One frame of every row: one call of the entry."""
        k = self.frame
        if self.sampler is not None:
            self.sampler.before(k, (self.state,))
        frame = tree_map(lambda x: x[:, k:k + 1], self.frames)
        state, out = self.replay(self.state, frame, self.chi2)
        if self.sampler is not None:
            self.sampler.after((state,))
        if self.collecting:
            self.collected["n_upd"].append(out.n_update_features)
            self.collected["p"].append(out.p)
        self.frame = k + 1
        if self.frame == self.frames.t.shape[1]:
            self.frame, state = 0, self.snapshot
        self.state = state

    def restart(self):
        self.state, self.frame = self.snapshot, 0

    def arm(self, seed: int):
        """Keep the states around the ticks the check samples."""
        c = self.mix["check"]
        self.sampler = Sampler(seed, self.rows, c["ticks"], c["rows"],
                               c["within_ticks"])

    def release(self):
        """Keep the sampled rows and their frames as arrays; free the
        program's state."""
        self.samples = [(k, r, ins[0], outs[0],
                         frame_dict(self.frames, r, k))
                        for k, r, ins, outs in self.sampler.rows_of(state_dict)]
        self.start = state_dict(self.snapshot, self.sampler.start_row)
        self.state = self.snapshot = self.collected = self.replay = None
        self.frames = self.sampler = None

    def check(self, control: bool = False) -> dict:
        """The compared numbers: with control, of the reference in float32
        (the step below the configuration's float64) in the program's
        place."""
        low = np.float32 if self.dtype == torch.float64 else np.float16
        out = {}
        for k, r, s_in, s_out, frame in self.samples:
            want = ref.step(self.cfg, s_in, frame)
            got = ref.step(self.cfg, s_in, frame, low) if control else s_out
            check.worst(out, "filter_rel", check.filter_rel(got, want))
        want = ref.start(self.cfg, *self.start_pose)
        got = ref.start(self.cfg, *self.start_pose, low) if control \
            else self.start
        check.worst(out, "start_rel", check.filter_rel(got, want))
        return out
