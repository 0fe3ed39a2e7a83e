"""Driver of the end-to-end Monte-Carlo cells: B rows over one image stream,
each with its own RANSAC generator, through the port's batched replay
(``orcvio_tpu_torch/eval/staged.py:make_batched_e2e_replay``): the front
end, static initialization, ZUPT and the hybrid filter, one frame of every
row a call.

Set-up reads the program's gate counters first (a program without them
cannot run the cell, and stops here), makes the stream on the device
(``vio_bench/stream.py``), runs frames 0 to setup_frames - 1 for every
row (static initialization, then ZUPT frames) and keeps the state before
frame setup_frames as the snapshot; the window runs passes from it, one
frame a call. Set-up also keeps, for the check, the initialized start and
one ZUPT frame's states before and after. The check follows sampled rows
through sampled frames with the plain reference (``vio_bench/reference/
frontend.py`` and ``larvio.py``) from the program's own state before each
frame (``vio_bench/check_e2e.py``).
"""
from __future__ import annotations

import numpy as np
import torch

from orcvio_tpu_torch.config.core import FilterConfig
from orcvio_tpu_torch.eval import staged
from orcvio_tpu_torch.filter.pipeline import FrameOutput
from orcvio_tpu_torch.frontend.ransac import RANSAC_HYPOTHESES, draw_gumbel
from orcvio_tpu_torch.frontend.tracker import (TrackerConfig, TrackerState,
                                               stack_tracker_states)
from orcvio_tpu_torch.tree import tree_stack
from orcvio_tpu_torch.vio import VioState

from .. import check_e2e, generate, stream
from .common import Sampler

# what the program has to count for the cell's metrics: the tracker's
# gates (eval/staged.py:COUNTS) and the in-state features (FrameOutput)
NEEDED = ("n_lk_in", "n_lk_ok", "n_orb_ok", "n_inliers", "n_placed",
          "n_ekf_features")
ZUPT_FRAMES = 8  # the last set-up frames (before the last) kept for the check


def _missing() -> list:
    have = set(getattr(staged, "COUNTS", ())) | set(FrameOutput._fields)
    return [k for k in NEEDED if k not in have]


def _np(x):
    return x.detach().cpu().numpy()


def tracker_dict(ts, r: int) -> dict:
    """Row r of the program's batched TrackerState (its pyramid left out:
    the reference builds its own from the previous image)."""
    return {"xy": _np(ts.xy[r]), "uvn": _np(ts.uvn[r]),
            "desc": _np(ts.desc[r]), "fid": _np(ts.fid[r]).astype(np.int64),
            "t": _np(ts.t[r]), "next_id": int(ts.next_id[r])}


def filter_dict(vs, r: int) -> dict:
    """Row r of the program's batched VioState's filter, as the
    reference's dict of arrays (``reference/larvio.py:STATE_KEYS``)."""
    fs = vs.filter
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
            "active": _np(ft.active[r]), "in_state": _np(ft.in_state[r]),
            "state_slot": _np(ft.state_slot[r]).astype(np.int64),
            "anchor_slot": _np(ft.anchor_slot[r]).astype(np.int64),
            "idp": _np(ft.idp[r]), "P": _np(fs.P[r]),
            "next_order": int(fs.next_order[r]),
            "R_b2c": _np(fs.R_b2c[r]), "t_c_b": _np(fs.t_c_b[r])}


def imu_dict(st: staged.StagedInputs, k: int) -> dict:
    """Frame k's IMU slab."""
    return {"imu_t": _np(st.imu_t[k]), "gyro": _np(st.imu_gyro[k]),
            "acc": _np(st.imu_acc[k]), "imu_mask": _np(st.imu_mask[k])}


def meas_dict(ts, r: int) -> dict:
    """Row r's tracker output, read from the tracker state after the frame
    (TrackerOutput: ids, normalized positions, their mask)."""
    fid = _np(ts.fid[r]).astype(np.int64)
    return {"fids": fid, "uvs": _np(ts.uvn[r]).astype(np.float64),
            "meas_mask": fid >= 0}


class Driver:
    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        missing = _missing()
        if missing:
            raise SystemExit(f"vio_bench: the program does not count "
                             f"{missing}, which this cell reads")
        self.cfg, self.mix, self.device = cfg, mix, torch.device(device)
        cuda = self.device.type == "cuda"
        self.dtype = dt = getattr(torch, cfg["filter_dtype"])
        # the replay's rule: float32 on the card (its LK kernels take
        # float32 only), the filter's dtype elsewhere
        self.tdt = getattr(torch, cfg["tracker_dtype"]) if cuda else dt
        self.rows = B = mix["rows"]
        self.tc = TrackerConfig(**{k: tuple(v) if isinstance(v, list) else v
                                   for k, v in cfg["tracker"].items()})
        self.fc = FilterConfig(**cfg["filter"])
        ext = cfg["extrinsics"]
        s = stream.make(cfg, mix, seed, self.device)
        self.staged = staged.StagedInputs(
            images=s["images"], frame_ts=s["frame_ts"].to(dt),
            imu_t=s["imu_t"].to(dt), imu_gyro=s["gyro"].to(dt),
            imu_acc=s["acc"].to(dt), imu_mask=s["imu_mask"])
        self.replay = staged.make_batched_e2e_replay(
            self.fc, self.tc, ext["R_b2c"], ext["t_c_b"], dt, self.device)
        N = self.tc.capacity
        ts = stack_tracker_states([
            TrackerState.create(self.tc, self.tdt, seed=s, device=self.device)
            for s in generate.seeds(seed, B, stream=1)])
        vs = tree_stack([VioState.create(self.fc, N, dt, device=self.device)]
                        * B)
        self.rngs = ts.rng
        self._setup(ts, vs)
        self.frame = self.first = mix["setup_frames"]
        self.collected = {k: [] for k in ("p", "n_ekf") + staged.COUNTS}
        self.collecting = False
        self.sampler = None

    def _setup(self, ts, vs):
        """Frames 0 to setup_frames - 1 of every row: the snapshot, the
        initialized start and the ZUPT frame the check holds (set-up reads
        each frame's flags; the window reads nothing)."""
        S = self.mix["setup_frames"]
        kept, started, zupts = {}, {}, []
        done = np.zeros(self.rows, bool)
        for k in range(S):
            before = vs
            (ts, vs), outs = self.replay(ts, vs, self.staged, frames=[k])
            now = outs["initialized"][:, 0].cpu().numpy()
            if (now & ~done).any():
                started[k] = vs  # the state right after static init
            done = now
            zupts.append(outs["zupt"][:, 0])
            if S - 1 - ZUPT_FRAMES <= k < S - 1:
                kept[k] = (before, vs, ts)
        if not done.all():
            raise RuntimeError("vio_bench: not every row initialized in "
                               f"the {S} set-up frames")
        self.snapshot = self.state = (ts, vs)
        zupt = torch.stack(zupts, 1).cpu().numpy()  # (B, S)
        # the ZUPT frame: the latest kept one on which the most rows fired
        self.zupt_frame = max(kept, key=lambda k: (int(zupt[:, k].sum()), k))
        self.zupt_kept = kept[self.zupt_frame]
        self.started = started

    def tick(self):
        """One frame of every row: one call of the entry."""
        k = self.frame
        smp = self.sampler
        if smp is not None:
            rng = ([g.get_state() for g in self.rngs] if smp.i in smp.ticks
                   else None)
            smp.before(k, self.state + (rng,))
        (ts, vs), outs = self.replay(*self.state, self.staged, frames=[k])
        if smp is not None:
            smp.after((ts, vs))
        if self.collecting:
            self.collected["p"].append(outs["p"])
            self.collected["n_ekf"].append(outs["n_ekf"])
            for c in staged.COUNTS:
                self.collected[c].append(outs[c])
        self.frame = k + 1
        self.state = (ts, vs)
        if self.frame == self.staged.images.shape[0]:
            self.restart()

    def restart(self):
        self.state, self.frame = self.snapshot, self.first

    def arm(self, seed: int):
        """Keep the states around the ticks the check samples."""
        c = self.mix["check"]
        self.sampler = Sampler(seed, self.rows, c["ticks"], c["rows"],
                               c["within_ticks"])

    def _gumbel(self, rng_state):
        """The RANSAC draw a row's generator made from rng_state: the
        program's own draw, reproduced."""
        g = torch.Generator(device=self.device)
        g.set_state(rng_state)
        return _np(draw_gumbel((RANSAC_HYPOTHESES, 8, self.tc.capacity), g,
                               self.tdt, self.device))

    def _image(self, k: int):
        return _np(self.staged.images[k])

    def sample(self, k: int, before, after, r: int) -> dict:
        """Row r's checked frame k, as arrays: before (tracker states,
        VIO states, the generators' states) and after (tracker states, VIO
        states) the batched states around the frame."""
        ts0, vs0, rng = before
        ts1, vs1 = after
        st = self.staged
        return {"frame": k, "row": r, "tracker_in": tracker_dict(ts0, r),
                "tracker_out": tracker_dict(ts1, r),
                "gumbel": self._gumbel(rng[r]),
                "filter_in": filter_dict(vs0, r),
                "filter_out": filter_dict(vs1, r), "meas": meas_dict(ts1, r),
                "imu": imu_dict(st, k), "t": float(st.frame_ts[k])}

    def release(self):
        """Keep the sampled rows, their frames and the set-up's checked
        states as arrays; free the program's state."""
        st = self.staged
        samples = [self.sample(k, before, after, r)
                   for k, before, after in self.sampler.kept
                   for r in self.sampler.rows]
        images = {k: self._image(k) for s in samples
                  for k in (s["frame"] - 1, s["frame"])}
        zb, za, zts = self.zupt_kept
        kz = self.zupt_frame
        zupt = [{"frame": kz, "row": r, "filter_in": filter_dict(zb, r),
                 "filter_out": filter_dict(za, r), "meas": meas_dict(zts, r),
                 "imu": imu_dict(st, kz)} for r in self.sampler.rows]
        r0 = self.sampler.start_row
        k0 = min(k for k, vs in self.started.items()
                 if bool(vs.filter.initialized[r0]))
        start = {"row": r0, "frame": k0,
                 "imu": [imu_dict(st, k) for k in range(k0 + 1)],
                 "program": filter_dict(self.started[k0], r0)}
        self.checked = {"samples": samples, "images": images, "zupt": zupt,
                        "start": start}
        self.state = self.snapshot = self.zupt_kept = self.started = None
        self.collected = self.replay = self.sampler = self.staged = None

    def check(self, control: bool = False) -> dict:
        """The compared numbers (``check_e2e.numbers``); with control, of
        the reference one precision step down in the program's place."""
        return check_e2e.numbers(self.cfg, self.checked, control)
