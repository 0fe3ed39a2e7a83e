#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (orcvio_tpu_torch) on one GPU.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases:
 1. set-up: the card's name and power limit (nvidia-smi), TF32 off, the
    kernels built from orcvio_tpu_torch/csrc with nvcc, and the
    registers, shared memory and spills of each kernel function built in
    this run (ptxas; none where a library was already built);
 2. the port's main path, the front end at the bench configuration
    (752x480, 3 levels, 200 features, detection every 2nd frame, float32)
    over a seeded synthetic stream whose true flow is known: launch counts
    (K2 reads the pyramid levels in place, so K1 cuts only ORB's windows:
    K1 once a frame, K2 four times), tracked features, flow error; a
    20-frame scan under torch's sync debug mode, which must find no host
    synchronisation; then a small stream on the card against the same
    stream through the plain versions on the CPU;
 3. each kernel against its plain version on the card, on windows and
    positions cut from the main path's last frames; K2 from both sources
    (the windows K1 cuts and the levels read in place), at the 3 levels
    and in the level-0 backward pass, the two bit-identical;
 4. times with CUDA events: tracker ms/frame (3 scans), each kernel's
    time beside its bound, its plain version's and (K1) an
    advanced-indexing gather's; K2 on the main path's route and on the
    windows. A bound counts the bytes
    and operations the kernel's function needs on this run's data: for K1
    the image tiles its windows cover and the windows, for K2 the taps
    its template and its visited positions read, not the whole windows it
    is given; then the tracker profiled over 10 frames;
 5. the slice's main path, the end-to-end replay (tracker, static init,
    filter) at the bench configuration in float32, over the bench
    sequence as the EuRoC writer makes it in memory, rendered on the card
    (300 frames, 60 of them static): init,
    finite poses, the ATE against the JAX package's on the same stream,
    the launch count of every kernel; ms/frame over 1 replay of 100
    frames after init (38 at standstill, 62 of flight); 20 of them under
    sync debug mode; 10 of them profiled;
 6. K4 against its plain version on the (P, K, H) the replay gave it (the
    stacked, last-chance and ZUPT updates) and on random (172, 444)
    inputs in float32 and float64, within the rounding bound and exactly
    symmetric; its times at each of the three shapes, with H P given, as
    the main path runs it (the kernel, the plain version and
    torch.addmm(P, K, HP, alpha=-1)), and with H P computed first, beside
    its bound;
 7. the K3 path at the bench front end's configuration: klt.track_level at
    each of the 3 levels on frame pairs of phase 2's known-flow stream (200
    features, windows (200, 48, 256)), its launches counted (K3 once a
    call, reading the second level in place; K1 once, for the template's
    windows); K3 on both routes (the windows K1 cuts and the level read in
    place), bit-identical, against its plain version and against the K2
    path (eps = 0); pyr_track's flow error on the stream and its launches
    (K2 once a level, no K1); N = 0; K3's times on both routes beside its
    bound;
 8. the K5 path: the ported window-extraction race (T = 30 frames, B = 1
    and 8, us per extract for the plain and K5 variants), its K5 launches
    counted; K5 bit-exact against its plain version at B = 1 and 8 (N =
    200), N = 13, N = 0 and origins at the image's edges; its times beside
    its bound and an advanced-indexing gather's;
 9. the EuRoC path: phase 5's frames and IMU (300 frames) written as
    EuRoC bytes with their config.yaml by the port's writer into a
    temporary directory; the native loader built and held equal to the
    Python reader (times, IMU slabs, decoded images), or the Python reader
    alone where it does not build (its decoder timed on 30 frames); then
    the port's CLI, run_vio.main, in-process on the bytes' first 100
    frames at full width, once --staged and once as the host loop: init
    on frame 20, finite poses, the TUM file read back, ATE (se3 and
    posyaw) against the JAX package's on its own writer's bytes (at most
    twice it, ate_limit), K1, K2 and K4 launches
    per frame as in phase 5, the host loop's failed dynamic attempts at
    frames 10 and 15 and no host synchronisation in 20 of its frames after
    init; and a 60-frame stream with no static start, on which the host
    loop must initialize dynamically, and on whose init window at least
    one of 24 more RANSAC draws of the initializer must match the ground
    truth's gravity direction and speed (its scene is a plane, so a draw
    is good only some of the time, in both packages);
10. the filter's flag variants (orcvio_tpu_torch/eval/bench_setup.py:
    VARIANTS: OrcVIO propagation left, right and Euler, left perturbation,
    no ZUPT, pure MSCKF, 3-d inverse depth, FEJ, extrinsic and td, the qr,
    chol and information update forms, the Joseph form, the IMU
    intrinsics, Schmidt nuisance states in both semantics, intrinsics
    and Schmidt together), each through vio_step on the first 40 frames
    of phase 5's stream (its static start: init, then the filter), the
    tracker's frames computed once: the init frame, the first frame with
    a non-finite pose, and the position error at frame 39 within 1 mm of
    the JAX package's on the same frames; the OrcVIO, FEJ, extrinsic-td,
    intrinsic and Schmidt variants once more in float64 to frame 83, past
    the visual updates that start the flight (frames 77-82), with updates
    made there, a clone demoted under Schmidt, and the position error
    within 5 mm of JAX's float64 one; K4 three times a filter frame
    (twice without ZUPT, never under the information and Joseph forms
    unless Schmidt states make them the qr and plain forms), ms per
    filter frame, and the host synchronisations in 8 filter frames
    (recorded, not held); the qr and chol update forms on a full-rank
    Jacobian against the direct one; K4 against its plain version at the
    variants' new shapes (D = 142, D = 232, q = D = 172; D = 196, and
    D = 208 and 232 with the nuisance block [nb:, nb:] kept, nb = 172 and
    196), on seeded inputs at those D's with nb = D - 36 in float32 and
    float64 (P's block kept bit for bit), and its times there;
11. many streams on one card (torch.func.vmap of the single-stream step,
    B = 4): (a) the vmap rules of K1, K2 (level route) and K4 at the bench
    shapes, each batched call one launch and each row bit-identical to
    its single launch (K4 exactly symmetric, float32 and float64, q = 444
    and 9, with nb < D), operands batched, shared and shared through a
    batch stride of 0, and their times beside 4 single launches; (b) the
    batched end-to-end replay with a float64 filter over the first 84
    frames of phase 5's stream, rows whose trackers differ (row b with
    RANSAC seed b starts its stream on frame 2 b; the batch runs from
    frame 6), each against its single-stream replay frame by frame: the
    tracker's ids and positions, its generator's state, init frame,
    update counts and ZUPT flags identical, p within 1e-6 m, every two
    rows apart; (c) the bench's batched configuration, float32 at B = 4
    identical rows over the first 100 frames of phase 5's stream: ms per
    batched frame and aggregate frames/s over 40 frames after init, K1, K2
    and K4 launching as often per batched frame as per single frame (1,
    4, 3), the rows bit-identical, row 0's ATE against JAX's over as many
    frames, no host synchronisation in 20 batched frames, 4 profiled;
    (d) the filter-only aggregate of bench.py:232-266 (16
    synthetic sequences of 50 frames through parallel/replay.py's
    sharded_replay_fn on a one-card mesh): frames/s and K4 launches a
    batched frame; and no op run without a batching rule throughout;
12. the object path (OrcVIO's object layer: SORT, keypoint ingest,
    triangulation and RANSAC Kabsch, the object LM, the object-residual
    EKF update through K4): config A of OBJECTS.md, the world of
    eval/object_map_sim.py (6 cars over 150 frames), on the host orchestrator
    (ObjectVio.step) in float64, with and without the object update:
    objects matched, estimated and in the ground truth equal to the JAX
    package's float64 figures on the CPU (JAX_OBJECTS), mean IoU within
    0.02 and ATE within 5 mm of its, the update lowering the ATE as in
    JAX, the updates applied, K4 launched at the object update's shape
    (D = 82, q = 1260); the staged replay (objects/staged.py) at
    bench.py:272-368's configuration in float32: ms a frame and frames/s
    from CUDA events after a warm-up, the map's size (at least JAX's less
    one), ATE (at most JAX's + 1 cm), K4's launches, the host reads a
    frame (find_syncs, each among those ROADMAP section 3 item 21 allows)
    and the device's busy share over frames profiled around a
    finalization; K4 against its plain version at (82, 1260) on
    the inputs both runs gave it and on seeded ones, float32 and float64,
    exactly symmetric, and its times beside its bound and addmm's. Config
    A's pair runs at scripts/object_map_eval.py --quick's size (6 cars over
    150 frames, OBJ_A_WORLD), its JAX figures recomputed there; the staged
    replay on the 12-car world cut to 150 frames (OBJ_FRAMES);
13. the image path of the objects (config B of OBJECTS.md: composite
    renders of 3 cars, 240x240, their pixel boxes, the StarMap keypoint
    network at the shipped widths in float32, SORT, keypoint ingest,
    init and LM, the object update through K4): (a) constructing the
    detector turns cuDNN's TF32 off; the network on the card against the
    same network in float64 on the CPU on 8 seeded crops of config B's
    renders (heat within 1e-4, the same found masks, untied peaks within
    0.05 heatmap px); (b) run_cnn_object_mapping over 260 frames, the
    filter in float64: objects matched, estimated and in the ground truth
    equal to the JAX package's float64 CPU figures, mean IoU within 0.03
    of its, the finalizations and updates recorded, K4 launched at (82,
    1260), ms a frame on the host clock split into render, detector and
    step; K4 against its plain version on config B's inputs; (c) the
    port's scripts/starmap_bench.py (M = 4 crops a frame as one batch,
    100 frames): ms a frame and crops/s from CUDA events, kernels a crop;
14. the scale-out layer and the tools: (a) one trajectory (the world of
    __graft_entry__.py:_dryrun_real_shapes: sw 20, 150 features, 300
    synthetic frames, float64) replayed serially and as 4 time blocks at
    once (parallel/temporal.py:seq_parallel_replay, n_iters 2, the blocks
    a vmapped batch): both finite, per-frame update counts and end
    positions against the JAX package's float64 CPU figures, K4 launched
    as often a batched block frame as a serial frame, no host read inside
    the blocks' frames, the wall clock of both and the speedup; (b) at
    n_iters = 4 within 1e-8 of the serial replay on tests/test_temporal.py's
    world, and at n_iters 2 within that test's accuracy band; (c) the
    feature-parallel update over 8 shards at capacity 21 against one
    information_update; (d) eval/scaling.py's harness on one card, no
    collective in its timed loop; (e) CLAHE and the pwl equalization over
    20 frames of phase 2's stream against the CPU's, then the tracker with
    CLAHE and on the pwl frames (K1 and K2 as in phase 2), 4 frames' tracks
    against the CPU's plain path; (f) a card filter state through a
    checkpoint, bit for bit; (g) the batch evaluator's vmapped run against
    its runs one by one.

Then the seconds each phase took.

Prints JSON lines; the last line is {"ok": true, "device": {...}}. Exits
non-zero, without that line, on any failed check, where CUDA is not
available, or where the port's package is missing.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import sys
import tempfile
import time
import warnings
from pathlib import Path

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_FLOP_PER_S = 67e12    # H100 SXM float32 outside the tensor cores
FP64_FLOP_PER_S = 34e12    # H100 SXM float64 outside the tensor cores
T_FRAMES = 120
SHIFT = (1.3, -0.7)        # true flow, px per frame
DEVICE = "cuda"
FAILURES: list[str] = []

sys.path.insert(0, str(Path(__file__).resolve().parent))
try:
    # the bench configuration, shared with scripts/flag_matrix.py
    from orcvio_tpu_torch.eval.bench_setup import (
        BENCH_FILTER, BENCH_SIM, TRACKER, VARIANTS, bench_inputs, gpu_line)
except ImportError as e:  # chip_smoke.py without the checkout around it
    sys.exit(f"chip_smoke: the port's package is missing: {e}")


# The end-to-end stream: the bench sequence of scripts/make_bench_seq.py:31-36
# (3 s static, then flight at 4 m over a textured ground plane) as the EuRoC
# writer makes it (dataio/euroc_writer.py:make_stream with its default
# WriterConfig: the camera, texture, extrinsics, biases and image noise of
# orcvio_tpu/dataio/euroc_writer.py:28-56), cut to E2E_FRAMES frames. Its
# timestamps start at 0.05 s, so float32 holds them: no rebase as bench.py
# does for EuRoC epochs.
E2E_FRAMES = 300
E2E_WINDOW = 100  # frames per timed replay from the second after init:
# 22-121 on the bench stream, 38 at standstill (ZUPT) and 62 of flight
# timed replays of the window and scans of the known-flow stream: few, so
# that all 13 phases fit the script's time on the slower hosts (PERF.md
# section 5)
E2E_REPLAYS = 1
TRACKER_SCANS = 3
# The JAX package's ATE on this stream: its make_e2e_replay in float32 on a
# CPU (on the stream the port's make_stream makes on the CPU), posyaw
# alignment over all frames, and over the first 100 (phase 11's bench
# pass), from `python tests/test_torch_e2e.py --jax-bench-ate --prefix
# 100`.
JAX_E2E = {"ate_m": 0.051326269113335064, "init_frame": 20,
           "filter_frames": 279, "n_upd_total": 1274, "zupt_frames": 43,
           "ate_m_100": 0.005486858895046913}
# The port passes where its ATE is at most ATE_MARGIN_M above the JAX
# figure and at most twice it (ate_limit): the RANSAC draws differ between
# the packages, so the two runs track other features and differ as two
# seeds of one filter do. The margin binds on the full streams (phase 5's
# 0.0513 m), twice the figure on the runs cut short (phases 9 and 11's 100
# frames, whose JAX figures are 0.0055-0.0079 m).
ATE_MARGIN_M = 0.05


def ate_limit(jax_ate):
    return jax_ate + min(ATE_MARGIN_M, jax_ate)

# The EuRoC path (phase 9): the bench sequence as bytes, and a stream with
# no static start on which the JAX package initializes dynamically.
EUROC_FRAMES = 300
# the CLI's runs on the bytes take their first EUROC_RUN_FRAMES (--max-frames:
# init on frame 20, the flight from frame 60), for the script's time
EUROC_RUN_FRAMES = 100
DECODE_FRAMES = 30  # frames the decoder is timed on where the native
# loader does not build (the CLI runs decode them all again)
DYN_FRAMES = 60
# The dynamic initializer's accuracy on the dynamic stream's window: DRAWS
# more RANSAC draws (generators seeded DRAW_SEED + i) of the attempt the
# host loop initialized on, each good where it is ok and within DRAW_GOOD
# of the ground truth's gravity direction and speed; at least DRAWS_MIN
# must be (see JAX_EUROC["dynamic"]).
DRAWS = 24
DRAW_SEED = 1000
DRAW_GOOD = {"gravity_deg": 3.0, "speed_err": 0.25}
DRAWS_MIN = 1
DYN_SIM = {**BENCH_SIM, "static_time": 0.0, "omega": 1.0}
# The JAX package on its own writer's bytes of these two streams, float32
# on a CPU, from `python tests/test_torch_euroc.py --jax-euroc-ate`: its
# run_vio.main --staged and as the host loop on the bench bytes (ATE over
# all frames), and its host loop on the dynamic stream (ATE over the
# frames from init on). Dynamic attempts: (frame, ok), None where the
# window had too few tracks. The port's dynamic init must fall on an attempt
# frame inside "attempt_window" (JAX's first attempt to one attempt after
# JAX's init). The dynamic initializer's accuracy depends on the RANSAC
# draws (the scene is a plane, degenerate for the 8-point fundamental
# matrix): JAX's run on the dynamic stream drew a poor init (26 deg off
# gravity, a speed 2.6 times the truth, then drift), so its ATE bounds the
# port's loosely; the draws check (DRAWS) holds the initializer's accuracy.
JAX_EUROC = {  # the bench runs over their first EUROC_RUN_FRAMES frames
    "staged": {"init_frame": 20, "n_upd_total": 126,
               "ate_m": {"se3": 0.007390862277727856,
                         "posyaw": 0.007889604878416327}},
    "host_loop": {"init_frame": 20, "n_upd_total": 129,
                  "ate_m": {"se3": 0.006597274729445154,
                            "posyaw": 0.0071402883737634775},
                  "dynamic_attempts": [[10, False], [15, False],
                                       [20, False]]},
    "dynamic": {"init_frame": 15, "n_upd_total": 234,
                "ate_se3_from_init_m": 4.129212400609316,
                "dynamic_attempts": [[10, False], [15, True]],
                "attempt_window": [10, 20],
                # from `python tests/test_torch_euroc.py --jax-dynamic-draws
                # --draws 24`: good draws of 24 on each attempt window
                "draws": 24, "draws_good": {"10": 7, "15": 4}}}
# The flag variants (phase 10): every variant of
# orcvio_tpu_torch/eval/bench_setup.py:VARIANTS over the first
# FLAG_FRAMES frames of phase 5's stream (static: init on frame 20, then
# the filter), the tracker's frames shared. The JAX package's figures on
# the same frames, from `python tests/test_torch_flags_replay.py
# --jax-flag-figures` (CPU, float32): the init frame, the position error at
# the last frame after aligning the estimate's pose to the ground truth's
# at init (pose_error_after_init), whether every pose stayed finite there,
# the first frame whose pose is not finite, and for FLIGHT_VARIANTS the
# figures of the filter in float64 at frame FLIGHT_FRAMES - 1. The chol
# form's run turns non-finite: its Gram-Cholesky compression factors a
# singular H^T H (ZUPT's 9 rows over 15 columns, and then the visual
# updates, whose features do not see a shift of every clone) and gives
# NaN, in both packages
# (tests/test_torch_flags_update.py). Whether a float32 factorization of a
# singular matrix fails depends on its rounding, so the port is held to a
# first non-finite frame no earlier than JAX's; update_forms_check runs
# the chol form on a Jacobian of full rank.
FLAG_FRAMES = 40
# The position error at frame FLAG_FRAMES - 1 is held within FLAG_POS_TOL_M
# of JAX's, either way: the two packages' trackers draw RANSAC samples
# differently, which moved no variant by more than 0.21 mm there on the
# card; a variant whose flags were ignored would sit at the base's 5e-5 m
# where JAX's OrcVIO runs drift 12 mm.
FLAG_POS_TOL_M = 1e-3
# The variants whose branches the static start barely runs (ZUPT fires on
# every filter frame there, so the visual updates wait for the flight):
# they run once more in float64 to frame FLIGHT_FRAMES - 1, past the
# flight's first visual updates (frames 77-82), where they must have made
# visual updates and sit within FLIGHT_POS_TOL_M of the JAX package's
# float64 position error (the card's runs sat 1.9e-5 to 2.9e-5 m from it:
# its tracker's float32 rounding; the limit is 17 times that). In float32
# the OrcVIO runs follow the rounding of the closed-form mean's so3
# operators there (ROADMAP section 3 item 18), in both packages. The
# Schmidt variants must also demote a clone to a nuisance slot by then:
# JAX's float64 runs first do on frame 78, once the flight's first
# promoted features outlive their anchor clones. Their covariance at frame
# FLIGHT_FRAMES - 1 must hold JAX's Schmidt blocks (schmidt_blocks) within
# SCHMIDT_BLOCK_RTOL. The JAX package's own float64 run, broken on
# purpose, moves them by far more: without the textbook form's mirror of
# the cross block (its update halved) cross_fro +23 % and nn_fro +20 %;
# with the nuisance block updated nn_fro -17 %; its position error moves
# 2.9e-5 m and 1.8e-6 m, inside FLIGHT_POS_TOL_M.
FLIGHT_FRAMES = 84
FLIGHT_VARIANTS = ("orcvio_prop", "orcvio_right", "orcvio_euler", "fej",
                   "extrinsic_td", "calib_imu", "schmidt", "schmidt_ref",
                   "calib_schmidt")
FLIGHT_POS_TOL_M = 5e-4
SCHMIDT_BLOCK_RTOL = 1e-2
# update_forms_check: the float64 forms' largest error on the card relative
# to the CPU's direct form (rounding: some 1e-16 times S's condition, here
# under 1e6; a NaN or a wrong factor is off by order 1)
UPDATE_FORM_TOL = 1e-8
JAX_FLAGS = {
    "orcvio_prop": {"init_frame": 20, "finite": True,
        "first_nonfinite_frame": None, "pos_err_m": 0.012163040062348595,
        "flight": {"init_frame": 20,
                   "pos_err_m": 0.009942967440902202, "n_upd": 53}},
    "orcvio_right": {"init_frame": 20, "finite": True,
        "first_nonfinite_frame": None, "pos_err_m": 0.012214709480242244,
        "flight": {"init_frame": 20,
                   "pos_err_m": 0.009052607987784008, "n_upd": 53}},
    "orcvio_euler": {"init_frame": 20, "finite": True,
        "first_nonfinite_frame": None, "pos_err_m": 0.012151087076893172,
        "flight": {"init_frame": 20,
                   "pos_err_m": 0.010017154687349497, "n_upd": 53}},
    "left_perturb": {"init_frame": 20, "finite": True,
        "first_nonfinite_frame": None, "pos_err_m": 5.2191539753323216e-05},
    "no_zupt": {"init_frame": 20, "finite": True,
        "first_nonfinite_frame": None, "pos_err_m": 0.008093320107320504},
    "pure_msckf": {"init_frame": 20, "finite": True,
        "first_nonfinite_frame": None, "pos_err_m": 0.00019792294119545077},
    "hybrid_3d": {"init_frame": 20, "finite": True,
        "first_nonfinite_frame": None, "pos_err_m": 0.0005447555563734777},
    "fej": {"init_frame": 20, "finite": True,
        "first_nonfinite_frame": None, "pos_err_m": 5.901595984403058e-05,
        "flight": {"init_frame": 20,
                   "pos_err_m": 0.009943659225960666, "n_upd": 53}},
    "extrinsic_td": {"init_frame": 20, "finite": True,
        "first_nonfinite_frame": None, "pos_err_m": 5.291955608016047e-05,
        "flight": {"init_frame": 20,
                   "pos_err_m": 0.009927249611310775, "n_upd": 53}},
    "update_qr": {"init_frame": 20, "finite": True,
        "first_nonfinite_frame": None, "pos_err_m": 5.214053861089626e-05},
    "update_chol": {"init_frame": 20, "finite": False,
        "first_nonfinite_frame": 22, "pos_err_m": None},
    "update_information": {"init_frame": 20, "finite": True,
        "first_nonfinite_frame": None, "pos_err_m": 5.1958419878893996e-05},
    "joseph": {"init_frame": 20, "finite": True,
        "first_nonfinite_frame": None, "pos_err_m": 5.047375781781183e-05},
    "calib_imu": {"init_frame": 20, "finite": True,
        "first_nonfinite_frame": None, "pos_err_m": 0.00020152583072533957,
        "flight": {"init_frame": 20,
                   "pos_err_m": 0.02033323905626841, "n_upd": 52}},
    "schmidt": {"init_frame": 20, "finite": True,
        "first_nonfinite_frame": None, "pos_err_m": 5.259912429676082e-05,
        "flight": {"init_frame": 20,
                   "pos_err_m": 0.009954358456802948, "n_upd": 53,
                   "first_demotion_frame": 78,
                   "cross_fro": 0.0022202236972906895,
                   "nn_fro": 0.0011682563760197521}},
    "schmidt_ref": {"init_frame": 20, "finite": True,
        "first_nonfinite_frame": None, "pos_err_m": 5.2191539753323216e-05,
        "flight": {"init_frame": 20,
                   "pos_err_m": 0.009954358456802948, "n_upd": 53,
                   "first_demotion_frame": 78,
                   "cross_fro": 0.00222022369729069,
                   "nn_fro": 0.0011682563760197521}},
    "calib_schmidt": {"init_frame": 20, "finite": True,
        "first_nonfinite_frame": None, "pos_err_m": 0.00034372606143225407,
        "flight": {"init_frame": 20,
                   "pos_err_m": 0.020401399111774864, "n_upd": 52,
                   "first_demotion_frame": 78,
                   "cross_fro": 0.005472135520824823,
                   "nn_fro": 0.0026937460045343632}}}
# Many streams on one card (phase 11): BATCH streams as one batch, as
# bench.py's E2E_BATCH; the float64 rows over ROW_FRAMES frames of phase
# 5's stream (init on frames 20-26, the flight's first visual updates on
# frames 77-82), each within ROW_TOL_M of its single-stream replay (vmap
# batches the products, whose sums round in another order, some 1e-16
# relative); the float32 bench replay's timed window starts at BATCH_START,
# after the frame following init (the last that reads the flags); the
# filter-only aggregate of bench.py:232-266 at its B and frame count.
BATCH = 4
ROW_FRAMES = 84
ROW_TOL_M = 1e-6
# Row b's stream starts on frame ROW_STARTS[b], so the rows' trackers
# differ: even frames, since the tracker detects on even frames only and a
# stream whose first frame holds no features never initializes (static
# init keeps its first frame as the reference). Their positions against
# the single streams': ids and decisions must be identical, so any
# difference is rounding.
ROW_STARTS = (0, 2, 4, 6)
ROW_XY_TOL_PX = 1e-3
BATCH_START = 25
# The bench pass (c): init, the timed window of BATCH_WINDOW frames, 20
# frames under sync debug mode and BATCH_PROFILE_FRAMES profiled (after as
# many more) fit in its BATCH_FRAMES frames; its ATE against JAX's over as
# many (JAX_E2E["ate_m_100"]).
BATCH_WINDOW = 40
BATCH_FRAMES = 100
BATCH_PROFILE_FRAMES = 4
FILTER_AGG_B = 16
FILTER_AGG_FRAMES = 50  # bench.py's 200, a quarter for the script's time
K3_FRAMES = 3   # frame pairs of the known-flow stream for the K3 path
RACE_REPS = 5   # timed passes of the race, as scripts/race_extract.py
# The object path (phase 12): config A of OBJECTS.md, the world of
# orcvio_tpu_torch/eval/object_map_sim.py at OBJ_A_WORLD, the host
# orchestrator in float64, and bench.py:272-368's staged replay in float32
# on the 12-car world over OBJ_FRAMES frames (map capacity 32, finalize
# budget 1). The JAX package's figures on the
# CPU come from `python tests/test_torch_objects_e2e.py --jax-object-map`
# (float64 config A with and without the object update; the staged replay
# in float32 without x64), not from OBJECTS.md's older tree.
OBJ_FRAMES = 150
# config A's pair of runs at scripts/object_map_eval.py --quick's size (6
# cars over 150 frames), so that phase 13 fits the script's time; the
# 300-frame, 12-car world stays in tests/test_torch_objects_config_a.py
OBJ_A_WORLD = {"n_objects": 6, "n_frames": 150}
OBJ_WARM_FRAMES = 10  # the staged replay's warm-up before its timed run
OBJ_PROFILE_FRAMES = 4  # frames a profiled window holds
# the staged replay's timed run is split here, so that the window profiled
# around a finalization starts from a carry it kept: two frames before its
# first finalization (frame 22 on the card, float32)
OBJ_PROFILE_FROM = 20
# the host reads the staged replay may make (ROADMAP section 3 item 21):
# (file, the text of its line); find_syncs reports file:line
OBJ_ALLOWED_READS = (
    ("orcvio_tpu_torch/objects/staged.py", "bool(pending.any())"),
    ("orcvio_tpu_torch/vio.py", "bool(state.filter.initialized)"),
    ("orcvio_tpu_torch/objects/init.py", "torch.linalg.svd("))
OBJ_IOU_TOL = 0.02
OBJ_ATE_TOL_M = 0.005
OBJ_STAGED_ATE_TOL_M = 0.01
OBJ_K4_SHAPE = (82, 1260)  # D, q: ten clones; 45 frames x (2 x 12 + 4) rows
# The image path of the objects (phase 13): config B of OBJECTS.md
# (eval/object_map_cnn.py: 3 cars, 240x240 composite renders, the StarMap
# detector at the shipped weights, 260 frames, the filter in float64).
# The JAX package's float64 CPU figures come from `python
# tests/test_torch_starmap_e2e.py --jax-config-b` on this tree; the
# network's card run is held against its own float64 CPU run on
# CNN_CROPS seeded crops of config B's renders (frames drawn among the
# first CNN_CROP_FRAMES).
CNN_CROPS = 8
CNN_CROP_FRAMES = 112  # the first two cars' passes
CNN_SEED = 13
CNN_HEAT_TOL = 1e-4
CNN_PEAK_TOL_PX = 0.05
CNN_TIE = 1e-5  # peaks whose score lies this close to another's may swap
CNN_IOU_TOL = 0.03
JAX_OBJECTS = {
    "config_a": {  # at OBJ_A_WORLD
        "update": {"mean_iou": 0.6106852127249147, "n_matched": 4,
                   "n_est": 4, "n_gt": 6, "ate_m": 0.11258068157051096,
                   "updates_tried": 6, "updates_applied": 6},
        "no_update": {"mean_iou": 0.6098974007019675, "n_matched": 4,
                      "n_est": 4, "n_gt": 6,
                      "ate_m": 0.11904504550032664}},
    "staged_f32": {"n_map": 8, "ate_m": 0.10150757431983948},
    "config_b": {"mean_iou": 0.3812230405936208, "n_matched": 3, "n_est": 3,
                 "n_gt": 3, "finalizations": 4, "finalized_ok": 3,
                 "updates_tried": 3, "updates_applied": 1}}


# Phase 14, the scale-out layer and the tools. (a) runs the world of
# __graft_entry__.py:_dryrun_real_shapes (sw 20, 150 features, IMU slab 10,
# 300 synthetic frames, 400 landmarks, max_obs 60, seed 0) in float64,
# serially and as K = 4 time blocks (seq_parallel_replay, n_iters 2); (b)
# tests/test_temporal.py's world at n_iters = K.
SP_CFG = dict(sw_size=20, max_features=150, max_track_len=6, imu_slab=10,
              observation_noise=0.004, tri_translation_threshold=-1.0)
SP_SIM = dict(n_frames=300, n_landmarks=400, max_obs=60, imu_slab=10, seed=0)
SP_BLOCKS, SP_ITERS = 4, 2
SP_SMALL_CFG = dict(SP_CFG, sw_size=10, max_features=80, imu_slab=12)
SP_SMALL_SIM = dict(n_frames=120, n_landmarks=300, max_obs=40, imu_slab=12,
                    seed=0)
SP_END_TOL_M = 1e-6
SP_EXACT_TOL = 1e-8
FP_CAPACITY, FP_SHARDS, FP_TOL = 21, 8, 1e-8
SCALING_FRAMES, SCALING_REPS = 10, 2
EQ_FRAMES = 20  # tracker frames of phase 2's stream under clahe and pwl
EQ_IMG_TOL = 1e-3  # the card's equalized images against the CPU's, gray
BATCH_EVAL_SEEDS = (3, 4)
BATCH_EVAL_CFG = dict(sw_size=8, max_features=60, max_track_len=4,
                      imu_slab=12, observation_noise=0.004,
                      tri_translation_threshold=-1.0)
BATCH_EVAL_SIM = dict(n_frames=20, n_landmarks=200, max_obs=40, imu_slab=12,
                      uv_noise=0.002)
# The JAX package's float64 CPU replays of SP_SIM on the port's frames and
# initial state (python tests/test_torch_temporal.py --jax-temporal-figures):
# the end position, the RMSE to the ground truth and the per-frame update
# counts of the serial run and of K = 4 blocks at n_iters 2 (corrected).
JAX_TEMPORAL = {
    "serial": {
        "end_p": [1.1329030945743768, 5.913833692896598, 0.03899543790567842],
        "rmse_m": 0.13684311875538202,
        "n_update": [int(x) for x in (
            "0 0 0 2 2 30 2 4 1 7 1 32 4 6 5 4 4 32 6 6 0 0 0 0 7 6 2 1 1 2 "
            "32 0 0 0 1 0 16 1 0 2 0 0 32 0 0 1 1 2 18 3 2 1 0 1 31 1 0 0 0 "
            "1 27 3 0 0 1 1 23 1 3 0 0 0 31 0 0 3 0 0 22 3 1 2 0 1 29 0 0 2 "
            "1 1 25 0 2 0 1 1 29 2 0 1 0 1 26 2 0 0 3 1 25 0 1 2 2 2 22 4 3 "
            "0 0 1 27 4 3 1 2 0 22 3 1 1 0 0 32 0 0 0 0 0 26 0 0 1 0 1 31 0 "
            "0 0 0 0 28 1 1 2 1 0 26 2 0 1 3 0 27 1 2 2 0 2 20 6 1 0 1 2 26 "
            "3 0 0 1 1 25 3 2 1 2 0 24 0 0 0 1 0 32 1 0 0 1 1 24 3 2 0 0 0 "
            "29 2 0 1 1 1 26 2 0 1 1 2 24 3 2 0 1 3 23 4 0 1 1 0 27 1 0 0 1 "
            "1 28 2 2 1 0 2 23 0 0 0 1 1 32 1 0 1 0 1 22 0 0 0 4 2 30 1 1 0 "
            "0 1 20 4 1 2 1 1 29 1 2 3 1 1 20 3 2 0 2 1 28 1 0 2 0 0 23 5 2 "
            "1 0 1 29 1 1 2 0 0").split()],
    },
    "parallel": {
        "end_p": [1.3371321733374515, 5.595476191132466, 0.005801443804442167],
        "rmse_m": 0.20654945736836694,
        "mean_gap_m": 0.15425387076122357,
        "n_update": [int(x) for x in (
            "0 0 0 2 2 30 2 4 1 7 1 32 4 6 5 4 4 32 6 6 0 0 0 0 7 6 2 1 1 2 "
            "32 0 0 0 1 0 16 1 0 2 0 0 32 0 0 1 1 2 18 3 2 1 0 1 31 1 0 0 0 "
            "1 27 3 0 0 1 1 23 1 3 0 0 0 31 0 0 3 0 0 22 3 1 2 0 1 29 0 0 2 "
            "1 1 25 0 2 0 1 1 29 2 0 1 0 1 26 2 0 0 3 1 25 0 1 2 2 2 22 4 3 "
            "0 0 1 27 4 3 1 2 0 22 3 1 1 0 0 32 0 0 0 0 0 26 0 0 1 0 1 31 0 "
            "0 0 0 0 1 1 1 28 1 0 2 1 0 25 6 1 2 2 3 20 1 1 1 1 2 29 3 2 2 "
            "1 0 20 1 0 1 1 2 32 3 0 0 0 0 18 2 0 1 0 1 32 1 0 0 0 1 20 1 0 "
            "1 1 2 32 1 0 1 1 1 21 1 1 0 3 2 28 2 0 1 1 1 1 1 0 27 1 0 0 1 "
            "1 28 2 2 1 0 2 23 0 0 0 1 1 32 1 0 1 0 1 22 0 0 0 4 2 30 1 1 0 "
            "0 1 20 4 1 2 1 1 29 1 2 3 1 1 20 3 2 0 2 1 28 1 0 2 0 0 23 5 2 "
            "1 0 1 29 1 1 2 0 0").split()],
    },
}
EQ_CPU_FRAMES = 4  # of them through the CPU's plain path as well


def check(ok: bool, what: str) -> None:
    print(("PASS " if ok else "FAIL ") + what, flush=True)
    if not ok:
        FAILURES.append(what)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def synthetic_stream(T, H, W, shift, seed=0, sigma=2.0):
    """uint8 frames of a periodic band-limited texture translated by
    `shift` px per frame (exact subpixel shifts in the Fourier domain)."""
    rng = np.random.default_rng(seed)
    F = np.fft.rfft2(rng.normal(size=(H, W)))
    ky = np.fft.fftfreq(H)[:, None]
    kx = np.fft.rfftfreq(W)[None, :]
    F = F * np.exp(-(kx**2 + ky**2) * (2 * np.pi * sigma) ** 2 / 2)
    frames = np.stack([np.fft.irfft2(F * np.exp(
        -2j * np.pi * (kx * shift[0] * k + ky * shift[1] * k)), s=(H, W))
        for k in range(T)])
    lo, hi = frames.min(), frames.max()
    images = np.round((frames - lo) / (hi - lo) * 235.0 + 10.0)
    S = 16
    t = 1.0 + 0.05 * np.arange(T)  # 20 Hz
    imu_t = t[:, None] - 0.05 + (0.05 / S) * np.arange(1, S + 1)[None, :]
    gyro = np.zeros((T, S, 3))
    acc = np.tile([0.0, 0.0, 9.81], (T, S, 1))
    mask = np.ones((T, S), bool)
    return images.astype(np.uint8), t, imu_t, gyro, acc, mask


def tracked_flow(frames, K):
    """Per frame k >= 1: rows whose track id persists from frame k-1, and
    their pixel flow (zero distortion: pixel = normalized * f + c)."""
    fids = frames.fids.cpu().numpy()
    uvs = frames.uvs.cpu().numpy()
    f = np.asarray(K[:2])
    counts, flows = [], []
    for k in range(1, fids.shape[0]):
        same = (fids[k] >= 0) & (fids[k] == fids[k - 1])
        counts.append(int(same.sum()))
        flows.append((uvs[k][same] - uvs[k - 1][same]) * f)
    return np.asarray(counts), np.concatenate(flows)


def same_track_uv_err(run_a, run_b, K):
    """|uv_a - uv_b| in px over the observations of tracks that carry one id
    in one row in both runs and began at the same pixel in both (a
    detection may pick another of two equal scores on another device), and
    the number of tracks that began apart."""
    (fa, ua), (fb, ub) = run_a, run_b
    f = max(K[:2])
    errs, apart = [], set()
    for k in range(fa.shape[0]):
        for i in np.nonzero((fa[k] >= 0) & (fa[k] == fb[k]))[0]:
            first = int(np.argmax(fa[:, i] == fa[k, i]))
            if np.abs(ua[first, i] - ub[first, i]).max() * f > 1e-3:
                apart.add(int(fa[k, i]))
                continue
            errs.append(np.abs(ua[k, i] - ub[k, i]).max() * f)
    return np.asarray(errs), len(apart)


def time_ms(fn, reps=30, warmup=3, preload=True):
    """Median of `reps` single-call CUDA-event times, in ms. With preload,
    a spin kernel first keeps the stream busy while the host enqueues the
    call, so the time is the device's alone; without, it includes the
    host's time to issue the call."""
    import torch

    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        if preload:
            torch.cuda._sleep(2_000_000)
        e0.record()
        fn()
        e1.record()
        pairs.append((e0, e1))
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in pairs]))


def find_syncs(fn):
    """Host synchronisations inside fn(), as the file:line of each warning
    torch's sync debug mode raises there."""
    import warnings

    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return [f"{Path(w.filename).name}:{w.lineno}" for w in caught
            if "called a synchronizing" in str(w.message)]


def check_no_syncs(fn, what):
    """Fail unless fn() makes no host synchronisation, while the debug mode
    does catch a deliberate one (an .item()) made after it."""
    import torch

    syncs = find_syncs(fn)
    control = find_syncs(lambda: torch.ones(1, device=DEVICE).sum().item())
    check(bool(control) and not syncs,
          f"no host synchronisation in {what} ({len(syncs)} found: "
          f"{sorted(set(syncs))[:5]}; a deliberate .item() was "
          f"{'caught' if control else 'missed'})")


def k1_needed_bytes(imgs, r0, c0, nr, nl):
    """Bytes K1's function must move: the distinct image tiles its windows
    cover, read once, the windows written once, and the (N,) indices."""
    import torch

    N = r0.shape[0]
    Hb, Wb = imgs.shape[1] // 8, imgs.shape[2] // 128
    cover = torch.zeros((Hb, Wb), dtype=torch.bool, device=imgs.device)
    rows = r0.long()[:, None] + torch.arange(nr, device=imgs.device)
    cols = c0.long()[:, None] + torch.arange(nl, device=imgs.device)
    cover[rows[:, :, None], cols[:, None, :]] = True
    tile = 8 * 128 * 4
    return int(cover.sum()) * tile + N * nr * nl * tile + 3 * N * 4


def visited_px(win, P, positions):
    """Distinct pixels of win (N, R, L) that the (P+1)^2 bilinear blocks of
    a (P, P) patch read at each of `positions`, (N, 2) window-local patch
    centres."""
    import torch

    N, R, L = win.shape
    r = (P - 1) // 2
    seen = torch.zeros((N, R, L), dtype=torch.bool, device=win.device)
    n = torch.arange(N, device=win.device)[:, None, None]
    a = torch.arange(P + 1, device=win.device)
    for pos in positions:
        ly = torch.clamp(pos[:, 1] - r, 0.0, R - 1.001 - P)
        lx = torch.clamp(pos[:, 0] - r, 0.0, L - 1.001 - P)
        rows = torch.floor(ly).long()[:, None] + a
        cols = torch.floor(lx).long()[:, None] + a
        seen[n, rows[:, :, None], cols[:, None, :]] = True
    return int(seen.sum())


def k2_needed_bytes(win0, win1, aux, iters, P, eps, plain):
    """Bytes K2's function must move for this data: per feature the
    (P+3)^2 block of win0 its template reads and the union of the (P+1)^2
    blocks of win1 at every position it visits (the plain version run for
    0..iters steps gives them), aux read once and the (N, 8) output written
    once. Not the windows as stored: the function reads only these taps."""
    N = win1.shape[0]
    win1_px = visited_px(win1, P, (plain(win0, win1, aux, k, P, eps)[:, :2]
                                   for k in range(iters + 1)))
    return (4 * (N * (P + 3) ** 2 + win1_px + aux.numel() + N * 8),
            win1_px / N)


def k3_needed_bytes(win, t, tgx, tgy, aux, iters, P, plain):
    """Bytes K3's function must move for this data: the template t, tgx,
    tgy and aux read once, the (N, 8) output written once, and of win the
    union of the (P+1)^2 blocks at every position it visits (the plain
    version run for 0..iters steps gives them)."""
    N = win.shape[0]
    win_px = visited_px(win, P, (plain(win, t, tgx, tgy, aux, k, P)[:, :2]
                                 for k in range(iters + 1)))
    return 4 * (3 * N * P * P + win_px + aux.numel() + N * 8), win_px / N


def k5_needed_bytes(imgp, y, x64, rows, lanes):
    """Bytes K5's function must move: the image pixels its windows cover,
    read once (windows overlap), the windows and offsets written once, and
    the (B, N) origins read once."""
    import torch

    B, N = y.shape
    cover = torch.zeros(imgp.shape, dtype=torch.bool, device=imgp.device)
    r = y.long()[..., None] + torch.arange(rows, device=imgp.device)
    c = x64.long()[..., None] + torch.arange(lanes, device=imgp.device)
    b = torch.arange(B, device=imgp.device)[:, None, None, None]
    cover[b, r[..., :, None], c[..., None, :]] = True
    return 4 * (int(cover.sum()) + B * N * rows * lanes + 3 * B * N)


def _kernel_name(mangled):
    """`name<args>` of a mangled `..._kernel` function: the <len><name>
    part that ends in `_kernel` (the length checked, as a namespace hash
    may end in digits), then its int or float/double template arguments."""
    for k in re.finditer(r"_kernel", mangled):
        for start in range(k.start(), 0, -1):
            n = str(k.end() - start)
            if mangled[start - len(n):start] != n:
                continue
            name = mangled[start:k.end()]
            t = re.match(r"I((?:Li-?\d+E|[df])+)E", mangled[k.end():])
            if t is None:
                return name
            args = [a or {"d": "double", "f": "float"}[b] for a, b in
                    re.findall(r"Li(-?\d+)E|([df])", t.group(1))]
            return f"{name}<{', '.join(args)}>"
    return mangled


def ptxas_usage(log):
    """Per kernel function of an `nvcc -Xptxas=-v` log: its name (with a
    template argument), registers, static shared memory and spill bytes."""
    out, fn = [], None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            fn = {"function": _kernel_name(m.group(1))}
            out.append(fn)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and fn is not None:
            fn["spill_stores"], fn["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m and fn is not None:
            smem = re.search(r"(\d+) bytes smem", line)
            fn["registers"] = int(m.group(1))
            fn["smem_bytes"] = int(smem.group(1)) if smem else 0
    return out


def device_rows(prof, averages=False):
    """{name: [device ms, count]} over the kernels, copies and sets that
    prof traced. Read off the profiler's raw events; key_averages() gives
    the same rows (averages=True reads them there) but first builds a
    Python tree of every host and device event, which takes longer than
    the traced frames themselves (some 30 s for 3.5e5 events)."""
    import torch
    from torch.autograd.profiler_util import _rewrite_name

    if averages:
        return {e.key: [e.device_time_total / 1e3, e.count]
                for e in prof.key_averages()
                if e.device_type.name == "CUDA" and e.device_time_total > 0}
    cuda, acc = torch.autograd.DeviceType.CUDA, {}
    for e in prof.profiler.kineto_results.events():
        if (e.device_type() != cuda
                or getattr(e, "is_hidden_event", lambda: False)()):
            continue
        row = acc.setdefault(e.name(), [0.0, 0])
        # key_averages() counts an event that ends on another thread, but
        # gives it no time
        if not (e.is_async() or e.start_thread_id() != e.end_thread_id()):
            row[0] += e.duration_ns() / 1e6
        row[1] += 1
    rows = {}
    for name, (ms, c) in acc.items():
        key = _rewrite_name(name, with_wildcard=True)
        row = rows.setdefault(key, [0.0, 0])
        row[0] += ms
        row[1] += c
    return {k: v for k, v in rows.items() if v[0] > 0}


def profile_frames(run, n, warm=True, cpu=True, cross_check=False):
    """Device busy share and kernel time by name over run(), n frames;
    run() once first unless warm is False (its code already ran). With
    cpu False only the device's activity is traced: the host's ops are
    not recorded, which keeps their cost out of the wall time. With
    cross_check the rows read off the raw events are held against
    key_averages()'s (names and counts equal, times within 1e-6 ms)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if warm:
        run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU] * cpu
                 + [ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    by_name = device_rows(prof)
    read_s = time.perf_counter() - t0
    rows = sorted(((k, ms, c) for k, (ms, c) in by_name.items()),
                  key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    out = {"frames": n, "wall_ms_per_frame": wall_ms / n,
           "device_ms_per_frame": busy_ms / n,
           "device_busy_share": busy_ms / wall_ms,
           "kernels_per_frame": sum(r[2] for r in rows) / n,
           "read_s": read_s,
           "top": [{"name": k[:60], "ms_per_frame": ms / n,
                    "calls_per_frame": c / n} for k, ms, c in rows[:10]]}
    if cross_check:
        t0 = time.perf_counter()
        avg = device_rows(prof, averages=True)
        out["key_averages_s"] = time.perf_counter() - t0
        agree = (avg.keys() == by_name.keys() and all(
            avg[k][1] == by_name[k][1]
            and abs(avg[k][0] - by_name[k][0]) < 1e-6 for k in avg))
        check(agree, f"profile: {len(by_name)} kernel rows off the raw events "
                     f"equal key_averages()'s ({out['key_averages_s']:.2f} s "
                     f"against {read_s:.2f} s to read)")
    return out


def k4_tolerance(P, K, HP, out):
    """Per-element bound on |kernel - plain| for sym(P - K HP): each forms
    A(r, c) and A(c, r) as length-q sums in its own order, so each is off
    the exact value by at most gamma_{q+2} (|K| |HP| + |P|) entry by entry
    (gamma_n = n u / (1 - n u)), plus a rounding of the mean; the two
    outputs differ by at most twice that."""
    import torch

    u = torch.finfo(P.dtype).eps / 2
    n = K.shape[1] + 2
    g = n * u / (1 - n * u)
    M = K.double().abs() @ HP.double().abs() + P.double().abs()
    return 2 * (g * 0.5 * (M + M.T) + u * out.double().abs())


def k4_inputs(D, q, seed, dtype, dev):
    """Random (P, K, H) as tests/test_torch_cov_update.py draws them."""
    import torch

    rng = np.random.default_rng(seed)
    A = rng.normal(size=(D, D))
    return tuple(torch.as_tensor(x, dtype=dtype, device=dev) for x in (
        A @ A.T / D, rng.normal(size=(D, q)) * 0.1,
        rng.normal(size=(q, D)) * 0.1))


def k4_check(cases):
    """K4 against its plain version, H P given as on the main path, on
    each (name, P, K, H) or (name, P, K, H, nb): within the rounding bound
    and exactly symmetric; with nb < D, the block [nb:, nb:] equal to P's
    bit for bit. Returns ({name: max |kernel - plain|}, the largest share
    of the bound in float32)."""
    import torch

    from orcvio_tpu_torch.ops.cov_update import cov_update, cov_update_plain

    k4_err, k4_ratio = {}, 0.0
    for name, P, K, H, *rest in cases:
        nb = rest[0] if rest else P.shape[0]
        HP = H @ P
        a = cov_update(P, K, H, HP, nb)
        p = cov_update_plain(P, K, H, HP, nb)
        err = (a - p).abs()
        tol = k4_tolerance(P, K, HP, p)
        ratio = float(torch.where(err == 0, 0.0, err.double() / tol).max())
        k4_err[name] = float(err.max())
        if P.dtype == torch.float32:
            k4_ratio = max(k4_ratio, ratio)
        kept = bool(torch.equal(a[nb:, nb:], P[nb:, nb:]))
        check(ratio <= 1.0 and bool(torch.equal(a, a.T)) and kept
              and bool(torch.isfinite(a).all()),
              f"K4 {name} D={P.shape[0]} q={K.shape[1]} nb={nb}: max "
              f"|kernel - plain| {float(err.max()):.2e}, {ratio:.3f} of the "
              f"rounding bound; exactly symmetric; P[nb:, nb:] kept bit for "
              f"bit")
    return k4_err, k4_ratio


def k4_times(P, K, H, nb=None):
    """K4's times at (P, K, H), the block [nb:, nb:] kept where nb < D.
    The function the main path runs takes H P given (apply_ekf_update has
    it for S and K already): the kernel ("kernel_ms"), its plain version
    ("library_ms": cuBLAS products and elementwise ops), and the one
    cuBLAS call that does most of it, torch.addmm(P, K, HP, alpha=-1)
    ("addmm_ms", the whole product). Beside them the whole function with
    H P computed first, kernel and plain ("with_hp_*"). The bound counts
    2 q (D^2 - (D - nb)^2) FLOP with H P given (the kept block needs no
    products), twice that without, on 2 D^2 + 2 D q elements."""
    import torch

    from orcvio_tpu_torch.ops.cov_update import cov_update, cov_update_plain

    HP = H @ P
    D, q = K.shape
    nb = D if nb is None else nb
    nbytes = P.element_size() * (2 * D * D + 2 * D * q)
    ops = 2 * q * (D * D - (D - nb) ** 2)
    out = {"kernel_ms": time_ms(lambda: cov_update(P, K, H, HP, nb)),
           "library_ms": time_ms(lambda: cov_update_plain(P, K, H, HP, nb)),
           "addmm_ms": time_ms(lambda: torch.addmm(P, K, HP, alpha=-1)),
           "kernel_call_ms": time_ms(lambda: cov_update(P, K, H, HP, nb),
                                     preload=False),
           "with_hp_ms": time_ms(lambda: cov_update(P, K, H, nb=nb)),
           "with_hp_plain_ms": time_ms(lambda: cov_update_plain(P, K, H,
                                                                nb=nb)),
           "with_hp_call_ms": time_ms(lambda: cov_update(P, K, H, nb=nb),
                                      preload=False),
           "bytes": nbytes, "ops": ops, "nb": nb}
    rate = FP64_FLOP_PER_S if P.dtype == torch.float64 else FP32_FLOP_PER_S
    out["bound_ms"], out["bound_by"] = bound_ms(nbytes, ops, rate)
    out["with_hp_bound_ms"] = bound_ms(nbytes, ops + 2 * D * D * q, rate)[0]
    return out


def bound_ms(nbytes, ops, flop_per_s=FP32_FLOP_PER_S):
    """(the least time in ms for `nbytes` of memory traffic and `ops`
    operations at `flop_per_s`, float32's rate unless given, and which of
    the two sets it)."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = ops / flop_per_s * 1e3
    return max(tb, to), ("bytes" if tb >= to else "operations")


class SyncWindow:
    """Wraps fn so that from its `start`-th call to its `stop`-th (0-based,
    the last excluded) everything runs under torch's sync debug mode: the
    host synchronisations made there, as file:line, end up in `found`."""

    def __init__(self, fn, start, stop):
        self.fn, self.start, self.stop = fn, start, stop
        self.calls, self.found, self._cm, self._caught = 0, [], None, None

    def __call__(self, *args, **kwargs):
        if self.calls == self.start:
            self._open()
        elif self.calls == self.stop:
            self.close()
        self.calls += 1
        return self.fn(*args, **kwargs)

    def _open(self):
        import torch

        self._cm = warnings.catch_warnings(record=True)
        self._caught = self._cm.__enter__()
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")

    def close(self):
        import torch

        if self._cm is None:
            return
        torch.cuda.set_sync_debug_mode("default")
        self._cm.__exit__(None, None, None)
        self.found += [f"{Path(w.filename).name}:{w.lineno}"
                       for w in self._caught
                       if "called a synchronizing" in str(w.message)]
        self._cm = None


def launch_counts(reset=False):
    """K1, K2 and K4's launch counters (set to 0 first with reset)."""
    from orcvio_tpu_torch.ops.cov_update import cov_update
    from orcvio_tpu_torch.ops.dma_gather import dma_gather_tiles
    from orcvio_tpu_torch.ops.lk_pallas import lk_level_fused

    wrappers = {"window_gather": dma_gather_tiles, "lk_level": lk_level_fused,
                "cov_update": cov_update}
    if reset:
        for w in wrappers.values():
            w.launches = 0
    return {name: w.launches for name, w in wrappers.items()}


def first_true(flags):
    flags = np.asarray(flags)
    return int(np.argmax(flags)) if flags.any() else None


def schmidt_blocks(P, nuisance_cap):
    """Frobenius norms of a Schmidt filter's covariance blocks: the
    active-nuisance cross block P[:nb, nb:] and the nuisance block
    P[nb:, nb:], nb = D - 6 nuisance_cap."""
    P = np.asarray(P, np.float64)
    nb = P.shape[0] - 6 * nuisance_cap
    return {"cross_fro": float(np.linalg.norm(P[:nb, nb:])),
            "nn_fro": float(np.linalg.norm(P[nb:, nb:]))}


def check_euroc_run(name, summary, tum_path, jax_fig, launches, frames):
    """The checks of one run_vio.main run on the bench bytes; returns its
    line of the report."""
    from orcvio_tpu_torch.dataio.euroc import read_tum

    res = summary["result"]
    k0 = first_true(res["initialized"])
    n_filter = 0 if k0 is None else frames - 1 - k0  # k0 itself inits
    check(k0 == jax_fig["init_frame"],
          f"{name}: init on frame {k0} == {jax_fig['init_frame']} (JAX)")
    check(bool(np.isfinite(res["p"]).all() and np.isfinite(res["R"]).all()),
          f"{name}: every pose finite")
    t, p, q = read_tum(tum_path)
    check(t.shape == (frames,) and p.shape == (frames, 3)
          and q.shape == (frames, 4) and bool(np.isfinite(p).all())
          and bool(np.allclose(p, res["p"], atol=1e-6)),
          f"{name}: the TUM file reads back ({len(t)} rows)")
    ate_m = {}
    for al in ("se3", "posyaw"):
        got = summary["ate"].get(al, {}).get("rmse_trans", float("nan"))
        limit = ate_limit(jax_fig["ate_m"][al])
        ate_m[al] = got
        check(bool(np.isfinite(got)) and got <= limit,
              f"{name}: ATE {al} {got:.4f} m <= {limit:.4f} m, JAX's "
              f"{jax_fig['ate_m'][al]:.4f} + min({ATE_MARGIN_M}, itself)")
    check(launches["window_gather"] == frames
          and launches["lk_level"] == 4 * frames
          and launches["cov_update"] == 3 * n_filter,
          f"{name}: launches {launches} == K1 1*T, K2 4*T, K4 3 x "
          f"{n_filter} filter frames (T = {frames})")
    return {"init_frame": k0, "filter_frames": n_filter,
            "ms_per_frame": 1e3 / summary["fps"], "ate_m": ate_m,
            "jax_ate_m": jax_fig["ate_m"],
            "n_upd_total": int(res["n_updates"].sum()),
            "jax_n_upd_total": jax_fig["n_upd_total"], "launches": launches,
            "dynamic_attempts": res["dynamic_attempts"]}


def init_errors(R, v, R_gt, v_gt):
    """An initial state's errors against the ground truth that a dynamic
    init can observe (numpy): the angle in degrees between the estimated
    and the true up direction in the body frame (gravity; yaw is not
    observable), and the relative error of the speed (the metric scale)."""
    up, up_gt = np.asarray(R)[2], np.asarray(R_gt)[2]  # R^T e_z
    cos = float(up @ up_gt / (np.linalg.norm(up) * np.linalg.norm(up_gt)))
    speed, speed_gt = np.linalg.norm(v), np.linalg.norm(v_gt)
    return (float(np.degrees(np.arccos(np.clip(cos, -1.0, 1.0)))),
            float(abs(speed - speed_gt) / speed_gt))


def good_init(res, R_gt, v_gt):
    """(ok and within DRAW_GOOD, gravity degrees, speed error) of a
    DynamicInitResult (None: a window with too few tracks)."""
    if res is None or not bool(res.ok):
        return False, float("nan"), float("nan")
    g, s = init_errors(res.imu.R.double().cpu().numpy(),
                       res.imu.v.double().cpu().numpy(), R_gt, v_gt)
    return (g <= DRAW_GOOD["gravity_deg"] and s <= DRAW_GOOD["speed_err"],
            g, s)


def euroc_phase(dev, bench, wc):
    """Phase 9: phase 5's stream (`bench`, from make_stream with `wc`)
    written as EuRoC bytes, read and run through the CLI, and the dynamic
    stream. Returns the report's "euroc" entry."""
    import torch

    from orcvio_tpu_torch import run_vio as rv
    from orcvio_tpu_torch.dataio import synthetic as syn
    from orcvio_tpu_torch.dataio.euroc import bin_imu_per_frame, load_euroc
    from orcvio_tpu_torch.dataio.euroc_writer import (
        write_reference_config, write_stream)
    from orcvio_tpu_torch.dataio.native import NativeEurocLoader
    from orcvio_tpu_torch.eval.staged import load_bench_images

    tmp = tempfile.mkdtemp(prefix="orcvio_euroc_")
    report = {}
    H, W = wc.cam.height, wc.cam.width
    try:
        # --- write the bytes: phase 5's frames, encoded ---
        seq_dir = os.path.join(tmp, "bench")
        cfg_path = os.path.join(seq_dir, "config.yaml")
        sim = syn.SimConfig(n_frames=EUROC_FRAMES, **BENCH_SIM)
        check(len(bench.frame_ts) == EUROC_FRAMES,
              f"phase 5's stream has {len(bench.frame_ts)} == "
              f"{EUROC_FRAMES} frames to write")
        t0 = time.perf_counter()
        info = write_stream(seq_dir, bench, wc)
        write_reference_config(cfg_path, sim, wc)
        report["writer_s"] = bench.render_s + time.perf_counter() - t0
        report["writer_render_s"] = bench.render_s
        report["writer_encode_s"] = info["encode_s"]

        # --- the readers; all frames decoded only to compare two ---
        py = load_euroc(seq_dir)
        slab = BENCH_FILTER["imu_slab"]
        try:
            t0 = time.perf_counter()
            nat = NativeEurocLoader(seq_dir, prefetch_threads=0)
            report["native_build_s"] = time.perf_counter() - t0
        except Exception as e:
            nat = None
            report["native"] = f"unavailable: {str(e).splitlines()[0]}"
            print(f"native loader unavailable ({str(e).splitlines()[0]}); "
                  "the Python reader is used", flush=True)
        n_dec = EUROC_FRAMES if nat is not None else DECODE_FRAMES
        t0 = time.perf_counter()
        py_images = load_bench_images(py.image_paths, H, W, limit=n_dec)
        report["decoder_s"] = time.perf_counter() - t0
        report["decoder_ms_per_frame"] = report["decoder_s"] * 1e3 / n_dec
        check(len(py.cam_t) == EUROC_FRAMES
              and np.array_equal(py_images, bench.images[:n_dec]),
              f"the Python reader reads {len(py.cam_t)} frames; the first "
              f"{n_dec} decode to the frames written")
        if nat is not None:
            report["native"] = "built"
            py_slabs = bin_imu_per_frame(py, slab)
            nat_slabs = nat.bin_imu(slab)
            t0 = time.perf_counter()
            nat_images = np.stack([nat.get_image(k)
                                   for k in range(nat.n_frames)])
            report["native_decode_s"] = time.perf_counter() - t0
            same = (nat.n_frames == len(py.cam_t)
                    and np.array_equal(nat.cam_t, py.cam_t)
                    and np.allclose(nat.imu_t, py.imu_t, rtol=0, atol=1e-9)
                    and np.allclose(nat.gyro, py.gyro, rtol=0, atol=1e-12)
                    and np.allclose(nat.acc, py.acc, rtol=0, atol=1e-12)
                    and all(np.allclose(a, b, rtol=0, atol=1e-9)
                            for a, b in zip(nat_slabs[:3], py_slabs[:3]))
                    and np.array_equal(nat_slabs[3], py_slabs[3])
                    and np.array_equal(nat_images, py_images))
            check(bool(same), "native loader == Python reader: times, IMU, "
                              "binned slabs, decoded images")
            nat.close()
        del py_images

        # --- the CLI, staged and as the host loop ---
        base = ["--euroc", seq_dir, "--config", cfg_path, "--max-frames",
                str(EUROC_RUN_FRAMES), "--imu-slab", str(slab), "--device",
                str(dev)]
        for name, extra in (("staged", ["--staged"]), ("host_loop", [])):
            tum = os.path.join(tmp, f"{name}.txt")
            k_sync = JAX_EUROC[name]["init_frame"] + 2
            hook = SyncWindow(rv.process_frame, k_sync, k_sync + 20)
            if name == "host_loop":
                rv.process_frame = hook
            launch_counts(reset=True)
            try:
                t0 = time.perf_counter()
                summary = rv.main(base + extra + ["--out", tum])
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            finally:
                hook.close()
                rv.process_frame = hook.fn
            launches = launch_counts()
            report["reader"] = summary["reader"]
            line = check_euroc_run(name, summary, tum, JAX_EUROC[name],
                                   launches, EUROC_RUN_FRAMES)
            line["main_s"] = wall
            if name == "host_loop":
                att = line["dynamic_attempts"]
                want = [k for k, _ in JAX_EUROC[name]["dynamic_attempts"]]
                check([k for k, _ in att] == want
                      and all(ok is False for _, ok in att),
                      f"host loop: dynamic attempts {att} ran at frames "
                      f"{want} and did not initialize (JAX: "
                      f"{JAX_EUROC[name]['dynamic_attempts']})")
                control = find_syncs(
                    lambda: torch.ones(1, device=dev).sum().item())
                check(bool(control) and hook.calls >= k_sync + 20
                      and not hook.found,
                      f"no host synchronisation in host-loop frames "
                      f"{k_sync}-{k_sync + 19} ({len(hook.found)} found: "
                      f"{sorted(set(hook.found))[:5]}; a deliberate .item() "
                      f"was {'caught' if control else 'missed'})")
            report[name] = line
        print(f"reader: {report['reader']}", flush=True)

        # --- the dynamic stream ---
        report["dynamic"] = dynamic_run(dev, wc, tmp, slab)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    report["config"] = (f"bench sequence 752x480, {EUROC_FRAMES} frames "
                        f"written (60 static), the first {EUROC_RUN_FRAMES} "
                        "run; 3 levels, 200 features; filter from the "
                        "bytes' config.yaml (D=172), f32")
    return report


def dynamic_run(dev, wc, tmp, slab):
    """Phase 9's dynamic stream through the host loop: a dynamic init
    inside JAX's window of attempts, finite poses after it, its ATE and
    its errors against the ground truth; then DRAWS further RANSAC draws
    of the initializer on the window it initialized on, of which at least
    DRAWS_MIN must be good (DRAW_GOOD). Returns the report's entry."""
    import torch

    from orcvio_tpu_torch import run_vio as rv
    from orcvio_tpu_torch.dataio import synthetic as syn
    from orcvio_tpu_torch.dataio.euroc_writer import (
        make_stream, write_reference_config, write_stream)
    from orcvio_tpu_torch.eval.trajectory import ate

    dyn_dir = os.path.join(tmp, "dynamic")
    dsim = syn.SimConfig(n_frames=DYN_FRAMES, **DYN_SIM)
    dst = make_stream(dsim, wc, device=dev)
    write_stream(dyn_dir, dst, wc)
    write_reference_config(os.path.join(dyn_dir, "config.yaml"), dsim, wc)
    tum = os.path.join(tmp, "dynamic.txt")
    windows = []
    attempt = rv.flexible_dynamic_attempt

    def spy(cfg, window, R_b2c, t_c_b, **kw):
        res = attempt(cfg, window, R_b2c, t_c_b, **kw)
        windows.append(((cfg, list(window), R_b2c, t_c_b), res))
        return res

    rv.flexible_dynamic_attempt = spy
    launch_counts(reset=True)
    try:
        summary = rv.main(["--euroc", dyn_dir, "--imu-slab", str(slab),
                           "--device", str(dev), "--out", tum])
    finally:
        rv.flexible_dynamic_attempt = attempt
    res = summary["result"]
    jfig = JAX_EUROC["dynamic"]
    k0 = first_true(res["initialized"])
    oks = [k for k, ok in res["dynamic_attempts"] if ok]
    window = jfig["attempt_window"]
    check(k0 is not None and oks == [k0]
          and window[0] <= k0 <= window[1],
          f"dynamic stream: dynamic init on frame {k0} (attempts "
          f"{res['dynamic_attempts']}), within JAX's window {window} "
          f"(JAX: frame {jfig['init_frame']})")
    after = slice(k0 if k0 is not None else DYN_FRAMES, None)
    check(k0 is not None and bool(np.isfinite(res["p"][after]).all())
          and bool(np.isfinite(res["R"][after]).all()),
          "dynamic stream: poses finite after init")
    t = dst.frame_ts
    q_gt = rotations_to_quat(dst.gt_R)
    try:
        dyn_ate = ate(t[after], res["p"][after],
                      rotations_to_quat(res["R"][after]), t, dst.gt_p,
                      q_gt)["rmse_trans"]
    except ValueError:
        dyn_ate = float("nan")
    limit = ate_limit(jfig["ate_se3_from_init_m"])
    check(bool(np.isfinite(dyn_ate)) and dyn_ate <= limit,
          f"dynamic stream: ATE se3 from init {dyn_ate:.4f} m <= {limit:.4f}"
          f" m, JAX's {jfig['ate_se3_from_init_m']:.4f} + min("
          f"{ATE_MARGIN_M}, itself)")
    out = {"init_frame": k0, "jax_init_frame": jfig["init_frame"],
           "dynamic_attempts": res["dynamic_attempts"],
           "ate_se3_from_init_m": dyn_ate,
           "jax_ate_se3_from_init_m": jfig["ate_se3_from_init_m"],
           "ms_per_frame": 1e3 / summary["fps"],
           "launches": launch_counts()}
    if k0 is None:
        return out
    (args, res0), = [w for (k, _), w in zip(res["dynamic_attempts"],
                                             windows) if k == k0]
    _, g0, s0 = good_init(res0, dst.gt_R[k0], dst.gt_v[k0])
    out.update(init_gravity_deg=g0, init_speed_err=s0)
    t0 = time.perf_counter()
    draws = [good_init(attempt(*args, generator=torch.Generator(
        device=dev).manual_seed(DRAW_SEED + i)), dst.gt_R[k0], dst.gt_v[k0])
        for i in range(DRAWS)]
    n_good = sum(g for g, _, _ in draws)
    out.update(draws=[[g, s] for _, g, s in draws], draws_good=n_good,
               draws_s=time.perf_counter() - t0)
    check(n_good >= DRAWS_MIN,
          f"dynamic stream: {n_good} of {DRAWS} RANSAC draws on frame "
          f"{k0}'s window give an init within {DRAW_GOOD['gravity_deg']} "
          f"deg of gravity and {DRAW_GOOD['speed_err']:.0%} of the speed "
          f">= {DRAWS_MIN} (JAX on its own windows: "
          f"{jfig['draws_good']} of {jfig['draws']}); the run's own draw: "
          f"{g0:.2f} deg, {s0:.1%}")
    return out


def pose_error_after_init(p, R, gt_p, gt_R, k0, k):
    """|position error| at frame k after aligning the estimate's pose at
    init frame k0 to the ground truth's there: the drift since init, in
    metres (the filter's world frame starts at the origin with an
    unobservable yaw)."""
    A = np.asarray(gt_R[k0]) @ np.asarray(R[k0]).T
    drift = A @ (np.asarray(p[k]) - np.asarray(p[k0]))
    return float(np.linalg.norm(drift - (gt_p[k] - gt_p[k0])))


def flag_phase(dev, bench, wc):
    """Phase 10: each flag variant of the filter through vio_step on the
    card, float32, over the first FLAG_FRAMES frames of phase 5's stream,
    then FLIGHT_VARIANTS in float64 over FLIGHT_FRAMES, the tracker's
    frames shared (make_tracker_scan once). K4's inputs are kept per
    (D, q) for its checks at the variants' new shapes. Returns (the
    report's "flags" entry, {(D, q): (P, K, H)}, the tracker's K1 and K2
    launches)."""
    import torch

    from orcvio_tpu_torch.config.core import FilterConfig
    from orcvio_tpu_torch.dataio.euroc_writer import R_B2C_DOWN
    from orcvio_tpu_torch.eval.staged import make_tracker_scan, stage_sequence
    from orcvio_tpu_torch.filter import update as filter_update
    from orcvio_tpu_torch.filter.pipeline import FrameInput, build_chi2_table
    from orcvio_tpu_torch.frontend.tracker import TrackerConfig, TrackerState
    from orcvio_tpu_torch.ops.cov_update import cov_update
    from orcvio_tpu_torch.vio import VioState, vio_step

    T, TF = FLAG_FRAMES, FLIGHT_FRAMES
    etc = TrackerConfig(**TRACKER, K=wc.cam.K)
    staged = stage_sequence(*(x[:TF] for x in bench_inputs(bench)),
                            torch.float32, device=dev)
    scan = make_tracker_scan(etc, R_B2C_DOWN, torch.float32, device=dev)
    launch_counts(reset=True)
    _, frames = scan(TrackerState.create(etc, torch.float32, seed=0,
                                         device=dev), staged)
    torch.cuda.synchronize()
    tracker_launches = launch_counts()
    frame = [FrameInput(*(x[k] for x in frames)) for k in range(TF)]
    R_b2c = torch.as_tensor(R_B2C_DOWN, dtype=torch.float32, device=dev)
    t_c_b = torch.as_tensor(wc.t_c_b, dtype=torch.float32, device=dev)

    # K4's first inputs per (D, q, nb) in each run, copied on the device;
    # kept after the run where finite (no host read inside the run)
    captured, pending = {}, {}

    def capture(P, K, H, HP=None, nb=None):
        key = (P.shape[0], K.shape[1], P.shape[0] if nb is None else nb)
        if key not in captured and key not in pending:
            pending[key] = tuple(x.clone() for x in (P, K, H))
        return cov_update(P, K, H, HP, nb)

    def pose_err(p, R, k0, k):
        return (pose_error_after_init(p, R, bench.gt_p, bench.gt_R, k0, k)
                if k0 is not None else float("nan"))

    report = {}
    filter_update.cov_update = capture
    try:
        for name, flags in VARIANTS.items():
            cfg = FilterConfig(**{**BENCH_FILTER, **flags})
            chi2 = build_chi2_table(cfg, torch.float32, dev)
            vs = VioState.create(cfg, etc.capacity, torch.float32, device=dev)
            vs = vs.replace(filter=vs.filter.replace(R_b2c=R_b2c, t_c_b=t_c_b))
            jax_fig = JAX_FLAGS[name]
            k0 = jax_fig["init_frame"]
            outs = []
            launch_counts(reset=True)

            def run(ks):
                nonlocal vs
                for k in ks:
                    vs, out = vio_step(cfg, vs, frame[k], chi2)
                    outs.append(out)

            # up to the frame after init (the last that reads the flag),
            # then 10 timed filter frames, then the rest under torch's sync
            # debug mode
            run(range(0, k0 + 2))
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            run(range(k0 + 2, k0 + 12))
            e1.record()
            torch.cuda.synchronize()
            ms = e0.elapsed_time(e1) / 10
            syncs = find_syncs(lambda: run(range(k0 + 12, T)))
            k4 = launch_counts()["cov_update"]
            P_finite = bool(torch.isfinite(vs.filter.P).all())
            for key, xs in pending.items():
                if all(bool(torch.isfinite(x).all()) for x in xs):
                    captured[key] = xs
            pending.clear()

            p = torch.stack([o.p for o in outs]).double().cpu().numpy()
            R = torch.stack([o.R for o in outs]).double().cpu().numpy()
            v = torch.stack([o.v for o in outs]).double().cpu().numpy()
            moved = np.abs(R - np.eye(3)).reshape(T, -1).max(1) > 0
            ki = int(np.argmax(moved)) if moved.any() else None
            n_filter = 0 if ki is None else T - 1 - ki
            ok = (np.isfinite(p).all(1) & np.isfinite(R).reshape(T, -1).all(1)
                  & np.isfinite(v).all(1))
            bad = None if ok.all() else int(np.argmin(ok))
            finite = bad is None and P_finite
            err = pose_err(p, R, ki, T - 1)
            per_frame = k4_per_frame(cfg)
            jbad = jax_fig["first_nonfinite_frame"]
            jbad = jbad if jbad is not None and jbad < T else None
            check(ki == k0, f"flags {name}: init on frame {ki} == {k0} (JAX)")
            if jbad is None:
                check(bad is None, f"flags {name}: every pose finite, as "
                      "JAX's")
            else:
                check(bad is not None and bad >= jbad,
                      f"flags {name}: first frame with a non-finite pose "
                      f"{bad}, none before JAX's {jbad}")
            if jax_fig["finite"]:
                jerr = jax_fig["pos_err_m"]
                check(finite, f"flags {name}: p, R, v and P finite")
                check(bool(abs(err - jerr) <= FLAG_POS_TOL_M),
                      f"flags {name}: position error at frame {T - 1} "
                      f"{err:.6f} m within {FLAG_POS_TOL_M} m of JAX's "
                      f"{jerr:.6f}")
            else:  # the JAX package's run turns non-finite on this stream
                check(not finite,
                      f"flags {name}: non-finite as the JAX package's run")
            check(k4 == per_frame * n_filter,
                  f"flags {name}: K4 launches {k4} == {per_frame} x "
                  f"{n_filter} filter frames")
            report[name] = {
                "init_frame": ki, "jax_init_frame": k0,
                "pos_err_m": err, "jax_pos_err_m": jax_fig["pos_err_m"],
                "finite": finite, "jax_finite": jax_fig["finite"],
                "first_nonfinite_frame": bad,
                "jax_first_nonfinite_frame": jbad,
                "k4_launches": k4, "filter_frames": n_filter,
                "k4_per_filter_frame": k4 / max(n_filter, 1),
                "syncs": len(syncs), "sync_sites": sorted(set(syncs))[:6],
                "sync_frames": T - k0 - 12, "ms_per_filter_frame": ms,
                "n_upd_total": int(sum(int(o.n_update_features)
                                       for o in outs)),
                "zupt_frames": int(sum(bool(o.zupt) for o in outs)),
                "D": cfg.state_dim}
            print(f"flags {name}: " + json.dumps(report[name]), flush=True)
    finally:
        filter_update.cov_update = cov_update

    # FLIGHT_VARIANTS once more in float64, on into the flight, where the
    # visual updates run (float32 OrcVIO runs follow the rounding of the
    # closed-form mean there: ROADMAP section 3 item 18)
    imu64 = stage_sequence(*(x[:TF] for x in bench_inputs(bench)),
                           torch.float64, device=dev)
    frame64 = [FrameInput(imu64.frame_ts[k], imu64.imu_t[k],
                          imu64.imu_gyro[k], imu64.imu_acc[k],
                          imu64.imu_mask[k], frames.fids[k],
                          frames.uvs[k].double(), frames.uv_vels[k].double(),
                          frames.meas_mask[k]) for k in range(TF)]
    for name in FLIGHT_VARIANTS:
        cfg = FilterConfig(**{**BENCH_FILTER, **VARIANTS[name]})
        chi2 = build_chi2_table(cfg, torch.float64, dev)
        vs = VioState.create(cfg, etc.capacity, torch.float64, device=dev)
        vs = vs.replace(filter=vs.filter.replace(R_b2c=R_b2c.double(),
                                                 t_c_b=t_c_b.double()))
        jf = JAX_FLAGS[name]["flight"]
        launch_counts(reset=True)
        outs, nui = [], []
        for k in range(TF):
            vs, out = vio_step(cfg, vs, frame64[k], chi2)
            outs.append(out)
            nui.append(vs.filter.nui.valid.any())
        k4f = launch_counts()["cov_update"]
        demoted = first_true(torch.stack(nui).cpu().numpy())
        p = torch.stack([o.p for o in outs]).cpu().numpy()
        R = torch.stack([o.R for o in outs]).cpu().numpy()
        moved = np.abs(R - np.eye(3)).reshape(TF, -1).max(1) > 0
        ki = int(np.argmax(moved)) if moved.any() else None
        finite_f = bool(np.isfinite(p).all() and np.isfinite(R).all()
                        and torch.isfinite(vs.filter.P).all())
        err_f = pose_err(p, R, ki, TF - 1)
        n_upd_f = int(sum(int(o.n_update_features) for o in outs[T:]))
        n_filter = 0 if ki is None else TF - 1 - ki
        per_frame = k4_per_frame(cfg)
        blocks = {}
        if cfg.use_schmidt:
            check(demoted is not None,
                  f"flags {name} float64: a clone demoted to a nuisance slot "
                  f"by frame {TF - 1}: first on frame {demoted} (JAX "
                  f"{jf['first_demotion_frame']})")
            blocks = schmidt_blocks(vs.filter.P.cpu().numpy(),
                                    cfg.nuisance_cap)
            for key, x in blocks.items():
                check(bool(abs(x - jf[key]) <= SCHMIDT_BLOCK_RTOL * jf[key]),
                      f"flags {name} float64: P's {key} at frame {TF - 1} "
                      f"{x:.6e} within {SCHMIDT_BLOCK_RTOL:.0%} of JAX's "
                      f"{jf[key]:.6e}")
        check(ki == jf["init_frame"] and finite_f,
              f"flags {name} float64: init on frame {ki} == "
              f"{jf['init_frame']} (JAX), finite to frame {TF - 1}")
        check(n_upd_f > 0 and jf["n_upd"] > 0,
              f"flags {name} float64: {n_upd_f} visual updates in frames "
              f"{T}-{TF - 1} (JAX {jf['n_upd']})")
        check(bool(abs(err_f - jf["pos_err_m"]) <= FLIGHT_POS_TOL_M),
              f"flags {name} float64: position error at frame {TF - 1} "
              f"{err_f:.6f} m within {FLIGHT_POS_TOL_M} m of JAX's "
              f"{jf['pos_err_m']:.6f}")
        check(k4f == per_frame * n_filter,
              f"flags {name} float64: K4 launches {k4f} == {per_frame} x "
              f"{n_filter} filter frames")
        report[name]["flight"] = {
            "dtype": "float64", "frames": TF, "init_frame": ki,
            "pos_err_m": err_f, "jax_pos_err_m": jf["pos_err_m"],
            "finite": finite_f, "n_upd": n_upd_f, "jax_n_upd": jf["n_upd"],
            "k4_launches": k4f, "first_demotion_frame": demoted,
            "jax_first_demotion_frame": jf.get("first_demotion_frame"),
            "zupt_frames": int(sum(bool(o.zupt) for o in outs[T:])),
            **blocks, **{"jax_" + key: jf[key] for key in blocks}}
        print(f"flags {name} flight: " + json.dumps(report[name]["flight"]),
              flush=True)
    check(tracker_launches["window_gather"] == TF
          and tracker_launches["lk_level"] == 4 * TF,
          f"flags: tracker launches {tracker_launches} == K1 1*T, K2 4*T "
          f"(T = {TF})")
    return report, captured, tracker_launches


def k4_per_frame(cfg):
    """K4's launches a filter frame: the stacked, ZUPT (where ZUPT is on)
    and last-chance updates, none under the information and Joseph forms,
    whose covariance steps are plain algebra, unless Schmidt states turn
    them into the qr and plain forms."""
    schmidt = cfg.use_schmidt and cfg.nuisance_cap > 0
    if (cfg.update_form == "information" or cfg.joseph_form) and not schmidt:
        return 0
    return 2 + cfg.if_zupt


def update_forms_check(dev, seed=5):
    """The qr and chol update forms on the card, where a Jacobian has full
    column rank (a seeded normal (444, D), the stacked update's row count;
    the filter's own stacked Jacobians leave the clones' common shift
    unobserved, so the chol form's Gram matrix is singular there):
    apply_ekf_update under each form, float64 and float32, at the bench's
    D = 172 with a seeded P (eigenvalues 1e-4 to 4e-3), against the
    "direct" form in float64 on the CPU (the forms are equal in exact
    arithmetic). float64 must agree within UPDATE_FORM_TOL (relative to the
    largest entry of P and of dx); float32 is reported. Returns the
    relative errors per dtype and form."""
    import dataclasses

    import torch

    from orcvio_tpu_torch.config.core import FilterConfig
    from orcvio_tpu_torch.filter.state import FilterState
    from orcvio_tpu_torch.filter.update import apply_ekf_update

    cfg = FilterConfig(**BENCH_FILTER)
    D = cfg.state_dim
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(D, D)) / np.sqrt(D)
    P = 1e-3 * (A @ A.T) + 1e-4 * np.eye(D)
    H = rng.normal(size=(444, D))
    r = 0.008 * rng.normal(size=444)

    def update(form, dtype, device):
        st = FilterState.create(cfg, dtype, device=device)
        st = st.replace(P=torch.as_tensor(P, dtype=dtype, device=device))
        st, dx = apply_ekf_update(
            dataclasses.replace(cfg, update_form=form), st,
            torch.as_tensor(H, dtype=dtype, device=device),
            torch.as_tensor(r, dtype=dtype, device=device))
        return st.P.double().cpu().numpy(), dx.double().cpu().numpy()

    P_ref, dx_ref = update("direct", torch.float64, "cpu")
    errs = {}
    for dtype in (torch.float64, torch.float32):
        for form in ("direct", "qr", "chol"):
            P_out, dx = update(form, dtype, dev)
            errs[f"{form} {str(dtype)[6:]}"] = {
                "P": float(np.abs(P_out - P_ref).max() / np.abs(P_ref).max()),
                "dx": float(np.abs(dx - dx_ref).max()
                            / np.abs(dx_ref).max())}
    for form in ("direct", "qr", "chol"):
        e = errs[f"{form} float64"]
        check(bool(max(e.values()) <= UPDATE_FORM_TOL),
              f"update form {form} on the card, float64, full-rank H (444, "
              f"{D}): P, dx within {UPDATE_FORM_TOL} of the CPU's direct "
              f"form ({e['P']:.2e}, {e['dx']:.2e})")
    return errs


def rotations_to_quat(R):
    """[x y z w] quaternions of (T, 3, 3) rotations (numpy)."""
    import torch

    from orcvio_tpu_torch.math import quat

    return quat.from_rotation(torch.as_tensor(R, dtype=torch.float64)).numpy()


def batched_rule_checks(dev, bench, wc):
    """Phase 11 (a): each kernel's vmap rule on the card at B = BATCH and
    the bench shapes, against B single launches of the same rows: K1
    (ORB's 440 windows a row) and K2 (the level route, 200 features a row)
    bit for bit, K4 bit for bit and exactly symmetric in float32 and
    float64 at q = 444 and 9, with nb = D and nb < D; operands batched,
    shared (in_dim None) and shared through a batch stride of 0 (what vmap
    hands back for an unbatched output). One launch a batched call. Then
    each batched entry's time beside B single launches (and, for K4, one
    torch.baddbmm of the same product) and its bound. Returns {kernel:
    its "batched" entry of the kernels line}."""
    import torch

    from orcvio_tpu_torch.frontend import klt
    from orcvio_tpu_torch.frontend.image import build_pyramid, equalize_hist
    from orcvio_tpu_torch.ops.cov_update import cov_update
    from orcvio_tpu_torch.ops.dma_gather import dma_gather_tiles
    from orcvio_tpu_torch.ops.lk_pallas import lk_level_fused, lk_level_src
    from orcvio_tpu_torch.ops.window_gather import window_origins

    B = BATCH
    vmap = torch.func.vmap

    def row(x, d, b):
        return x if d is None else x[b]

    def one_launch(counter, fn, what):
        """fn() under a launch counter: the result, checked to be one
        launch."""
        n = counter.launches
        out = fn()
        torch.cuda.synchronize()
        check(counter.launches == n + 1,
              f"batched {what}: {counter.launches - n} launch(es) == 1")
        return out

    # the bench stream's frames 60-63 (flight), equalized, as pyramids
    frames = [equalize_hist(torch.as_tensor(bench.images[k]).to(
        dev, torch.float32)) for k in range(60, 60 + B + 1)]
    pyrs = [klt.prepare_pyramid(build_pyramid(f, 3)) for f in frames]
    H, W = frames[0].shape
    rng = np.random.default_rng(21)
    xy = torch.as_tensor(rng.uniform([24, 24], [W - 24, H - 24],
                                     size=(B, 200, 2)),
                         dtype=torch.float32, device=dev)
    shift = torch.tensor([1.3, -0.7], device=dev)
    out = {}

    # K2, level 0: row b tracks its own 200 features from frame 60 to 61
    # (levels shared, as on the replay's route) or from frame 60 + b to
    # 61 + b (levels batched)
    def k2_row(b, a0, a1):
        lw0 = klt.gather_level(a0, xy[b], cut=False)
        lw1 = klt.gather_level(a1, xy[b] + shift, cut=False)
        aux = klt._level_aux(lw0, lw1, xy[b], xy[b] + shift, 15)[0]
        return lw0.level, lw0.offset, lw1.level, lw1.offset, aux

    shared_rows = [k2_row(b, pyrs[0][0], pyrs[1][0]) for b in range(B)]
    own_rows = [k2_row(b, pyrs[b][0], pyrs[b + 1][0]) for b in range(B)]
    k2_exact = True
    k2_cases = {"levels shared": (shared_rows, (None, 0, None, 0, 0)),
                "levels batched": (own_rows, (0, 0, 0, 0, 0)),
                "level 0 stride 0": (shared_rows, (0, 0, None, 0, 0))}
    for name, (rows, dims) in k2_cases.items():
        args = [r[0] if d is None else torch.stack(r)
                for r, d in zip(zip(*rows), dims)]
        if name == "level 0 stride 0":
            args[0] = args[0][0].expand(B, *args[0].shape[1:])
        call = lambda: vmap(  # noqa: E731
            lambda *a: lk_level_src(*a, 10, 15, klt.KLT_EPS),
            in_dims=dims)(*args)
        got = one_launch(lk_level_fused, call, f"K2 {name}")
        want = torch.stack([lk_level_src(*(row(x, d, b) for x, d in
                                           zip(args, dims)), 10, 15,
                                         klt.KLT_EPS) for b in range(B)])
        same = bool(torch.equal(got, want))
        k2_exact &= same
        check(same, f"batched K2 {name}: B = {B} rows of 200 features "
                    "bit-identical to single launches")
    args = [r[0] if d is None else torch.stack(r) for r, d in
            zip(zip(*shared_rows), k2_cases["levels shared"][1])]
    dims = k2_cases["levels shared"][1]
    out["lk_level"] = {
        "B": B, "shape": f"{B} x 200 features on shared levels "
                         f"{tuple(args[0].shape)}",
        "bit_identical_to_single_launches": k2_exact,
        "ms": time_ms(lambda: vmap(lambda *a: lk_level_src(
            *a, 10, 15, klt.KLT_EPS), in_dims=dims)(*args)),
        "single_launches_ms": time_ms(lambda: [lk_level_src(
            *(row(x, d, b) for x, d in zip(args, dims)), 10, 15,
            klt.KLT_EPS) for b in range(B)])}

    # K1: ORB's 440 windows a row at level 0 (200 tracked + 240 candidates)
    centers = torch.cat([xy, xy[:, :120] + 40.0, xy[:, :120] - 40.0], 1)
    origins = [window_origins(pyrs[b][0], centers[b], -16, 48, 256)[:2]
               for b in range(B)]
    r0, c0 = (torch.stack(x) for x in zip(*origins))
    b0 = torch.zeros_like(r0)
    imgs_b = torch.stack([pyrs[b][0].padded for b in range(B)])
    k1_exact = True
    for name, imgs, d in (("image shared", pyrs[0][0].padded, None),
                          ("images batched", imgs_b, 0)):
        call = lambda: vmap(lambda *a: dma_gather_tiles(  # noqa: E731
            *a, 6, 2), in_dims=(d, 0, 0, 0))(imgs, r0, c0, b0)
        got = one_launch(dma_gather_tiles, call, f"K1 {name}")
        want = torch.stack([dma_gather_tiles(row(imgs, d, b), r0[b], c0[b],
                                             b0[b], 6, 2) for b in range(B)])
        same = bool(torch.equal(got, want))
        k1_exact &= same
        check(same, f"batched K1 {name}: B = {B} rows of 440 windows "
                    "bit-identical to single launches")
    img0 = pyrs[0][0].padded
    out["window_gather"] = {
        "B": B, "shape": f"{B} x 440 windows (48, 256) from shared "
                         f"{tuple(img0.shape)}",
        "bit_identical_to_single_launches": k1_exact,
        "ms": time_ms(lambda: vmap(lambda *a: dma_gather_tiles(*a, 6, 2),
                                   in_dims=(None, 0, 0, 0))(img0, r0, c0,
                                                            b0)),
        "single_launches_ms": time_ms(lambda: [dma_gather_tiles(
            img0, r0[b], c0[b], b0[b], 6, 2) for b in range(B)]),
        "bound_ms": bound_ms(sum(k1_needed_bytes(img0, r0[b], c0[b], 6, 2)
                                 for b in range(B)), 0)[0]}

    # K4 at the bench's D = 172: rows of seeded inputs
    k4_exact = True
    D = 172
    for dtype in (torch.float32, torch.float64):
        for q in (444, 9):
            rows = [k4_inputs(D, q, 300 + b, dtype, dev) for b in range(B)]
            P, K = (torch.stack([r[i] for r in rows]) for i in (0, 1))
            HP = torch.stack([r[2] @ r[0] for r in rows])
            for name, nb, dims, Pb, HPb in (
                    ("batched", D, (0, 0, 0), P, HP),
                    ("nb", D - 36, (0, 0, 0), P, HP),
                    ("HP shared", D, (0, 0, None), P, HP[0]),
                    ("P stride 0", D, (0, 0, 0), P[0].expand(B, D, D), HP)):
                call = lambda: vmap(  # noqa: E731
                    lambda p, k, hp: cov_update(p, k, None, hp, nb),
                    in_dims=dims)(Pb, K, HPb)
                what = f"K4 {name} q={q} {str(dtype)[6:]}"
                got = one_launch(cov_update, call, what)
                want = torch.stack([cov_update(Pb[b], K[b], None,
                                               row(HPb, dims[2], b), nb)
                                    for b in range(B)])
                same = bool(torch.equal(got, want)
                            and torch.equal(got, got.mT)
                            and torch.equal(got[:, nb:, nb:],
                                            Pb[:, nb:, nb:]))
                k4_exact &= same
                check(same, f"batched {what} nb={nb}: B = {B} rows "
                            "bit-identical to single launches, exactly "
                            "symmetric")
            if dtype == torch.float32 and q == 444:
                k4_args = (P, K, HP)
    P, K, HP = k4_args
    q = K.shape[-1]
    nbytes = 4 * B * (2 * D * D + 2 * D * q)
    bnd, by = bound_ms(nbytes, B * 2 * D * D * q)
    out["cov_update"] = {
        "B": B, "shape": f"{B} x P ({D},{D}), K ({D},{q}), HP ({q},{D}) "
                         "float32",
        "bit_identical_to_single_launches": k4_exact,
        "ms": time_ms(lambda: vmap(lambda p, k, hp: cov_update(
            p, k, None, hp))(P, K, HP)),
        "single_launches_ms": time_ms(lambda: [cov_update(
            P[b], K[b], None, HP[b]) for b in range(B)]),
        "library_ms": time_ms(lambda: torch.baddbmm(P, K, HP, alpha=-1)),
        "library": "torch.baddbmm(P, K, HP, alpha=-1)",
        "bound_ms": bnd, "bound_by": by}
    return out


def frame_by_frame(replay, state, staged, ks):
    """replay over the frames ks one call a frame: the final state, the
    outs of all frames, and the tracker's (fid, xy, uvn) after each."""
    import torch

    tracks, outs = [], []
    for k in ks:
        state, o = replay(*state, staged, frames=[k])
        tracks.append((state[0].fid, state[0].xy, state[0].uvn))
        outs.append(o)
    dim = outs[0]["p"].dim() - 2  # the frame axis: 1 batched, 0 single
    return state, {key: torch.cat([o[key] for o in outs], dim)
                   for key in outs[0]}, tracks


def batched_e2e_rows(dev, bench, wc):
    """Phase 11 (b): the batched end-to-end replay, float64 filter (the
    tracker in float32: the LK kernels take float32 only), B = BATCH rows
    whose trackers differ: row b (RANSAC seed b) starts its stream on
    frame ROW_STARTS[b] of phase 5's stream, so from the frame the batch
    starts on each row tracks other features under other ids. The batch
    runs to frame ROW_FRAMES (init, then the flight's first visual
    updates), one call a frame, each row drawing its noise from its own
    generator. Each row against its single-stream replay on the card,
    frame by frame: the tracker's ids identical and positions within
    ROW_XY_TOL_PX, the same init frame, identical update counts and ZUPT
    flags, p within ROW_TOL_M, and at the end the same next id, descriptors
    and generator state. Returns the report's entry."""
    import torch

    from orcvio_tpu_torch.config.core import FilterConfig
    from orcvio_tpu_torch.dataio.euroc_writer import R_B2C_DOWN
    from orcvio_tpu_torch.eval.staged import (make_batched_e2e_replay,
                                              make_e2e_replay, stage_sequence)
    from orcvio_tpu_torch.frontend.tracker import (TrackerConfig,
                                                   TrackerState,
                                                   stack_tracker_states)
    from orcvio_tpu_torch.tree import tree_stack
    from orcvio_tpu_torch.vio import VioState

    B, TR, S0 = BATCH, ROW_FRAMES, max(ROW_STARTS)
    f32, f64 = torch.float32, torch.float64
    etc = TrackerConfig(**TRACKER, K=wc.cam.K)
    cfg = FilterConfig(**BENCH_FILTER)
    staged = stage_sequence(*(x[:TR] for x in bench_inputs(bench)), f64,
                            device=dev)
    args = (cfg, etc, R_B2C_DOWN, wc.t_c_b, f64, dev)
    single, batched = make_e2e_replay(*args), make_batched_e2e_replay(*args)

    trk = f32 if dev.type == "cuda" else f64  # the replays' tracker dtype

    def fresh(b):
        return (TrackerState.create(etc, trk, seed=b, device=dev),
                VioState.create(cfg, etc.capacity, f64, device=dev))

    pre = [fresh(b) if s == S0 else
           single(*fresh(b), staged, frames=range(s, S0))[0]
           for b, s in enumerate(ROW_STARTS)]
    t0 = time.perf_counter()
    (tsb, _), outs, tracks = frame_by_frame(batched, (
        stack_tracker_states([x[0] for x in pre]),
        tree_stack([x[1] for x in pre])), staged, range(S0, TR))
    torch.cuda.synchronize()
    batched_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    singles = [frame_by_frame(single, fresh(b), staged, range(s, TR))
               for b, s in enumerate(ROW_STARTS)]
    torch.cuda.synchronize()
    singles_s = time.perf_counter() - t0
    rows = []
    for b, ((ts, _), one, one_tracks) in enumerate(singles):
        s = ROW_STARTS[b]
        one = {key: v[S0 - s:] for key, v in one.items()}
        k0 = first_true(outs["initialized"][b].cpu().numpy())
        k1 = first_true(one["initialized"].cpu().numpy())
        same = {f: bool(torch.equal(outs[f][b], one[f]))
                for f in ("n_upd", "zupt")}
        err = float((outs["p"][b] - one["p"]).abs().max())
        n_upd = int(one["n_upd"].sum())
        fids = all(bool(torch.equal(x[0][b], y[0]))
                   for x, y in zip(tracks, one_tracks[S0 - s:]))
        xy_err = max(float((x[1][b] - y[1]).abs().max())
                     for x, y in zip(tracks, one_tracks[S0 - s:]))
        end = {"next_id": bool(torch.equal(tsb.next_id[b], ts.next_id)),
               "desc": bool(torch.equal(tsb.desc[b], ts.desc)),
               "generator": bool(torch.equal(tsb.rng[b].get_state(),
                                             ts.rng.get_state()))}
        # row 0's stream is phase 5's: it inits on JAX's frame
        jax_k0 = JAX_E2E["init_frame"] if s == 0 else None
        also = "" if jax_k0 is None else f" == JAX's {jax_k0}"
        check(k0 is not None and k0 == k1 and all(same.values())
              and err <= ROW_TOL_M and n_upd > 0
              and jax_k0 in (None, S0 + k0),
              f"batched row {b} (seed {b}, from frame {s}), float64: init "
              f"on frame {None if k0 is None else S0 + k0} == its single "
              f"stream's{also}, n_upd and zupt identical {same}, {n_upd} "
              f"visual updates, p within {err:.2e} <= {ROW_TOL_M} m")
        check(fids and xy_err <= ROW_XY_TOL_PX and all(end.values()),
              f"batched row {b}: tracker ids identical to its single "
              f"stream's on all {len(tracks)} frames ({fids}), positions "
              f"within {xy_err:.2e} <= {ROW_XY_TOL_PX} px, at the end "
              f"{end}")
        rows.append({"seed": b, "start_frame": s,
                     "init_frame": None if k0 is None else S0 + k0,
                     "p_err_m": err, "xy_err_px": xy_err,
                     "identical": {**same, "fids": fids, **end},
                     "n_upd_total": n_upd})
    apart = {f"{a},{b}": sum(not torch.equal(x[0][a], x[0][b])
                             and not torch.equal(x[1][a], x[1][b])
                             for x in tracks)
             for a in range(B) for b in range(a + 1, B)}
    diff = min(float((outs["p"][b] - outs["p"][a]).abs().max())
               for a in range(B) for b in range(a + 1, B))
    check(min(apart.values()) >= len(tracks) // 3
          and diff > 10 * ROW_TOL_M,
          f"batched rows: every two rows' trackers apart (other ids and "
          f"positions) on {min(apart.values())} of {len(tracks)} frames at "
          f"least, their p by {diff:.3e} m (> 10 x {ROW_TOL_M} m), so a row "
          "mixed into another would fail its parity")
    return {"B": B, "frames": [S0, TR], "starts": list(ROW_STARTS),
            "dtype": "float64 filter, float32 tracker", "rows": rows,
            "rows_apart_frames": apart, "rows_min_p_diff_m": diff,
            "batched_s": batched_s, "singles_s": singles_s}


def batched_bench(dev, bench, wc, gt_q, frame_ts):
    """Phase 11 (c): the bench's batched configuration, the float32
    end-to-end replay at B = BATCH identical rows (as bench.py:219-221
    stacks them) over the first BATCH_FRAMES frames of phase 5's stream,
    in one pass: frames up to BATCH_START, then BATCH_WINDOW frames
    timed with CUDA events and their launches counted (1 K1, 4 K2, 3 K4 a
    batched frame, as a single stream's), then 20 under sync debug mode,
    BATCH_PROFILE_FRAMES (after as many more) profiled, and the rest; the
    rows bit-identical; row 0's ATE over the pass within ate_limit of
    JAX's over as many frames. Returns the report's entry."""
    import torch

    from orcvio_tpu_torch.config.core import FilterConfig
    from orcvio_tpu_torch.dataio.euroc_writer import R_B2C_DOWN
    from orcvio_tpu_torch.eval.staged import (make_batched_e2e_replay,
                                              stage_sequence)
    from orcvio_tpu_torch.eval.trajectory import ate
    from orcvio_tpu_torch.tree import tree_stack
    from orcvio_tpu_torch.frontend.tracker import (TrackerConfig,
                                                   TrackerState,
                                                   stack_tracker_states)
    from orcvio_tpu_torch.math import quat
    from orcvio_tpu_torch.vio import VioState

    B, TE, n = BATCH, BATCH_FRAMES, BATCH_PROFILE_FRAMES
    f32 = torch.float32
    etc = TrackerConfig(**TRACKER, K=wc.cam.K)
    cfg = FilterConfig(**BENCH_FILTER)
    staged = stage_sequence(*(x[:TE] for x in bench_inputs(bench)), f32,
                            device=dev)
    replay = make_batched_e2e_replay(cfg, etc, R_B2C_DOWN, wc.t_c_b, f32,
                                     device=dev)
    state = (stack_tracker_states([TrackerState.create(etc, f32, seed=0,
                                                       device=dev)
                                   for _ in range(B)]),
             tree_stack([VioState.create(cfg, etc.capacity, f32,
                                         device=dev)] * B))
    parts = []

    def run(ks):
        """The frames ks, on from the pass's state."""
        nonlocal state
        state, o = replay(*state, staged, frames=ks)
        parts.append(o)

    window = range(BATCH_START, BATCH_START + BATCH_WINDOW)
    check(window.stop + 20 + 2 * n <= TE,
          f"batched e2e: the pass's {TE} frames hold the window, the sync "
          "check and the profile")
    run(range(BATCH_START))
    torch.cuda.synchronize()
    launch_counts(reset=True)
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    run(window)
    e1.record()
    torch.cuda.synchronize()
    launches = launch_counts()
    ms = e0.elapsed_time(e1) / len(window)
    k = window.stop
    check_no_syncs(lambda: run(range(k, k + 20)),
                   f"20 batched end-to-end frames after init (B = {B})")
    later = iter((range(k + 20, k + 20 + n),
                  range(k + 20 + n, k + 20 + 2 * n)))
    prof = profile_frames(lambda: run(next(later)), n)
    run(range(k + 20 + 2 * n, TE))
    outs = {key: torch.cat([p[key] for p in parts], 1) for key in parts[0]}
    want = {"window_gather": 1, "lk_level": 4, "cov_update": 3}
    per_frame = {key: v / len(window) for key, v in launches.items()}
    check(per_frame == want,
          f"batched e2e: launches per batched frame {per_frame} == a single "
          f"stream's {want} (B = {B})")
    same = all(bool(torch.equal(outs[key][b], outs[key][0])) for key in outs
               for b in range(1, B))
    check(same, f"batched e2e: the {B} identical rows' outputs are "
                "bit-identical")
    k0 = first_true(outs["initialized"][0].cpu().numpy())
    check(k0 == JAX_E2E["init_frame"] and k0 + 2 <= BATCH_START,
          f"batched e2e: init on frame {k0} == JAX's "
          f"{JAX_E2E['init_frame']}, before the timed window "
          f"({BATCH_START})")
    p = outs["p"][0].double().cpu().numpy()
    q = quat.from_rotation(outs["R"][0].double()).cpu().numpy()
    finite = bool(np.isfinite(p).all() and np.isfinite(q).all())
    try:
        m = ate(frame_ts[:TE], p, q, frame_ts[:TE], bench.gt_p[:TE],
                gt_q[:TE], "posyaw")
    except ValueError as e:
        m = {"rmse_trans": float("nan"), "error": str(e)}
    jax_ate = JAX_E2E[f"ate_m_{TE}"]
    limit = ate_limit(jax_ate)
    check(p.shape[0] == TE and finite
          and bool(m["rmse_trans"] <= limit),
          f"batched e2e: row 0's ATE {m['rmse_trans']:.4f} m (posyaw) over "
          f"{p.shape[0]} frames <= {limit:.4f} m, JAX's over as many, "
          f"{jax_ate:.4f} m, + min({ATE_MARGIN_M}, itself)")
    return {"B": B, "frames": TE, "init_frame": k0,
            "window": [window.start, window.stop],
            "ms_per_batched_frame": ms,
            "aggregate_frames_per_s": B * 1e3 / ms,
            "launches": launches, "launches_per_batched_frame": per_frame,
            "rows_bit_identical": same, "ate_m": m["rmse_trans"],
            "jax_ate_m": jax_ate, "ate_limit_m": limit,
            "n_upd_total_row0": int(outs["n_upd"][0].sum()),
            "profile": prof}


def batched_filter_aggregate(dev):
    """Phase 11 (d): bench.py:232-266's filter-only aggregate through the
    port's sharded_replay_fn on a one-card mesh: FILTER_AGG_B sequences of
    the port's synthetic.generate frames (its sizes: sw 20, 150 features,
    400 landmarks, IMU slab 12), float32, FILTER_AGG_FRAMES frames, from
    the initialized state __graft_entry__._build makes. One timed run on
    the host clock: aggregate frames/s and K4 launches a batched frame."""
    import torch

    from orcvio_tpu_torch.config.core import FilterConfig
    from orcvio_tpu_torch.dataio import synthetic as syn
    from orcvio_tpu_torch.filter.pipeline import FrameInput
    from orcvio_tpu_torch.tree import tree_stack
    from orcvio_tpu_torch.parallel.replay import make_mesh, sharded_replay_fn

    B, T = FILTER_AGG_B, FILTER_AGG_FRAMES
    cfg = FilterConfig(sw_size=20, max_features=150, max_track_len=6,
                       imu_slab=12, observation_noise=0.004,
                       tri_translation_threshold=-1.0)
    sim = syn.SimConfig(n_frames=T, n_landmarks=400, max_obs=60,
                        imu_slab=12, seed=0)
    st, frames, chi2 = syn.initialized_run(cfg, sim, torch.float32, dev)
    states = tree_stack([st] * B)
    frames_b = FrameInput(*(x.expand(B, *x.shape) for x in frames))
    mesh = make_mesh(1)
    fn = sharded_replay_fn(cfg, mesh)
    torch.cuda.synchronize()
    launch_counts(reset=True)
    t0 = time.perf_counter()
    final, outs = fn(states, frames_b, chi2)
    torch.cuda.synchronize()
    s = time.perf_counter() - t0
    k4 = launch_counts()["cov_update"]
    finite = bool(torch.isfinite(outs.p).all()
                  and torch.isfinite(final.P).all())
    same = bool(torch.equal(outs.p, outs.p[:1].expand_as(outs.p)))
    check(finite and same and k4 > 0,
          f"filter aggregate: B = {B} x {T} frames finite, rows "
          f"bit-identical, K4 {k4 / T:.2f} launches a batched frame")
    return {"B": B, "frames": T, "devices": len(mesh), "seconds": s,
            "aggregate_frames_per_s": B * T / s,
            "ms_per_batched_frame": s * 1e3 / T,
            "k4_launches": k4, "k4_per_batched_frame": k4 / T,
            "n_upd_total_row0": int(outs.n_update_features[0].sum())}


def batched_phase(dev, bench, wc, gt_q, frame_ts):
    """Phase 11, many streams on one card: (a) the kernels' vmap rules,
    (b) the float64 rows against their single streams, (c) the bench's
    batched end-to-end configuration, (d) the filter-only aggregate. The
    vmap fallback's warning is on throughout: an op without a batching rule
    (run row by row) fails the phase."""
    import torch

    functorch = torch._C._functorch
    functorch._set_vmap_fallback_warning_enabled(True)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        try:
            report, seconds = {}, {}
            for name, part in (
                    ("rules", lambda: batched_rule_checks(dev, bench, wc)),
                    ("rows", lambda: batched_e2e_rows(dev, bench, wc)),
                    ("e2e", lambda: batched_bench(dev, bench, wc, gt_q,
                                                  frame_ts)),
                    ("filter_aggregate",
                     lambda: batched_filter_aggregate(dev))):
                t0 = time.perf_counter()
                report[name] = part()
                seconds[name] = time.perf_counter() - t0
            report["seconds"] = seconds
        finally:
            functorch._set_vmap_fallback_warning_enabled(False)
    fallbacks = sorted({str(w.message)[:160] for w in caught
                        if "batching rule" in str(w.message)})
    check(not fallbacks, f"batched: no op ran without a batching rule "
                         f"({fallbacks[:3]})")
    report["ops_without_batching_rule"] = fallbacks
    return report


class K4Shapes:
    """Records the (P, K, H, HP) of K4's first call at each (D, q) that
    apply_ekf_update makes, the launches counted as ever."""

    def __init__(self):
        from orcvio_tpu_torch.filter import update as filter_update

        self.module, self.seen = filter_update, {}
        self.fn = filter_update.cov_update

    def __enter__(self):
        def spy(P, K, H, HP=None, nb=None):
            key = (P.shape[0], K.shape[1])
            if key not in self.seen:
                self.seen[key] = tuple(x.detach().clone() for x in (
                    P, K, H, H @ P if HP is None else HP))
            return self.fn(P, K, H, HP, nb)

        self.module.cov_update = spy
        return self

    def __exit__(self, *exc):
        self.module.cov_update = self.fn


def allowed_object_reads():
    """OBJ_ALLOWED_READS as the file:line names find_syncs gives."""
    root = Path(__file__).resolve().parent
    out = set()
    for path, text in OBJ_ALLOWED_READS:
        lines = (root / path).read_text().splitlines()
        out |= {f"{Path(path).name}:{i + 1}"
                for i, line in enumerate(lines) if text in line}
    return out


def config_a_run(dev, use_update, frames):
    """run_object_mapping(WorldConfig(**OBJ_A_WORLD)) over `frames` frames
    in float64 on the card: the map's figures, the ATE, the updates, the launches, ms a frame
    and the K4 inputs it made. ms a frame is the host clock over the whole
    call over its frames and flush frames: the world's set-up, the scoring
    and the diagnostics hook's reads (some 10 a update) are in it; it runs
    in this process after phases 1-11, so cuBLAS and cuSOLVER are set up."""
    import torch

    from orcvio_tpu_torch.eval.object_map_sim import (WorldConfig,
                                                      run_object_mapping)

    torch.cuda.synchronize()
    launch_counts(reset=True)
    t0 = time.perf_counter()
    with K4Shapes() as shapes:
        res = run_object_mapping(WorldConfig(**{**OBJ_A_WORLD,
                                                "n_frames": frames}),
                                 use_object_update=use_update,
                                 dtype=torch.float64, device=dev,
                                 collect_diag=True)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    n = frames + 5  # and the flush frames (max_age + 2)
    return {"mean_iou": res["mean_iou"], "n_matched": res["n_matched"],
            "n_est": res["n_est"], "n_gt": res["n_gt"], "ate_m": res["ate_m"],
            "updates_tried": len(res["diag"]),
            "updates_applied": sum(d["used"] for d in res["diag"]),
            "launches": launch_counts(), "seconds": secs,
            "ms_per_frame": 1e3 * secs / n, "k4_shapes": sorted(shapes.seen),
            "pr": {f"{p}m/{r}deg": v for (p, r), v in res["pr"].items()},
            "finite": bool(np.isfinite(res["est_p"]).all())}, shapes.seen


def staged_objects_run(dev, frames):
    """bench.py:272-368's staged replay in float32 over `frames` frames of
    the 12-car world: a warm-up of OBJ_WARM_FRAMES frames, then one timed
    replay (CUDA events) split at OBJ_PROFILE_FROM, its map, ATE and K4
    launches. From the carries kept at the warm-up's end and at the split,
    OBJ_PROFILE_FRAMES frames without a finalization and as many around
    the first one are profiled (the device's activity only); the latter
    window runs once more with its host reads found and K4's inputs
    recorded, by (D, q), and so do the first OBJ_PROFILE_FRAMES frames
    (once-made constants are made by then, as in the other phases'
    windows)."""
    import torch

    from orcvio_tpu_torch.dataio.synthetic import generate
    from orcvio_tpu_torch.eval import object_map_sim as oms
    from orcvio_tpu_torch.filter.pipeline import FrameInput
    from orcvio_tpu_torch.objects.staged import (ObjectsStream,
                                                 make_objects_replay)
    from orcvio_tpu_torch.vio import VioState

    f32 = torch.float32
    wc = oms.WorldConfig(n_frames=frames)
    sim = oms.world_sim(wc)
    ocfg = oms.object_vio_config(wc)
    data = generate(sim, R_b2c=oms.R_B2C, t_c_b=oms.T_C_B, dtype=f32,
                    device=dev)
    dets = oms.detection_stream(wc, oms.make_world(wc), data.gt_R.cpu().numpy(),
                                data.gt_p.cpu().numpy(),
                                np.random.default_rng(wc.seed + 1))
    stream = ObjectsStream(*(torch.as_tensor(x).to(
        dev, f32 if x.dtype.kind == "f" else None) for x in dets))
    vs = VioState.create(ocfg.filter, sim.max_obs, f32, dev).replace(
        filter=oms.initial_filter_state(ocfg.filter, sim, f32, dev))
    replay = make_objects_replay(ocfg, sim.max_obs, map_capacity=32,
                                 dtype=f32, device=dev)
    frames_in = data.frames

    def part(a, b, carry=None):
        return replay(replay.init_carry(vs) if carry is None else carry,
                      FrameInput(*(x[a:b] for x in frames_in)),
                      ObjectsStream(*(x[a:b] for x in stream)))

    W, P, k0 = OBJ_WARM_FRAMES, OBJ_PROFILE_FRAMES, OBJ_PROFILE_FROM
    laps = [time.perf_counter()]
    carry_w = part(0, W)[0]
    torch.cuda.synchronize()
    laps.append(time.perf_counter())
    launch_counts(reset=True)
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    e0.record()
    carry_k0, outs0 = part(0, k0)
    carry, outs1 = part(k0, frames, carry_k0)
    e1.record()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    ms = e0.elapsed_time(e1) / frames
    launches = launch_counts()
    outs = {k: torch.cat([outs0[k], outs1[k]]) for k in outs0}
    est_p = outs["p"].double().cpu().numpy()
    gt_p = data.gt_p.double().cpu().numpy()
    ate = float(np.sqrt(np.mean(np.sum((est_p - gt_p) ** 2, axis=1))))
    n_map = outs["n_map"].cpu().numpy()
    k_fin = int(np.argmax(n_map > 0)) if (n_map > 0).any() else frames
    check(k0 < k_fin < k0 + P and W + P <= k0,
          f"objects staged: the profiled window, frames {k0}-{k0 + P - 1}, "
          f"holds the first finalization (frame {k_fin}), and the window "
          f"without one, frames {W}-{W + P - 1}, ends before it")
    window = lambda: part(k0, k0 + P, carry_k0)  # noqa: E731
    laps.append(time.perf_counter())
    prof = profile_frames(window, P, warm=False, cpu=False)
    laps.append(time.perf_counter())
    prof_plain = profile_frames(lambda: part(W, W + P, carry_w), P,
                                warm=False, cpu=False)
    laps.append(time.perf_counter())
    with K4Shapes() as shapes:  # the object update's K4 inputs
        syncs_fin = find_syncs(window)
    syncs_first = find_syncs(lambda: part(0, P))
    laps.append(time.perf_counter())
    seconds = dict(zip(("warm_up", "timed", "profile", "profile_plain",
                        "host_reads"), np.diff(laps).tolist()))
    return {"frames": frames, "ms_per_frame": ms, "fps": 1e3 / ms,
            "seconds": seconds,
            "host_s": host_s, "n_map": int(carry.omap.valid.sum()),
            "ate_m": ate, "finite": bool(np.isfinite(est_p).all()),
            "launches": launches, "first_insert_frame": k_fin,
            "profile_from_frame": k0, "profile": prof,
            "profile_without_finalize": prof_plain,
            "profile_without_finalize_from_frame": W,
            "host_reads_per_frame_with_finalize": len(syncs_fin) / P,
            "host_reads_with_finalize": sorted(set(syncs_fin)),
            "host_reads_per_frame_first": len(syncs_first) / P,
            "host_reads_first": sorted(set(syncs_first))}, shapes.seen


def objects_phase(dev, frames=OBJ_FRAMES):
    """Phase 12: config A on the host orchestrator with and without the
    object update, one run after the other, then the staged replay, then
    K4 at the object update's shape. Returns (report, the K4 entries for
    the kernels line)."""
    import torch

    D, q = OBJ_K4_SHAPE
    jx = JAX_OBJECTS
    runs, seconds = {}, {}
    for name in ("update", "no_update"):
        t0 = time.perf_counter()
        runs[name], seen = config_a_run(dev, name == "update",
                                        OBJ_A_WORLD["n_frames"])
        seconds[f"config_a_{name}"] = time.perf_counter() - t0
        if name == "update":
            config_a_k4 = seen.get((D, q))
    emit({"objects_config_a": runs})
    up, no = runs["update"], runs["no_update"]
    for name, r in runs.items():
        j = jx["config_a"][name]
        check(r["finite"] and r["n_matched"] == j["n_matched"]
              and r["n_est"] == j["n_est"] and r["n_gt"] == j["n_gt"],
              f"objects config A ({name}): matched {r['n_matched']}, "
              f"estimated {r['n_est']}, ground truth {r['n_gt']} == JAX's "
              f"{j['n_matched']}, {j['n_est']}, {j['n_gt']}")
        check(abs(r["mean_iou"] - j["mean_iou"]) <= OBJ_IOU_TOL,
              f"objects config A ({name}): mean IoU {r['mean_iou']:.4f} "
              f"within {OBJ_IOU_TOL} of JAX's {j['mean_iou']:.4f}")
        check(abs(r["ate_m"] - j["ate_m"]) <= OBJ_ATE_TOL_M,
              f"objects config A ({name}): ATE {r['ate_m']:.5f} m within "
              f"{OBJ_ATE_TOL_M} m of JAX's {j['ate_m']:.5f}")
    check(up["ate_m"] < no["ate_m"],
          f"objects config A: ATE with the object update {up['ate_m']:.5f} "
          f"m < without {no['ate_m']:.5f} m, as in JAX "
          f"({jx['config_a']['update']['ate_m']:.5f} < "
          f"{jx['config_a']['no_update']['ate_m']:.5f})")
    check(up["updates_applied"] >= 1 and up["launches"]["cov_update"] > 0
          and (D, q) in up["k4_shapes"],
          f"objects config A: {up['updates_applied']} object updates "
          f"applied of {up['updates_tried']} tried (JAX "
          f"{jx['config_a']['update']['updates_applied']}), K4 launched "
          f"{up['launches']['cov_update']} times, at (D, q) = {(D, q)} "
          f"among {up['k4_shapes']}")

    t0 = time.perf_counter()
    staged, staged_seen = staged_objects_run(dev, frames)
    seconds["staged"] = time.perf_counter() - t0
    emit({"objects_staged": staged})
    js = jx["staged_f32"]
    check(staged["finite"] and staged["n_map"] >= js["n_map"] - 1,
          f"objects staged float32: map {staged['n_map']} >= JAX's "
          f"{js['n_map']} - 1")
    check(staged["ate_m"] <= js["ate_m"] + OBJ_STAGED_ATE_TOL_M,
          f"objects staged float32: ATE {staged['ate_m']:.5f} m <= JAX's "
          f"{js['ate_m']:.5f} + {OBJ_STAGED_ATE_TOL_M}")
    check(staged["launches"]["cov_update"] > 0,
          f"objects staged: K4 launched {staged['launches']['cov_update']} "
          "times in the timed replay")
    allowed = allowed_object_reads()
    found = set(staged["host_reads_first"]) | set(
        staged["host_reads_with_finalize"])
    check(len(allowed) == len(OBJ_ALLOWED_READS) and found <= allowed,
          f"objects staged: host reads {sorted(found)} among those ROADMAP "
          f"section 3 item 21 allows, {sorted(allowed)}")

    # (a) K4 at the object update's shape: the inputs config A and the
    # staged replay gave it, and seeded ones in float32 and float64
    t0 = time.perf_counter()
    cases = [(f"objects {run} D={D} q={q} {dt}", *got[:3])
             for run, dt, got in (("config A", "float64", config_a_k4),
                                  ("staged", "float32",
                                   staged_seen.get((D, q))))
             if got is not None]
    check(len(cases) == 2, f"K4's inputs at {(D, q)} from config A and the "
                           f"staged replay: {len(cases)} of 2")
    for dtype in (torch.float32, torch.float64):
        cases.append((f"objects random D={D} q={q} {str(dtype)[6:]}",
                       *k4_inputs(D, q, D + q, dtype, dev)))
    k4_err, k4_ratio = k4_check(cases)
    times = {}
    for dtype in (torch.float32, torch.float64):
        t = k4_times(*k4_inputs(D, q, D + q, dtype, dev))
        times[str(dtype)[6:]] = {k: t[k] for k in (
            "kernel_ms", "library_ms", "addmm_ms", "bound_ms", "bound_by",
            "bytes", "ops", "kernel_call_ms")}
    seconds["k4"] = time.perf_counter() - t0
    report = {"frames": frames, "config_a_world": OBJ_A_WORLD,
              "config_a": runs, "staged": staged,
              "seconds": seconds,
              "k4": {"max_abs_err": k4_err,
                     "max_share_of_rounding_bound_f32": k4_ratio,
                     "times": times}}
    k4_entry = {"launches_objects_config_a": up["launches"]["cov_update"],
                "launches_objects_staged": staged["launches"]["cov_update"],
                "by_shape_objects": times,
                "max_abs_err_objects": k4_err}
    return report, k4_entry


def config_b_crops(det, n=CNN_CROPS):
    """n crops of config B's renders, cut and resized as the detector cuts
    them ((n, 3, S, S) on its device): the frames drawn with CNN_SEED
    among the first CNN_CROP_FRAMES that hold a box, rendered in order as
    run_cnn_object_mapping renders them."""
    import torch

    from orcvio_tpu_torch.dataio.synthetic import generate
    from orcvio_tpu_torch.eval import object_map_cnn as cb
    from orcvio_tpu_torch.eval.object_map_sim import make_world

    wc = cb.world_config()
    objs = make_world(wc)
    data = generate(cb.world_sim(wc), R_b2c=cb.R_B2C, t_c_b=cb.T_C_B,
                    dtype=torch.float64, device="cpu")
    gt_R, gt_p = data.gt_R.numpy(), data.gt_p.numpy()
    rng = np.random.default_rng(5)
    seen = []
    for k in range(CNN_CROP_FRAMES):
        img, boxes = cb.render_frame(wc, objs,
                                     cb.camera_pose(gt_R[k], gt_p[k]), rng)
        if len(boxes):
            seen.append((k, img, boxes[0]))
    pick = np.sort(np.random.default_rng(CNN_SEED).choice(
        len(seen), n, replace=False))
    crops = [det.crop(seen[i][1], seen[i][2])[0] for i in pick]
    S = det.size
    return torch.stack(crops)[:, None].expand(n, 3, S, S).contiguous(), \
        [seen[i][0] for i in pick]


def starmap_check(dev):
    """Phase 13 (a): the detector's construction turns TF32 off; the
    network at the shipped widths in float32 on the card against the same
    network in float64 on the CPU, on config B's crops: heat within
    CNN_HEAT_TOL, the found masks and valid peaks equal, the peaks within
    CNN_PEAK_TOL_PX heatmap px wherever no other peak's score lies within
    CNN_TIE."""
    import torch

    from orcvio_tpu_torch.dataio.render_object import CAR_KEYPOINTS
    from orcvio_tpu_torch.eval import object_map_cnn as cb
    from orcvio_tpu_torch.models.starmap import (detect_keypoints,
                                                 load_pretrained)
    from orcvio_tpu_torch.objects.detector import StarMapKeypointDetector

    torch.backends.cudnn.allow_tf32 = True
    det = StarMapKeypointDetector(CAR_KEYPOINTS, cb.camera_K(), device=dev)
    tf32_off = not torch.backends.cudnn.allow_tf32
    check(tf32_off, "phase 13: constructing the detector turned cuDNN's "
                    "TF32 off (set on before)")
    crops, frames = config_b_crops(det)
    ref, _ = load_pretrained(device="cpu", dtype=torch.float64)
    x64 = crops.double().cpu()
    canon = torch.as_tensor(CAR_KEYPOINTS)
    with torch.no_grad():
        heat = torch.sigmoid(det.model(crops)[-1][:, 0]).double().cpu()
        heat_ref = torch.sigmoid(ref(x64)[-1][:, 0])
    got = detect_keypoints(det.model, crops, canon.to(dev, torch.float32))
    want = detect_keypoints(ref, x64, canon.double())
    got = {k: v.cpu() for k, v in got.items()}
    heat_err = float((heat - heat_ref).abs().max())
    same_found = bool(torch.equal(got["found"], want["found"]))
    same_valid = bool(torch.equal(got["peaks_valid"], want["peaks_valid"]))
    s = want["peaks_score"]
    gap = (s[:, :, None] - s[:, None, :]).abs() + 9 * torch.eye(s.shape[1])
    clear = want["peaks_valid"] & (gap.amin(-1) > CNN_TIE)
    err = (got["peaks_xy"].double() - want["peaks_xy"]).norm(dim=-1)
    peak_err = float(err[clear].max()) if bool(clear.any()) else None
    check(heat_err <= CNN_HEAT_TOL and same_found and same_valid,
          f"phase 13: StarMap float32 on the card against float64 on the "
          f"CPU, {CNN_CROPS} crops of config B (frames {frames}): heat "
          f"within {heat_err:.2e} <= {CNN_HEAT_TOL}, found masks "
          f"{'equal' if same_found else 'differ'}, valid peaks "
          f"{'equal' if same_valid else 'differ'}")
    check(peak_err is not None and peak_err <= CNN_PEAK_TOL_PX,
          f"phase 13: {int(clear.sum())} untied peaks within {peak_err} <= "
          f"{CNN_PEAK_TOL_PX} heatmap px of the float64 CPU run")
    return {"tf32_off": tf32_off, "crop_frames": frames,
            "heat_max_abs_err": heat_err, "found_equal": same_found,
            "peaks_valid_equal": same_valid,
            "untied_peaks": int(clear.sum()),
            "peak_max_err_px": peak_err,
            "found_per_crop": got["found"].sum(-1).tolist()}


def config_b_run(dev):
    """Phase 13 (b): run_cnn_object_mapping over config B's 260 frames on
    the card, the filter in float64: the map's figures against the JAX
    package's, the finalizations and updates, K4's launches and shapes,
    ms a frame (host clock) split into render, detector and the rest of
    the step. Returns (report, K4's inputs at the object update's
    shape)."""
    import torch

    from orcvio_tpu_torch.eval.object_map_cnn import run_cnn_object_mapping

    torch.cuda.synchronize()
    launch_counts(reset=True)
    with K4Shapes() as shapes:
        res = run_cnn_object_mapping(device=dev)
    launches = launch_counts()
    report = {
        "mean_iou": res["mean_iou"], "n_matched": res["n_matched"],
        "n_est": res["n_est"], "n_gt": res["n_gt"],
        "finalizations": len(res["finalizations"]),
        "finalized_ok": sum(f["ok"] for f in res["finalizations"]),
        "updates_tried": res["updates_tried"],
        "updates_applied": res["updates_applied"],
        "seconds": res["seconds"], "ms_per_frame": res["ms_per_frame"],
        "ms_per_frame_split": {k: 1e3 * v / res["n_steps"] for k, v in
                               res["seconds_split"].items()},
        "launches": launches, "k4_shapes": sorted(shapes.seen)}
    jb = JAX_OBJECTS["config_b"]
    check(all(report[k] == jb[k] for k in ("n_matched", "n_est", "n_gt")),
          f"phase 13: config B matched {report['n_matched']}, estimated "
          f"{report['n_est']}, ground truth {report['n_gt']} == JAX's "
          f"{jb['n_matched']}, {jb['n_est']}, {jb['n_gt']}")
    check(abs(report["mean_iou"] - jb["mean_iou"]) <= CNN_IOU_TOL,
          f"phase 13: config B mean IoU {report['mean_iou']:.4f} within "
          f"{CNN_IOU_TOL} of JAX's {jb['mean_iou']:.4f}")
    check(launches["cov_update"] > 0 and OBJ_K4_SHAPE in shapes.seen,
          f"phase 13: K4 launched {launches['cov_update']} times in config "
          f"B, at (D, q) = {OBJ_K4_SHAPE} among {sorted(shapes.seen)} "
          f"({report['updates_tried']} object updates tried, "
          f"{report['updates_applied']} applied; JAX {jb['updates_tried']}, "
          f"{jb['updates_applied']})")
    return report, shapes.seen.get(OBJ_K4_SHAPE)


def image_objects_phase(dev):
    """Phase 13: the image path of the objects. (a) StarMap on the card
    against its float64 CPU run, (b) config B over 260 frames, (c) the
    port's starmap_bench (bench.py:371-393's StarMap figure): ms a frame
    at M = 4 crops a frame and crops/s from CUDA events, kernels a crop;
    then K4 against its plain version on the inputs config B gave it.
    Returns (report, the K4 entries for the kernels line)."""
    from orcvio_tpu_torch.scripts import starmap_bench

    seconds, t0 = {}, time.perf_counter()
    net = starmap_check(dev)
    seconds["network"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cfg_b, k4_in = config_b_run(dev)
    seconds["config_b"] = time.perf_counter() - t0
    emit({"objects_config_b": cfg_b})
    t0 = time.perf_counter()
    bench = starmap_bench.run(dev)
    seconds["starmap_bench"] = time.perf_counter() - t0
    check(bench["finite"] and bench["kernels_per_crop"] is not None,
          f"phase 13: starmap_bench {bench['ms_per_frame']:.3f} ms a frame "
          f"of {bench['boxes_per_frame']} crops, "
          f"{bench['crops_per_sec']:.1f} crops/s, "
          f"{bench['kernels_per_crop']} kernels a crop")
    D, q = OBJ_K4_SHAPE
    k4_err = {}
    if k4_in is not None:
        k4_err, _ = k4_check([(f"objects config B D={D} q={q} float64",
                               *k4_in[:3])])
    report = {"network": net, "config_b": cfg_b, "starmap_bench": bench,
              "seconds": seconds}
    return report, {"launches_objects_config_b": cfg_b["launches"][
        "cov_update"], "max_abs_err_objects_config_b": k4_err}


def sp_syncs(run):
    """(run(), the host synchronisations inside the blocks' frames, those
    elsewhere) for run() a seq_parallel_replay call, each as file:line,
    under torch's sync debug mode: temporal.make_block_replay's replay is
    wrapped to tell its reads from those of the starts, the stitch and
    the covariance correction."""
    import torch

    from orcvio_tpu_torch.parallel import temporal

    make = temporal.make_block_replay
    in_blocks = []

    def wrapped(*a, **kw):
        replay = make(*a, **kw)

        def inner(starts, fb):
            n0 = len(caught)
            out = replay(starts, fb)
            in_blocks.extend(caught[n0:])
            return out

        return inner

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        temporal.make_block_replay = wrapped
        torch.cuda.set_sync_debug_mode("warn")
        try:
            res = run()
        finally:
            torch.cuda.set_sync_debug_mode("default")
            temporal.make_block_replay = make

    def where(ws):
        return [f"{Path(w.filename).name}:{w.lineno}" for w in ws
                if "called a synchronizing" in str(w.message)]

    inside = {id(w) for w in in_blocks}
    return res, where(in_blocks), where([w for w in caught
                                         if id(w) not in inside])


def sp_world(dev, cfg_kw, sim_kw):
    import torch

    from orcvio_tpu_torch.config.core import FilterConfig
    from orcvio_tpu_torch.dataio.synthetic import (SimConfig, generate,
                                                   initialized_run)

    cfg, sim = FilterConfig(**cfg_kw), SimConfig(**sim_kw)
    st, frames, chi2 = initialized_run(cfg, sim, torch.float64, dev)
    gt_p = generate(sim, dtype=torch.float64, device="cpu").gt_p.numpy()
    return cfg, st, frames, chi2, gt_p


def sp_bands(p_s, p_p, gt_p):
    """tests/test_temporal.py:99-102's figures: both RMSEs to the ground
    truth, the band 1.3 RMSE_serial + 0.02 m, and the parallel run's mean
    distance to the serial one against max(RMSE_serial, 0.05 m)."""
    rmse = [float(np.sqrt(((p - gt_p) ** 2).sum(1).mean())) for p in (p_s, p_p)]
    gap = float(np.linalg.norm(p_p - p_s, axis=1).mean())
    return {"rmse_serial_m": rmse[0], "rmse_parallel_m": rmse[1],
            "rmse_band_m": 1.3 * rmse[0] + 0.02, "mean_gap_m": gap,
            "gap_limit_m": max(rmse[0], 0.05),
            "in_band": rmse[1] <= 1.3 * rmse[0] + 0.02
            and gap < max(rmse[0], 0.05)}


def sequence_parallel_full(dev):
    """Phase 14 (a): SP_SIM in float64, serial (run_sequence) and as
    SP_BLOCKS blocks at n_iters SP_ITERS, each timed once on the host
    clock after a short warm-up: finite, the per-frame update counts and
    end positions of both against the JAX package's (JAX_TEMPORAL), K4's
    launches a batched block frame against a serial frame's, no host read
    inside the blocks' frames, and the speedup. The band of
    tests/test_temporal.py is recorded here (the JAX package's own run of
    this world lies outside it) and held in (b)."""
    import torch

    from orcvio_tpu_torch.filter.pipeline import FrameInput, run_sequence
    from orcvio_tpu_torch.parallel.temporal import seq_parallel_replay

    cfg, st, frames, chi2, gt_p = sp_world(dev, SP_CFG, SP_SIM)
    warm = FrameInput(*(x[:2 * SP_BLOCKS] for x in frames))
    run_sequence(cfg, st, warm, chi2)
    seq_parallel_replay(cfg, st, warm, chi2, n_blocks=SP_BLOCKS, n_iters=1)
    torch.cuda.synchronize()

    T = frames.t.shape[0]
    launch_counts(reset=True)
    t0 = time.perf_counter()
    end_s, outs_s = run_sequence(cfg, st, frames, chi2)
    torch.cuda.synchronize()
    serial_s = time.perf_counter() - t0
    k4_serial = launch_counts()["cov_update"]

    launch_counts(reset=True)
    t0 = time.perf_counter()
    (end_p, outs_p), inside, outside = sp_syncs(
        lambda: seq_parallel_replay(cfg, st, frames, chi2,
                                    n_blocks=SP_BLOCKS, n_iters=SP_ITERS))
    torch.cuda.synchronize()
    parallel_s = time.perf_counter() - t0
    k4_par = launch_counts()["cov_update"]
    block_frames = SP_ITERS * (T // SP_BLOCKS)

    p_s, p_p = outs_s.p.cpu().numpy(), outs_p["p"].cpu().numpy()
    finite = bool(np.isfinite(p_s).all() and np.isfinite(p_p).all()
                  and torch.isfinite(end_s.P).all()
                  and torch.isfinite(end_p.P).all())
    check(finite, f"sequence parallel: serial and {SP_BLOCKS}-block runs of "
                  f"{T} frames finite")
    bands = sp_bands(p_s, p_p, gt_p)
    upd = {"serial": outs_s.n_update_features.cpu().numpy().tolist(),
           "parallel": outs_p["n_update_features"].cpu().numpy().tolist()}
    ends = {"serial": end_s.imu.p.cpu().numpy(),
            "parallel": end_p.imu.p.cpu().numpy()}
    vs_jax = {}
    for run in ("serial", "parallel"):
        jax_run = JAX_TEMPORAL[run]
        diff = [k for k, (a, b) in enumerate(zip(upd[run],
                                                  jax_run["n_update"]))
                if a != b]
        end_err = float(np.abs(ends[run] - jax_run["end_p"]).max())
        vs_jax[run] = {"update_frames_differing": len(diff),
                       "first_differing": diff[:5], "end_p_err_m": end_err,
                       "rmse_jax_m": jax_run["rmse_m"]}
        check(not diff and len(upd[run]) == len(jax_run["n_update"]),
              f"sequence parallel: {run} update counts on all {T} frames "
              f"equal to the JAX package's ({len(diff)} differ: {diff[:5]})")
        check(end_err < SP_END_TOL_M,
              f"sequence parallel: {run} end position within "
              f"{SP_END_TOL_M} m of the JAX package's ({end_err:.2e})")
    check(k4_par * T == k4_serial * block_frames and k4_serial > 0,
          f"sequence parallel: K4 {k4_par / block_frames:.2f} launches a "
          f"batched block frame == {k4_serial / T:.2f} a serial frame")
    check(not inside, f"sequence parallel: no host read inside the blocks' "
                      f"frames ({len(inside)}: {sorted(set(inside))[:5]})")
    return {"frames": T, "blocks": SP_BLOCKS, "n_iters": SP_ITERS,
            "serial_s": serial_s, "parallel_s": parallel_s,
            "speedup": serial_s / parallel_s,
            "ms_per_frame_serial": serial_s * 1e3 / T,
            "ms_per_batched_frame": parallel_s * 1e3 / block_frames,
            **bands, "jax_mean_gap_m": JAX_TEMPORAL["parallel"].get(
                "mean_gap_m"),
            "vs_jax": vs_jax, "k4_launches": k4_par,
            "k4_launches_serial": k4_serial,
            "host_reads_in_blocks": inside,
            "host_reads_outside_blocks": len(outside),
            "host_reads_outside_where": sorted(set(outside))}


def sequence_parallel_small(dev):
    """Phase 14 (b): tests/test_temporal.py's world (sw 10, 80 features, 120
    frames) in float64: n_iters = K within SP_EXACT_TOL of the serial
    replay (p on every frame, the end state's P), update counts equal;
    and n_iters = 2 within tests/test_temporal.py's band."""
    import torch

    from orcvio_tpu_torch.filter.pipeline import run_sequence
    from orcvio_tpu_torch.parallel.temporal import seq_parallel_replay

    cfg, st, frames, chi2, gt_p = sp_world(dev, SP_SMALL_CFG, SP_SMALL_SIM)
    end_s, outs_s = run_sequence(cfg, st, frames, chi2)
    end_k, outs_k = seq_parallel_replay(cfg, st, frames, chi2,
                                        n_blocks=SP_BLOCKS,
                                        n_iters=SP_BLOCKS)
    _, outs_2 = seq_parallel_replay(cfg, st, frames, chi2, n_blocks=SP_BLOCKS,
                                    n_iters=SP_ITERS)
    p_err = float((outs_k["p"] - outs_s.p).abs().max())
    P_err = float((end_k.P - end_s.P).abs().max())
    same_upd = bool(torch.equal(outs_k["n_update_features"],
                                outs_s.n_update_features))
    check(p_err < SP_EXACT_TOL and P_err < SP_EXACT_TOL and same_upd,
          f"sequence parallel: n_iters = K against the serial replay, p "
          f"{p_err:.2e}, P {P_err:.2e} < {SP_EXACT_TOL}, update counts "
          f"{'equal' if same_upd else 'differ'}")
    bands = sp_bands(outs_s.p.cpu().numpy(), outs_2["p"].cpu().numpy(), gt_p)
    check(bands["in_band"],
          f"sequence parallel: n_iters = {SP_ITERS} RMSE "
          f"{bands['rmse_parallel_m']:.4f} <= {bands['rmse_band_m']:.4f} m "
          f"and mean gap {bands['mean_gap_m']:.4f} < "
          f"{bands['gap_limit_m']:.4f} m (tests/test_temporal.py's band)")
    return {"frames": int(frames.t.shape[0]), "p_err_m": p_err,
            "P_err": P_err, "updates_equal": same_upd,
            "n_update_total": int(outs_s.n_update_features.sum()),
            "band_n_iters_2": bands}


def fp_inputs(dev, F=FP_CAPACITY, seed=6):
    """tests/test_parallel.py's feature-parallel case in the port, float64:
    five clones observing F seeded landmarks; (cfg, state, tracks,
    positions, use mask)."""
    import torch

    from orcvio_tpu_torch.config.core import FilterConfig
    from orcvio_tpu_torch.filter import features as feat
    from orcvio_tpu_torch.filter.augment import cam_poses, state_augmentation
    from orcvio_tpu_torch.filter.state import FilterState
    from orcvio_tpu_torch.filter.tracks import compact_tracks
    from orcvio_tpu_torch.filter.triangulation import triangulate
    from orcvio_tpu_torch.math import so3

    f64 = torch.float64
    rng = np.random.default_rng(seed)
    cfg = FilterConfig(sw_size=6, max_features=F, max_track_len=4,
                       observation_noise=0.004, tri_translation_threshold=-1.0)
    st = FilterState.create(cfg, f64, device=dev)
    lm = rng.normal(size=(F, 3)) * 2 + [0, 0, 8]
    ids = torch.arange(F, dtype=torch.int32, device=dev)
    for i in range(5):
        R = so3.exp(torch.as_tensor(rng.normal(size=3) * 0.05, device=dev))
        p = torch.tensor([0.4 * i, 0.05 * i, 0.0], dtype=f64, device=dev)
        imu = st.imu.replace(R=R, p=p)
        st = st.replace(imu=imu, imu_fej_now=imu,
                        t=torch.tensor(float(i), dtype=f64, device=dev))
        st = state_augmentation(cfg, st)
        R_c2w, t_c_w = cam_poses(st)
        pc = (lm - t_c_w[i].cpu().numpy()) @ R_c2w[i].cpu().numpy()
        uv = torch.as_tensor(pc[:, :2] / pc[:, 2:3]
                             + rng.normal(size=(F, 2)) * 1e-3, device=dev)
        tb, _ = feat.add_observations(
            st.features, torch.tensor(i, device=dev), ids, uv, uv * 0,
            torch.ones(F, dtype=torch.bool, device=dev))
        st = st.replace(features=tb)
    st = st.replace(P=torch.eye(cfg.state_dim, dtype=f64, device=dev) * 1e-2)
    ct = compact_tracks(st.features, st.clones.order, cfg.max_track_len)
    R_c2w, t_c_w = cam_poses(st)
    tri = triangulate(cfg, ct, R_c2w, t_c_w)
    return cfg, st, ct, tri.p_world, tri.valid & (2 * ct.n_obs > 3)


def feature_parallel_check(dev):
    """Phase 14 (c): the 8-shard update at capacity 21 against one
    information_update on the same inputs, on the card."""
    from orcvio_tpu_torch.filter.update import (feature_jacobians,
                                                information_update)
    from orcvio_tpu_torch.parallel.feature_parallel import (
        feature_parallel_update, information_from_jacobians)

    cfg, st, ct, p_w, use = fp_inputs(dev)
    st_c, dx_c = feature_parallel_update(cfg, n_shards=FP_SHARDS)(
        st, ct, p_w, use)
    fj = feature_jacobians(cfg, st, ct, p_w)
    st_b, dx_b = information_update(cfg, st,
                                    *information_from_jacobians(fj, use))
    errs = {"dx": float((dx_c - dx_b).abs().max()),
            "P": float((st_c.P - st_b.P).abs().max()),
            "p": float((st_c.imu.p - st_b.imu.p).abs().max())}
    n_use = int(use.sum())
    check(max(errs.values()) < FP_TOL and n_use > 8,
          f"feature parallel: {FP_SHARDS} shards of capacity "
          f"{FP_CAPACITY} ({n_use} features used) against one "
          f"information_update, max err {max(errs.values()):.2e} < {FP_TOL}")
    return {"capacity": FP_CAPACITY, "shards": FP_SHARDS, "used": n_use,
            "max_abs_err": errs}


def scaling_check(dev):
    """Phase 14 (d): eval.scaling.measure([1]) on the card at
    SCALING_FRAMES frames, SCALING_REPS timed passes."""
    from orcvio_tpu_torch.eval import scaling

    out = scaling.measure([1], seqs_per_device=2, n_frames=SCALING_FRAMES,
                          reps=SCALING_REPS, dtype="float32", device=dev)
    row = out["weak_scaling"][0]
    check(row["finite"] and row["fps"] > 0
          and row["hot_loop_collectives"] == 0,
          f"scaling: measure([1]) {row['fps']:.1f} frames/s, "
          f"{row['hot_loop_collectives']} collectives in the timed loop")
    return out


def equalize_check(dev, seq):
    """Phase 14 (e): CLAHE and the pwl equalization over EQ_FRAMES frames of
    phase 2's known-flow stream on the card: the equalized frames against
    the CPU's (within EQ_IMG_TOL gray levels; the frames hold integer gray
    levels, so every pixel falls in the same histogram bin on both
    devices and no pixel sits on a bin edge); then the tracker at the
    bench configuration, with equalize "clahe" (as the JAX package's
    TrackerConfig) and, for pwl, with equalize off on the card's own pwl
    frames rounded to gray levels (the tracker, as the JAX package's,
    knows no pwl mode): K1 once and K2 four times a frame, the flow error,
    and the first EQ_CPU_FRAMES frames' tracks against the CPU's plain
    path with the same RANSAC draws (phase 2's small-stream
    tolerances)."""
    import torch

    from orcvio_tpu_torch.eval.staged import make_tracker_scan, stage_sequence
    from orcvio_tpu_torch.frontend.image import clahe, equalize_hist
    from orcvio_tpu_torch.frontend.tracker import TrackerConfig, TrackerState

    f32, cpu = torch.float32, torch.device("cpu")
    tc0 = TrackerConfig(**TRACKER)
    part = tuple(x[:EQ_FRAMES] for x in seq)
    gumbel = np.random.default_rng(3).gumbel(
        size=(EQ_FRAMES, 128, 8, tc0.capacity))
    equalize = {"clahe": clahe,
                "pwl": lambda v: equalize_hist(v, mode="pwl")}
    report = {}
    for mode in ("clahe", "pwl"):
        img_err, eq_frames = 0.0, {dev: [], cpu: []}
        for k in range(EQ_FRAMES):
            eq = {d: equalize[mode](torch.as_tensor(
                part[0][k], device=d).to(f32)) for d in (dev, cpu)}
            img_err = max(img_err,
                          float((eq[dev].cpu() - eq[cpu]).abs().max()))
            for d, v in eq.items():
                eq_frames[d].append(v.round().to(torch.uint8).cpu().numpy())
        check(img_err < EQ_IMG_TOL,
              f"equalize {mode}: {EQ_FRAMES} card frames within "
              f"{img_err:.2e} < {EQ_IMG_TOL} gray of the CPU's")

        if mode == "clahe":
            tc, images = tc0._replace(equalize="clahe"), {dev: part[0],
                                                          cpu: part[0]}
        else:
            tc = tc0._replace(equalize=False)
            images = {d: np.stack(v) for d, v in eq_frames.items()}
        res = {}
        for name, d, n in (("card", dev, EQ_FRAMES),
                           ("cpu", cpu, EQ_CPU_FRAMES)):
            if name == "card":
                launch_counts(reset=True)
            _, fr = make_tracker_scan(tc, np.eye(3), f32, device=d)(
                TrackerState.create(tc, f32, device=d),
                stage_sequence(images[d][:n], *(x[:n] for x in part[1:]),
                               f32, device=d),
                ransac_gumbel=torch.as_tensor(gumbel[:n], dtype=f32,
                                              device=d))
            if name == "card":
                launches = launch_counts()
                counts, flow = tracked_flow(fr, tc.K)
            res[name] = (fr.fids.cpu().numpy(), fr.uvs.cpu().numpy())
        check(launches["window_gather"] == EQ_FRAMES
              and launches["lk_level"] == 4 * EQ_FRAMES,
              f"equalize {mode}: K1 {launches['window_gather']} == "
              f"{EQ_FRAMES}, K2 {launches['lk_level']} == {4 * EQ_FRAMES}")
        flow_err = float(np.median(np.linalg.norm(flow - np.asarray(SHIFT),
                                                  axis=1)))
        check(float(np.median(counts)) >= 100 and flow_err < 0.1,
              f"equalize {mode}: median tracked {np.median(counts)} >= 100, "
              f"median flow error {flow_err:.4f} px < 0.1")
        card = tuple(a[:EQ_CPU_FRAMES] for a in res["card"])
        same = card[0] == res["cpu"][0]
        uv_err, n_apart = same_track_uv_err(card, res["cpu"], tc.K)
        check(same.mean() >= 0.95 and uv_err.size > 0
              and uv_err.max() < 0.05,
              f"equalize {mode}: {EQ_CPU_FRAMES} frames against the CPU's "
              f"plain path, fids equal on {same.mean():.3f} >= 0.95 of rows, "
              f"max uv diff {uv_err.max() if uv_err.size else None} px "
              f"< 0.05 ({n_apart} tracks began apart)")
        report[mode] = {"img_max_abs_err": img_err,
                        "tracker_equalize": tc.equalize,
                        "launches": launches,
                        "tracked_median": float(np.median(counts)),
                        "flow_err_median_px": flow_err,
                        "cpu_frames": EQ_CPU_FRAMES,
                        "fids_equal_share": float(same.mean()),
                        "uv_max_diff_px": float(uv_err.max())
                        if uv_err.size else None}
    return report


def checkpoint_check(dev):
    """Phase 14 (f): a card FilterState (tests/test_parallel.py's case)
    saved and restored bit for bit, on the card."""
    import torch

    from orcvio_tpu_torch.filter.state import FilterState
    from orcvio_tpu_torch.tree import tree_map
    from orcvio_tpu_torch.utils.checkpoint import restore_state, save_state

    cfg, st, _, _, _ = fp_inputs(dev)
    with tempfile.TemporaryDirectory() as tmp:
        save_state(tmp, st, step=5)
        back = restore_state(tmp, FilterState.create(
            cfg, torch.float64, device=dev), step=5)
    same = []
    tree_map(lambda a, b: same.append(
        torch.equal(a, b) and a.dtype == b.dtype and b.is_cuda), st, back)
    check(all(same), f"checkpoint: a card FilterState restored bit for bit "
                     f"({sum(same)} of {len(same)} leaves)")
    return {"leaves": len(same), "equal": sum(same)}


def batch_eval_check(dev):
    """Phase 14 (g): run_synthetic_batch_vmap against run_synthetic_case
    for seeds 3 and 4 (tests/test_parallel.py::TestVmapBatchEval's filter,
    its world cut to 20 frames, float64): update counts equal, RMSE within
    1e-6 m."""
    import torch

    from orcvio_tpu_torch.config.core import FilterConfig
    from orcvio_tpu_torch.dataio.synthetic import SimConfig
    from orcvio_tpu_torch.eval.batch import (run_synthetic_batch_vmap,
                                             run_synthetic_case)

    cfg = FilterConfig(**BATCH_EVAL_CFG)
    sims = [SimConfig(**BATCH_EVAL_SIM, seed=s) for s in BATCH_EVAL_SEEDS]
    batched = run_synthetic_batch_vmap(cfg, sims, torch.float64, dev)
    rows = []
    for sim, got in zip(sims, batched):
        ref = run_synthetic_case(cfg, sim, torch.float64, dev)
        err = abs(got["rmse_pos_m"] - ref["rmse_pos_m"])
        check(got["updates"] == ref["updates"] and err < 1e-6
              and got["rmse_pos_m"] < 0.3,
              f"batch eval: seed {sim.seed} vmapped against alone, updates "
              f"{got['updates']} == {ref['updates']}, RMSE "
              f"{got['rmse_pos_m']:.5f} m within {err:.1e} < 1e-6")
        rows.append({"seed": sim.seed, "vmap": got, "alone": ref})
    return rows


def scale_out_phase(dev, seq):
    """Phase 14: (a) the sequence-parallel replay at full width, (b) at
    n_iters = K and in tests/test_temporal.py's band, (c) the
    feature-parallel update, (d) the scaling harness, (e) CLAHE and the
    pwl equalization, each under the tracker, (f) a checkpoint round
    trip, (g) the batch evaluator. Returns the report (seconds by part)."""
    report, seconds = {}, {}
    for name, part in (
            ("sequence_parallel", lambda: sequence_parallel_full(dev)),
            ("sequence_parallel_k", lambda: sequence_parallel_small(dev)),
            ("feature_parallel", lambda: feature_parallel_check(dev)),
            ("scaling", lambda: scaling_check(dev)),
            ("equalize", lambda: equalize_check(dev, seq)),
            ("checkpoint", lambda: checkpoint_check(dev)),
            ("batch_eval", lambda: batch_eval_check(dev))):
        t0 = time.perf_counter()
        report[name] = part()
        seconds[name] = time.perf_counter() - t0
    report["seconds"] = seconds
    return report


def main() -> int:
    t_lap, laps = [time.perf_counter()], {}

    def lap(name):
        """Seconds since the previous lap, kept under `name`."""
        now = time.perf_counter()
        laps[name] = now - t_lap[0]
        t_lap[0] = now

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    try:
        from orcvio_tpu_torch import no_tf32
        from orcvio_tpu_torch.config.core import FilterConfig
        from orcvio_tpu_torch.dataio import synthetic as syn
        from orcvio_tpu_torch.dataio.euroc_writer import (
            R_B2C_DOWN, WriterConfig, make_stream)
        from orcvio_tpu_torch.eval.staged import (
            make_e2e_replay, make_tracker_scan, stage_sequence)
        from orcvio_tpu_torch.eval.trajectory import ate
        from orcvio_tpu_torch.filter import update as filter_update
        from orcvio_tpu_torch.frontend import klt
        from orcvio_tpu_torch.frontend.detect import detect_grid
        from orcvio_tpu_torch.frontend.image import (
            build_pyramid, equalize_hist)
        from orcvio_tpu_torch.frontend.tracker import (
            TrackerConfig, TrackerState)
        from orcvio_tpu_torch.math import quat
        from orcvio_tpu_torch.ops import _build
        from orcvio_tpu_torch.ops.cov_update import (
            cov_update, cov_update_plain)
        from orcvio_tpu_torch.ops.dma_gather import (
            BL, BR, dma_gather_tiles, dma_gather_tiles_plain)
        from orcvio_tpu_torch.ops.lk_pallas import (
            lk_iterate_fused, lk_iterate_fused_plain, lk_iterate_src,
            lk_level_fused, lk_level_fused_plain, lk_level_src)
        from orcvio_tpu_torch.ops.window_gather import window_origins
        from orcvio_tpu_torch.scripts import race_extract as race
        from orcvio_tpu_torch.vio import VioState
    except ImportError as e:
        print(f"chip_smoke: the port's package is missing: {e}",
              file=sys.stderr)
        return 1

    lap("0 imports")
    # ---------------- 1. set-up ----------------
    gpu = gpu_line()
    print(gpu, flush=True)
    no_tf32()
    dev = torch.device(DEVICE)
    t0 = time.perf_counter()
    report = _build.build(_build.SOURCES)
    emit({"build": {"seconds": round(time.perf_counter() - t0, 3),
                    "sources": sorted(report)}})
    # the compiler's report of this run's builds: build() gives none for a
    # library it found already built
    ptxas = {src: ptxas_usage(r["log"]) for src, r in report.items()}
    emit({"ptxas": ptxas})

    lap("1 set-up")
    # ---------------- 2. the main path ----------------
    tc = TrackerConfig(**TRACKER)
    seq = synthetic_stream(T_FRAMES + 1, tc.height, tc.width, SHIFT)
    main_seq = tuple(x[:T_FRAMES] for x in seq)
    staged = stage_sequence(*main_seq, torch.float32, device=dev)
    R_b2c = np.eye(3)
    scan = make_tracker_scan(tc, R_b2c, torch.float32, device=dev)
    ts0 = TrackerState.create(tc, torch.float32, seed=0, device=dev)
    torch.cuda.synchronize()

    dma_gather_tiles.launches = 0
    lk_level_fused.launches = 0
    t0 = time.perf_counter()
    ts, frames = scan(ts0, staged)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {"window_gather": dma_gather_tiles.launches,
                "lk_level": lk_level_fused.launches}

    T = T_FRAMES
    # per frame: K2 reads the levels in place, so K1 cuts only ORB's
    # windows; 3 forward levels + 1 level-0 backward LK pass
    check(launches["window_gather"] == T,
          f"K1 launches {launches['window_gather']} == 1*T = {T}")
    check(launches["lk_level"] == 4 * T,
          f"K2 launches {launches['lk_level']} == 4*T = {4 * T}")
    uvs = frames.uvs
    check(tuple(uvs.shape) == (T, 200, 2) and bool(torch.isfinite(uvs).all())
          and bool(torch.isfinite(frames.uv_vels).all()),
          "outputs finite, uvs (T, 200, 2)")
    check(bool((frames.meas_mask == (frames.fids >= 0)).all()),
          "meas_mask == fids >= 0")
    counts, flow = tracked_flow(frames, tc.K)
    flow_err = np.linalg.norm(flow - np.asarray(SHIFT), axis=1)
    med_tracked = float(np.median(counts))
    med_err = float(np.median(flow_err))
    check(med_tracked >= 100, f"median tracked features {med_tracked} >= 100")
    check(med_err < 0.1, f"median flow error {med_err:.4f} px < 0.1")
    emit({"main_path": {"frames": T, "first_run_s": first_s,
                        "launches": launches,
                        "tracked_median": med_tracked,
                        "tracked_min": int(counts.min()),
                        "flow_err_median_px": med_err,
                        "flow_err_p90_px": float(np.quantile(flow_err, 0.9)),
                        "next_id": int(ts.next_id)}})

    # the frame loop waits for the card nowhere (caches are warm after the
    # first run, so any sync here would be one per frame)
    part = type(staged)(*(x[:20] for x in staged))
    check_no_syncs(lambda: scan(ts0, part), "a 20-frame scan")

    # small stream: card (kernels) against CPU (plain versions), same draws
    stc = tc._replace(height=120, width=160, pyramid_levels=2, capacity=32,
                      grid_rows=4, grid_cols=4)
    small = synthetic_stream(6, stc.height, stc.width, (2.1, -1.4), seed=1)
    gumbel = np.random.default_rng(2).gumbel(size=(6, 128, 8, 32))
    res = {}
    for name, d in (("cuda", dev), ("cpu", torch.device("cpu"))):
        _, fr = make_tracker_scan(stc, R_b2c, torch.float32, device=d)(
            TrackerState.create(stc, torch.float32, device=d),
            stage_sequence(*small, torch.float32, device=d),
            ransac_gumbel=torch.as_tensor(gumbel, dtype=torch.float32,
                                          device=d))
        res[name] = (fr.fids.cpu().numpy(), fr.uvs.cpu().numpy())
    same_ids = res["cuda"][0] == res["cpu"][0]
    check(same_ids.mean() >= 0.95,
          f"small stream: fids equal on {same_ids.mean():.3f} >= 0.95 of rows")
    uv_err, n_apart = same_track_uv_err(res["cuda"], res["cpu"], stc.K)
    check(uv_err.size >= 0.5 * same_ids.size and uv_err.max() < 0.05,
          f"small stream: {uv_err.size} observations of tracks that began at "
          f"one pixel on both, max uv diff {uv_err.max():.2e} px < 0.05 "
          f"({n_apart} tracks began at other pixels)")

    lap("2 main path")
    # ---------------- 3. kernels against plain versions ----------------
    # windows and positions of the main path's next frame, at every level
    nxt = torch.as_tensor(seq[0][T], device=dev).to(torch.float32)
    img1 = equalize_hist(nxt)
    pyr1 = klt.prepare_pyramid(build_pyramid(img1, tc.pyramid_levels))
    xy0 = ts.xy
    k1_cases, k2_cases = [], []
    p1 = xy0 / 2.0 ** (tc.pyramid_levels - 1)
    for lv in range(tc.pyramid_levels - 1, -1, -1):
        if lv != tc.pyramid_levels - 1:
            p1 = p1 * 2.0
        p0 = xy0 / 2.0 ** lv
        for ai, c in ((ts.pyr[lv], p0), (pyr1[lv], p1)):
            r0, c0, _ = window_origins(ai, c, -(klt.SEARCH_WD // 2), 48, 256)
            k1_cases.append((f"L{lv}", ai.padded, r0, c0))
        lw0 = klt.gather_level(ts.pyr[lv], p0)
        lw1 = klt.gather_level(pyr1[lv], p1)
        src = (klt.gather_level(ts.pyr[lv], p0, cut=False),
               klt.gather_level(pyr1[lv], p1, cut=False))
        aux, lo, hi = klt._level_aux(lw0, lw1, p0, p1, tc.patch_size)
        k2_cases.append((f"L{lv}", lw0, lw1, src, aux, lo, hi))
        out = lk_level_fused(lw0.win, lw1.win, aux, tc.klt_iters,
                             tc.patch_size, klt.KLT_EPS)
        p1 = klt._level_result(out, lw1, lo, hi)[0]
    # the level-0 backward pass: template from image 1 at the forward
    # result, LK over image 0 from the first frame's positions
    _, lw0, lw1, (s0, s1), _, _, _ = k2_cases[-1]
    aux, lo, hi = klt._level_aux(lw1, lw0, p1, xy0, tc.patch_size)
    k2_cases.append(("L0 backward", lw1, lw0, (s1, s0), aux, lo, hi))
    # ORB reads 440 windows: the 200 tracked positions + 240 candidates
    det_xy = detect_grid(img1, tc.per_cell, tc.grid_rows, tc.grid_cols)[0]
    r0, c0, _ = window_origins(pyr1[0], torch.cat([p1, det_xy]), -16, 48,
                               256)
    k1_cases.append(("ORB", pyr1[0].padded, r0, c0))

    k1_exact = True
    for name, imgs, r0, c0 in k1_cases:
        b = torch.zeros_like(r0)
        a = dma_gather_tiles(imgs, r0, c0, b, 6, 2)
        p = dma_gather_tiles_plain(imgs, r0, c0, b, 6, 2)
        exact = bool(torch.equal(a, p))
        k1_exact &= exact
        check(exact, f"K1 {name} {tuple(imgs.shape)} N={r0.shape[0]}: "
                     "bit-exact against the plain version")
    empty = dma_gather_tiles(k1_cases[0][1], r0[:0], c0[:0], r0[:0], 6, 2)
    check(tuple(empty.shape) == (0, 48, 256), "K1 N=0 returns (0, 48, 256)")

    # K2 from both sources: the windows K1 cut, and the padded levels read
    # in place at the windows' offsets (the main path's route), which must
    # give the same bits
    k2_err, k2_routes_equal = {}, True
    for eps, tol in ((0.0, 1e-3), (klt.KLT_EPS, 2e-2)):
        worst = 0.0
        for name, lw0, lw1, (s0, s1), aux, lo, hi in k2_cases:
            a = lk_level_fused(lw0.win, lw1.win, aux, tc.klt_iters,
                               tc.patch_size, eps)
            b = lk_level_src(s0.level, s0.offset, s1.level, s1.offset, aux,
                             tc.klt_iters, tc.patch_size, eps, klt.ROWS,
                             2 * klt.LANES)
            same = bool(torch.equal(a, b))
            k2_routes_equal &= same
            check(same, f"K2 {name} eps={eps}: the level route is "
                        "bit-identical to the window route")
            p = lk_level_fused_plain(lw0.win, lw1.win, aux, tc.klt_iters,
                                     tc.patch_size, eps)
            err = float((a[:, :2] - p[:, :2]).abs().max())
            worst = max(worst, err)
            ca = klt._level_result(a, lw1, lo, hi)[2]
            cp = klt._level_result(p, lw1, lo, hi)[2]
            agree = float((ca == cp).float().mean())
            check(err < tol and agree >= 0.99,
                  f"K2 {name} eps={eps}: max |dpos| {err:.2e} < {tol}, "
                  f"conv agree {agree:.3f} >= 0.99")
        k2_err[eps] = worst
    torch.cuda.synchronize()

    lap("3 kernels")
    # ---------------- 4. times ----------------
    reps_scan = TRACKER_SCANS
    ev = []
    for _ in range(reps_scan):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        scan(ts0, staged)
        e1.record()
        ev.append((e0, e1))
    torch.cuda.synchronize()
    per_frame = np.asarray([a.elapsed_time(b) / T for a, b in ev])
    emit({"tracker": {"ms_per_frame": float(np.median(per_frame)),
                      "min": float(per_frame.min()),
                      "p10": float(np.quantile(per_frame, 0.1)),
                      "p90": float(np.quantile(per_frame, 0.9)),
                      "max": float(per_frame.max()), "scans": reps_scan,
                      "frames": T,
                      "config": "752x480, 3 levels, 200 features, f32"}})

    # K1 at the main path's shape, ORB's 440 windows, and at the level-0
    # KLT shape that track_level (the K3 path) still cuts
    _, imgs, r0, c0 = k1_cases[-1]  # ORB, the new frame
    b = torch.zeros_like(r0)
    N = r0.shape[0]
    k1_ms = time_ms(lambda: dma_gather_tiles(imgs, r0, c0, b, 6, 2))
    k1_call_ms = time_ms(lambda: dma_gather_tiles(imgs, r0, c0, b, 6, 2),
                         preload=False)
    k1_plain_ms = time_ms(lambda: dma_gather_tiles_plain(imgs, r0, c0, b, 6,
                                                         2), reps=20,
                          preload=False)
    rows = r0.long()[:, None] * BR + torch.arange(48, device=dev)
    cols = c0.long()[:, None] * BL + torch.arange(256, device=dev)
    bl = b.long()[:, None, None]
    ri, ci = rows[:, :, None], cols[:, None, :]
    lib = imgs[bl, ri, ci]
    check(bool(torch.equal(lib, dma_gather_tiles(imgs, r0, c0, b, 6, 2))),
          "K1 yardstick gather equals the kernel")
    k1_lib_ms = time_ms(lambda: imgs[bl, ri, ci])
    k1_bytes = k1_needed_bytes(imgs, r0, c0, 6, 2)
    _, kimgs, kr0, kc0 = k1_cases[-2]  # KLT level 0, the new frame
    kb = torch.zeros_like(kr0)
    k1_klt_ms = time_ms(lambda: dma_gather_tiles(kimgs, kr0, kc0, kb, 6, 2))
    k1_klt_bound = bound_ms(k1_needed_bytes(kimgs, kr0, kc0, 6, 2), 0)[0]

    # K2 at level 0 with the main path's eps, on the main path's route (the
    # level read in place) and on the windows K1 cuts; ops counted from the
    # steps this data takes
    _, lw0, lw1, (s0, s1), aux, lo, hi = k2_cases[-2]
    N2 = aux.shape[0]
    P = tc.patch_size
    k2_out = lk_level_fused(lw0.win, lw1.win, aux, tc.klt_iters, P,
                            klt.KLT_EPS)
    steps = float(k2_out[:, 5].sum())
    k2_call = lambda: lk_level_src(  # noqa: E731
        s0.level, s0.offset, s1.level, s1.offset, aux, tc.klt_iters, P,
        klt.KLT_EPS, klt.ROWS, 2 * klt.LANES)
    k2_ms = time_ms(k2_call)
    k2_call_ms = time_ms(k2_call, preload=False)
    k2_win_ms = time_ms(lambda: lk_level_fused(lw0.win, lw1.win, aux,
                                               tc.klt_iters, P, klt.KLT_EPS))
    k2_plain_ms = time_ms(lambda: lk_level_fused_plain(
        lw0.win, lw1.win, aux, tc.klt_iters, P, klt.KLT_EPS), reps=20,
        preload=False)
    k2_bytes, win1_px = k2_needed_bytes(lw0.win, lw1.win, aux, tc.klt_iters,
                                        P, klt.KLT_EPS, lk_level_fused_plain)
    # template: (P+2)^2 bilinear taps (9 ops) + P^2 differences and Hessian
    # terms (10); per step: P^2 taps of bilinear, error and two products
    # (14) + the 2x2 solve (20); residual: P^2 x 12
    k2_ops = (N2 * ((P + 2) ** 2 * 9 + P * P * 10 + P * P * 12)
              + steps * (P * P * 14 + 20))

    k1_bound, k1_by = bound_ms(k1_bytes, 0)
    k2_bound, k2_by = bound_ms(k2_bytes, k2_ops)
    kernels = [
        {"name": "window_gather", "route": "cuda",
         "source": "orcvio_tpu_torch/csrc/window_gather.cu",
         "replaces": "orcvio_tpu/ops/dma_gather.py:77",
         "launches": launches["window_gather"],
         "max_abs_err": 0.0 if k1_exact else None,
         "ms": k1_ms, "plain_ms": k1_plain_ms, "bound_ms": k1_bound,
         "bound_by": k1_by, "library_ms": k1_lib_ms,
         "shape": f"({N},48,256) from {tuple(imgs.shape)} (ORB)",
         "bytes": k1_bytes, "call_ms": k1_call_ms,
         "klt_level0_ms": k1_klt_ms, "klt_level0_bound_ms": k1_klt_bound,
         "klt_level0_shape": f"({kr0.shape[0]},48,256)",
         "check": "bit-exact at 3 levels x 2 images + ORB"},
        {"name": "lk_level", "route": "cuda",
         "source": "orcvio_tpu_torch/csrc/lk_level.cu",
         "replaces": "orcvio_tpu/ops/lk_pallas.py:223",
         "launches": launches["lk_level"],
         "max_abs_err": k2_err[klt.KLT_EPS],
         "ms": k2_ms, "plain_ms": k2_plain_ms,
         "bound_ms": k2_bound, "bound_by": k2_by, "library_ms": None,
         "shape": f"levels {tuple(s0.level.shape)}, {tuple(s1.level.shape)}"
                  f" at {N2} offsets, windows (48,256), aux ({N2},16)",
         "bytes": k2_bytes, "ops": k2_ops,
         "win1_px_per_feature": win1_px, "call_ms": k2_call_ms,
         "window_route_ms": k2_win_ms,
         "routes_bit_identical": k2_routes_equal,
         "steps_mean": steps / N2, "steps_max": float(k2_out[:, 5].max()),
         "max_abs_err_eps0": k2_err[0.0],
         "check": "positions vs plain: eps=0 < 1e-3 px, eps=0.01 < 2e-2 px;"
                  " conv agree >= 99%; level route == window route, 3 "
                  "levels and the backward pass"},
    ]
    part10 = type(staged)(*(x[:10] for x in staged))
    tracker_profile = profile_frames(lambda: scan(ts0, part10), 10,
                                     cross_check=True)

    lap("4 times")
    # ---------------- 5. the end-to-end path ----------------
    # the bench-like stream, rendered on the card: 60 static frames, flight
    sim = syn.SimConfig(n_frames=E2E_FRAMES, **BENCH_SIM)
    wc = WriterConfig()
    t0 = time.perf_counter()
    etc = TrackerConfig(**TRACKER, K=wc.cam.K)
    bench = make_stream(sim, wc, device=dev)
    e2e_inputs = bench_inputs(bench)
    gt_R, gt_p = bench.gt_R, bench.gt_p
    frame_ts = e2e_inputs[1]
    staged_e = stage_sequence(*e2e_inputs, torch.float32, device=dev)
    stream_s = time.perf_counter() - t0
    fcfg = FilterConfig(**BENCH_FILTER)
    replay = make_e2e_replay(fcfg, etc, R_B2C_DOWN, wc.t_c_b, torch.float32,
                             device=dev)
    ts_e = TrackerState.create(etc, torch.float32, seed=0, device=dev)
    vs_e = VioState.create(fcfg, etc.capacity, torch.float32, device=dev)
    torch.cuda.synchronize()

    # the counted run; K4's inputs are kept per row count q as they pass
    # (stacked update, last-chance update, ZUPT) for the kernel checks
    captured = {}

    def capture(P, K, H, HP=None):
        captured[K.shape[1]] = tuple(x.clone() for x in (P, K, H))
        return cov_update(P, K, H, HP)

    filter_update.cov_update = capture
    dma_gather_tiles.launches = 0
    lk_level_fused.launches = 0
    cov_update.launches = 0
    try:
        t0 = time.perf_counter()
        _, outs = replay(ts_e, vs_e, staged_e)
        torch.cuda.synchronize()
        e2e_first_s = time.perf_counter() - t0
    finally:
        filter_update.cov_update = cov_update
    e2e_launches = {"window_gather": dma_gather_tiles.launches,
                    "lk_level": lk_level_fused.launches,
                    "cov_update": cov_update.launches}

    TE = E2E_FRAMES
    inited = outs["initialized"].cpu().numpy()
    k0 = int(np.argmax(inited)) if inited.any() else None
    n_filter = 0 if k0 is None else TE - 1 - k0
    check(k0 is not None and n_filter >= 200,
          f"static init happened (frame {k0}; JAX: {JAX_E2E['init_frame']}),"
          f" {n_filter} filter frames >= 200")
    check(bool(np.all(inited[k0:])) if k0 is not None else False,
          "initialized stays true after init")
    finite = all(bool(torch.isfinite(outs[f]).all()) for f in ("p", "R", "v"))
    check(finite, "every pose (p, R, v) finite")
    p_est = outs["p"].double().cpu().numpy()
    q_est = quat.from_rotation(outs["R"].double()).cpu().numpy()
    q_gt = quat.from_rotation(torch.as_tensor(gt_R)).numpy()
    try:
        m = ate(frame_ts, p_est, q_est, frame_ts, gt_p, q_gt, "posyaw")
    except ValueError as e:
        m = {"rmse_trans": float("nan"), "rmse_rot_deg": float("nan"),
             "error": str(e)}
    ate_m = m["rmse_trans"]
    e2e_ate_limit = ate_limit(JAX_E2E["ate_m"])
    check(bool(np.isfinite(ate_m)) and ate_m <= e2e_ate_limit,
          f"ATE {ate_m:.4f} m (posyaw) <= {e2e_ate_limit:.4f} m, JAX's "
          f"{JAX_E2E['ate_m']:.4f} m + min({ATE_MARGIN_M}, itself)")
    check(e2e_launches["cov_update"] == 3 * n_filter,
          f"K4 launches {e2e_launches['cov_update']} == 3 x filter frames "
          f"= {3 * n_filter}")
    check(e2e_launches["window_gather"] == TE
          and e2e_launches["lk_level"] == 4 * TE,
          f"e2e K1 launches {e2e_launches['window_gather']} == 1*T, "
          f"K2 {e2e_launches['lk_level']} == 4*T (T = {TE})")
    n_upd = outs["n_upd"].cpu().numpy()

    # From the states after the frame following init (the last frame that
    # reads the flag): ms/frame over E2E_REPLAYS replays of E2E_WINDOW
    # frames, the standstill's end and the flight's start, CUDA events (the
    # host sets the pace); no host sync in 20 of those frames; 10 of them
    # profiled. The window, not the whole stream, keeps the script inside
    # its time: a whole replay takes some 50 s.
    e2e_ms, e2e_profile, e2e_secs = np.full(1, np.nan), None, {}
    window = range(0 if k0 is None else k0 + 2,
                   E2E_WINDOW + (0 if k0 is None else k0 + 2))
    if k0 is not None and window.stop <= TE:
        t0 = time.perf_counter()
        (ts_b, vs_b), _ = replay(ts_e, vs_e, staged_e, frames=range(k0 + 2))
        torch.cuda.synchronize()
        e2e_secs["to_window"] = time.perf_counter() - t0
        ev = []
        for _ in range(E2E_REPLAYS):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            replay(ts_b, vs_b, staged_e, frames=window)
            e1.record()
            ev.append((e0, e1))
        torch.cuda.synchronize()
        e2e_ms = np.asarray([a.elapsed_time(b) / len(window) for a, b in ev])
        e2e_secs["window"] = time.perf_counter() - t0 - e2e_secs["to_window"]
        t0 = time.perf_counter()
        check_no_syncs(lambda: replay(ts_b, vs_b, staged_e,
                                      frames=window[:20]),
                       "20 end-to-end frames after init")
        e2e_secs["sync_check"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        e2e_profile = profile_frames(lambda: replay(
            ts_b, vs_b, staged_e, frames=window[:10]), 10)
        e2e_secs["profile"] = time.perf_counter() - t0
    else:
        check(False, f"{E2E_WINDOW} frames after init for the timing, the "
                     "sync check and the profile")
    emit({"e2e": {"frames": TE, "init_frame": k0, "filter_frames": n_filter,
                  "ms_per_frame": float(np.median(e2e_ms)),
                  "min": float(e2e_ms.min()),
                  "p90": float(np.quantile(e2e_ms, 0.9)),
                  "max": float(e2e_ms.max()), "replays": len(e2e_ms),
                  "window": [window.start, window.stop],
                  "whole_stream_ms_per_frame": e2e_first_s * 1e3 / TE,
                  "ate_m": ate_m, "ate_rot_deg": m["rmse_rot_deg"],
                  "jax_ate_m": JAX_E2E["ate_m"],
                  "jax_init_frame": JAX_E2E["init_frame"],
                  "ate_limit_m": e2e_ate_limit,
                  "n_upd_total": int(n_upd.sum()),
                  "jax_n_upd_total": JAX_E2E["n_upd_total"],
                  "zupt_frames": int(outs["zupt"].sum()),
                  "launches": e2e_launches, "first_run_s": e2e_first_s,
                  "stream_s": stream_s, "seconds": e2e_secs,
                  "config": "752x480, 3 levels, 200 features; filter D=172, "
                            "sw 20, 30 EKF features, f32"}})

    lap("5 end to end")
    # ---------------- 6. K4 against its plain version ----------------
    k4_cases = [(f"replay q={q}", *captured[q]) for q in sorted(captured)]
    for dtype in (torch.float32, torch.float64):
        k4_cases.append((f"random {dtype}".replace("torch.", ""),
                         *k4_inputs(172, 444, 3, dtype, dev)))
    check(sorted(captured) == [9, 384, 444],
          f"K4 saw the ZUPT, last-chance and stacked updates: q in "
          f"{sorted(captured)} == [9, 384, 444]")
    k4_err, k4_ratio = k4_check(k4_cases)

    # times at each of the main path's shapes, float32, on the replay's own
    # inputs: the stacked (q = 444), last-chance (384) and ZUPT (9) updates,
    # one of each a filter frame; the entry's own times are q = 444's
    k4_by_q = {q: k4_times(*captured.get(q, k4_inputs(172, q, 3,
                                                      torch.float32, dev)))
               for q in (444, 384, 9)}
    k4 = k4_by_q[444]
    D, q = 172, 444
    for kern in kernels:
        kern["launches_tracker_path"] = kern["launches"]
        kern["launches"] = e2e_launches[kern["name"]]
    kernels.append(
        {"name": "cov_update", "route": "cuda",
         "source": "orcvio_tpu_torch/csrc/cov_update.cu",
         "replaces": "orcvio_tpu/ops/cov_update.py:54",
         "launches": e2e_launches["cov_update"],
         "max_abs_err": max(v for k, v in k4_err.items() if "float64" not in k),
         "ms": k4["kernel_ms"], "plain_ms": k4["library_ms"],
         "bound_ms": k4["bound_ms"], "bound_by": k4["bound_by"],
         "library_ms": k4["library_ms"],
         "shape": f"P ({D},{D}), K ({D},{q}), HP ({q},{D}) float32",
         **{k: v for k, v in k4.items() if k not in ("bound_by",)},
         "by_q": {str(q): {k: v[k] for k in ("kernel_ms", "library_ms",
                                             "addmm_ms", "bound_ms")}
                  for q, v in k4_by_q.items()},
         "ms_per_filter_frame": sum(v["kernel_ms"] for v in k4_by_q.values()),
         "addmm_ms_per_filter_frame": sum(v["addmm_ms"]
                                          for v in k4_by_q.values()),
         "max_abs_err_by_case": k4_err,
         "max_share_of_rounding_bound_f32": k4_ratio,
         "check": "vs plain on the replay's q=444/384/9 inputs and random "
                  "(172,444) f32/f64: within the rounding bound, exactly "
                  "symmetric"})
    lap("6 K4")
    # ---------------- 7. the K3 path ----------------
    # track_level at every level on K3_FRAMES frame pairs of the known-flow
    # stream, at 200 seeded positions: windows (200, 48, 256), the flow
    # 1.3, -0.7 px a frame at level 0
    levels, P, iters = tc.pyramid_levels, tc.patch_size, tc.klt_iters
    pyrs = [build_pyramid(equalize_hist(torch.as_tensor(
        seq[0][k], device=dev).to(torch.float32)), levels)
        for k in range(K3_FRAMES + 1)]
    xy = torch.as_tensor(np.random.default_rng(7).uniform(
        [24, 24], [tc.width - 24, tc.height - 24], size=(tc.capacity, 2)),
        dtype=torch.float32, device=dev)
    torch.cuda.synchronize()
    lk_iterate_fused.launches = 0
    dma_gather_tiles.launches = 0
    lk_level_fused.launches = 0
    tl = [klt.track_level(pyrs[k][lv], pyrs[k + 1][lv], xy / 2.0 ** lv,
                          xy / 2.0 ** lv, P, iters, klt.KLT_EPS)
          for k in range(K3_FRAMES) for lv in range(levels)]
    torch.cuda.synchronize()
    k3_launches = lk_iterate_fused.launches
    n_calls = K3_FRAMES * levels
    check(k3_launches == n_calls
          and dma_gather_tiles.launches == n_calls
          and lk_level_fused.launches == 0,
          f"K3 launches {k3_launches} == {n_calls} track_level calls, K1 "
          f"{dma_gather_tiles.launches} == {n_calls} (the template's "
          f"windows; K3 reads the second level in place), K2 "
          f"{lk_level_fused.launches} == 0")
    shift = torch.tensor(SHIFT, device=dev)
    l0_err = torch.cat([torch.linalg.norm(p - xy - shift, dim=1)[conv]
                        for p, _, conv in tl[::levels]]).cpu().numpy()
    check(l0_err.size >= 0.5 * K3_FRAMES * tc.capacity
          and np.median(l0_err) < 0.1,
          f"track_level level 0: {l0_err.size} converged, median flow "
          f"error {np.median(l0_err):.4f} px < 0.1")

    k3_cases = []
    for lv in range(levels):
        c = xy / 2.0 ** lv
        ai1 = klt.prepare_pyramid(pyrs[1])[lv]
        lw0 = klt.gather_level(klt.prepare_pyramid(pyrs[0])[lv], c)
        lw1 = klt.gather_level(ai1, c)
        src1 = klt.gather_level(ai1, c, cut=False)
        tmpl = klt._template(lw0, c, P)
        aux, lo, hi = klt._iterate_aux(lw1, tmpl, c, P)
        k3_cases.append((f"L{lv}", lw0, lw1, src1, c, tmpl, aux, lo, hi))
    k3_err, k3_k2_err, k3_routes_equal = 0.0, 0.0, True
    for name, lw0, lw1, src1, c, tmpl, aux, lo, hi in k3_cases:
        a = lk_iterate_fused(lw1.win, *tmpl[:3], aux, iters, P)
        b = lk_iterate_src(src1.level, src1.offset, *tmpl[:3], aux, iters, P,
                           klt.ROWS, 2 * klt.LANES)
        same = bool(torch.equal(a, b))
        k3_routes_equal &= same
        check(same, f"K3 {name}: the level route is bit-identical to the "
                    "window route")
        p = lk_iterate_fused_plain(lw1.win, *tmpl[:3], aux, iters, P)
        err = float((a[:, :2] - p[:, :2]).abs().max())
        k3_err = max(k3_err, err)
        ca, cp = (klt._converged(o[:, :2], o[:, 3], tmpl[6], lo, hi)
                  for o in (a, p))
        agree = float((ca == cp).float().mean())
        zeros = bool((a[:, 4:] == 0).all())
        check(err < 1e-3 and agree >= 0.99 and zeros,
              f"K3 {name}: max |dpos| {err:.2e} < 1e-3 against the plain "
              f"version, conv agree {agree:.3f} >= 0.99, columns 4-7 zero")
        aux2, _, _ = klt._level_aux(lw0, lw1, c, c, P)
        k2 = lk_level_fused(lw0.win, lw1.win, aux2, iters, P, 0.0)
        err2 = float((a[:, :2] - k2[:, :2]).abs().max())
        k3_k2_err = max(k3_k2_err, err2)
        check(err2 < 1e-3, f"K3 path {name}: max |dpos| {err2:.2e} < 1e-3 "
                           "against the K2 path at eps = 0")
    # pyr_track reads the levels in place: K2 once a level, no K1
    dma_gather_tiles.launches = 0
    lk_level_fused.launches = 0
    pt = [klt.pyr_track(pyrs[k], pyrs[k + 1], xy, xy, P, iters)
          for k in range(K3_FRAMES)]
    torch.cuda.synchronize()
    check(dma_gather_tiles.launches == 0
          and lk_level_fused.launches == levels * K3_FRAMES,
          f"pyr_track launches: K1 {dma_gather_tiles.launches} == 0, K2 "
          f"{lk_level_fused.launches} == {levels} levels x {K3_FRAMES}")
    pt_err = torch.cat([torch.linalg.norm(res.xy - xy - shift, dim=1)[res.ok]
                        for res in pt]).cpu().numpy()
    pt_ok = sum(int(res.ok.sum()) for res in pt)
    check(pt_ok >= 0.5 * K3_FRAMES * tc.capacity
          and np.median(pt_err) < 0.1,
          f"pyr_track: {pt_ok} tracked, median flow error "
          f"{np.median(pt_err):.4f} px < 0.1")
    empty = klt.track_level(pyrs[0][0], pyrs[1][0], xy[:0], xy[:0], P,
                            iters, klt.KLT_EPS)
    _, _, lw1, src1, _, tmpl, aux, _, _ = k3_cases[0]
    e_tmpl = [x[:0] for x in tmpl[:3]]
    e_out = lk_iterate_fused(lw1.win[:0], *e_tmpl, aux[:0], iters, P)
    e_src = lk_iterate_src(src1.level, src1.offset[:0], *e_tmpl, aux[:0],
                           iters, P)
    check([tuple(x.shape) for x in empty] == [(0, 2), (0,), (0,)]
          and tuple(e_out.shape) == tuple(e_src.shape) == (0, 8),
          "K3 path N = 0: track_level gives (0, 2), (0,), (0,); K3 (0, 8) "
          "on both routes")

    # times at level 0, (200, 48, 256): the route track_level takes on the
    # card (the level read in place) and the windows K1 cuts
    N3 = aux.shape[0]
    k3_call = lambda: lk_iterate_src(  # noqa: E731
        src1.level, src1.offset, *tmpl[:3], aux, iters, P, klt.ROWS,
        2 * klt.LANES)
    k3_ms = time_ms(k3_call)
    k3_call_ms = time_ms(k3_call, preload=False)
    k3_win = lambda: lk_iterate_fused(lw1.win, *tmpl[:3], aux,  # noqa: E731
                                      iters, P)
    k3_win_ms = time_ms(k3_win)
    k3_win_call_ms = time_ms(k3_win, preload=False)
    k3_plain_ms = time_ms(lambda: lk_iterate_fused_plain(
        lw1.win, *tmpl[:3], aux, iters, P), reps=20, preload=False)
    k3_bytes, k3_px = k3_needed_bytes(lw1.win, *tmpl[:3], aux, iters, P,
                                      lk_iterate_fused_plain)
    # per step: P^2 taps of bilinear, error and two products (14) + the
    # 2x2 solve (20); residual: P^2 x 12
    k3_ops = N3 * (iters * (P * P * 14 + 20) + P * P * 12)
    k3_bound, k3_by = bound_ms(k3_bytes, k3_ops)
    emit({"k3_path": {"track_level_calls": n_calls, "launches": k3_launches,
                      "level0_flow_err_median_px": float(np.median(l0_err)),
                      "pyr_track_flow_err_median_px":
                          float(np.median(pt_err)),
                      "pyr_track_tracked": pt_ok,
                      "max_abs_err_vs_plain": k3_err,
                      "max_abs_err_vs_k2_path": k3_k2_err,
                      "routes_bit_identical": k3_routes_equal}})
    kernels.append(
        {"name": "lk_iterate", "route": "cuda",
         "source": "orcvio_tpu_torch/csrc/lk_level.cu",
         "replaces": "orcvio_tpu/ops/lk_pallas.py:265",
         "launches": k3_launches, "max_abs_err": k3_err,
         "ms": k3_ms, "plain_ms": k3_plain_ms, "bound_ms": k3_bound,
         "bound_by": k3_by, "library_ms": None,
         "shape": f"level {tuple(src1.level.shape)} at {N3} offsets or win "
                  f"({N3},48,256), t/tgx/tgy ({N3},{P},{P}), aux ({N3},16), "
                  f"{iters} steps",
         "bytes": k3_bytes, "ops": k3_ops, "win_px_per_feature": k3_px,
         "call_ms": k3_call_ms, "window_route_ms": k3_win_ms,
         "window_route_call_ms": k3_win_call_ms,
         "routes_bit_identical": k3_routes_equal,
         "max_abs_err_vs_k2_path": k3_k2_err,
         "check": "level route == window route, 3 levels; positions vs "
                  "plain < 1e-3 px, conv agree >= 99%, columns 4-7 zero; "
                  "vs the K2 path < 1e-3 px; N = 0 on both routes"})

    lap("7 K3 path")
    # ---------------- 8. the K5 path ----------------
    race.extract_pallas.launches = 0
    t0 = time.perf_counter()
    race_us = race.main(dev, frames=race.T, reps=RACE_REPS)
    torch.cuda.synchronize()
    race_s = time.perf_counter() - t0
    k5_launches = race.extract_pallas.launches
    # the K5 variant at B = 1 and 8: one untimed pass and RACE_REPS timed
    # passes of T frames, one launch a frame
    want = 2 * (1 + RACE_REPS) * race.T
    check(k5_launches == want,
          f"K5 launches in the race {k5_launches} == {want}")

    imgs, oys, oxs = (torch.as_tensor(x, device=dev)
                      for x in race.draws(frames=8))
    imgp = race.prep(imgs)
    edge_y, edge_x = oys[:1].clone(), oxs[:1].clone()
    edge_y[0, :8] = torch.tensor([0, 0, race.HP - race.WD,
                                  race.HP - race.WD, -5, race.HP, 1, 300])
    edge_x[0, :8] = torch.tensor([0, race.WP - 65, 0, race.WP - 65,
                                  race.WP - 40, -3, 767, race.WP])
    k5_cases = [("B=1 N=200", imgp[:1], oys[:1], oxs[:1]),
                ("B=8 N=200", imgp, oys, oxs),
                ("B=2 N=13", imgp[:2], oys[:2, :13].contiguous(),
                 oxs[:2, :13].contiguous()),
                ("B=8 N=0", imgp, oys[:, :0], oxs[:, :0]),
                ("B=1 edges", imgp[:1], edge_y, edge_x)]
    k5_exact = True
    for name, im, oy, ox in k5_cases:
        w, off = race.extract_pallas(im, oy, ox)
        wp, offp = race.extract_dynslice(im, oy, ox)
        exact = (torch.equal(w, wp) and torch.equal(off, offp)
                 and tuple(w.shape) == (*oy.shape, race.WD, race.LANES))
        k5_exact &= exact
        check(exact, f"K5 {name}: windows and offsets bit-exact against "
                     "the plain version")

    # times at the race's B = 8 shape
    B5, N5 = oys.shape
    k5_call = lambda: race.extract_pallas(imgp, oys, oxs)  # noqa: E731
    k5_ms = time_ms(k5_call)
    k5_call_ms = time_ms(k5_call, preload=False)
    k5_plain_ms = time_ms(lambda: race.extract_dynslice(imgp, oys, oxs),
                          reps=20, preload=False)
    y5, x64, _ = race._origins(imgp, oys, oxs)
    rows = y5.long()[..., None] + torch.arange(race.WD, device=dev)
    cols = x64.long()[..., None] + torch.arange(race.LANES, device=dev)
    b5 = torch.arange(B5, device=dev)[:, None, None, None]
    ri, ci = rows[..., :, None], cols[..., None, :]
    check(bool(torch.equal(imgp[b5, ri, ci], k5_call()[0])),
          "K5 yardstick gather equals the kernel")
    k5_lib_ms = time_ms(lambda: imgp[b5, ri, ci])
    k5_bytes = k5_needed_bytes(imgp, y5, x64, race.WD, race.LANES)
    k5_bound, k5_by = bound_ms(k5_bytes, 0)
    emit({"k5_path": {"race_us_per_extract": race_us, "frames": race.T,
                      "reps": RACE_REPS, "launches": k5_launches,
                      "seconds": race_s,
                      "config": "200 windows (36, 128) a frame from "
                                "(560, 896), B = 1 and 8, prep included"}})
    kernels.append(
        {"name": "extract64", "route": "cuda",
         "source": "orcvio_tpu_torch/csrc/extract64.cu",
         "replaces": "scripts/race_extract.py:86",
         "launches": k5_launches,
         "max_abs_err": 0.0 if k5_exact else None,
         "ms": k5_ms, "plain_ms": k5_plain_ms, "bound_ms": k5_bound,
         "bound_by": k5_by, "library_ms": k5_lib_ms,
         "shape": f"({B5},{N5},{race.WD},{race.LANES}) from "
                  f"{tuple(imgp.shape)}",
         "bytes": k5_bytes, "call_ms": k5_call_ms,
         "check": "bit-exact at B=1/8 N=200, N=13, N=0, edge origins"})

    lap("8 K5 path")
    # ---------------- 9. the EuRoC path ----------------
    t0 = time.perf_counter()
    euroc = euroc_phase(dev, bench, wc)
    euroc["seconds"] = time.perf_counter() - t0
    emit({"euroc": euroc})
    for kern in kernels:  # this slice's path counts K1, K2 and K4 too
        for run in ("staged", "host_loop"):
            if kern["name"] in euroc.get(run, {}).get("launches", {}):
                kern[f"launches_euroc_{run}"] = \
                    euroc[run]["launches"][kern["name"]]

    lap("9 EuRoC path")
    # ---------------- 10. the flag variants ----------------
    flags, k4_in, flag_tracker = flag_phase(dev, bench, wc)
    form_errs = update_forms_check(dev)
    # K4's (D, q, nb) in the variants: pure MSCKF, 3-d inverse depth, the
    # qr and chol forms, then calib_imu (D = 196), Schmidt (D = 208, nb =
    # 172) and both (D = 232, nb = 196), each at the stacked update's
    # q = 444 and ZUPT's q = 9
    main_shapes = {(172, 444, 172), (172, 384, 172), (172, 9, 172)}
    new_shapes = [(142, 384, 142), (232, 444, 232), (172, 172, 172),
                  (196, 444, 196), (196, 9, 196), (208, 444, 172),
                  (208, 9, 172), (232, 444, 196), (232, 9, 196)]
    check(all(x in k4_in for x in new_shapes),
          f"K4 saw the variants' new shapes (D, q, nb) {new_shapes}: "
          f"{sorted(k4_in)}")
    # the nb entry on seeded inputs at the new D's, float32 and float64, nb
    # a multiple of the 32-row tile (160) and not (172, 196)
    k4_nb_cases = [(f"random nb D={D} q={q} {str(dtype)[6:]}",
                    *k4_inputs(D, q, D + q, dtype, dev), D - 36)
                   for D in (196, 208, 232) for q in (444, 9)
                   for dtype in (torch.float32, torch.float64)]
    k4_flag_err, k4_flag_ratio = k4_check(
        [(f"flags D={D} q={q} nb={nb}", *k4_in[(D, q, nb)], nb)
         for D, q, nb in sorted(k4_in) if (D, q, nb) not in main_shapes]
        + k4_nb_cases)
    k4_flag_times = {f"D={D} q={q} nb={nb}": {
        k: v for k, v in k4_times(*k4_in[(D, q, nb)], nb).items()
        if k in ("kernel_ms", "library_ms", "addmm_ms", "bound_ms", "ops",
                 "bytes")}
        for D, q, nb in new_shapes if (D, q, nb) in k4_in}
    emit({"flags": {"frames": FLAG_FRAMES, "flight_frames": FLIGHT_FRAMES,
                    "variants": flags, "update_forms_rel_err": form_errs,
                    "tracker_launches": flag_tracker,
                    "k4_max_abs_err": k4_flag_err,
                    "k4_max_share_of_rounding_bound_f32": k4_flag_ratio,
                    "k4_times": k4_flag_times}})
    for kern in kernels:
        if kern["name"] == "cov_update":
            kern["launches_flags"] = sum(
                v["k4_launches"] + v.get("flight", {}).get("k4_launches", 0)
                for v in flags.values())
            kern["by_shape_flags"] = k4_flag_times
            kern["max_abs_err_by_case"].update(k4_flag_err)
        elif kern["name"] in flag_tracker:
            kern["launches_flags"] = flag_tracker[kern["name"]]

    lap("10 flag variants")
    # ---------------- 11. many streams on one card ----------------
    batched = batched_phase(dev, bench, wc, q_gt, frame_ts)
    emit({"batched": batched})
    for kern in kernels:
        if kern["name"] in batched["rules"]:
            kern["batched"] = batched["rules"][kern["name"]]
            kern["launches_batched"] = batched["e2e"]["launches"][
                kern["name"]]

    lap("11 batched")
    # ---------------- 12. the object path ----------------
    objects, k4_objects = objects_phase(dev)
    emit({"objects": {k: v for k, v in objects.items()
                      if k not in ("config_a", "staged")}})
    for kern in kernels:
        if kern["name"] == "cov_update":
            kern.update(k4_objects)

    lap("12 objects")
    # ---------------- 13. the image path of the objects ----------------
    images, k4_images = image_objects_phase(dev)
    emit({"objects_images": {k: v for k, v in images.items()
                             if k != "config_b"}})
    for kern in kernels:
        if kern["name"] == "cov_update":
            kern.update(k4_images)

    lap("13 object images")
    # ---------------- 14. scale-out and tools ----------------
    scale = scale_out_phase(dev, main_seq)
    emit({"scale_out": scale})
    for kern in kernels:
        if kern["name"] == "cov_update":
            kern["launches_sequence_parallel"] = scale["sequence_parallel"][
                "k4_launches"]
        elif kern["name"] in ("window_gather", "lk_level"):
            for mode, eq in scale["equalize"].items():
                kern[f"launches_{mode}"] = eq["launches"][kern["name"]]

    lap("14 scale-out")
    emit({"phase_seconds": laps, "total_s": sum(laps.values())})
    for kern in kernels:  # None where the library was built before this run
        kern["ptxas"] = ptxas.get(Path(kern["source"]).stem)
    emit({"kernels": kernels})
    emit({"profile": {"tracker": tracker_profile, "e2e": e2e_profile}})

    if FAILURES:
        print(f"chip_smoke: {len(FAILURES)} check(s) failed:",
              file=sys.stderr)
        for f in FAILURES:
            print(f"  {f}", file=sys.stderr)
        return 1
    print(gpu, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
