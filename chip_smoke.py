#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one NVIDIA GPU and check its kernels.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It needs one
CUDA card and the CUDA toolkit (``nvcc``); without a card it exits non-zero
and prints no result.  It imports nothing of JAX or of the JAX package.

Phases (any failure raises and ends the run with a non-zero code):

1. device: the card's name and power limit from ``nvidia-smi``;
2. build: every kernel from ``bluerov2_dynamics_tpu_torch/csrc``, one
   ``nvcc`` per source, all started together; then, for the redesigned
   kernels (the euler12 RK4 rollouts K1, with its prologue folded in and
   on a ready tau_seq, and K3, and the window kernels
   K2, K4 and K5 in their fused and endpoint forms at 9,065 and 44,800
   starts, each as its launcher plans it there), their registers, stack
   frame and spill bytes (ptxas), resident blocks per SM at the launched
   block size (the CUDA occupancy query), block size, warps a start, K3's
   stage plan, the window kernels' waves and plans, and the step loops'
   opcode counts (``cuobjdump -sass``; a warp-pair kernel's loop of each
   warp); a spill, a kernel that cannot be resident, K1/K3 needing a
   second wave at the bench shape, or K1's step loop differing between its
   two forms, fails the run;
3. main paths, each with every launch count set to 0 just before it and
   read just after; each must have launched its kernels:
   - the Koopman apps (:func:`koopman_apps`): T2 ``apps.tank_koopman.main``
     on the pseudo tank recording (45,823 steps made by the CUDA-graph
     generator, 500 RBFs, the Fossen baseline on K2 fused: one launch a
     call, cold and warm at H = 1, 10, 100), then with ``--koopman-conv``,
     a 3 x 3 ``--sweep`` and ``--streaming-chunk 1024`` on 20,000 steps of
     the same generator; T1 ``apps.sim_koopman.main`` at its defaults (48,000
     steps, 200 RBFs).  Checked: the generator against its eager loop bit
     for bit over its first two chunks, finite data, the Koopman RMSEs
     against the same port functions in float64 on the host CPU (on the
     card's data and centers), conv against scan, a NaN model from a Gram
     that is not positive definite skipped by ``select_best``, and TF32
     off inside the Koopman calls with the caller's TF32 on.  Timed: the
     generator (graph and eager), the fits cold and warm, the multistep
     RMSE at each H by scan and conv, the sweep and the streaming fit;
   - the learned-model apps (:func:`learned_apps`): T6
     ``apps.tank_full_comparison.main`` on the 45,823-step pseudo
     recording with a copy of the committed PINc checkpoint (its sidecar
     honoured), ``--pinc-psi-ssa`` and ``--json-out`` (Koopman, Fossen on
     K2 Euler, DI, PINc), T5 ``apps.tank_rk4.main`` the same on K2 RK4 at
     20,000 steps, T3
     and T4 (``tank_wrench_comp``, ``tank_wrench_quat``) at 20,000 steps
     on K4 and K5; then PINc trained from scratch at the flagship batch
     (256, rollout 10 x 16) for a few epochs and its checkpoint reloaded
     bit for bit.  Checked: each Fossen row against its plain version,
     the DI and PINc RMSEs and the committed PINc's forward against the
     same port functions in float64 on the host CPU, finite losses; the
     device-busy share of the PINc endpoint and of training steps;
   - the differentiable Fossen identification inside those app runs (no
     recording is made for it): T6 with ``--fossen-fit --fossen-fit-stderr
     --fossen-fit-gains --fossen-fit-current`` (36,658 training rows,
     horizon 10, 300 Adam steps, one CUDA graph of an iteration replayed),
     T5, T2 and T4 with ``--fossen-fit``, T3 with ``--fossen-fit
     --fossen-fit-current``; each app's "Fossen (fitted)" row runs its
     kernel (K2 Euler/RK4, K4, K5) under the fitted coefficients, gains
     and current.  Checked: finite, falling losses; each fitted row against
     its plain version; T6's fitted row below its nominal one at H = 10 and
     100; T6's stderrs ``inf`` exactly at Yv, Kp, Nr; at T6's shape over
     20 steps, the graph fit (its loss and gradient from the window-loss
     kernel ``sysid_window``) against the eager autograd loop at rtol
     1e-4 and its launches, and an RK4 graph fit against its eager loop
     bit for bit, with one lag-history launch; ``sysid_window`` against
     autograd's loss and gradient at T6's start and fitted points (rtol
     1e-5; 1e-4 of the start point's largest gradient entry, the fitted
     point's gradient being rounding), and its gradient there against
     float64 on the host CPU (the same 1e-4), timed against its plain
     version and its bound; the window loss and its gradient at T6's
     fitted point against float64 on the host CPU; K2 (Euler, RK4), K4 and
     K5 under fitted values in both forms against their plain versions;
     the lag-history kernel ``lag_history`` at 36,658 rows against its
     float64 plain version on the host CPU (1e-5 of the history's largest
     magnitude), timed against its plain version and its bound
     (``kernels`` line); then, in phase 6, ``mesh=`` at world 1
     on the one-rank NCCL group against ``mesh=None``.  Timed: the fits,
     an eager iteration, the stderrs (and their peak memory); the
     profiler's device events and busy share of an eager iteration and of
     the graph fit;
   - the host data path (:func:`ingest_runs`): the host libraries and
     ``g++``, the native CDR decoder's build; the generator on the card at
     dt 0.01 for 91,658 steps (the real manual bag's 916.58 s) written as a
     rosbag2 sqlite3 recording of ~183k Odometry and ActuatorMotors
     messages; ``data.bag2csv`` through its CLI with pandas unimportable
     (both topics through the native decoder, counted) to the 50 Hz CSV;
     then T2 (``--physics-baseline``, K2), T6 (the committed PINc, a
     25-step Fossen fit, K2; its GIF, 2-D and fit-scales figures where
     matplotlib and PIL exist) on the CSV, T3 and T4 (K4, K5) on 20,000
     rows of it through ``wrench.augment_csv`` and the quaternion loader.
     Checked: native = the Python codec bit for bit on 2,000 messages, the
     CSV's states against a numpy mean of the generator's states in each
     20 ms bin, ``sanity.run_all``, each Fossen row (and T6's fitted row)
     against its plain version, each figure's signature and the GIF's frame
     count.  Timed: the build, decode msgs/s native and Python, read,
     resample and CSV write, each app, each render;
   - the physics demo (:func:`demo_runs`): ``apps.demo`` ``euler`` and
     ``ode`` at their defaults, ``ode --bdf`` and ``ode --tether`` cut to
     ``--t-end 0.1``, each endpoint against the same port call in float64
     on the host CPU;
   - state estimation (:func:`estimation_runs`), which launches none of
     K1-K8 (the counts are read to show it): ``apps.estimate.main`` on the
     pseudo recording (10,000 rows; 45,823 until the ingest phase came)
     with ``--smooth --fit-noise --fossen-fit
     --refit-koopman`` (EKF, RTS, the noise fit on a 16 x 250 bank, the
     Koopman refit), then each other branch once at a cut length
     (``EST_BRANCHES``).  Checked: the RTS RMSE at least 4x below the raw
     sensor's, the mean NIS in [9, 15], the fitted R sigmas within 5% of
     the generator's; every CUDA-graph step loop (EKF, RTS, fit_noise, PF)
     against its eager loop bit for bit; the PF's repeat from one seed and
     its resampling firing; float32 against float64 on the card over the
     recording's first 4,096 rows; the MEKF's quaternion norms; in phase
     6, the sharded EKF and PF banks at world 1 against the unsharded
     ones bit for bit.  Timed: every phase of the headline run, each
     branch; the profiler's launches a step and busy share of a replayed
     EKF and RTS chunk and of a fit_noise iteration;
   - control and guidance (:func:`control_runs`), which launches none of
     K1-K8 (the counts are read to show it): ``apps.control_demo.main``
     with ``all`` at the demo's default sizes (hover LQR, Koopman-LQR on
     60 x 100 episodes and 100 RBFs, trajopt 250 x 8 over 250 Adam
     iterations), then ``mppi``, ``ilqr``, ``lqg``, ``adaptive`` and
     ``los`` at their defaults and ``mpc`` cut to 10 plant steps of 300.
     Checked: every CUDA-graph loop (closed loop, trajopt, MPPI, MPC, LQG,
     LOS, iLQR) against its eager loop bit for bit, MPPI's repeat from one
     seed, ``fossen_lqr`` in float32 against float64, the task claims at
     the JAX package's test thresholds (``all`` also draws its figure where
     matplotlib and PIL exist, timed apart); in phase 6, ``simulate_mppi``
     with ``mesh=`` at world 1 against the unsharded call bit for bit.
     Timed: every task; the profiler's launches and busy share of one
     trajopt iteration, one MPPI round and one MPC Adam iteration;
   - K1: the shared-input RK4 rollout at B=65,536 x T=500 through
     ``make_rollout_final_cuda``: one C call, one kernel (the profiler
     counts its device events);
   - T2: the tank app's Fossen evaluator (Euler) at H = 1, 10, 100 on a
     9,165-row recording through ``apps.tank_koopman.fossen_evaluator``
     (K2 fused: one launch returns the squared-error sum);
   - T3: the wrench app's evaluator on the same recording's wrench through
     ``apps.tank_wrench_comp.fossen_wrench_evaluator`` (K4 fused);
   - T4: the quaternion app's evaluator on its quat13 version through
     ``apps.tank_wrench_quat.fossen_quat_evaluator`` (K5 fused);
   - the window endpoints: ``make_endpoint_final_cuda*`` at H=100 on the
     same recordings (K2, K4, K5 writing the endpoint states);
   - K6: the quat13 shared-wrench RK4 rollout at 65,536 x 500 through
     ``make_rollout_final_cuda_quat``;
   - K3: the per-trajectory-command RK4 rollout at 65,536 x 500 through
     ``make_batched_rollout_cuda``;
4. checks: each kernel against its plain PyTorch version on the same card
   inputs (K1's prologue alone and inside K1 at T = 0, 1, 255, 256, 257,
   500 and 9,165, with and without the lag, against the chunked plain
   version and the serial one; K2 at both start counts; K4 and K5 in both
   forms at both start
   counts and H = 1, 10, 100; the fused sums at rtol 1e-5 and with the
   same bits on ten calls), the evaluators' RMSEs
   against the plain step loops, K6's quaternion norms, and small inputs
   against the plain versions on the host CPU;
5. timing: each kernel and its plain version with CUDA events, the window
   kernels (as short as their launchers' host time) at 9,065 and 44,800
   starts and K1's tau prologue alone by the profiler's device events, K1
   with the prologue inside in turns with K1 on a ready tau_seq, and the
   calls end to end (K1's one call in turns with the two-launch form on
   the scanned prologue kernel, 60 synchronised calls each; the evaluators in turns with the
   unfused policy they replace, 5 repeats of 20 calls; min / median /
   max);
6. K7: the three sharded window evaluators (``parallel.sharded``) at
   44,800 starts x H=100 (Euler) on a one-rank NCCL group, one fused
   launch a call, held against the unsharded kernels, the unfused
   composition and the plain versions; then four contiguous blocks
   through the unfused per-rank body, whose squared errors must sum to the
   world-1 result (world > 1 needs one card per rank: NCCL refuses two
   ranks on one card, so the 4-rank runs are the CPU tests' work); the
   fused and unfused compositions timed in turns (5 repeats of 20 calls),
   and ``torch.profiler`` once over the fused one for the device-busy
   share;
7. K8: the four ceiling probes at 65,536 lanes, each at the block size
   that measures fastest, with the card's clocks and power beside each
   rate; each kernel against its plain version at 16 iterations; the
   probes' loop bodies as ``cuobjdump -sass`` shows them (the fma probe
   is held by its increment, the mix probe at both quat13 budgets);
8. the measured ceilings of K1-K7 from the probes' rates, and the
   measured price of one sinf and one rsqrtf in FMA-tree flops;
9. a ``koopman apps:``, a ``learned apps:``, a ``demo:``, an
   ``estimation:``, a ``control:`` and an ``ingest:`` JSON line, one JSON line
   ``{"kernels": [...]}``,
   then the last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
DT = 0.02
B_ROLL, T_ROLL = 65_536, 500        # bench.py run_pallas / sec_quat_rollout shape
N_REC = 9_165                       # the tank recording's test split
H_APP = (1, 10, 100)
N_LARGE = 44_800                    # full-recording start count
T2_STEPS = 45_823                   # the pseudo tank recording (apps.tank_koopman --recording)
T2_ARGS = ["--synthetic", "--recording", "--steps", str(T2_STEPS), "--physics-baseline",
           "--no-media"]
T1_ARGS = ["--no-media"]            # apps.sim_koopman at its defaults: 48,000 steps, 200 RBFs
# T2's --koopman-conv, --sweep and --streaming-chunk runs, each of which
# generates its own recording: 45,823 steps until the script's time needed
# headroom on slow hosts
T2_RERUN_STEPS = 20_000
SWEEP_ARGS = ["--sweep", "--sweep-gammas", "1", "3", "10", "--sweep-ridges", "1e-3", "1e-2", "1e-1"]
EAGER_CHUNKS = 2                    # graph chunks held against the eager loop bit for bit
# the host data path (ingest_runs): a rosbag2 recording the size of the real
# manual tank bag (916.58 s; 95-110 Hz topics): the generator at dt 0.01 for
# 91,658 steps, each step an Odometry and an ActuatorMotors message, stamped
# every 10 ms plus 1-4 ms of jitter from a start that is not a multiple of
# 20 ms; bag2csv through its CLI to the 50 Hz CSV; T2, T6 (with a short
# Fossen fit and, where matplotlib and PIL exist, its figures), T3 and T4
# (on INGEST_T34_ROWS rows of the CSV, as learned_apps cuts them) read it.
INGEST_STEPS = 91_658
INGEST_DT = 0.01
INGEST_T0_NS = 1_762_430_000_123_456_789
INGEST_PY_MSGS = 20_000             # messages the per-message Python codec is timed on
INGEST_CHECK_MSGS = 2_000           # messages held native = Python, bit for bit
INGEST_T34_ROWS = 20_000
INGEST_FIT = ["--fossen-fit", "--fossen-fit-steps", "25"]
# the CSV's states against a plain numpy mean of the generator's states in
# each 20 ms bin: the resample is that mean (pandas' compensated sum; no
# bin is empty, so none is interpolated); the quaternion round trip of the
# angles and the sums' order differ at float64 rounding (measured on the
# card's machine over the 45,829 bins with an exact parse: 8.9e-16), held at
# 1e-12.  The CSV is read with pandas' default float parser, as csv_loader
# reads it for T2-T6; that parser is not correctly rounded and returns up to
# 2e-12 relative off the written value (tests/test_torch_csv_loader.py
# measures 9.8e-13), so each state is held at 1e-12 + 2e-12 |mean|
INGEST_STATE_ATOL = 1e-12
INGEST_PARSE_RTOL = 2e-12
# the dataset sanity checks (data/sanity.py) on the CSV equal, to float64
# rounding, the same checks on the numpy bin means and the commands of the
# bins' first messages, and the z-dot RMSE stays below the JAX package's test
# bound (tests/test_data.py: 0.05 m/s; its 0.99 correlation is for noiseless
# data: here the 1e-3 m sensor noise differenced over 20 ms dominates z-dot)
SANITY_RMSE = 0.05
SANITY_RTOL = 1e-9
# the learned-model apps: T6 and T5 on the full pseudo recording with the
# committed PINc checkpoint (copied to a temporary directory), T3 and T4 at
# the apps' default 20,000 steps; then PINc training at the flagship batch
LEARNED_ARGS = ["--synthetic", "--recording", "--steps", str(T2_STEPS), "--no-media",
                "--pinc-psi-ssa"]
T34_ARGS = ["--synthetic", "--recording", "--steps", "20000", "--no-media"]
TRAIN_EPOCHS = 1                    # batch 256, rollout 10 steps x 16 windows (3 until the
                                    # ingest phase came; cut for the script's time)
# the differentiable Fossen fit, added to the app runs above (300 Adam steps,
# horizon 10, input delay 1 on the generated recording: the apps' defaults)
T2_FIT = ["--fossen-fit"]
T6_FIT = ["--fossen-fit", "--fossen-fit-stderr", "--fossen-fit-gains", "--fossen-fit-current"]
T5_FIT = ["--fossen-fit", "--fossen-fit-steps", "100"]  # 300 until the ingest phase came
T5_STEPS = 20_000                   # T5's recording: T6's 45,823 steps until the script's
                                    # time needed headroom on slow hosts
T3_FIT = ["--fossen-fit", "--fossen-fit-current"]
T4_FIT = ["--fossen-fit"]
FIT_CHECK_STEPS = 20                # the graph fit against the eager loop, at T6's shape
# the graph fit (its loss and gradient from the window-loss kernel) against
# the eager loop (autograd): losses relative, fitted parameters absolute
FIT_KERNEL_TOL = {"losses": 1e-4, "params": 1e-5}
# the window-loss kernel against autograd's loss and gradient on the same
# inputs: the loss relative, the gradient over its largest entry
WINDOW_KERNEL_TOL = {"loss": 1e-5, "grad": 1e-4}
SQ_ERR_OPS = 3                      # per state component of an error: sub, mul, add
WINDOW_TIMED = 20                   # window-loss kernel launches in its timed graph
LAG_ROWS = 36_658                   # the lag history at a tank recording's training split
LAG_TOL = 1e-5                      # float32 kernel off the float64 plain version, of max|hist|
ZERO_NOMINAL = (12, 14, 16)         # Yv, Kp, Nr: zero in Table A1, unidentifiable (inf stderr)
# the window loss and its gradient on the card (float32) against float64 on
# the host CPU at T6's start and fitted points (at the fitted point, where
# the gradient is near zero, its error over the start's |grad|); mesh= at
# world 1 against mesh=None at the JAX package's tolerances
# (tests/test_sysid.py): losses, log-scales
FIT_F64_RTOL = 1e-3
MESH_RTOL = {"losses": 2e-4, "scales": 1e-3}
# the demo: its endpoints on the card (float32) against float64 on the host
DEMO_TETHER_T_END = 0.1             # 10 outer steps x 40 RK4 substeps, eager
DEMO_ATOL = 1e-4
TRAIN_PROFILE_STEPS = 5             # minibatch steps traced for the device-busy share
# The Koopman RMSEs on the card (float32 k-means, lifts and propagation; the
# normal equations in float64) against the same port functions in float64
# on the host CPU, on the card's data and centers: measured on the H100 at
# most 5.3e-4 (T2, H=100) and 1.7e-5 (T1); held at ten times the larger.
# Scan against conv on the card: reassociation only (measured 4.4e-4).
KOOP_RTOL = 5e-3
CONV_RTOL = 1e-3
# The learned models on the card (float32) against the same port functions
# in float64 on the host CPU, with the card's weights and gains, measured on
# the H100 and held at about ten times that: the PINc endpoint RMSEs at most
# 5.3e-5 relative (T6, H=100), the DI ones 2.3e-7 (T3, H=100), the committed
# PINc's forward on the T6 test split 5.5e-5 absolute on outputs up to 6.7.
PINC_RTOL = 6e-4
DI_RTOL = 3e-6
PINC_FWD_ATOL = 6e-4
# State estimation (apps.estimate): the headline run on the full pseudo
# recording, each other branch once at a cut length, then the checks.  The
# headline's claims (the JAX package's run on a TPU read the smoothed
# "all channels" RMSE 6.9x below the raw sensor's): RTS at least 4x below
# raw, mean NIS in the chi^2_12 band below, the fitted R sigmas within 5%
# of the generator's.
EST_STEPS = 10_000                  # 45,823 until the ingest phase came, then 20,000 until
                                    # the script's time needed headroom on slow hosts (the
                                    # noise fit's window is 4,000 rows either way)
# the noise fit's Adam iterations cut from the app's 200 to 100 when the
# ingest phase came (its R starts at the generator's sigmas)
EST_HEADLINE = ["--synthetic", "--recording", "--steps", str(EST_STEPS), "--smooth",
                "--fit-noise-steps", "100",
                "--fit-noise", "--fossen-fit", "--refit-koopman", "--no-media"]
EST_BASE = ["--synthetic", "--recording", "--no-media"]
# (b): the app's default is 20,000 rows; cut for time (halved again when
# the ingest phase came, to keep the script inside its limit); MHE cut
# from README's 600 rows to 40 (60 until the ingest phase came)
EST_BRANCHES = (
    ("pose+smooth", ["--steps", "2000", "--measure", "pose", "--smooth"]),
    ("ukf", ["--steps", "4000", "--filter", "ukf"]),
    ("koopman", ["--steps", "10000", "--filter", "koopman"]),
    ("pf", ["--steps", "4000", "--noise-scale", "25", "--filter", "pf", "--q", "1e-4"]),
    ("quat+smooth", ["--steps", "1500", "--contract", "quat", "--smooth"]),
    ("mhe", ["--steps", "40", "--outlier-frac", "0.03", "--filter", "mhe", "--q", "1e-4"]),
)
EST_RTS_GAIN = 4.0
EST_NIS_BAND = (9.0, 15.0)
EST_R_SIGMAS = (1e-3, 2e-3, 1e-3, 2e-3)
EST_R_RTOL = 0.05
EST_QUAT_ATOL = 1e-5
# (c): graph against eager bit for bit over EST_CHECK_STEPS steps (fit_noise
# EST_FIT_CHECK_STEPS iterations on a bank of 50-step segments); float32
# against float64 on the card over the recording's first EST_F64_ROWS rows,
# RMSE vs truth (filter and smoother) and loglik at these relative bounds
EST_CHECK_STEPS = 300
EST_FIT_CHECK_STEPS = 5
EST_F64_ROWS = 4096
EST_F64_RTOL = {"rmse": 2e-2, "loglik": 1e-3}
EST_PARTICLES = 1024
# Control and guidance (control_runs): (a) ``all`` at the demo's default
# sizes, (b) every opt-in task, MPC cut from 300 plant steps to
# CTRL_MPC_STEPS for time (its plan width and iterations kept), (c) the
# checks.  The claims hold at the thresholds the JAX package's tests
# assert: hover |x| at the end (tests/test_control.py:100), trajopt's last
# loss against its first and terminal error in m (:158-159), MPPI's closest
# approach in obstacle radii and final error in m (:513-515), iLQR's
# feedback error against open-loop replay (:479); LOS hits every waypoint
# (tests/test_guidance.py:171).
CTRL_TASKS = ("mppi", "ilqr", "lqg", "adaptive", "los")
CTRL_MPC_STEPS = 5                  # 10 until the ingest phase came
CTRL_HOVER_END = 1e-2
CTRL_TRAJOPT = (1e-3, 0.05)
CTRL_MPPI = (0.9, 0.15)
CTRL_ILQR_GAIN = 0.4
# float32 against float64, fossen_lqr end to end: trim's Adam wanders at
# float32's floor near the optimum (measured on the host CPU: K 1.9e-3
# relative, u_eq 9.4e-4 absolute); the linearization and the Riccati
# iteration alone at the float64 trim point measured 1.1e-6 there
CTRL_F64 = {"K": 5e-3, "u_eq": 2e-3, "K_same_trim": 1e-4}

# H100 SXM peaks (NVIDIA data sheet): FP32 outside the tensor cores, HBM3.
# The bounds price the audited step counts (eval/op_counts.py) at these
# peaks, with a division or rsqrt at 8 and a sinf/cosf at 16 operations;
# the ceilings price them at the rates the K8 probes measure.
FP32_PEAK = 67e12
HBM_BYTES_PER_S = 3.35e12
K7_BACKEND = "nccl"
K7_BLOCKS = 4                       # offset blocks of the world-1 check
REPEATS, CALLS = 5, 20              # spread of the host-bound calls: repeats of CALLS calls
K1_CALLS = 60                       # K1 calls timed end to end, each way
# the fused window kernels: (the evaluator that runs them, their endpoint form)
FUSED = {"window_sq": ("fossen_evaluator", "window_eval"),
         "window_sq_wrench": ("fossen_wrench_evaluator", "window_eval_wrench"),
         "window_sq_quat": ("fossen_quat_evaluator", "window_eval_quat")}
PROBE_BLOCKS = (128, 256, 512)      # threads per block tried for each probe
CHECK_ITERS = 16                    # probe iterations of the check against the plain versions

# |kernel - plain| <= atol + rtol * |plain|, elementwise, as (rtol, atol).
# The kernels and their plain versions do the same float32 operations in
# the same order, except that nvcc contracts a*b+c into a fused
# multiply-add (and the plain tau_seq sums its small matrix products in the
# library's order, and CUDA's rsqrtf is not correctly rounded).  The
# rollout and window bounds are the JAX package's own for its kernels
# (tests/test_pallas_rollout.py, test_pallas_eval.py, test_pallas_quat.py);
# the windows add rtol 2e-4, since the recording's positions reach metres;
# tau_seq reaches ~50 N, where one float32 ulp is 3.8e-6.
TOL = {
    "rollout_final": (0.0, 2e-5),        # RK4, 500 steps
    "shared_tau": (1e-5, 1e-4),
    "window_eval": (2e-4, 2e-5),         # Euler, H=100
    "batched_rollout": (2e-4, 2e-5),     # RK4, 500 steps, per-trajectory commands
    "window_eval_wrench": (2e-4, 2e-5),  # Euler, H=100
    "window_eval_quat": (2e-4, 2e-5),    # Euler, H=100
    "rollout_final_quat": (0.0, 2e-5),   # RK4, 500 steps
    "rmse": (1e-4, 0.0),
    "quat_norm": (0.0, 1e-5),
    # K7 against the unsharded kernel: the same per-rank kernel, one float32
    # sum reordered (against the plain versions K7 keeps "rmse")
    "sharded_rmse": (1e-5, 0.0),
    # the fused window kernels' sums against the plain versions': float32
    # squares summed in another order (csrc/fossen_rows.cuh grid_sum)
    "window_sq": (1e-5, 0.0),
    "window_sq_wrench": (1e-5, 0.0),
    "window_sq_quat": (1e-5, 0.0),
    # K4's and K5's endpoints at every start count and H of their checks:
    # the same operations on states of order one (the plain versions' rows
    # differ only by FMA contraction)
    "window_shapes": (0.0, 2e-5),
    # K2/K4/K5 under a fit's coefficients, gains and current on the apps'
    # test splits, H = 100: endpoints at atol 2e-5, fused sums at rtol 1e-5
    "fitted_endpoints": (0.0, 2e-5),
    # K8 at CHECK_ITERS: one rounding of a fused multiply-add where the
    # plain version has two, over 16 dependent steps.  The fma probe is held
    # by its increment (cuda_probes.fma_peak_increment): its output moves
    # only ~1e-7 per iteration, its increment by 1/CHECK_ITERS of itself
    "fma_peak": (1e-5, 0.0),
    "transcendental_peak": (1e-5, 0.0),
    "fma_tree_peak": (1e-5, 0.0),
    "quat_mix_peak": (1e-5, 0.0),
}
# K3's white-noise commands tip a few trajectories over: where pitch passes
# +-pi/2 the euler12 rates divide by the clamped cos(theta) and the path is
# chaotic (float32 and float64 runs of the same plain code part by ~1e2).
# A float64 step loop over the same commands marks every trajectory whose
# pitch comes within 0.07 rad of the singularity; those are counted and
# left out of K3's elementwise check, which fails if they are over 1%.
GIMBAL_MARGIN = 1.5
# the prologue's T held on the card: none, one step, a chunk (256 steps) less
# one, one, one more, the bench's, a whole recording
TAU_EDGE_T = (0, 1, 255, 256, 257, T_ROLL, N_REC)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def max_err(got, want, name, tol=None):
    rtol, atol = TOL[name] if tol is None else TOL[tol]
    got, want = got.double().cpu(), want.double().cpu()
    if got.shape != want.shape:
        fail(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not torch.isfinite(got).all():
        fail(f"{name}: non-finite values")
    if got.numel() == 0:
        print(f"{name}: empty, as the plain version")
        return 0.0
    d = (got - want).abs()
    bad = d > atol + rtol * want.abs()
    err = float(d.max())
    print(f"{name}: max|kernel - plain| = {err:.3e} (rtol {rtol:g}, atol {atol:g})")
    if bool(bad.any()):
        fail(f"{name}: {int(bad.sum())} elements outside the tolerance")
    return err


def close(got: float, want: float, rtol: float, what: str) -> None:
    print(f"{what}: {got:.9g} vs {want:.9g} (rel {abs(got - want) / abs(want):.3e}, "
          f"rtol {rtol:g})")
    if not abs(got - want) <= rtol * abs(want):
        fail(f"{what}: {got} vs {want}, outside rtol {rtol}")


def bound(ops: float, nbytes: float):
    t_ops, t_bytes = ops / FP32_PEAK, nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def ar1_commands(rng, n, alpha=0.98, noise=0.02):
    """Smooth random commands u_{k+1} = clip(alpha u_k + noise N(0, 1))."""
    U = np.empty((n, 8), np.float32)
    u = np.zeros(8)
    for k in range(n):
        u = np.clip(alpha * u + noise * rng.normal(size=8), -1.0, 1.0)
        U[k] = u
    return U


def gimbal_near(fossen, p, cfg, lag, x0, U):
    """Trajectories of ``x0 (B, 12)`` under ``U (T, B, 8)`` whose pitch
    reaches ``GIMBAL_MARGIN`` in a float64 step loop (RK4) with the same
    stored coefficients."""
    p64, cfg64, lag64 = (type(c)(*(f.double() for f in c)) for c in (p, cfg, lag))
    step = fossen.make_thruster_step(p64, cfg64, lag64, DT, "rk4")
    x = x0.double()
    L = torch.zeros((x0.shape[0], 8, 3), dtype=torch.float64, device=x0.device)
    peak = torch.zeros(x0.shape[0], dtype=torch.float64, device=x0.device)
    for t in range(U.shape[0]):
        x, L = step((x, L), U[t].double())
        peak = torch.maximum(peak, x[:, 4].abs())
    return peak >= GIMBAL_MARGIN


STEP_OPS = ("FFMA", "FMUL", "FADD", "FSEL", "FSETP", "MUFU.RCP", "MUFU.RSQ", "F2I", "I2FP", "FCHK",
            "BRA", "BSSY", "BSYNC", "LDS", "STS", "LDG", "BAR", "SHFL")
# K4 and K5 in both forms: (name, library, fused)
PAIR_KERNELS = (("window_eval_wrench", "window_eval", False), ("window_sq_wrench", "window_eval", True),
                ("window_eval_quat", "quat", False), ("window_sq_quat", "quat", True))


def redesigned_report(logs) -> dict:
    """The redesigned kernels' resources, residency, plan and step-loop
    opcode counts: K1 and K3 (RK4 with the lag) at the bench shape; K2
    (Euler with the lag), K4 (Euler) and K5 (Euler, renormalised) in their
    fused form, which the apps run, and their endpoint form, at the apps'
    and the full recording's starts, each as its launcher plans it there
    (K4 and K5: one warp or a warp pair a start; a warp-pair kernel has a
    step loop a warp).  Fails if any spills, or if K1 or K3 needs a second
    wave at the bench shape."""
    from bluerov2_dynamics_tpu_torch.eval import rollout_ab as ab
    from bluerov2_dynamics_tpu_torch.ops import _build
    from bluerov2_dynamics_tpu_torch.ops import cuda_eval as ce
    from bluerov2_dynamics_tpu_torch.ops import cuda_probes as cp
    from bluerov2_dynamics_tpu_torch.ops import cuda_quat as cq
    from bluerov2_dynamics_tpu_torch.ops import cuda_rollout as cr

    H = H_APP[-1]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    # name: (library, kernel instantiation, block, resident blocks per SM, blocks,
    #        warps a start, a second wave fails, step loop read, plan)
    kernels = {}
    for name, lib, (block, per_sm), kernel in (
            ("rollout_final", "rollout", cr.rollout_commands_occupancy(),
             "rollout_commands_kernel<1>"),
            ("rollout_final two-launch", "rollout", cr.rollout_occupancy(), "rollout_kernel<1>"),
            ("batched_rollout", "batched_rollout", ce.batched_rollout_occupancy(),
             "batched_rollout_kernel<1, true>")):
        kernels[name] = (lib, kernel, block, per_sm, -(-B_ROLL // block), 1, True, True, None)
    for n in (N_REC - H, N_LARGE):
        for fused in (True, False):
            occ = ce.window_occupancy("euler", True, fused=fused)
            kernels[f"window_{'sq' if fused else 'eval'} {n}"] = (
                "window_eval", f"window_eval_kernel<0, true, {str(fused).lower()}>", occ["block"],
                occ["blocks_per_sm"], ce.window_plan(n, H)["n_blocks"], 1, False, fused, None)
        for name, lib, fused in PAIR_KERNELS:
            plan = (ce.wrench_occupancy(n, "euler", fused) if lib == "window_eval"
                    else cq.quat_occupancy(n, "euler", True, fused))
            kernels[f"{name} {n}"] = (lib, ab.pair_kernel(name, plan), plan["block"],
                                      plan["blocks_per_sm"], plan["n_blocks"], plan["warps"], False,
                                      True, plan)
    out, sass = {}, {}
    for name, (lib, kernel, block, per_sm, n_blocks, warps, one_wave, read_loop,
               plan) in kernels.items():
        key = ab.mangled_key(kernel)
        res = [r for fn, r in _build.ptxas_resources(logs[lib]).items() if key in fn]
        if len(res) != 1:
            fail(f"ptxas: {len(res)} functions match {key}")
        res = res[0]
        if per_sm < 1:
            fail(f"{name}: {kernel} cannot be resident at {block} threads a block")
        waves = -(-n_blocks // (per_sm * sms))
        extra = f"; stage plan {ce.stage_plan(B_ROLL, T_ROLL)}" if name == "batched_rollout" else ""
        if plan is not None:
            extra = f"; {kernel}, plan {plan}"
        print(f"{name}: {res['regs']} registers, {res['stack']}-byte stack frame, spill "
              f"{res['spill_stores']}/{res['spill_loads']} bytes (stores/loads); {warps} warp(s) "
              f"a start, {block} threads a block, {per_sm} resident blocks per SM: "
              f"{n_blocks} blocks in {waves} wave(s){extra}")
        if res["spill_stores"] or res["spill_loads"]:
            fail(f"{name} spills {res['spill_stores']}/{res['spill_loads']} bytes")
        if one_wave and waves > 1:
            fail(f"{name}: {n_blocks} blocks of {block} threads need {waves} waves")
        out[name] = dict(regs=res["regs"], stack=res["stack"], blocks_per_sm=per_sm, block=block,
                         lanes=1, warps=warps, waves=waves)
        if plan is not None:
            out[name].update(kernel=kernel, plan=plan)
        if not read_loop:
            continue
        if lib not in sass:
            sass[lib] = cp.sass_text(lib)
        if sass[lib] is None:
            print(f"{name}: cuobjdump not found; step loop not read")
            continue
        loops = {}
        for loop in ab.loop_counts(sass[lib], kernel):   # a warp pair's kinematic warp first
            counts = {op: loop["fast"].get(op, 0) for op in STEP_OPS if loop["static"].get(op)}
            label = "" if loop["warp"] == "one" else f" ({loop['warp']} warp)"
            print(f"{name} step loop{label}: {sum(loop['fast'].values())} instructions on the "
                  f"common path ({sum(loop['static'].values())} with the slow paths): {counts}")
            loops[loop["warp"]] = counts
        out[name]["step_loop"] = loops.pop("one", loops)
    # K1's step loop is the same whether the prologue runs inside it or not
    loops = [out[n].get("step_loop") for n in ("rollout_final", "rollout_final two-launch")]
    if None not in loops and loops[0] != loops[1]:
        fail(f"K1's step loop differs from the two-launch K1's: {loops[0]} against {loops[1]}")
    return out


def device_busy_share(fn):
    """The device's busy time (its kernel, copy and set events) over the
    host time of CALLS calls of ``fn``, or None where the trace holds no
    device event."""
    from bluerov2_dynamics_tpu_torch.eval.timing import profile_calls

    dev, wall_us = profile_calls(fn, CALLS)
    if not dev:
        print("torch.profiler: no device events; device-busy share not measured")
        return None
    busy = sum(e.time_range.elapsed_us() for e in dev)
    names = sorted({e.name for e in dev})
    print(f"torch.profiler over {CALLS} fused K7 compositions: {len(dev)} device events "
          f"({', '.join(n[:60] for n in names)}), busy {busy:.1f} of {wall_us:.1f} us = "
          f"{busy / wall_us:.4f} busy share")
    return busy / wall_us


def fossen_vs_plain(app, run, row, plain, X, U) -> dict:
    """An app's Fossen row ``row`` (a fused kernel) against its plain
    version on the same card inputs, at each H; returns the relative
    differences."""
    from bluerov2_dynamics_tpu_torch.apps import common

    rel = {}
    for H in H_APP:
        want = float(common.fused_rmse(lambda X_, U_: plain(X_, U_, H), X, U, H))
        got = run["rmse"][row][H]
        close(got, want, TOL["rmse"][0], f"{app} {row} H={H} (kernel vs plain)")
        rel[H] = abs(got - want) / abs(want)
    return rel


def media_libraries() -> bool:
    """Whether this machine can draw the apps' figures (matplotlib and PIL)."""
    import importlib.util

    return all(importlib.util.find_spec(m) is not None for m in ("matplotlib", "PIL"))


def media_file(path, frames=None) -> None:
    """A figure the run wrote: a PNG, or a GIF of ``frames`` frames."""
    data = path.read_bytes()
    if path.suffix == ".png":
        if data[:8] != b"\x89PNG\r\n\x1a\n":
            fail(f"{path.name} is not a PNG")
        return
    from PIL import Image

    if data[:6] not in (b"GIF87a", b"GIF89a"):
        fail(f"{path.name} is not a GIF")
    with Image.open(path) as im:
        if im.n_frames != frames:
            fail(f"{path.name}: {im.n_frames} frames, not the {frames} its frame step implies")


def fitted_row(app, run, plain_sq, X, U, nominal, card) -> dict:
    """An app's differentiable Fossen fit: finite, falling losses, and its
    "Fossen (fitted)" row (the app's fused kernel under the fitted
    coefficients) against the plain version on the same card inputs.
    Returns the fit's summary for the JSON line."""
    from bluerov2_dynamics_tpu_torch.apps import common

    res = run["sysid"]
    losses = res.losses.double().cpu().numpy()
    print(f"{app} Fossen fit: {len(losses)} Adam steps in {run['sysid_s']:.3f} s (the app's "
          f"host clock), loss {losses[0]:.6e} -> {losses[-1]:.6e}")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        fail(f"{app} Fossen fit: losses {losses[0]} -> {losses[-1]}")
    rel = {}
    for H in H_APP:
        want = float(common.fused_rmse(lambda X_, U_: plain_sq(X_, U_, H), X, U, H))
        got = run["rmse"]["Fossen (fitted)"][H]
        close(got, want, TOL["rmse"][0], f"{app} Fossen (fitted) H={H} (kernel vs plain)")
        rel[H] = abs(got - want) / abs(want)
    warm = run["warm_s"]["Fossen (fitted)"]
    print(f"{app} Fossen (fitted) row, warm ms at H = {', '.join(map(str, H_APP))}: "
          + ", ".join(f"{1e3 * warm[H]:.4f}" for H in H_APP) + f"; the fit {run['sysid_s']:.3f} s "
          f"[{card}]")
    return dict(seconds=run["sysid_s"], steps=len(losses), loss_first=losses[0],
                loss_last=losses[-1], rmse=run["rmse"]["Fossen (fitted)"],
                nominal_rmse=run["rmse"][nominal],
                table_warm_ms={H: 1e3 * v for H, v in run["warm_s"]["Fossen (fitted)"].items()},
                rel_vs_plain=rel,
                current=None if res.current is None else res.current.tolist())


def lag_history_entry(dev, card, launches: int) -> dict:
    """The lag-history kernel (``csrc/lag_history.cu``) at LAG_ROWS rows of
    smooth commands, float32: its gap to the float64 plain version
    (``thrusters.lag_history_chunked``, which the tests hold against the
    serial loop and the JAX package) on the host CPU beside the float32
    plain version's own there, against LAG_TOL of the history's largest
    magnitude; its device time by CUDA events over 20 launches, its plain
    version's on the card, and its bound (each byte of F_cmd read and of
    hist written once).  ``launches`` is the kernel's count in the T6 graph
    fit of ``fit_checks``.  Returns the ``kernels`` entry."""
    from bluerov2_dynamics_tpu_torch.eval.timing import cuda_event_time
    from bluerov2_dynamics_tpu_torch.models import sysid
    from bluerov2_dynamics_tpu_torch.models.params import lag_params, thruster_config
    from bluerov2_dynamics_tpu_torch.models.thrusters import lag_history_chunked, static_thrust

    U = ar1_commands(np.random.default_rng(SEED + 21), LAG_ROWS)
    cpu = torch.device("cpu")

    def inputs(dtype, device):
        """``(lag, F_cmd)`` of the commands in ``dtype`` on ``device``."""
        cfg = thruster_config(dtype=dtype, device=device)
        return (lag_params(DT, dtype=dtype, device=device),
                static_thrust(cfg, torch.as_tensor(U, dtype=dtype, device=device)))

    want = lag_history_chunked(*inputs(torch.float64, cpu))
    scale = float(want.abs().max())
    gap = lambda h: float((h.double().cpu() - want).abs().max()) / scale  # noqa: E731
    lag, F = inputs(torch.float32, dev)
    got = sysid.lag_history(thruster_config(device=dev), lag, torch.as_tensor(U, device=dev))
    gaps = {"kernel": gap(got), "plain_float32_host": gap(lag_history_chunked(*inputs(
        torch.float32, cpu))), "plain_on_card": gap(lag_history_chunked(lag, F))}
    k_ms = cuda_event_time(lambda: sysid._launch_lag_history(lag, F), iters=20)
    p_ms = cuda_event_time(lambda: lag_history_chunked(lag, F), iters=3)
    b = bound(0, LAG_ROWS * (8 + 24) * 4)
    print(f"lag_history at {LAG_ROWS} rows, float32: {launches} launch in the T6 graph fit; off "
          f"the float64 plain version {gaps['kernel']:.3e} of max|hist| (the float32 plain "
          f"version on the host {gaps['plain_float32_host']:.3e}, on the card "
          f"{gaps['plain_on_card']:.3e}; tol {LAG_TOL:g}); {k_ms:.4f} ms a launch (plain "
          f"{p_ms:.2f} ms, bound {b[0]:.4f} ms by {b[1]}: {100 * b[0] / k_ms:.2f}%) [{card}]")
    if gaps["kernel"] > LAG_TOL:
        fail(f"the lag-history kernel is {gaps['kernel']:.3e} off the float64 plain version")
    return dict(name="lag_history", route="cuda",
                source="bluerov2_dynamics_tpu_torch/csrc/lag_history.cu",
                replaces="none: the JAX package's lag_history is a lax.scan "
                         "(bluerov2_dynamics_tpu/models/sysid.py:219) with no pallas_call",
                launches=launches, max_rel_err=gaps["kernel"],
                err_of="max|kernel - float64 plain version| over max|hist|", gaps=gaps,
                tol=LAG_TOL, ms=k_ms, kernel_ms=k_ms, ms_of="20 launches between CUDA events",
                plain_ms=p_ms, bound_ms=b[0], bound_by=b[1], library_ms=None,
                shape=f"F_cmd ({LAG_ROWS}, 8) -> hist ({LAG_ROWS}, 8, 3), float32")


def fit_checks(dev, card, t6, t5, t3, t4):
    """The fits of the app runs, checked further on the card, at T6's
    shape over FIT_CHECK_STEPS steps: the graph fit (the window-loss
    kernel) against the eager loop (autograd), with the kernel's launches
    from 0 just before it; an RK4 graph fit (autograd) against its eager
    loop bit for bit.  The window-loss kernel alone against autograd's
    loss and gradient at T6's start and fitted points, its device time,
    its plain version's and its bound.  An eager iteration's host time,
    device events and busy share; a replay of the kernel's iteration and
    its capture's host time; the stderrs' time
    and peak memory; the window loss and its gradient at T6's fitted point
    against float64 on the host CPU; K2 (Euler, RK4), K4 and K5 under the
    fitted values in both forms against their plain versions.  Returns
    ``(summary, context for the mesh check and the kernels' record)``."""
    from bluerov2_dynamics_tpu_torch.eval.op_counts import actuation_ops, row_ops
    from bluerov2_dynamics_tpu_torch.eval.timing import cuda_event_time, host_ms, profile_calls
    from bluerov2_dynamics_tpu_torch.models import sysid
    from bluerov2_dynamics_tpu_torch.models.params import lag_params
    from bluerov2_dynamics_tpu_torch.ops import _build
    from bluerov2_dynamics_tpu_torch.ops import cuda_eval as ce
    from bluerov2_dynamics_tpu_torch.ops import cuda_quat as cq
    from bluerov2_dynamics_tpu_torch.ops.precision import full_f32

    cpu = torch.device("cpu")
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev).contiguous()  # noqa: E731
    lag = lag_params(DT, device=dev)
    res6 = t6["sysid"]
    X_tr, U_tr = f32(t6["train"].X), f32(t6["train"].U)
    kw = dict(horizon=10, lr=0.02, input_delay=1, fit_gains=True, fit_current=True)
    out = {}

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        return r, time.perf_counter() - t0

    # the lag history alone (a step loop over the training split, once a fit)
    _, lag_s = timed(lambda: sysid.lag_history(t6["sysid"].cfg, lag, U_tr))
    # the graph fit (the window-loss kernel) against the eager loop (autograd)
    _build.reset_launch_counts()
    graph, graph_s = timed(lambda: sysid.fit_thruster(
        X_tr, U_tr, DT, steps=FIT_CHECK_STEPS, graph=True, **kw))
    window_launches = _build.launches["sysid_window"]
    lag_launches = _build.launches["lag_history"]
    print(f"T6 graph fit: {window_launches} sysid_window launches ({sysid.GRAPH_WARMUP} warm-up, "
          f"{FIT_CHECK_STEPS} replays), {lag_launches} lag_history launch")
    if window_launches != FIT_CHECK_STEPS + sysid.GRAPH_WARMUP:
        fail(f"the T6 graph fit launched the window-loss kernel {window_launches} times, not "
             f"{FIT_CHECK_STEPS} replays and {sysid.GRAPH_WARMUP} warm-up iterations")
    if lag_launches != 1:
        fail(f"the T6 graph fit launched the lag-history kernel {lag_launches} times, not once")
    eager, eager_s = timed(lambda: sysid.fit_thruster(
        X_tr, U_tr, DT, steps=FIT_CHECK_STEPS, graph=False, **kw))
    gaps = {"losses": float(((graph.losses - eager.losses).abs() / eager.losses.abs()).max())}
    gaps["params"] = max(float((getattr(graph, f) - getattr(eager, f)).abs().max())
                         for f in ("log_scales", "log_gains", "current"))
    print(f"T6 fit, graph (kernel) against eager (autograd) over {FIT_CHECK_STEPS} steps at "
          f"{X_tr.shape[0]} rows: losses rel {gaps['losses']:.3e} (tol "
          f"{FIT_KERNEL_TOL['losses']:g}), parameters max|d| {gaps['params']:.3e} (tol "
          f"{FIT_KERNEL_TOL['params']:g}); graph {graph_s:.3f} s, eager {eager_s:.3f} s "
          f"(lag history, warm-up and capture included) [{card}]")
    if any(gaps[k] > FIT_KERNEL_TOL[k] for k in gaps):
        fail(f"the graph fit and the eager fit differ ({gaps})")
    # an RK4 fit still replays autograd's graph: the same kernels in the
    # same order as its eager loop, so the same bits
    rk4 = {mode: sysid.fit_thruster(X_tr, U_tr, DT, steps=FIT_CHECK_STEPS, method="rk4",
                                    graph=mode, **kw) for mode in ("graph", "eager")}
    fields = ("losses", "log_scales", "log_gains", "current")
    same = {f: torch.equal(getattr(rk4["graph"], f), getattr(rk4["eager"], f)) for f in fields}
    parted = (rk4["graph"].losses != rk4["eager"].losses).nonzero().flatten().tolist()
    print(f"T6 RK4 fit, graph against eager over {FIT_CHECK_STEPS} steps: the same bits {same}; "
          f"first iteration where the losses part: {parted[0] if parted else None} [{card}]")
    if not all(same.values()):
        fail(f"the RK4 graph fit and its eager fit differ ({same}; losses part at {parted[:1]})")

    # the window-loss kernel alone against autograd's loss and gradient (its
    # plain version) on the same inputs, at T6's start and fitted points
    wl, kernel_fn = sysid._thruster_loss(X_tr, U_tr, DT, 10, True, input_delay=1, fit_gains=True,
                                         fit_current=True)
    fitted = {"s": res6.log_scales, "g": res6.log_gains, "c": res6.current}
    start = {k: torch.zeros_like(v) for k, v in fitted.items()}

    def card_value_and_grad(fn, point):
        th = {k: v.detach().clone().requires_grad_(True) for k, v in point.items()}
        with full_f32():
            loss = fn(th)
            grad = torch.autograd.grad(loss, [th[k] for k in sorted(th)])
        return loss.detach(), torch.cat([g.reshape(-1) for g in grad])

    # at the fitted point the gradient vanishes to float32's rounding (its
    # largest entry ~3e-7, both float32 gradients 0.2-2.7% of it off
    # float64), so there each gap is over the start's largest entry, the
    # fit's gradient scale; the float64 gradient comes further on
    kernel_gaps, kernel_grads = {}, {}
    for label, point in (("start", start), ("fitted", fitted)):
        got_l, got_g = card_value_and_grad(kernel_fn, point)
        want_l, want_g = card_value_and_grad(wl.loss_fn, point)
        kernel_grads[label] = got_g.double().cpu()
        if label == "start":
            start_largest = float(want_g.abs().max())
        d = float((got_g - want_g).abs().max())
        kernel_gaps[label] = dict(loss_rel=float((got_l - want_l).abs() / want_l.abs()),
                                  grad_over_largest=d / float(want_g.abs().max()),
                                  grad_over_start_largest=d / start_largest)
        print(f"sysid_window at T6's {label} point against autograd: loss rel "
              f"{kernel_gaps[label]['loss_rel']:.3e} (rtol {WINDOW_KERNEL_TOL['loss']:g}), "
              f"gradient max|d| over its largest entry "
              f"{kernel_gaps[label]['grad_over_largest']:.3e}, over the start's "
              f"{kernel_gaps[label]['grad_over_start_largest']:.3e} (tol "
              f"{WINDOW_KERNEL_TOL['grad']:g})")
    if any(g["loss_rel"] > WINDOW_KERNEL_TOL["loss"]
           or g["grad_over_start_largest"] > WINDOW_KERNEL_TOL["grad"]
           for g in kernel_gaps.values()):
        fail(f"the window-loss kernel is off autograd's loss or gradient: {kernel_gaps}")
    # its time, its plain version's (autograd's loss and gradient) and its
    # bound: the forward's steps and squared errors, the reverse pass at
    # twice the forward.  A launch is as short as its launcher's host time,
    # and the profiler keeps few of its events in this long process, so the
    # kernel's time is a CUDA graph of WINDOW_TIMED launches back to back,
    # between CUDA events; the launches one by one beside it
    with torch.no_grad():
        kernel_fn(fitted)
        torch.cuda.synchronize()
        timed_graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(timed_graph):
            for _ in range(WINDOW_TIMED):
                kernel_fn(fitted)
        k_ms = cuda_event_time(timed_graph.replay, iters=5) / WINDOW_TIMED
        e_ms = cuda_event_time(lambda: kernel_fn(fitted), iters=20)
    del timed_graph
    p_ms = cuda_event_time(lambda: card_value_and_grad(wl.loss_fn, fitted), iters=3)
    nnz = int((res6.cfg.wrench_map != 0).sum())
    b = bound(3 * wl.n_start * 10 * (row_ops("euler") + actuation_ops(nnz) + 12 * SQ_ERR_OPS), 0)
    print(f"sysid_window at {wl.n_start} starts x H=10: {k_ms:.4f} ms a launch in a graph of "
          f"{WINDOW_TIMED}, {e_ms:.4f} ms a launch one by one (plain {p_ms:.2f} ms, bound "
          f"{b[0]:.4f} ms by {b[1]}: {100 * b[0] / k_ms:.1f}%) [{card}]")
    window_entry = dict(
        launches=window_launches,
        max_rel_err=max(g["grad_over_start_largest"] for g in kernel_gaps.values()),
        err_of="the gradient's max|kernel - autograd| over the start point's largest entry, at "
               "T6's start and fitted points", gaps=kernel_gaps, tol=WINDOW_KERNEL_TOL,
        ms=k_ms, kernel_ms=k_ms, ms_of=f"a CUDA graph of {WINDOW_TIMED} launches between CUDA "
                                       "events", event_ms=e_ms, plain_ms=p_ms,
        bound_ms=b[0], bound_by=b[1], library_ms=None,
        shape=f"X ({X_tr.shape[0]}, 12), U ({X_tr.shape[0]}, 8), {wl.n_start} starts x H=10, "
              f"Euler, input delay 1, gains and current")

    # the app's iteration on the kernel, captured and replayed as the app
    # does: a replay's device milliseconds and the capture's host seconds
    replay = {}
    sysid._run_adam(kernel_fn, wl.theta0, len(res6.losses), 0.02, graph=True, stats=replay)

    # an eager iteration: host time, device events, busy share
    theta = {k: v.clone().requires_grad_(True) for k, v in fitted.items()}
    leaves = [theta[k] for k in sorted(theta)]
    mu, nu = [torch.zeros_like(t) for t in leaves], [torch.zeros_like(t) for t in leaves]
    count = torch.zeros((), dtype=torch.float64, device=dev)

    def iteration():
        loss = wl.loss_fn(theta)
        sysid.adam_update(leaves, torch.autograd.grad(loss, leaves), mu, nu, count, 0.02)
        return loss

    it_ms = sorted(host_ms(iteration, calls=5))
    events, wall_us = profile_calls(iteration, calls=3)
    busy_us = sum(e.time_range.elapsed_us() for e in events)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    se, stderr_s = timed(lambda: sysid._laplace_stderr(wl.loss_fn, fitted, 10 * wl.n_start * 12))
    peak = torch.cuda.max_memory_allocated(dev)
    out["T6_fit"] = dict(
        rows=X_tr.shape[0], starts=wl.n_start, graph_vs_eager_gaps=gaps,
        rk4_graph_vs_eager_same_bits=same, lag_history_s=lag_s,
        graph_s_20=graph_s, eager_s_20=eager_s, eager_ms_an_iteration=it_ms[len(it_ms) // 2],
        graph_ms_an_iteration=replay["replay_ms"], graph_capture_s=replay["capture_s"],
        kernel_share_of_replay=k_ms / replay["replay_ms"],
        app_fit_s=t6["sysid_s"], stderr_s=stderr_s, stderr_peak_gib=peak / 2 ** 30,
        stderr_base_gib=base / 2 ** 30, launches_an_iteration=len(events) / 3,
        eager_busy_share=busy_us / wall_us if events else None,
        iteration_device_ms=1e-3 * busy_us / 3 if events else None)
    o = out["T6_fit"]
    print(f"T6 fit: an eager iteration {o['eager_ms_an_iteration']:.2f} ms (median of 5), "
          f"{o['launches_an_iteration']:.0f} device events, busy {busy_us / 3:.1f} of "
          f"{wall_us / 3:.1f} us under the profiler = {o['eager_busy_share']}; a replay of the "
          f"kernel's iteration {o['graph_ms_an_iteration']:.4f} ms over {len(res6.losses)} "
          f"replays, the kernel {o['kernel_share_of_replay']:.3f} of it, capture "
          f"{o['graph_capture_s']:.4f} s; the app's fit {t6['sysid_s']:.3f} s with its stderrs; "
          f"the lag history {lag_s:.3f} s; stderrs "
          f"{stderr_s:.3f} s, peak {peak / 2 ** 30:.3f} GiB (base {base / 2 ** 30:.3f}) "
          f"[{card}]")
    if not all(np.array_equal(np.isinf(se[k].cpu().numpy()), np.isinf(res6.stderr[k].cpu().numpy()))
               for k in se):
        fail("the stderrs of a second call differ in their inf entries from the app's")

    # the window loss and its gradient: float32 on the card against float64
    # on the host CPU (and float32 there), at T6's start and fitted points
    t0 = time.perf_counter()
    wl64 = sysid.thruster_loss(t6["train"].X, t6["train"].U, DT, 10, input_delay=1, fit_gains=True,
                               fit_current=True, dtype=torch.float64, device=cpu)
    wl32h = sysid.thruster_loss(t6["train"].X, t6["train"].U, DT, 10, input_delay=1,
                                fit_gains=True, fit_current=True, device=cpu)

    def value_and_grad(w, point, dtype, device):
        th = {k: v.detach().to(dtype=dtype, device=device).requires_grad_(True)
              for k, v in point.items()}
        names = sorted(th)
        loss = w.loss_fn(th)
        grad = torch.autograd.grad(loss, [th[k] for k in names])
        return float(loss.detach()), torch.cat([g.reshape(-1) for g in grad]).double().cpu()

    grads = {}
    for label, point in (("start", start), ("fitted", fitted)):
        l32, g32 = value_and_grad(wl, point, torch.float32, dev)
        l32h, g32h = value_and_grad(wl32h, point, torch.float32, cpu)
        l64, g64 = value_and_grad(wl64, point, torch.float64, cpu)
        grads[label] = dict(
            loss_rel=abs(l32 - l64) / abs(l64),
            grad_rel=float(torch.linalg.norm(g32 - g64) / torch.linalg.norm(g64)),
            host_f32_grad_rel=float(torch.linalg.norm(g32h - g64) / torch.linalg.norm(g64)),
            grad_norm=float(torch.linalg.norm(g64)), loss=l64)
        if label == "start":
            start64_largest = float(g64.abs().max())
        # the window-loss kernel's gradient and autograd's (both float32 on
        # the card) against float64, max|d| over the start's largest entry
        for name, g in (("kernel", kernel_grads[label]), ("autograd", g32)):
            kernel_gaps[label][f"{name}_f64_over_start_largest"] = (
                float((g - g64).abs().max()) / start64_largest)
        print(f"sysid_window at T6's {label} point against host float64: gradient max|d| over "
              f"the start's largest entry {kernel_gaps[label]['kernel_f64_over_start_largest']:.3e}"
              f" (autograd's {kernel_gaps[label]['autograd_f64_over_start_largest']:.3e}; tol "
              f"{WINDOW_KERNEL_TOL['grad']:g})")
    if any(g["kernel_f64_over_start_largest"] > WINDOW_KERNEL_TOL["grad"]
           for g in kernel_gaps.values()):
        fail(f"the window-loss kernel's gradient is off float64: {kernel_gaps}")
    scale = grads["start"]["grad_norm"]
    for label, g in grads.items():
        g["grad_err_over_start_norm"] = g["grad_rel"] * g["grad_norm"] / scale
        print(f"T6 window loss at the {label} point: card float32 against host float64: loss rel "
              f"{g['loss_rel']:.3e}, gradient rel {g['grad_rel']:.3e} (the host's float32 "
              f"{g['host_f32_grad_rel']:.3e}), |grad| {g['grad_norm']:.3e}, the error over the "
              f"start's |grad| {g['grad_err_over_start_norm']:.3e} (rtol {FIT_F64_RTOL:g})")
    print(f"float64 and float32 on the host: {time.perf_counter() - t0:.1f} s")
    # at the fitted point the gradient is near zero, so its own relative
    # error is float32's rounding of the residuals: it is held against the
    # fit's gradient scale, the start's |grad|
    if not (all(g["loss_rel"] <= FIT_F64_RTOL for g in grads.values())
            and grads["start"]["grad_rel"] <= FIT_F64_RTOL
            and grads["fitted"]["grad_err_over_start_norm"] <= FIT_F64_RTOL):
        fail(f"the window loss or its gradient on the card is off float64: {grads}")
    out["T6_fit"]["vs_float64"] = grads

    # K2, K4 and K5 under the fitted values, both forms, against the plain versions
    X6, U6 = f32(t6["test"].X), f32(t6["test"].U)
    X3, W3 = f32(t3["test"].X), f32(t3["test"].U)
    X4, W4 = f32(t4["test"].X), f32(t4["test"].U)
    p6, c6, p5, c5 = res6.params, res6.cfg, t5["sysid"].params, t5["sysid"].cfg
    cases = {  # name: (endpoint fn, fused fn, plain endpoints, X, input) at H
        "K2 Euler, T6's fit (gains, current)": lambda H: (
            ce.make_endpoint_final_cuda(p6, c6, lag, DT, H, "euler"),
            ce.make_endpoint_sq_cuda(p6, c6, lag, DT, H, "euler"),
            lambda: ce.endpoint_final_plain(p6, c6, lag, X6, U6, DT, H, "euler"), X6, U6),
        "K2 RK4, T6's fit (gains, current)": lambda H: (
            ce.make_endpoint_final_cuda(p6, c6, lag, DT, H, "rk4"),
            ce.make_endpoint_sq_cuda(p6, c6, lag, DT, H, "rk4"),
            lambda: ce.endpoint_final_plain(p6, c6, lag, X6, U6, DT, H, "rk4"), X6, U6),
        "K2 RK4, T5's fit": lambda H: (
            ce.make_endpoint_final_cuda(p5, c5, lag, DT, H, "rk4"),
            ce.make_endpoint_sq_cuda(p5, c5, lag, DT, H, "rk4"),
            lambda: ce.endpoint_final_plain(p5, c5, lag, X6, U6, DT, H, "rk4"), X6, U6),
    }
    for app, X, W, fin, sq, pl in (
            ("T3", X3, W3, ce.make_endpoint_final_cuda_wrench, ce.make_endpoint_sq_cuda_wrench,
             ce.endpoint_final_wrench_plain),
            ("T4", X4, W4, cq.make_endpoint_final_cuda_quat, cq.make_endpoint_sq_cuda_quat,
             cq.endpoint_final_quat_plain)):
        k = "K4" if app == "T3" else "K5"
        for label, pf in ((f"{app}'s fit", {"T3": t3, "T4": t4}[app]["sysid"].params),
                          ("T6's fit (current)", p6)):
            cases[f"{k}, {label}"] = (
                lambda H, fin=fin, sq=sq, pl=pl, pf=pf, X=X, W=W: (
                    fin(pf, DT, H, "euler"), sq(pf, DT, H, "euler"),
                    lambda: pl(pf, X, W, DT, H, "euler"), X, W))
    checked = {}
    for name, make in cases.items():
        for H in H_APP[1:]:
            final_fn, sq_fn, plain, X, V = make(H)
            want = plain()
            print(f"{name}, H={H}, endpoints:", end=" ")
            e = max_err(final_fn(X, V), want, "fitted_endpoints")
            bits = {sq_fn(X, V).cpu().numpy().tobytes() for _ in range(10)}
            got, want_sq = float(sq_fn(X, V)), float(ce.endpoint_sq(want, X, H))
            close(got, want_sq, TOL["window_sq"][0], f"{name}, H={H}: fused sum vs the plain version's")
            if len(bits) != 1:
                fail(f"{name}, H={H}: ten calls gave {len(bits)} sums")
            checked[f"{name}, H={H}"] = dict(endpoint_err=e, sq_rel=abs(got - want_sq) / abs(want_sq))
    print("K2 (Euler, RK4), K4 and K5 under the fitted coefficients, gains and current agree with "
          "their plain versions; the fused sums give the same bits on ten calls")
    out["kernels_under_fitted_values"] = checked
    return out, dict(X_tr=X_tr, U_tr=U_tr, kw=kw, eager=eager, sysid_window=window_entry,
                     lag_history_launches=lag_launches)


def demo_runs(dev, card) -> dict:
    """The physics demo (``apps.demo.main``) on the card: ``euler`` and
    ``ode`` at their defaults, ``ode --bdf``, ``ode --tether`` cut to
    DEMO_TETHER_T_END; each endpoint (the ROV's 12 states; the BDF's
    position) against the same port call in float64 on the host CPU."""
    import contextlib
    import io

    from bluerov2_dynamics_tpu_torch.apps import demo

    f64 = dict(dtype=torch.float64, device="cpu")
    runs = (
        ("euler", ["euler"], lambda: demo.run_euler(**f64)),
        ("ode", ["ode"], lambda: demo.run_ode(**f64)),
        ("ode --bdf", ["ode", "--bdf"], lambda: demo.run_ode(bdf_check=True, **f64)),
        ("ode --tether", ["ode", "--tether", "--t-end", str(DEMO_TETHER_T_END)],
         lambda: demo.run_ode(t_end=DEMO_TETHER_T_END, use_tether=True, **f64)),
    )

    def bdf_end(text):
        m = re.search(r"BDF endpoint pos: \[(.*)\]", text)
        return np.array(m.group(1).split(), float)

    out = {}
    for label, argv, host in runs:
        buf, hbuf = io.StringIO(), io.StringIO()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            traj = demo.main(argv, device=dev)
        secs = time.perf_counter() - t0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(hbuf):
            ref = host()
        host_s = time.perf_counter() - t0
        lines = buf.getvalue().splitlines()
        if traj.shape != ref.shape or not np.isfinite(traj).all():
            fail(f"demo {label}: trajectory {traj.shape} (host {ref.shape}) or not finite")
        err = float(np.abs(traj[-1, :12] - ref[-1, :12]).max())
        entry = dict(seconds=secs, host_f64_seconds=host_s, steps=traj.shape[0] - 1,
                     lines=len(lines), endpoint_err=err)
        extra = ""
        if "--bdf" in argv:
            entry["bdf_err"] = float(np.abs(bdf_end(buf.getvalue()) - bdf_end(hbuf.getvalue())).max())
            extra = f"; BDF endpoint max|card - host| {entry['bdf_err']:.3e}"
        print(f"demo {label}: {secs:.3f} s on the card, {traj.shape[0] - 1} steps, {len(lines)} lines "
              f"printed (last: {lines[-1]}); float64 on the host CPU {host_s:.3f} s; the endpoint's "
              f"ROV state max|card - host| {err:.3e}{extra} (atol {DEMO_ATOL:g}) [{card}]")
        if err > DEMO_ATOL or entry.get("bdf_err", 0.0) > DEMO_ATOL:
            fail(f"demo {label}: the card's endpoint is {err} from float64 on the host")
        out[label] = entry
    return out


def estimation_runs(dev, card) -> dict:
    """State estimation on the card (``apps.estimate.main``): (a) the
    headline run on EST_STEPS rows of the pseudo recording (EKF with exact
    Jacobians, RTS, the ML noise fit on a 16 x 250 bank, the Fossen fit,
    the Koopman refit), (b) every other branch once, (c) the checks: the
    CUDA-graph step loops against the eager ones bit for bit, float32
    against float64, the MEKF's quaternion norms, the particle filter's
    determinism.  Every step loop runs as replays of CUDA graphs; the
    phase launches none of K1-K8."""
    import tempfile
    from pathlib import Path

    from bluerov2_dynamics_tpu_torch.apps import common, estimate
    from bluerov2_dynamics_tpu_torch.eval.timing import profile_calls
    from bluerov2_dynamics_tpu_torch.models import estimation as est
    from bluerov2_dynamics_tpu_torch.models import fossen
    from bluerov2_dynamics_tpu_torch.models.params import (
        fossen_params, lag_params, thruster_config)
    from bluerov2_dynamics_tpu_torch.models.thrusters import effective_wrench_history
    from bluerov2_dynamics_tpu_torch.ops import scan as scan_mod

    out = {}
    kept = []
    load = common.load_or_generate_with_truth

    def keep(*a, **k):
        t0 = time.perf_counter()
        r = load(*a, **k)
        kept.append((r, time.perf_counter() - t0))
        return r

    def run_app(argv):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rec = estimate.main(argv, device=None)
        torch.cuda.synchronize()
        return rec, time.perf_counter() - t0

    common.load_or_generate_with_truth = keep
    try:
        # (a) the headline run
        with tempfile.TemporaryDirectory() as tmp:
            path = Path(tmp) / "estimate.json"
            rec, secs = run_app(EST_HEADLINE + ["--json-out", str(path)])
            if json.loads(path.read_text()) != json.loads(json.dumps(estimate.json_sanitize(rec))):
                fail("estimation: the JSON record on disk differs from the returned one")
        (ds, X_true, delay), gen_s = kept[-1]
        fitn, rows = rec["fit_noise"], rec["rmse_vs_truth"]
        raw, ekf_all, rts_all = (rows[k]["all"] for k in ("raw sensor", "EKF", "RTS smoothed"))
        r_sig = [fitn["r_sigma_groups"][g] for g, _, _ in estimate.GROUPS]
        print(f"estimation (a) {' '.join(EST_HEADLINE)}: {secs:.1f} s on the card: generator "
              f"{gen_s:.2f} s, Fossen fit {rec['fossen_fit_s']:.2f} s, wrench history "
              f"{rec['wrench_history_s']:.3f} s, noise fit {fitn['seconds']:.2f} s (graph "
              f"capture {fitn.get('capture_s', np.nan):.2f} s, "
              f"{fitn.get('replay_ms', np.nan):.2f} ms an iteration replayed), EKF cold {rec['filter_cold_s']:.2f} s / warm "
              f"{rec['filter_warm_s']:.2f} s, RTS cold {rec['smooth_cold_s']:.2f} s / warm "
              f"{rec['smooth_warm_s']:.2f} s (warm: the call less its graph capture) [{card}]")
        print(f"estimation (a): RMSE all channels raw {raw:.6f}, EKF {ekf_all:.6f}, RTS "
              f"{rts_all:.6f} ({raw / rts_all:.2f}x below raw); mean NIS {rec['nis_mean']:.3f}, "
              f"mean NEES {rec['nees_mean']:.3f}; fitted R sigmas "
              + ", ".join(f"{g} {v:.4e}" for (g, _, _), v in zip(estimate.GROUPS, r_sig))
              + "; Koopman refit " + json.dumps(rec["koopman_refit"]))
        out["headline"] = dict(seconds=secs, generator_s=gen_s, record=rec)
        finite = [raw, ekf_all, rts_all, rec["nis_mean"], rec["nees_mean"], rec["loglik"], *r_sig,
                  *(v for d in rec["koopman_refit"].values() for v in d.values())]
        if not np.isfinite(finite).all():
            fail(f"estimation (a): a number is not finite: {finite}")
        if rts_all * EST_RTS_GAIN > raw:
            fail(f"estimation (a): RTS RMSE {rts_all} not {EST_RTS_GAIN}x below raw {raw}")
        if not EST_NIS_BAND[0] <= rec["nis_mean"] <= EST_NIS_BAND[1]:
            fail(f"estimation (a): mean NIS {rec['nis_mean']} outside {EST_NIS_BAND}")
        for (g, _, _), v, want in zip(estimate.GROUPS, r_sig, EST_R_SIGMAS):
            if abs(v / want - 1.0) > EST_R_RTOL:
                fail(f"estimation (a): fitted R sigma {g} {v} not within {EST_R_RTOL:.0%} of {want}")

        # (b) every other branch once
        branches = {}
        for label, extra in EST_BRANCHES:
            rec_b, secs_b = run_app(EST_BASE + extra)
            keys = ("loglik", "nis_mean", "ess_mean", "mhe_final_cost", "nees_mean",
                    "filter_cold_s", "filter_warm_s", "smooth_cold_s", "smooth_warm_s",
                    "quat_norm_max_dev")
            entry = {k: rec_b[k] for k in keys if k in rec_b}
            entry.update(seconds=secs_b, rows=rec_b["n_rows"], rmse_all={
                k: v["all"] for k, v in rec_b["rmse_vs_truth"].items()})
            print(f"estimation (b) {label} ({' '.join(extra)}): {secs_b:.1f} s, "
                  + json.dumps(entry) + f" [{card}]")
            if label == "mhe":
                print("estimation (b) mhe: 40 rows, cut from README's 600 for time "
                      "(21 windows of 20 Adam iterations after the first window's 400)")
            if not np.isfinite([v for v in entry.values() if isinstance(v, float)]).all():
                fail(f"estimation (b) {label}: a number is not finite")
            branches[label] = entry
        if branches.get("quat+smooth", {}).get("quat_norm_max_dev", 0.0) > EST_QUAT_ATOL:
            fail(f"estimation: MEKF quaternion norms {branches['quat+smooth']} beyond "
                 f"{EST_QUAT_ATOL} of 1")
        out["branches"] = branches
    finally:
        common.load_or_generate_with_truth = load

    # (c) the checks, on the headline recording's first rows (nominal plant,
    # the app's default noise model)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)  # noqa: E731
    p = fossen_params(device=dev)
    step = fossen.make_wrench_step(p, DT, "euler", "euler12")
    TAU = effective_wrench_history(thruster_config(device=dev), lag_params(DT, device=dev),
                                   f32(ds.U[:EST_F64_ROWS]))
    Y = f32(ds.X[:EST_F64_ROWS])
    U = TAU[delay:delay + EST_F64_ROWS - 1]
    R = f32(np.diag(np.repeat(np.asarray(EST_R_SIGMAS) ** 2, 3)))
    Q, P0 = torch.eye(12, device=dev) * 1e-6, torch.eye(12, device=dev) * 1e-2
    ident = lambda x: x  # noqa: E731
    n = EST_CHECK_STEPS
    checks = {}

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))

    ekf_args = (step, ident, Q, R, Y[0], P0, U[:n - 1], Y[:n])
    g = est.ekf(*ekf_args, graph=True)
    checks["ekf"] = same(g, est.ekf(*ekf_args, graph=False))
    sg = est.rts_smooth(step, Q, U[:n - 1], g, graph=True)
    checks["rts"] = same(sg[:2], est.rts_smooth(step, Q, U[:n - 1], g, graph=False)[:2])
    m0b, Ub, Yb = est.segment_trajectory(U[:n - 1], Y[:n], 50)
    fit_kw = dict(q0=1e-6, r0=torch.diagonal(R), steps=EST_FIT_CHECK_STEPS, lr=0.15)
    checks["fit_noise"] = same(est.fit_noise(step, ident, m0b, P0, Ub, Yb, graph=True, **fit_kw),
                               est.fit_noise(step, ident, m0b, P0, Ub, Yb, graph=False, **fit_kw))
    pf_args = (step, ident, Q * 100, R * 625, Y[0], P0, U[:n - 1], Y[:n])
    pf = est.particle_filter(*pf_args, n_particles=EST_PARTICLES, seed=SEED, graph=True)
    checks["pf"] = same(pf, est.particle_filter(*pf_args, n_particles=EST_PARTICLES, seed=SEED,
                                                graph=False))
    checks["pf_repeat"] = same(pf, est.particle_filter(*pf_args, n_particles=EST_PARTICLES,
                                                       seed=SEED, graph=True))
    resampled = int((pf.ess[:-1] < 0.5 * EST_PARTICLES).sum())
    print(f"estimation (c): graph against eager bit for bit over {n} steps (fit_noise "
          f"{EST_FIT_CHECK_STEPS} iterations of a {tuple(Yb.shape[:2])} bank): {checks}; the PF "
          f"resampled after {resampled} of {n - 1} steps")
    if not all(checks.values()) or resampled == 0:
        fail(f"estimation (c): graph against eager {checks}, PF resampling steps {resampled}")

    # launches a step and the device-busy share of a replayed chunk (EKF and
    # RTS), of the RTS pass's batched Jacobian, and of a fit_noise
    # iteration at the headline bank's 16 segments (two segment lengths:
    # an iteration's launches are linear in them)
    chunk = scan_mod.GRAPH_CHUNK

    def traced(what, replay, per):
        events, wall_us = profile_calls(replay, calls=1) if replay is not None else ([], 0.0)
        if not events:
            print(f"estimation: torch.profiler saw no device events; {what} not measured")
            return None
        busy = sum(e.time_range.elapsed_us() for e in events)
        print(f"estimation: {what}: {len(events)} device events ({len(events) / per:.1f} a "
              f"step), busy {busy:.1f} of {wall_us:.1f} us = {busy / wall_us:.4f} busy share, "
              f"{wall_us / per:.1f} us a step [{card}]")
        return dict(events=len(events), launches_per_step=len(events) / per, busy_us=busy,
                    wall_us=wall_us, busy_share=busy / wall_us)

    scan_mod.STATS["keep"] = True
    f_chunk = est.ekf(step, ident, Q, R, Y[0], P0, U[:chunk], Y[:chunk + 1])
    out["ekf_chunk"] = traced(f"one replayed EKF chunk of {chunk} steps",
                              scan_mod.STATS.pop("replay", None), chunk)
    scan_mod.STATS["keep"] = True
    est.rts_smooth(step, Q, U[:chunk], f_chunk)
    out["rts_chunk"] = traced(f"one replayed RTS chunk of {chunk} steps (the gain recursion)",
                              scan_mod.STATS.pop("replay", None), chunk)
    out["rts_jacobians"] = traced(
        f"the RTS pass's batched Jacobians of {chunk} steps (once a pass, eager)",
        lambda: est._jac(step, f_chunk.means[:-1], 12, U[:chunk]), chunk)
    fit_events = {}
    for seg in (10, 20):
        st = {"keep": True}
        m0s, Us, Ys = est.segment_trajectory(U[:16 * seg - 1], Y[:16 * seg], seg)
        est.fit_noise(step, ident, m0s, P0, Us, Ys, q0=1e-6, r0=torch.diagonal(R), steps=1,
                      stats=st)
        fit_events[seg] = traced(f"one replayed fit_noise iteration, bank 16 x {seg}",
                                 st.pop("replay", None), seg)
    if all(fit_events.values()):
        slope = (fit_events[20]["events"] - fit_events[10]["events"]) / 10
        at250 = fit_events[10]["events"] + 240 * slope
        print(f"estimation: a fit_noise iteration at the headline's 16 x 250 bank: "
              f"{at250:.0f} launches ({slope:.1f} a filter step, from the two banks above)")
        out["fit_noise_iteration"] = dict(launches_16x250=at250, launches_per_step=slope,
                                          banks=fit_events)

    # float32 against float64 on the card, EST_F64_ROWS rows
    Xt = torch.as_tensor(X_true[:EST_F64_ROWS], device=dev)
    cmp = {}
    for dtype in (torch.float32, torch.float64):
        c = lambda t: t.to(dtype)  # noqa: E731
        st = fossen.make_wrench_step(fossen_params(dtype=dtype, device=dev), DT, "euler", "euler12")
        t0 = time.perf_counter()
        f = est.ekf(st, ident, c(Q), c(R), c(Y[0]), c(P0), c(U), c(Y))
        sm = est.rts_smooth(st, c(Q), c(U), f)
        torch.cuda.synchronize()
        rm = lambda a: float(torch.sqrt(torch.mean((a.double() - Xt.double()) ** 2)))  # noqa: E731
        cmp[str(dtype)] = dict(loglik=float(f.loglik), rmse_ekf=rm(f.means), rmse_rts=rm(sm.means),
                               seconds=time.perf_counter() - t0)
    a32, a64 = cmp["torch.float32"], cmp["torch.float64"]
    rel = {k: abs(a32[k] / a64[k] - 1.0) for k in ("loglik", "rmse_ekf", "rmse_rts")}
    print(f"estimation (c): float32 against float64 on the card over {EST_F64_ROWS} rows of the "
          f"headline recording: {json.dumps(cmp)}; relative {json.dumps(rel)} (bounds "
          f"{EST_F64_RTOL}) [{card}]")
    if rel["loglik"] > EST_F64_RTOL["loglik"] or max(rel["rmse_ekf"], rel["rmse_rts"]) > \
            EST_F64_RTOL["rmse"]:
        fail(f"estimation (c): float32 parts from float64 by {rel}")
    out["checks"] = dict(graph_eager=checks, pf_resampled_steps=resampled, f32_f64=cmp,
                         f32_f64_rel=rel)
    return out


def est_bank_checks(mesh1, dev, card) -> dict:
    """``sharded_ekf_bank`` and ``sharded_pf_bank`` at world 1 on the
    one-rank group against the unsharded banks, bit for bit: 16 segments
    of 50 steps of a random-walk wrench through the Fossen plant."""
    from bluerov2_dynamics_tpu_torch.models import estimation as est
    from bluerov2_dynamics_tpu_torch.models import fossen
    from bluerov2_dynamics_tpu_torch.models.params import fossen_params
    from bluerov2_dynamics_tpu_torch.parallel import sharded

    rng = np.random.default_rng(SEED + 11)
    B, T = 16, 50
    step = fossen.make_wrench_step(fossen_params(device=dev), DT, "euler", "euler12")
    U = torch.as_tensor(np.cumsum(0.3 * rng.normal(size=(B, T - 1, 6)), axis=1),
                        dtype=torch.float32, device=dev)
    Y = torch.as_tensor(0.05 * rng.normal(size=(B, T, 12)), dtype=torch.float32, device=dev)
    m0 = Y[:, 0]
    Q, R, P0 = (torch.eye(12, device=dev) * v for v in (1e-4, 1e-3, 1e-2))
    ident = lambda x: x  # noqa: E731
    t0 = time.perf_counter()
    got = sharded.sharded_ekf_bank(mesh1, step, ident, Q, R, m0, P0, U, Y)
    want = est.ekf(step, ident, Q, R, m0, P0, U, Y, batched=True)
    ekf_same = all(torch.equal(a, b) for a, b in zip(got, want))
    got = sharded.sharded_pf_bank(mesh1, step, ident, Q, R, m0, P0, U, Y, seed=SEED,
                                  n_particles=256)
    want = est.particle_filter_bank(step, ident, Q, R, m0, P0, U, Y, seed=SEED, n_particles=256)
    pf_same = all(torch.equal(a, b) for a, b in zip(got, want))
    secs = time.perf_counter() - t0
    print(f"estimation: sharded_ekf_bank / sharded_pf_bank at world 1 ({K7_BACKEND}) against the "
          f"unsharded banks ({B} x {T} steps, PF 256 particles), bit for bit: {ekf_same} / "
          f"{pf_same}; {secs:.2f} s [{card}]")
    if not (ekf_same and pf_same):
        fail("estimation: a sharded filter bank at world 1 differs from the unsharded bank")
    return dict(ekf=ekf_same, pf=pf_same, seconds=secs)


def control_runs(dev, card) -> dict:
    """Control and guidance on the card (``apps.control_demo``): (a)
    ``all`` at the demo's default sizes (hover LQR, Koopman-LQR, trajopt);
    (b) every opt-in task once, MPC cut to CTRL_MPC_STEPS plant steps;
    (c) the checks: every CUDA-graph loop against its eager loop bit for
    bit, MPPI's repeat from one seed, float32 against float64, and the task
    claims.  The launches of one trajopt iteration, one MPPI round and one
    MPC Adam iteration are the profiler's device events of one replay.  The
    phase launches none of K1-K8."""
    from bluerov2_dynamics_tpu_torch.apps import control_demo as cd
    from bluerov2_dynamics_tpu_torch.eval.timing import profile_calls
    from bluerov2_dynamics_tpu_torch.models import control, fossen, guidance
    from bluerov2_dynamics_tpu_torch.models.params import (
        fossen_params, lag_params, thruster_config)

    out = {}

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        return r, time.perf_counter() - t0

    def traced(what, stats, key):
        replay = stats.get("replay")
        replay = replay.get(key) if isinstance(replay, dict) else replay
        events, wall_us = profile_calls(replay, calls=1) if replay is not None else ([], 0.0)
        if not events:
            print(f"control: torch.profiler saw no device events; {what} not measured")
            return None
        busy = sum(e.time_range.elapsed_us() for e in events)
        print(f"control: {what}: {len(events)} device events (launches) a replay, busy "
              f"{busy:.1f} of {wall_us:.1f} us = {busy / wall_us:.4f} busy share [{card}]")
        return dict(launches=len(events), busy_us=busy, wall_us=wall_us,
                    busy_share=busy / wall_us)

    def with_stats(name, stats):
        """``cd.<name>`` wrapped to pass ``stats`` (restored by the caller)."""
        orig = getattr(cd, name)
        setattr(cd, name, lambda **kw: orig(stats=stats, **kw))
        return orig

    # (a) brov2-control all, at the demo's default sizes, with its figure
    # where matplotlib and PIL exist (drawn after the tasks; timed apart)
    import shutil
    import tempfile
    from pathlib import Path

    st_traj = {"keep": True}
    orig = with_stats("run_waypoint", st_traj)
    media_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_control_")) if media_libraries() else None
    real_figure, render = cd.save_figure, {}

    def timed_figure(*a, **kw):
        t = time.perf_counter()
        path = real_figure(*a, **kw)
        render["all"] = time.perf_counter() - t
        return path

    cd.save_figure = timed_figure
    try:
        res, secs = timed(lambda: cd.main(
            ["all"] + (["--media-dir", str(media_dir)] if media_dir else []), device=None))
        if media_dir:
            names = sorted(q.name for q in media_dir.iterdir())
            if names != ["control_demo_2D.png"]:
                fail(f"control all: figures {names}, not the JAX app's control_demo_2D.png")
            media_file(media_dir / names[0])
            print(f"control (a) all: control_demo_2D.png drawn in {render['all']:.2f} s "
                  f"(inside the task's {secs:.1f} s) [{card}]")
            out["render_s"] = render["all"]
    finally:
        cd.run_waypoint = orig
        cd.save_figure = real_figure
        if media_dir:
            shutil.rmtree(media_dir, ignore_errors=True)
    hov, koop, way = res["hover"], res["koopman"], res["waypoint"]
    traj_it = traced("one trajopt iteration (250 x 8 plan, 250-step rollout and backward)",
                     st_traj, None)
    print(f"control (a) all: {secs:.1f} s on the card [{card}]; hover |x| "
          f"{hov['initial_norm']:.3f} -> {hov['final_norm']:.3e}; EDMDc fit {koop['fit_s']:.2f} s, "
          f"lifted Riccati ({koop['lift_dim']}-dim) {koop['lqr_s']:.2f} s, Koopman-LQR |x| "
          f"{koop['initial_norm']:.3f} -> {koop['final_norm']:.3e}; trajopt loss "
          f"{way['losses'][0]:.3e} -> {way['losses'][-1]:.3e}, terminal error "
          f"{way['terminal_error']:.3e} m, {way['seconds']:.2f} s, an iteration replayed in "
          f"{st_traj.get('replay_ms', float('nan')):.3f} ms (capture "
          f"{st_traj.get('capture_s', float('nan')):.2f} s)")
    out["all"] = dict(seconds=secs, hover={k: hov[k] for k in ("initial_norm", "final_norm")},
                      koopman={k: koop[k] for k in ("initial_norm", "final_norm", "fit_s",
                                                     "lqr_s", "lift_dim")},
                      trajopt=dict(loss_first=float(way["losses"][0]),
                                   loss_last=float(way["losses"][-1]),
                                   terminal_error=way["terminal_error"], seconds=way["seconds"],
                                   replay_ms=st_traj.get("replay_ms"),
                                   capture_s=st_traj.get("capture_s"), iteration=traj_it))
    claims = {"hover_final_norm": (hov["final_norm"], hov["final_norm"] < CTRL_HOVER_END),
              "trajopt_loss_ratio": (way["losses"][-1] / way["losses"][0],
                                     way["losses"][-1] < CTRL_TRAJOPT[0] * way["losses"][0]),
              "trajopt_terminal_error": (way["terminal_error"],
                                         way["terminal_error"] < CTRL_TRAJOPT[1])}

    # (b) every opt-in task once
    tasks = {}
    st_mppi = {"keep": True}
    orig = with_stats("run_mppi", st_mppi)
    try:
        for task in CTRL_TASKS:
            r, secs = timed(lambda: cd.main([task], device=None))
            tasks[task] = dict(r[task], wall_s=secs)
    finally:
        cd.run_mppi = orig
    print(f"control (b) mpc: {CTRL_MPC_STEPS} plant steps instead of the demo's 300, cut for "
          f"time; the plan kept at 60 x 8 with 20 Adam iterations a step and 150 initial")
    st_mpc = {"keep": True}
    r, secs = timed(lambda: cd.run_mpc(sim_steps=CTRL_MPC_STEPS, stats=st_mpc))
    tasks["mpc"] = dict(r, wall_s=secs)
    scalars = {t: {k: v for k, v in d.items() if isinstance(v, (float, int, bool))}
               for t, d in tasks.items()}
    for t, d in scalars.items():
        print(f"control (b) {t}: " + json.dumps(d, default=float) + f" [{card}]")
    mppi_round = traced("one MPPI round (512 samples x 60 steps, costs, softmax, update)",
                        st_mppi, "round")
    mpc_iter = traced("one MPC Adam iteration (60 x 8 plan, 60-step rollout and backward)",
                      st_mpc, "iteration")
    out["tasks"] = dict(scalars, mppi_round=mppi_round, mpc_iteration=mpc_iter,
                        mpc_cut=f"{CTRL_MPC_STEPS} plant steps of 300")
    radius = cd.MPPI_OBSTACLE[2]
    m, il, los = tasks["mppi"], tasks["ilqr"], tasks["los"]
    claims.update({
        "mppi_min_dist": (m["min_dist"], m["min_dist"] > CTRL_MPPI[0] * radius),
        "mppi_final_err": (m["final_err"], m["final_err"] < CTRL_MPPI[1]),
        "ilqr_feedback_ratio": (il["feedback_error"] / il["open_loop_error"],
                                il["feedback_error"] < CTRL_ILQR_GAIN * il["open_loop_error"]),
        "los_all_hit": (los["all_hit"], los["all_hit"]),
    })

    # (c) graph against eager, bit for bit, at cut sizes
    p, cfg = fossen_params(device=dev), thruster_config(device=dev)
    plant = fossen.make_thruster_step(p, cfg, lag_params(DT, device=dev), DT, "euler")
    carry = cd._carry
    get = cd._get
    zero = torch.zeros(12, device=dev)
    pol = control.fossen_lqr(p, cfg, DT)
    x_h = cd._perturbed_x0(dev)
    target = cd._state(dev, x0=1.0, x1=0.5, x2=-0.3)
    x_m = cd._state(dev, x0=1.5)
    x_c = cd._state(dev, x0=1.5, x1=0.5, x5=3.0)
    mppi_kw = dict(sim_steps=10, horizon=30, n_samples=64, sigma=0.15, init_rounds=2,
                   replan_rounds=2, effort_weight=1e-2, carry_init=carry, get_state=get,
                   seed=SEED)
    plan = guidance.make_plan([0, 0, 0], cd.LOS_WAYPOINTS, device=dev)
    runs = {
        "closed_loop": lambda g: control.simulate_closed_loop(plant, pol, carry(x_h), 100, get,
                                                              graph=g),
        "trajopt": lambda g: control.trajopt(plant, zero, target, horizon=50, steps=5,
                                             carry_init=carry, get_state=get, graph=g),
        "mppi": lambda g: control.simulate_mppi(plant, x_m, zero, graph=g, **mppi_kw),
        "mpc": lambda g: control.simulate_mpc(plant, x_c, zero, sim_steps=1, horizon=60,
                                              replan_iters=3, init_iters=2, carry_init=carry,
                                              get_state=get, graph=g),
        "lqg": lambda g: control.simulate_lqg(plant, pol, lambda x: x[:6], 1e-8, 2.5e-5,
                                              carry(x_h), 50, seed=SEED, get_state=get, graph=g),
        "los": lambda g: guidance.simulate_los_mission(plant, pol, plan, carry(zero), 200,
                                                       get_state=get, graph=g),
        "ilqr": lambda g: control.ilqr(plant, zero, target, horizon=50, iters=2,
                                       carry_init=carry, get_state=get, graph=g),
    }

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))

    checks, t0 = {}, time.perf_counter()
    for name, fn in runs.items():
        g = fn(True)
        checks[name] = same(g, fn(False))
        if name == "mppi":
            checks["mppi_repeat"] = same(g, fn(True))
    torch.cuda.synchronize()
    print(f"control (c): graph against eager bit for bit (closed loop 100 steps, trajopt 5 "
          f"iterations at H=50, MPPI 10 plant steps at 64 samples, one MPC plant step at "
          f"H=60, LQG 50 steps, LOS 200 steps, iLQR 2 sweeps at H=50) and MPPI's repeat from "
          f"one seed: {checks}; {time.perf_counter() - t0:.1f} s")
    if not all(checks.values()):
        fail(f"control (c): a graph differs from its eager loop: {checks}")

    # float32 against float64 on the card (CTRL_F64's bounds, stated before the run)
    lqr = {dt: control.fossen_lqr(fossen_params(dtype=dt, device=dev),
                                  thruster_config(dtype=dt, device=dev), DT, dtype=dt)
           for dt in (torch.float32, torch.float64)}
    K32, K64 = (lqr[dt].K.double() for dt in (torch.float32, torch.float64))
    u_at = lqr[torch.float64].u_eq
    K_same = {}
    for dt in (torch.float32, torch.float64):
        nolag = fossen.make_thruster_step(
            fossen_params(dtype=dt, device=dev), thruster_config(dtype=dt, device=dev),
            lag_params(DT, dtype=dt, device=dev), DT, "euler", use_lag=False)
        lag0 = torch.zeros((8, 3), dtype=dt, device=dev)
        A, B = control.linearize(lambda x, u: nolag((x, lag0), u)[0],
                                 torch.zeros(12, dtype=dt, device=dev), u_at.to(dt))
        K_same[dt], _ = control.dlqr(A, B, torch.eye(12, dtype=dt, device=dev),
                                     0.1 * torch.eye(8, dtype=dt, device=dev))
    f64 = {"K": float((K32 - K64).abs().max() / K64.abs().max()),
           "u_eq": float((lqr[torch.float32].u_eq.double() - u_at).abs().max()),
           "K_same_trim": float((K_same[torch.float32].double() - K_same[torch.float64]).abs().max()
                                / K_same[torch.float64].abs().max())}
    print(f"control (c): fossen_lqr float32 against float64 on the card: K relative "
          f"{f64['K']:.3e} (bound {CTRL_F64['K']:g}), u_eq max abs {f64['u_eq']:.3e} (bound "
          f"{CTRL_F64['u_eq']:g}); linearization + Riccati at the float64 trim point: K "
          f"relative {f64['K_same_trim']:.3e} (bound {CTRL_F64['K_same_trim']:g}) [{card}]")
    if any(f64[k] > CTRL_F64[k] for k in CTRL_F64):
        fail(f"control (c): float32 parts from float64: {f64}")

    claims = {k: (float(v), bool(h)) for k, (v, h) in claims.items()}
    print("control (c): task claims at the JAX package's test thresholds: " + json.dumps(
        {k: {"value": v, "holds": h} for k, (v, h) in claims.items()}))
    if not all(h for _, h in claims.values()):
        fail(f"control (c): a task claim fails on the card: {claims}")
    out["checks"] = dict(graph_eager=checks, f32_f64=f64,
                         claims={k: v for k, (v, _) in claims.items()})
    return out


def control_mesh_check(mesh1, dev, card) -> dict:
    """``simulate_mppi(mesh=...)`` at world 1 on the one-rank group against
    the unsharded call, bit for bit (the draws are the same; the minimum,
    the softmax's denominator and the weighted noise all-reduce over one
    rank)."""
    from bluerov2_dynamics_tpu_torch.models import control, fossen
    from bluerov2_dynamics_tpu_torch.models.params import (
        fossen_params, lag_params, thruster_config)

    p, cfg = fossen_params(device=dev), thruster_config(device=dev)
    plant = fossen.make_thruster_step(p, cfg, lag_params(DT, device=dev), DT, "euler")
    x0 = torch.zeros(12, device=dev)
    x0[0] = 1.5
    kw = dict(sim_steps=10, horizon=30, n_samples=64, sigma=0.15, init_rounds=2, replan_rounds=2,
              carry_init=lambda x: (x, torch.zeros((8, 3), device=dev)),
              get_state=lambda c: c[0], seed=SEED)
    t0 = time.perf_counter()
    got = control.simulate_mppi(plant, x0, torch.zeros(12, device=dev), mesh=mesh1, **kw)
    want = control.simulate_mppi(plant, x0, torch.zeros(12, device=dev), **kw)
    same = all(torch.equal(a, b) for a, b in zip(got, want))
    secs = time.perf_counter() - t0
    print(f"control: simulate_mppi with mesh= at world 1 ({K7_BACKEND}) against the unsharded "
          f"call (64 samples, 10 plant steps), bit for bit: {same}; {secs:.2f} s [{card}]")
    if not same:
        fail("control: simulate_mppi with mesh= at world 1 differs from the unsharded call")
    return dict(same=same, seconds=secs)


def koopman_apps(dev, card, drive) -> dict:
    """The Koopman apps T2 (``tank_koopman``: the pseudo recording at its
    full 45,823 steps, 500 RBFs, the Fossen baseline on K2 fused, and with
    ``--fossen-fit`` the fitted row on K2 under the fitted values; then
    ``--koopman-conv``, a 3 x 3 ``--sweep`` and ``--streaming-chunk 1024``
    on the same recording) and T1 (``sim_koopman`` at its defaults), each
    with the launch counts set to 0 before and read after, and their
    checks: the CUDA-graph generator against the eager loop bit for bit
    over its first chunks, finite data, the RMSEs against the same port
    functions in float64 on the host CPU, conv against scan, a Gram that
    is not positive definite giving a NaN model that ``select_best``
    skips, and TF32 off inside the Koopman calls."""
    from bluerov2_dynamics_tpu_torch.apps import sim_koopman, tank_koopman
    from bluerov2_dynamics_tpu_torch.data import synthetic
    from bluerov2_dynamics_tpu_torch.eval.timing import host_ms, profile_calls
    from bluerov2_dynamics_tpu_torch.models import koopman
    from bluerov2_dynamics_tpu_torch.models.params import lag_params
    from bluerov2_dynamics_tpu_torch.ops import cuda_eval as ce
    from bluerov2_dynamics_tpu_torch.ops import precision

    out, counts = {}, {}
    cpu = torch.device("cpu")
    f64 = lambda a: torch.as_tensor(a, dtype=torch.float64, device=cpu)  # noqa: E731
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)  # noqa: E731

    def eager_check(name, runs, rows):
        """The eager loop on the card over the first chunks, against the
        graph-made rows: the same bits."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sim = runs()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        for field, want in rows.items():
            got = getattr(sim, field).double().cpu().numpy()
            if not np.array_equal(got, want[:got.shape[0]]):
                fail(f"{name}: the CUDA-graph generator's {field} differs from the eager loop's "
                     f"over its first {EAGER_CHUNKS} chunks "
                     f"(max {np.abs(got - want[:got.shape[0]]).max():.3e})")
        print(f"{name}: the CUDA-graph generator equals the eager loop bit for bit over its first "
              f"{sim.X.shape[0]} steps; eager {secs:.3f} s for them ({1e3 * secs / sim.X.shape[0]:.4f}"
              f" ms a step) [{card}]")
        return secs / sim.X.shape[0]

    def host_check(app, got, model, train, test, n_rbfs, gamma, ridge):
        """The card's RMSEs against the port's functions in float64 on the
        host CPU, on the card's data and centers."""
        t0 = time.perf_counter()
        m64 = koopman.fit(None, f64(train.X), f64(train.U), n_rbfs, gamma, ridge, 0,
                          init=model.centers.double().cpu())
        Xt, Ut = f64(test.X), f64(test.U)
        rel = {}
        for H in H_APP:
            want = float(koopman.evaluate(m64, Xt, Ut) if (app == "T1" and H == 1)
                         else koopman.multistep_rmse(m64, Xt, Ut, H))
            rel[H] = abs(got[H] - want) / abs(want)
            print(f"{app} Koopman H={H}: card (float32) {got[H]:.6f}, host CPU (float64) {want:.6f}, "
                  f"rel {rel[H]:.3e} (rtol {KOOP_RTOL:g})")
            if not rel[H] <= KOOP_RTOL:
                fail(f"{app} Koopman RMSE at H={H}: {got[H]} on the card vs {want} in float64")
        print(f"{app}: float64 host check {time.perf_counter() - t0:.1f} s")
        return rel

    # --- T2 ------------------------------------------------------------------------
    t2 = drive("T2 app (tank_koopman.main --fossen-fit)", ("window_sq",),
               lambda: tank_koopman.main(T2_ARGS + T2_FIT, device=dev), into=counts)
    # each horizon's nominal and fitted call is timed cold and warm: one launch a call
    if counts["window_sq"] != 4 * len(H_APP):
        fail(f"T2 app: {counts['window_sq']} K2 launches, not one a call of the Fossen rows "
             f"(nominal and fitted, 3 horizons, cold and warm)")
    train, test = t2["train"], t2["test"]
    for part in (train, test):
        if not (np.isfinite(part.X).all() and np.isfinite(part.U).all()):
            fail("T2: the generated recording is not finite")
    if test.X.shape != (N_REC, 12) or train.X.shape != (T2_STEPS - N_REC, 12):
        fail(f"T2 split {train.X.shape} / {test.X.shape}")
    n_eager = EAGER_CHUNKS * synthetic.GRAPH_CHUNK
    draws = synthetic.tank_recording_draws(0, T2_STEPS)
    first = {k: (v[:n_eager] if v.dim() == 2 else v) for k, v in draws.items()}
    eager_step = eager_check("T2 generator", lambda: synthetic.generate_tank_recording_from_draws(
        first, dt=DT, device=dev, graph=False), {"X": train.X, "U": train.U})
    # device events a step of the generator (the profiler, eager 1 and 11 steps)
    n_events = [len(profile_calls(lambda: synthetic.generate_tank_recording_from_draws(
        {k: (v[:n] if v.dim() == 2 else v) for k, v in draws.items()}, dt=DT, device=dev,
        graph=False), calls=1)[0]) for n in (1, 11)]
    kernels_a_step = (n_events[1] - n_events[0]) / 10 if n_events[0] else None
    print(f"T2 generator: {kernels_a_step} device events a step (the profiler: {n_events} for 1 "
          f"and 11 eager steps)")
    model = t2["model"]
    rmse = {H: t2["rmse"]["Koopman"][H] for H in H_APP}
    rel = host_check("T2", rmse, model, train, test, 500, 3.0, 0.1)
    X_te, U_te = f32(test.X), f32(test.U)
    res2, lag = t2["sysid"], lag_params(DT, device=dev)
    fit2 = fitted_row("T2", t2, lambda X, U, H: ce.window_sq_plain(
        res2.params, res2.cfg, lag, X, U, DT, H, "euler"), X_te, U_te, "Fossen (BlueROV2)", card)
    ms = {"scan": {}, "conv": {}}
    for H in H_APP:
        conv = float(koopman.multistep_rmse(model, X_te, U_te, H, method="conv"))
        close(conv, rmse[H], CONV_RTOL, f"T2 Koopman H={H}: conv vs scan on the card")
        for method in ms:
            t = host_ms(lambda: koopman.multistep_rmse(model, X_te, U_te, H, method=method),
                        calls=5)
            ms[method][H] = sorted(t)[len(t) // 2]
    print("T2 multistep_rmse, median of 5 synchronised calls, ms: " + "; ".join(
        f"{m} " + ", ".join(f"H={H} {v:.4f}" for H, v in d.items()) for m, d in ms.items())
        + f" [{card}]")
    # TF32 on at the caller: the Koopman calls pin it off and restore it
    prev = (torch.get_float32_matmul_precision(), torch.backends.cuda.matmul.allow_tf32)
    seen, real_rmse = [], koopman.rmse
    try:
        torch.set_float32_matmul_precision("high")
        torch.backends.cuda.matmul.allow_tf32 = True
        Z = koopman.lift(model, X_te)
        tf32_moves = float((Z @ model.A.T - (Z.double() @ model.A.double().T).float()).abs().max())
        koopman.rmse = lambda a, b: (seen.append(precision.tf32_enabled()), real_rmse(a, b))[1]
        under = float(koopman.multistep_rmse(model, X_te, U_te, 10))
        restored = precision.tf32_enabled()
    finally:
        koopman.rmse = real_rmse
        torch.set_float32_matmul_precision(prev[0])
        torch.backends.cuda.matmul.allow_tf32 = prev[1]
    with precision.full_f32():
        Zf = koopman.lift(model, X_te)
        f32_err = float((Zf @ model.A.T - (Zf.double() @ model.A.double().T).float()).abs().max())
    print(f"TF32: inside multistep_rmse tf32_enabled() = {seen}, after it {restored}; H=10 with "
          f"the caller's TF32 on {under:.9g} vs {rmse[10]:.9g}; one Z @ A^T against float64: "
          f"{tf32_moves:.3e} with TF32, {f32_err:.3e} in full float32")
    if seen != [False] or not restored or under != rmse[10]:
        fail("TF32 was not pinned off inside the Koopman call, or not restored after it")
    # a Gram that is not positive definite: NaN model, skipped by select_best
    k_nan = 64
    Xs, Us = f32(train.X[:4096]), f32(train.U[:4096])
    models, combos = koopman.fit_sweep(None, Xs, Us, k_nan, (3.0,), (0.1, -1e6), 0,
                                       init=model.centers[:k_nan])
    best, combo, rm = koopman.select_best(models, combos, X_te, U_te, 10)
    nan_rows = torch.isnan(models.A).reshape(2, -1).all(1).tolist()
    print(f"NaN guard on the card: ridges (0.1, -1e6) -> NaN models {nan_rows}, RMSEs "
          f"{rm.tolist()}, select_best keeps ridge {float(combo[1]):g}")
    if nan_rows != [False, True] or not torch.equal(combo, combos[0]) or not bool(torch.isnan(rm[1])):
        fail("a Gram that is not positive definite did not give a NaN model skipped by select_best")
    runs = {}
    for label, extra in (("conv", ["--koopman-conv"]), ("sweep", SWEEP_ARGS),
                         ("streaming", ["--streaming-chunk", "1024"])):
        r = drive(f"T2 app {label}", ("window_sq",),
                  lambda: tank_koopman.main(T2_ARGS + ["--steps", str(T2_RERUN_STEPS)] + extra,
                                            device=dev), into={})
        runs[label] = dict(rmse=r["rmse"]["Koopman"], fit_s=r["fit_s"], data_s=r["data_s"])
        if not all(np.isfinite(v) for v in r["rmse"]["Koopman"].values()):
            fail(f"T2 {label}: a Koopman RMSE is not finite")
    out["T2"] = dict(
        steps=T2_STEPS, data_s=t2["data_s"], graph_ms_a_step=1e3 * t2["data_s"] / T2_STEPS,
        eager_ms_a_step=1e3 * eager_step, kernels_a_step=kernels_a_step, fit_s=t2["fit_s"],
        rmse=rmse,
        fossen_rmse=t2["rmse"]["Fossen (BlueROV2)"], warm_s=t2["warm_s"], cold_s=t2["cold_s"],
        rel_vs_float64=rel, multistep_ms=ms, k2_launches=counts["window_sq"], runs=runs,
        tf32_matmul_err=tf32_moves, f32_matmul_err=f32_err, sysid=fit2)
    print(f"T2: generator (graph) {t2['data_s']:.2f} s for {T2_STEPS} steps, eager "
          f"{1e3 * eager_step:.4f} ms a step; fit cold {t2['fit_s'][0]:.3f} / warm "
          f"{t2['fit_s'][1]:.3f} s; sweep 3x3 cold {runs['sweep']['fit_s'][0]:.3f} / warm "
          f"{runs['sweep']['fit_s'][1]:.3f} s; streaming cold {runs['streaming']['fit_s'][0]:.3f}"
          f" / warm {runs['streaming']['fit_s'][1]:.3f} s [{card}]")

    # --- T1 ------------------------------------------------------------------------
    t1 = sim_koopman.main(T1_ARGS, device=dev)
    tr1, te1 = t1["train"], t1["test"]
    if not (np.isfinite(tr1.X).all() and np.isfinite(te1.X).all()):
        fail("T1: the generated dataset is not finite")
    sim_draws = synthetic.sim_dataset_draws(0, 48_000)
    eager1 = eager_check("T1 generator", lambda: synthetic.generate_sim_dataset_from_draws(
        {k: v[:n_eager] for k, v in sim_draws.items()}, dt=0.05, device=dev, graph=False),
        {"X": tr1.X, "U": tr1.U})
    rel1 = host_check("T1", t1["rmse"], t1["model"], tr1, te1, 200, 1.0, 1e-3)
    out["T1"] = dict(steps=48_000, data_s=t1["data_s"], graph_ms_a_step=1e3 * t1["data_s"] / 48_000,
                     eager_ms_a_step=1e3 * eager1, fit_s=t1["fit_s"], rmse=t1["rmse"],
                     rel_vs_float64=rel1)
    print(f"T1: generator (graph) {t1['data_s']:.2f} s for 48000 steps, eager {1e3 * eager1:.4f} "
          f"ms a step; fit {t1['fit_s']:.3f} s (one cold fit) [{card}]")
    return out


def learned_apps(dev, card, drive) -> dict:
    """The learned-model apps, each with the launch counts set to 0 before
    and read after: T6 (``tank_full_comparison``) on the pseudo recording
    at 45,823 steps with a copy of the committed PINc checkpoint (its
    sidecar turns the position mask on), ``--pinc-psi-ssa`` and
    ``--json-out``, the Fossen row on K2 Euler; T5 (``tank_rk4``) the same
    with K2 RK4; T3 and T4 at 20,000 steps (K4, K5); each with its Fossen
    fit (T6 with stderrs, gains and current) and fitted row, checked by
    :func:`fitted_row` and :func:`fit_checks`.  Checked: the Fossen
    rows against the plain versions on the card, the DI and PINc RMSEs
    against the same port functions in float64 on the host CPU (the card's
    gains and weights), the committed PINc's forward against float64, the
    JSON record.  Then PINc trains from scratch on T6's training split at
    the flagship batch for a few epochs: seconds an epoch, finite losses,
    the device-busy share of its minibatch steps and of the PINc endpoint,
    and the saved checkpoint reloading with the same bits.  Returns the
    JSON summary and the context of phase 6's ``mesh=`` check."""
    import shutil
    import tempfile
    from pathlib import Path

    from bluerov2_dynamics_tpu_torch import convert
    from bluerov2_dynamics_tpu_torch.apps import (
        tank_full_comparison, tank_rk4, tank_wrench_comp, tank_wrench_quat)
    from bluerov2_dynamics_tpu_torch.eval import metrics
    from bluerov2_dynamics_tpu_torch.eval.timing import profile_calls
    from bluerov2_dynamics_tpu_torch.models import di, pinc
    from bluerov2_dynamics_tpu_torch.models.params import (
        fossen_params, lag_params, reduced_params, thruster_config)
    from bluerov2_dynamics_tpu_torch.ops import cuda_eval as ce
    from bluerov2_dynamics_tpu_torch.ops import cuda_quat as cq
    from bluerov2_dynamics_tpu_torch.utils.checkpoint import load_pytree, save_pytree

    cpu = torch.device("cpu")
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)  # noqa: E731
    f64 = lambda a: torch.as_tensor(a, dtype=torch.float64, device=cpu)  # noqa: E731
    p = fossen_params(device=dev)
    cfg, lag = thruster_config(device=dev), lag_params(DT, device=dev)
    out = {}

    def busy_share(fn, what, calls=1):
        dev_events, wall_us = profile_calls(fn, calls)
        if not dev_events:
            print(f"{what}: torch.profiler saw no device events; busy share not measured")
            return None
        busy = sum(e.time_range.elapsed_us() for e in dev_events)
        share = busy / wall_us
        print(f"{what}: {len(dev_events) / calls:.0f} device events a call, busy {busy / calls:.1f} "
              f"of {wall_us / calls:.1f} us = {share:.4f} busy share [{card}]")
        return dict(events_a_call=len(dev_events) / calls, busy_us=busy / calls,
                    wall_us=wall_us / calls, share=share)

    def di_vs_float64(app, run, variant):
        """The card's DI RMSEs against float64 on the host CPU, the card's gains."""
        gains = di.DIGains(*(g.double().cpu() for g in run["gains"]))
        step = {"euler12": di.make_step_euler12, "euler12_rk4": di.make_step_euler12_rk4,
                "quat13": di.make_step_quat13}[variant](gains, DT)
        X, U = f64(run["test"].X), f64(run["test"].U)
        rel = {}
        for H in H_APP:
            want = float(metrics.endpoint_rmse(step, X, U, H))
            got = run["rmse"][di_name[app]][H]
            rel[H] = abs(got - want) / abs(want)
            close(got, want, DI_RTOL, f"{app} DI H={H} (card float32 vs host float64)")
        return rel

    name_of = {"T6": "Fossen (BlueROV2)", "T5": "Fossen (BlueROV2)", "T3": "Fossen (wrench)",
               "T4": "Fossen (quat)"}
    di_name = {"T6": "Double Integrator", "T5": "Double Integrator", "T3": "Double Integrator",
               "T4": "DI (quat)"}

    def app_entry(run, seconds=None, launches=None):
        return dict(seconds=seconds, launches=launches, rmse=run["rmse"], warm_s=run["warm_s"],
                    cold_s=run["cold_s"], fit_s=run["fit_s"])

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        ckpt = tmp / "pinc_best.msgpack"
        models = Path(__file__).resolve().parent / "models"
        for name in ("pinc_best.msgpack", "pinc_best.msgpack.json"):
            shutil.copy(models / name, tmp / name)
        record = tmp / "t6.json"
        t0 = time.perf_counter()
        counts = {}
        t6 = drive("T6 app (tank_full_comparison.main, the Fossen fit with stderrs, gains and "
                   "current)", ("window_sq",),
                   lambda: tank_full_comparison.main(
                       LEARNED_ARGS + T6_FIT + ["--pinc-ckpt", str(ckpt), "--json-out", str(record)],
                       device=dev), into=counts)
        t6_s = time.perf_counter() - t0
        if counts["window_sq"] != 4 * len(H_APP):
            fail(f"T6 app: {counts['window_sq']} K2 launches, not one a call of the Fossen rows "
                 f"(nominal and fitted)")
        net = t6["net"]
        if not (net.position_invariant and net.hidden == (64, 64, 64, 64)
                and net.norm_mu is not None and np.any(net.norm_mu != 0)):
            fail("T6: the committed checkpoint's sidecar (position mask, normalisation) was "
                 "not honoured")
        rec = json.loads(record.read_text())
        if rec["backend"] != dev.type or set(rec["rmse"]) != set(t6["rmse"]):
            fail(f"T6: the JSON record is not the run's: {rec}")
        for name, row in t6["rmse"].items():
            if not all(np.isfinite(v) for v in row.values()):
                fail(f"T6 {name}: an RMSE is not finite: {row}")
        fossen_rel = {"T6": fossen_vs_plain(
            "T6", t6, name_of["T6"],
            lambda X, U, H: ce.window_sq_plain(p, cfg, lag, X, U, DT, H, "euler"),
            f32(t6["test"].X), f32(t6["test"].U))}
        di_rel = {"T6": di_vs_float64("T6", t6, "euler12")}
        # the fit: its row against the plain version and below the nominal one,
        # its stderrs inf exactly at the zero-nominal scales, its rollout
        res6 = t6["sysid"]
        fits = {"T6": fitted_row("T6", t6, lambda X, U, H: ce.window_sq_plain(
            res6.params, res6.cfg, lag, X, U, DT, H, "euler"), f32(t6["test"].X),
            f32(t6["test"].U), "Fossen (BlueROV2)", card)}
        for H in H_APP[1:]:
            fitted, nominal = t6["rmse"]["Fossen (fitted)"][H], t6["rmse"]["Fossen (BlueROV2)"][H]
            print(f"T6 H={H}: Fossen (fitted) {fitted:.6f} against the nominal {nominal:.6f}")
            if not fitted < nominal:
                fail(f"T6 H={H}: the fitted row {fitted} is not below the nominal {nominal}")
        se = {k: v.cpu().numpy() for k, v in res6.stderr.items()}
        print(f"T6 stderrs: s {np.round(se['s'], 6).tolist()}, gains {np.round(se['g'], 6).tolist()},"
              f" current {np.round(se['c'], 6).tolist()}; fitted current {res6.current.tolist()}")
        if (tuple(np.flatnonzero(np.isinf(se["s"]))) != ZERO_NOMINAL
                or not all(np.isfinite(np.delete(se["s"], ZERO_NOMINAL)).all()
                           and np.isfinite(se[k]).all() for k in ("g", "c"))):
            fail(f"T6 stderrs: inf at {np.flatnonzero(~np.isfinite(se['s']))}, not exactly at "
                 f"{ZERO_NOMINAL}")
        fits["T6"].update(stderr={k: v.tolist() for k, v in se.items()},
                          rollout_s=t6["rollout_s"]["Fossen (fitted)"])
        if not np.isfinite(t6["trajs"]["FOSSEN (fitted)"]).all():
            fail("T6: the fitted open-loop rollout is not finite")

        # PINc: the card's RMSEs and the committed net's forward against float64 on the host
        t0 = time.perf_counter()
        net64 = convert.pinc_params_from_numpy(
            convert.pinc_params_to_numpy(net), net.norm_mu, net.norm_sigma, net.hidden,
            position_invariant=net.position_invariant, dtype=torch.float64, device=cpu)
        X64, U64 = f64(t6["test"].X), f64(t6["test"].U)
        U4_64 = pinc.wrench4_from_thrusters(thruster_config(dtype=torch.float64, device=cpu),
                                            lag_params(DT, dtype=torch.float64, device=cpu), U64)
        pinc_rel = {}
        for name, mode in (("PINc (ResDNN)", "raw"), ("PINc (ssa psi)", "ssa")):
            for H in H_APP:
                want = float(pinc.endpoint_rmse(net64, X64, U4_64, DT, H, mode))
                got = t6["rmse"][name][H]
                pinc_rel[f"{mode} H={H}"] = abs(got - want) / abs(want)
                close(got, want, PINC_RTOL, f"T6 {name} H={H} (card float32 vs host float64)")
        z64 = torch.cat([pinc.state12_to_9(X64[:-1]), U4_64[:-1],
                         torch.full((len(X64) - 1, 1), DT, dtype=torch.float64)], dim=1)
        with torch.no_grad():
            fwd = net(z64.float().to(dev)).double().cpu()
            fwd64 = net64(z64)
        fwd_err = float((fwd - fwd64).abs().max())
        print(f"T6 PINc forward on {len(z64)} rows: max|card float32 - host float64| "
              f"{fwd_err:.3e} on outputs up to {float(fwd64.abs().max()):.3g} "
              f"(atol {PINC_FWD_ATOL:g}); host float64 checks {time.perf_counter() - t0:.1f} s")
        if not fwd_err <= PINC_FWD_ATOL:
            fail(f"T6 PINc forward: {fwd_err} from float64")
        X_te, U4_te = f32(t6["test"].X), pinc.wrench4_from_thrusters(cfg, lag, f32(t6["test"].U))
        endpoint_busy = busy_share(
            lambda: pinc.endpoint_rmse(net, X_te, U4_te, DT, H_APP[-1]),
            f"PINc endpoint H={H_APP[-1]} over {len(X_te) - H_APP[-1]} starts")

        # T5: T5_STEPS steps of the same generator and the checkpoint under RK4 (K2's RK4 form)
        counts5 = {}
        t5 = drive("T5 app (tank_rk4.main --fossen-fit)", ("window_sq",),
                   lambda: tank_rk4.main(LEARNED_ARGS + ["--steps", str(T5_STEPS)] + T5_FIT
                                         + ["--pinc-ckpt", str(ckpt)], device=dev), into=counts5)
        if counts5["window_sq"] != 4 * len(H_APP):
            fail(f"T5 app: {counts5['window_sq']} K2 launches, not one a call of the Fossen rows")
        fossen_rel["T5"] = fossen_vs_plain(
            "T5", t5, name_of["T5"],
            lambda X, U, H: ce.window_sq_plain(p, cfg, lag, X, U, DT, H, "rk4"),
            f32(t5["test"].X), f32(t5["test"].U))
        res5 = t5["sysid"]
        fits["T5"] = fitted_row("T5", t5, lambda X, U, H: ce.window_sq_plain(
            res5.params, res5.cfg, lag, X, U, DT, H, "rk4"), f32(t5["test"].X),
            f32(t5["test"].U), "Fossen (BlueROV2)", card)
        di_rel["T5"] = di_vs_float64("T5", t5, "euler12_rk4")

        # T3 and T4: Koopman, Fossen (K4 / K5) and DI on the wrench recording
        runs34, sq_plain = {}, {"T3": ce.window_sq_wrench_plain, "T4": cq.window_sq_quat_plain}
        for app, main, kname, fit_args, variant in (
                ("T3", tank_wrench_comp.main, "window_sq_wrench", T3_FIT, "euler12"),
                ("T4", tank_wrench_quat.main, "window_sq_quat", T4_FIT, "quat13")):
            plain = lambda X, U, H, app=app: sq_plain[app](p, X, U, DT, H, "euler")  # noqa: E731
            c = {}
            t0 = time.perf_counter()
            r = drive(f"{app} app ({main.__module__.rsplit('.', 1)[1]}.main "
                      f"{' '.join(fit_args)})", (kname,),
                      lambda main=main, fit_args=fit_args: main(T34_ARGS + fit_args, device=dev),
                      into=c)
            secs = time.perf_counter() - t0
            if c[kname] != 4 * len(H_APP):
                fail(f"{app} app: {c[kname]} {kname} launches, not one a call of the Fossen rows")
            fits[app] = fitted_row(app, r, lambda X, U, H, app=app, res=r["sysid"]: sq_plain[app](
                res.params, X, U, DT, H, "euler"), f32(r["test"].X), f32(r["test"].U),
                name_of[app], card)
            runs34[app + "_run"] = r
            for name, row in r["rmse"].items():
                if not all(np.isfinite(v) for v in row.values()):
                    fail(f"{app} {name}: an RMSE is not finite: {row}")
            fossen_rel[app] = fossen_vs_plain(app, r, name_of[app], plain, f32(r["test"].X),
                                              f32(r["test"].U))
            di_rel[app] = di_vs_float64(app, r, variant)
            runs34[app] = app_entry(r, secs, c[kname])

        fit_summary, fit_ctx = fit_checks(dev, card, t6, t5, runs34.pop("T3_run"),
                                          runs34.pop("T4_run"))
        fits.update(fit_summary)

        # PINc training from scratch at the flagship batch on T6's training split
        X_tr, U_tr = f32(t6["train"].X), f32(t6["train"].U)
        data = pinc.make_dataset(X_tr, U_tr, DT, cfg, lag)
        tc = pinc.TrainConfig(epochs=TRAIN_EPOCHS, normalize=True, position_invariant=True,
                              lr_schedule="cosine")
        gen = torch.Generator(dev).manual_seed(SEED + 1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trained, hist = pinc.train(gen, data, tc)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        n_batches = len(data.z) // tc.batch
        print(f"PINc training: {TRAIN_EPOCHS} epochs of {n_batches} minibatches (batch "
              f"{tc.batch}, rollout {tc.rollout_steps} x {tc.rollout_windows}) in {train_s:.2f} s "
              f"= {train_s / TRAIN_EPOCHS:.3f} s an epoch, losses {hist} [{card}]")
        if len(hist) != TRAIN_EPOCHS or not np.isfinite(hist).all():
            fail(f"PINc training: losses {hist}")
        perm, starts = pinc.epoch_draws(gen, len(data.z), n_batches, tc.batch, tc)
        opt = pinc.make_optimizer(tc, trained.parameters(), total_steps=n_batches)
        k = TRAIN_PROFILE_STEPS
        rp = reduced_params(device=dev)
        step_busy = busy_share(
            lambda: pinc.train_epoch(trained, opt, data, perm[:k], starts[:k], tc, rp, True),
            f"PINc training, {k} minibatch steps", calls=1)
        saved = tmp / "trained.msgpack"
        save_pytree(saved, {"params": convert.pinc_params_to_numpy(trained),
                            "norm_mu": trained.norm_mu, "norm_sigma": trained.norm_sigma})
        tree = load_pytree(saved)
        back = convert.pinc_params_from_numpy(tree["params"], tree["norm_mu"], tree["norm_sigma"],
                                              trained.hidden, position_invariant=True, device=dev)
        same = all(torch.equal(a, b) for a, b in zip(trained.state_dict().values(),
                                                     back.state_dict().values()))
        print(f"PINc checkpoint: {saved.stat().st_size} bytes, reloads with the same bits: {same}")
        if not same or not np.array_equal(tree["norm_mu"], trained.norm_mu):
            fail("the trained PINc checkpoint did not reload with the same bits")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    out["T6"] = dict(app_entry(t6, t6_s, counts["window_sq"]), data_s=t6["data_s"],
                     rollout_s=t6["rollout_s"], pinc_fwd_err_vs_float64=fwd_err,
                     pinc_endpoint_busy=endpoint_busy)
    out["T5"] = dict(app_entry(t5, None, counts5["window_sq"]), data_s=t5["data_s"],
                     rollout_s=t5["rollout_s"])
    out.update(runs34)
    out["rel_vs_float64"] = {"pinc": pinc_rel, "di": di_rel}
    out["fossen_rel_vs_plain"] = fossen_rel
    out["sysid"] = fits
    out["training"] = dict(epochs=TRAIN_EPOCHS, minibatches=n_batches, seconds=train_s,
                           s_an_epoch=train_s / TRAIN_EPOCHS, losses=hist,
                           step_busy=step_busy, reload_same_bits=same)
    print(f"T6: {t6_s:.1f} s in all (recording {t6['data_s']:.2f} s); T5 data {t5['data_s']:.2f} "
          f"s; T3 {runs34['T3']['seconds']:.1f} s, T4 {runs34['T4']['seconds']:.1f} s [{card}]")
    return out, fit_ctx


def recording_bag(bag_dir, X, U, stamps):
    """A rosbag2 sqlite3 recording of the generator's states and commands:
    each row an Odometry (position, the Euler angles as a quaternion, body
    twists, child frame ``base_link``) and an ActuatorMotors (the 8
    commands, then 4 NaN), both at ``stamps``.  Returns the messages'
    blobs by topic."""
    from bluerov2_dynamics_tpu_torch.data import bag_sqlite, cdr
    from bluerov2_dynamics_tpu_torch.data.bag2csv import BagTopics
    from bluerov2_dynamics_tpu_torch.data.csv_loader import euler_to_quat_np

    topics = BagTopics()
    q = euler_to_quat_np(X[:, 3], X[:, 4], X[:, 5])
    q_xyzw = np.concatenate([q[:, 1:4], q[:, 0:1]], axis=1).tolist()
    Xl, nan4 = X.tolist(), [float("nan")] * 4
    odom = [cdr.encode_odometry(x[0:3], qk, x[6:9], x[9:12], child_frame_id="base_link",
                                sec=int(ts // 10**9), nanosec=int(ts % 10**9))
            for x, qk, ts in zip(Xl, q_xyzw, stamps.tolist())]
    motors = [cdr.encode_actuator_motors(u + nan4, timestamp=int(ts // 1000))
              for u, ts in zip(U.tolist(), stamps.tolist())]
    bag_sqlite.write_bag_sqlite(bag_dir, {
        topics.mocap_odom: ("nav_msgs/msg/Odometry", stamps, odom),
        topics.px4_motors: ("px4_msgs/msg/ActuatorMotors", stamps, motors)})
    return {"odom": odom, "motors": motors}


def ingest_runs(dev, card, drive) -> dict:
    """The host data path on the card's machine, end to end: its host
    libraries and compiler, the native decoder's build; a rosbag2
    recording of the real manual bag's length written from the generator's
    states on the card; ``bag2csv`` through its CLI with pandas
    unimportable, every topic through the native decoder; then T2, T6,
    T3 and T4 on that CSV, each through ``drive`` (K2, K2, K4, K5) and
    each Fossen row against its plain version, T6's fitted row too
    (:func:`fitted_row`); T6's figures where matplotlib and PIL exist.
    Checked: native = the Python codec bit for bit, the CSV's states
    against a numpy mean of the generator's states in each 20 ms bin,
    ``sanity.run_all``, each figure's signature and frame count.  Returns
    the ``ingest:`` JSON line's numbers."""
    import importlib.util
    import shutil
    import tempfile
    from pathlib import Path

    from bluerov2_dynamics_tpu_torch.apps import (
        tank_full_comparison, tank_koopman, tank_wrench_comp, tank_wrench_quat)
    from bluerov2_dynamics_tpu_torch.data import bag2csv, bag_sqlite, cdr, csv_loader
    from bluerov2_dynamics_tpu_torch.data import native_cdr, sanity
    from bluerov2_dynamics_tpu_torch.data import table as tb
    from bluerov2_dynamics_tpu_torch.data.synthetic import generate_tank_recording
    from bluerov2_dynamics_tpu_torch.data.wrench import augment_csv
    from bluerov2_dynamics_tpu_torch.models.params import (
        fossen_params, lag_params, thruster_config)
    from bluerov2_dynamics_tpu_torch.ops import cuda_eval as ce
    from bluerov2_dynamics_tpu_torch.ops import cuda_quat as cq

    out = {"card": card}
    # 1. the host side
    libs = {m: importlib.util.find_spec(m) is not None
            for m in ("pandas", "matplotlib", "PIL", "pyarrow")}
    gxx = subprocess.run(["g++", "--version"], capture_output=True, text=True, timeout=60)
    gxx = gxx.stdout.splitlines()[0] if gxx.returncode == 0 and gxx.stdout else "absent"
    t0 = time.perf_counter()
    if not native_cdr.available():
        fail("the native CDR decoder did not build")
    build_s = time.perf_counter() - t0
    print(f"ingest host: importable {libs}; g++: {gxx}; native decoder built and loaded in "
          f"{build_s:.2f} s ({native_cdr.library_path().name})")
    out.update(host_libraries=libs, gxx=gxx, native_build_s=build_s)
    media = media_libraries()
    if not media:
        print("media: matplotlib or PIL is absent on this machine: the figures are not drawn "
              "here (the CPU tests hold them); the kernels of this path still run and are "
              "checked")

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_ingest_"))
    saved_pandas = sys.modules.get("pandas", None)
    try:
        # 2. the recording, and its bag
        t0 = time.perf_counter()
        rec = generate_tank_recording(SEED, n_steps=INGEST_STEPS, dt=INGEST_DT, device=dev)
        X = rec.X.double().cpu().numpy()
        U = rec.U.double().cpu().numpy()
        gen_s = time.perf_counter() - t0
        rng = np.random.default_rng(SEED + 13)
        jitter = rng.integers(1_000_000, 4_000_000, INGEST_STEPS)
        jitter[0] = 0
        stamps = INGEST_T0_NS + np.arange(INGEST_STEPS, dtype=np.int64) * 10_000_000 + jitter
        t0 = time.perf_counter()
        bag = tmp / "rosbag2_manual_pseudo"
        blobs = recording_bag(bag, X, U, stamps)
        bag_s = time.perf_counter() - t0
        n_msgs = sum(len(v) for v in blobs.values())
        bag_mb = sum(f.stat().st_size for f in bag.iterdir()) / 1e6
        print(f"ingest bag: {INGEST_STEPS} steps generated on the card in {gen_s:.2f} s; "
              f"{n_msgs} messages ({(stamps[-1] - stamps[0]) / 1e9:.2f} s of recording) written "
              f"in {bag_s:.2f} s, {bag_mb:.1f} MB")
        out.update(steps=INGEST_STEPS, messages=n_msgs, bag_mb=bag_mb, generator_s=gen_s,
                   bag_write_s=bag_s, duration_s=(stamps[-1] - stamps[0]) / 1e9)

        # decode rates: the native batch decoders on every message, the
        # per-message Python codec on INGEST_PY_MSGS (best of 3, as bench.py)
        def best_of(fn, reps=3):
            best = float("inf")
            for _ in range(reps):
                t = time.perf_counter()
                fn()
                best = min(best, time.perf_counter() - t)
            return best

        t_nat = best_of(lambda: (native_cdr.decode_odometry_batch(blobs["odom"]),
                                 native_cdr.decode_actuator_motors_batch(blobs["motors"])))
        half = INGEST_PY_MSGS // 2
        t_py = best_of(lambda: ([cdr.decode_odometry(b) for b in blobs["odom"][:half]],
                                [cdr.decode_actuator_motors(b) for b in blobs["motors"][:half]]))
        rates = {"native": n_msgs / t_nat, "python": 2 * half / t_py}
        print(f"ingest decode: native {rates['native']:.4g} msgs/s ({n_msgs} messages), "
              f"Python codec {rates['python']:.4g} msgs/s ({2 * half} messages), "
              f"{rates['native'] / rates['python']:.1f}x")
        out["decode_msgs_per_s"] = rates
        # native = the Python codec, bit for bit
        k = INGEST_CHECK_MSGS // 2
        f_nat, flags = native_cdr.decode_odometry_batch(blobs["odom"][:k])
        f_py = np.array([[m.pose.pose.position.x, m.pose.pose.position.y, m.pose.pose.position.z,
                          m.pose.pose.orientation.x, m.pose.pose.orientation.y,
                          m.pose.pose.orientation.z, m.pose.pose.orientation.w,
                          m.twist.twist.linear.x, m.twist.twist.linear.y,
                          m.twist.twist.linear.z, m.twist.twist.angular.x,
                          m.twist.twist.angular.y, m.twist.twist.angular.z]
                         for m in map(cdr.decode_odometry, blobs["odom"][:k])])
        m_nat = native_cdr.decode_actuator_motors_batch(blobs["motors"][:k])
        m_py = np.array([cdr.decode_actuator_motors(b).control[:8]
                         for b in blobs["motors"][:k]], np.float32)
        if not (np.array_equal(f_nat.view(np.int64), f_py.view(np.int64)) and flags.all()
                and np.array_equal(m_nat.view(np.int32), m_py.view(np.int32))):
            fail(f"native and Python decoding differ on the first {2 * k} messages")
        print(f"ingest decode: native = Python codec bit for bit on {2 * k} messages")

        # 3. bag2csv through its CLI, pandas unimportable
        # each stage timed by wrapping the module function convert calls
        sys.modules["pandas"] = None
        bag_sqlite.ROUTES.clear()
        timings = {}

        def timed(mod, attr, key):
            real = getattr(mod, attr)

            def run(*a, **kw):
                t = time.perf_counter()
                r = real(*a, **kw)
                timings[key] = time.perf_counter() - t
                return r
            return real, run

        stages = {(bag_sqlite, "read_bag_sqlite"): "read",
                  (bag2csv, "resample_and_join"): "resample", (tb, "write_csv"): "write_csv"}
        reals = {}
        for (mod, attr), key in stages.items():
            reals[mod, attr], run = timed(mod, attr, key)
            setattr(mod, attr, run)
        try:
            t0 = time.perf_counter()
            csv = bag2csv.main([str(bag), "--out", str(tmp / "koopman_dataset_50Hz")])
            cli_s = time.perf_counter() - t0
        finally:
            for (mod, attr), real in reals.items():
                setattr(mod, attr, real)
        routes = dict(bag_sqlite.ROUTES)
        got = tb.read_csv(csv)   # as csv_loader reads it for T2-T6
        rows = tb.nrows(got)
        want_routes = {(t, "native"): INGEST_STEPS for t in (bag2csv.BagTopics().mocap_odom,
                                                             bag2csv.BagTopics().px4_motors)}
        if routes != want_routes:
            fail(f"bag2csv: decode routes {routes}, not the native decoder for both topics")
        print(f"ingest bag2csv (CLI, pandas unimportable): {cli_s:.2f} s in all, read and decode "
              f"{timings['read']:.2f} s, resample and join {timings['resample']:.2f} s, CSV write "
              f"{timings['write_csv']:.2f} s; {rows} rows; routes {routes} [{card}]")
        out.update(bag2csv_s=cli_s, read_s=timings["read"], resample_s=timings["resample"],
                   write_csv_s=timings["write_csv"], rows=rows,
                   routes={f"{t} {r}": n for (t, r), n in routes.items()})

        # the CSV's states against a plain mean of the generator's states a bin
        if list(got) != ["t"] + bag2csv.STATE_COLS + bag2csv.ACT_COLS:
            fail(f"bag2csv: columns {list(got)}")
        ref = X.copy()
        ref[:, 3:6] = np.unwrap(np.arctan2(np.sin(X[:, 3:6]), np.cos(X[:, 3:6])), axis=0)
        b = (stamps - stamps[0]) // 20_000_000
        counts = np.bincount(b)
        mean = np.stack([np.bincount(b, weights=ref[:, j]) for j in range(12)], axis=1)
        mean /= counts[:, None]
        states = np.stack([got[c] for c in bag2csv.STATE_COLS], axis=1)
        if states.shape != mean.shape or not (counts > 0).all():
            fail(f"bag2csv: {states.shape} states against {mean.shape} bins")
        state_err = float(np.max(np.abs(states - mean)))
        state_excess = float(np.max(np.abs(states - mean) - INGEST_PARSE_RTOL * np.abs(mean)))
        t_err = float(np.max(np.abs(got["t"] - np.arange(len(counts)) * 0.02)))
        # each bin's commands: its first message's, the nearest to the bin start
        acts = np.stack([got[c] for c in bag2csv.ACT_COLS], axis=1)
        first = np.concatenate([[0], np.cumsum(counts)[:-1]])
        want_acts = np.clip(U[first], -1.0, 1.0)
        acts_excess = float(np.max(np.abs(acts - want_acts) - INGEST_PARSE_RTOL * np.abs(want_acts)))
        print(f"ingest CSV: {len(counts)} rows of 20 ms bins ({counts.min()}-{counts.max()} "
              f"messages each); max |CSV state - numpy bin mean| {state_err:.3e}, less "
              f"{INGEST_PARSE_RTOL:g} |mean|: {state_excess:.3e} (atol {INGEST_STATE_ATOL:g}); "
              f"max |t - 0.02 k| {t_err:.3e}; commands against each bin's first message's, "
              f"less {INGEST_PARSE_RTOL:g} |command|: {acts_excess:.3e} (held at 0)")
        if not (state_excess <= INGEST_STATE_ATOL and t_err < 1e-9 and acts_excess <= 0):
            fail("bag2csv: the CSV is not the binned recording")
        ds = csv_loader.load_thruster_dataset(csv, verbose=False)
        checks = sanity.run_all(ds, verbose=False)
        want = sanity.run_all(csv_loader.Dataset(X=mean, U=acts, t=ds.t, dt=ds.dt), verbose=False)
        kin = checks["kinematic"]
        print(f"ingest sanity: z-dot RMSE {kin['rmse']:.4f} m/s (bound {SANITY_RMSE}), "
              f"correlation {kin['corr']:.4f}, on the bin means {want['kinematic']}; "
              f"buoyancy drift {checks['buoyancy_drift']}")
        near = lambda a, b: abs(a - b) <= SANITY_RTOL * abs(b)  # noqa: E731
        if not (kin["rmse"] < SANITY_RMSE
                and all(near(kin[k], want["kinematic"][k]) for k in kin)
                and np.allclose(checks["actuator_corrs"], want["actuator_corrs"], rtol=SANITY_RTOL,
                                atol=0)):
            fail(f"sanity.run_all on the CSV {checks} against the bin means {want}")
        out.update(state_max_abs_err=state_err, sanity=kin, dt=ds.dt)
        sys.modules.pop("pandas")
        if saved_pandas is not None:
            sys.modules["pandas"] = saved_pandas

        # 4. the apps on the CSV (and its wrench augmentation), each kernel launched
        dt = ds.dt
        p, cfg, lag = fossen_params(device=dev), thruster_config(device=dev), lag_params(
            dt, device=dev)
        f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)  # noqa: E731
        rel, launches, secs = {}, {}, {}

        def app_run(name, kernel, main, argv):
            c = {}
            t = time.perf_counter()
            r = drive(f"{name} on the bag's CSV", (kernel,), lambda: main(argv, device=dev),
                      into=c)
            secs[name], launches[name] = time.perf_counter() - t, c[kernel]
            for row, vals in r["rmse"].items():
                if not all(np.isfinite(v) for v in vals.values()):
                    fail(f"{name} on the bag's CSV: {row} RMSE not finite: {vals}")
            return r

        t2 = app_run("T2", "window_sq", tank_koopman.main,
                     ["--csv", str(csv), "--physics-baseline", "--no-media"])
        if launches["T2"] != 2 * len(H_APP):
            fail(f"T2 on the bag's CSV: {launches['T2']} K2 launches")
        rel["T2"] = fossen_vs_plain("T2 (bag)", t2, "Fossen (BlueROV2)", lambda X_, U_, H: (
            ce.window_sq_plain(p, cfg, lag, X_, U_, dt, H, "euler")), f32(t2["test"].X),
            f32(t2["test"].U))

        models = Path(__file__).resolve().parent / "models"
        for name in ("pinc_best.msgpack", "pinc_best.msgpack.json"):
            shutil.copy(models / name, tmp / name)
        media_dir = tmp / "media"
        render = {}
        real_save = tank_full_comparison.save_media

        def timed_save(*a, **kw):
            t = time.perf_counter()
            real_save(*a, **kw)
            render["T6"] = time.perf_counter() - t

        tank_full_comparison.save_media = timed_save
        try:
            t6 = app_run("T6", "window_sq", tank_full_comparison.main,
                         ["--csv", str(csv), "--pinc-ckpt", str(tmp / "pinc_best.msgpack"),
                          "--pinc-psi-ssa", *INGEST_FIT]
                         + (["--media-dir", str(media_dir)] if media else ["--no-media"]))
        finally:
            tank_full_comparison.save_media = real_save
        if launches["T6"] != 4 * len(H_APP):
            fail(f"T6 on the bag's CSV: {launches['T6']} K2 launches")
        rel["T6"] = fossen_vs_plain("T6 (bag)", t6, "Fossen (BlueROV2)", lambda X_, U_, H: (
            ce.window_sq_plain(p, cfg, lag, X_, U_, dt, H, "euler")), f32(t6["test"].X),
            f32(t6["test"].U))
        res6 = t6["sysid"]
        out["T6_fit"] = fitted_row("T6 (bag)", t6, lambda X_, U_, H: ce.window_sq_plain(
            res6.params, res6.cfg, lag, X_, U_, dt, H, "euler"), f32(t6["test"].X),
            f32(t6["test"].U), "Fossen (BlueROV2)", card)

        # T3 and T4 on INGEST_T34_ROWS rows of the CSV, augmented with the wrench
        cut = tb.write_csv(tmp / "cut.csv", tb.take(got, slice(0, INGEST_T34_ROWS)))
        wrench_csv = augment_csv(cut, tmp / "cut_with_wrench.csv")
        t3 = app_run("T3", "window_sq_wrench", tank_wrench_comp.main,
                     ["--csv", str(wrench_csv), "--no-media"])
        t4 = app_run("T4", "window_sq_quat", tank_wrench_quat.main,
                     ["--csv", str(wrench_csv), "--no-media"])
        for name, r, row, plain in (
                ("T3", t3, "Fossen (wrench)", ce.window_sq_wrench_plain),
                ("T4", t4, "Fossen (quat)", cq.window_sq_quat_plain)):
            if launches[name] != 2 * len(H_APP):
                fail(f"{name} on the bag's CSV: {launches[name]} launches")
            rel[name] = fossen_vs_plain(f"{name} (bag)", r, row, lambda X_, U_, H, plain=plain: (
                plain(p, X_, U_, dt, H, "euler")), f32(r["test"].X), f32(r["test"].U))
        print(f"ingest apps on the CSV: T2 {secs['T2']:.1f} s, T6 {secs['T6']:.1f} s (its "
              f"{INGEST_FIT[-1]}-step fit {t6['sysid_s']:.2f} s), T3 {secs['T3']:.1f} s, T4 "
              f"{secs['T4']:.1f} s; launches {launches} [{card}]")
        out.update(app_s=secs, launches=launches, fossen_rel_vs_plain=rel,
                   rmse={n: r["rmse"] for n, r in (("T2", t2), ("T6", t6), ("T3", t3),
                                                   ("T4", t4))})

        # 5. T6's figures: the GIF of the open-loop window, the 2-D figure, the scales
        if media:
            T = len(t6["trajs"]["TRUE (Recorded)"])
            fps = int(round(1.0 / dt))
            frames = len(range(0, T, max(1, -(-fps // 50))))
            names = sorted(q.name for q in media_dir.iterdir())
            want = ["fossen_fit_scales.png", "tank_true_vs_4models.gif",
                    "tank_true_vs_4models_2D.png"]
            if names != want:
                fail(f"T6 media: {names}, not {want}")
            for n in names:
                media_file(media_dir / n, frames)
            print(f"ingest media: T6's {', '.join(names)} in {render['T6']:.2f} s (a "
                  f"{frames}-frame GIF) [{card}]")
            out["render_s"] = {"T6": render["T6"]}
            out["gif_frames"] = frames
    finally:
        if sys.modules.get("pandas", 0) is None:
            sys.modules.pop("pandas")
            if saved_pandas is not None:
                sys.modules["pandas"] = saved_pandas
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def main() -> None:
    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is false)")

    from bluerov2_dynamics_tpu_torch.apps.tank_koopman import fossen_evaluator
    from bluerov2_dynamics_tpu_torch.apps.tank_wrench_comp import (
        fossen_wrench_evaluator, wrench_dataset)
    from bluerov2_dynamics_tpu_torch.apps.tank_wrench_quat import (
        fossen_quat_evaluator, quat_dataset)
    import torch.distributed as dist

    from bluerov2_dynamics_tpu_torch.eval import metrics
    from bluerov2_dynamics_tpu_torch.eval.op_counts import (
        DIV_OPS, QUAT_BUDGET, ROW_BUDGET, TRIG_OPS, actuation_ops, quat_ops, row_ops)
    from bluerov2_dynamics_tpu_torch.eval.timing import (
        cuda_event_time, device_ms, host_ms, profile_calls, time_fn)
    from bluerov2_dynamics_tpu_torch.models import fossen, sysid
    from bluerov2_dynamics_tpu_torch.models.params import (
        fossen_params, lag_params, thruster_config)
    from bluerov2_dynamics_tpu_torch.ops import _build
    from bluerov2_dynamics_tpu_torch.ops import cuda_eval as ce
    from bluerov2_dynamics_tpu_torch.ops import cuda_probes as cp
    from bluerov2_dynamics_tpu_torch.ops import cuda_quat as cq
    from bluerov2_dynamics_tpu_torch.ops import cuda_rollout as cr
    from bluerov2_dynamics_tpu_torch.parallel import mesh as pmesh
    from bluerov2_dynamics_tpu_torch.parallel import sharded

    # 1. device ---------------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device {kind}")
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    # 2. build ------------------------------------------------------------------
    t0 = time.perf_counter()
    logs = _build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s for {sorted(logs)}")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"  ptxas[{name}]: {line.strip()}")
    spills = [line.strip() for line in logs["probes"].splitlines()
              if any(int(n) for n in re.findall(r"(\d+) bytes spill", line))]
    if spills:
        fail(f"a probe spills, so it measures local memory and not the card's FP32 rate: {spills}")
    redesigned = redesigned_report(logs)

    # 3. inputs and the main paths ----------------------------------------------
    rng = np.random.default_rng(SEED)
    x0 = torch.from_numpy((0.1 * rng.normal(size=(B_ROLL, 12))).astype(np.float32)).to(dev)
    U = torch.from_numpy(np.clip(0.5 * rng.normal(size=(T_ROLL, 8)), -1, 1)
                         .astype(np.float32)).to(dev)
    p, cfg, lag = fossen_params(device=dev), thruster_config(device=dev), lag_params(DT, device=dev)

    launches = {}

    def drive(phase, names, fn, into=launches):
        """Run ``fn`` with the launch counts set to 0 just before and read
        just after into ``into``; every kernel of ``names`` must have
        launched."""
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        counts = {n: _build.launches[n] for n in names}
        print(f"{phase}: launches {counts}")
        for n, c in counts.items():
            if c < 1:
                fail(f"kernel {n} was not launched on the {phase} path")
        into.update(counts)
        return out

    phase_s, t_mark = {}, [t_start]

    def mark(name):
        """The host seconds since the previous mark, as phase ``name``."""
        now = time.perf_counter()
        phase_s[name] = now - t_mark[0]
        t_mark[0] = now
        print(f"phase {name}: {phase_s[name]:.1f} s")

    mark("build")
    # the Koopman apps T2 and T1 at full size
    apps = koopman_apps(dev, card, drive)
    mark("koopman_apps")
    # the learned-model apps T6, T5, T3 and T4 with their Fossen fits, and PINc training
    learned, fit_ctx = learned_apps(dev, card, drive)
    mark("learned_apps")
    # the host data path: a rosbag2 recording -> bag2csv -> T2, T6, T3, T4 and figures
    ingest = ingest_runs(dev, card, drive)
    mark("ingest_runs")
    # the physics demo
    demos = demo_runs(dev, card)
    mark("demo_runs")
    # state estimation (launches none of K1-K8: the counts are read to show it)
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    estimation = estimation_runs(dev, card)
    torch.cuda.synchronize()
    estimation["launches"] = dict(_build.launches)
    print(f"estimation: launches {estimation['launches']}")
    mark("estimation_runs")
    # control and guidance (launches none of K1-K8: the counts are read to show it)
    _build.reset_launch_counts()
    ctrl = control_runs(dev, card)
    torch.cuda.synchronize()
    ctrl["launches"] = dict(_build.launches)
    print(f"control: launches {ctrl['launches']}")
    mark("control_runs")

    # the recording: the port's own simulator on the card, plus sensor noise;
    # its step loop replayed from CUDA graphs (ops/scan.py), held against
    # the eager rollout bit for bit over the first graph chunk
    from bluerov2_dynamics_tpu_torch.ops.scan import GRAPH_CHUNK, scan

    t0 = time.perf_counter()
    U_rec = torch.from_numpy(ar1_commands(rng, N_REC)).to(dev)
    x_start = torch.zeros(12, device=dev)
    x_start[2] = 1.0
    rec_step = fossen.make_thruster_step(p, cfg, lag, DT, "euler")

    def rec_body(carry, xs):
        x, z = rec_step(carry, xs[0])
        return (x, z), (x,)

    (X_steps,) = scan(rec_body, (x_start, torch.zeros(8, 3, device=dev)), (U_rec,), graph=True)
    X_true = torch.cat([x_start[None], X_steps])[:-1]
    eager = fossen.simulate_thruster(p, cfg, lag, x_start, U_rec[:GRAPH_CHUNK], DT, "euler")
    if not torch.equal(eager, torch.cat([x_start[None], X_steps[:GRAPH_CHUNK]])):
        fail("the recording's graph loop differs from the eager rollout")
    noise = torch.from_numpy((1e-3 * rng.normal(size=(N_REC, 12))).astype(np.float32)).to(dev)
    X_rec = (X_true + noise).contiguous()
    if not torch.isfinite(X_rec).all():
        fail("the simulated recording is not finite")
    print(f"recording: {N_REC} rows simulated on the card in {time.perf_counter() - t0:.1f} s")
    # T3/T4 inputs: the recorded vehicle's wrench; quaternions in float64 on the host
    X_np, U_np = X_rec.cpu().numpy(), U_rec.cpu().numpy()
    _, W_np = wrench_dataset(X_np, U_np)
    X13_np, _ = quat_dataset(X_np, U_np)
    W_rec = torch.as_tensor(W_np, dtype=torch.float32, device=dev).contiguous()
    X13_rec = torch.as_tensor(X13_np, dtype=torch.float32, device=dev).contiguous()
    # K6 inputs (bench.py:735-741) and K3's per-trajectory commands (1.05 GB)
    xq0_np = 0.1 * rng.normal(size=(B_ROLL, 13))
    xq0_np[:, 3] += 1.0
    xq0 = torch.from_numpy(xq0_np.astype(np.float32)).to(dev)
    TAUq = torch.from_numpy((3.0 * rng.normal(size=(T_ROLL, 6))).astype(np.float32)).to(dev)
    Ub = torch.from_numpy(np.clip(0.5 * rng.standard_normal((T_ROLL, B_ROLL, 8), dtype=np.float32),
                                  -1, 1)).to(dev)

    roll = cr.make_rollout_final_cuda(p, cfg, lag, DT, "rk4")
    xT = drive("K1 rollout", ("rollout_final",), lambda: roll(x0, U))
    # one C call, one kernel: K1 with the prologue inside, the prologue
    # kernel not launched
    launches["shared_tau"] = _build.launches["shared_tau"]
    if (launches["shared_tau"], launches["rollout_final"]) != (0, 1):
        fail(f"K1 rollout: launch counts {launches}, not one launch of K1 and none of the "
             f"prologue kernel")
    k1_events, _ = profile_calls(lambda: roll(x0, U), calls=1)
    k1_kernels = [e.name for e in k1_events]
    print(f"K1 rollout: one call makes {len(k1_kernels)} device event(s) "
          f"({', '.join(n[:60] for n in k1_kernels)})")
    if k1_events and (len(k1_kernels) != 1 or "rollout_commands_kernel" not in k1_kernels[0]):
        fail(f"K1 rollout: {k1_kernels} a call, not the one folded kernel")
    evaluate = fossen_evaluator(DT, X_rec, U_rec, method="euler")
    rmses = drive("T2 evaluator", ("window_sq",),
                  lambda: {H: float(evaluate(H)) for H in H_APP})
    evaluate3 = fossen_wrench_evaluator(DT, X_rec, W_rec, method="euler")
    rmses3 = drive("T3 evaluator", ("window_sq_wrench",),
                   lambda: {H: float(evaluate3(H)) for H in H_APP})
    evaluate4 = fossen_quat_evaluator(DT, X13_rec, W_rec, method="euler")
    rmses4 = drive("T4 evaluator", ("window_sq_quat",),
                   lambda: {H: float(evaluate4(H)) for H in H_APP})
    H = H_APP[-1]
    endpoint_fns = (ce.make_endpoint_final_cuda(p, cfg, lag, DT, H, "euler"),
                    ce.make_endpoint_final_cuda_wrench(p, DT, H, "euler"),
                    cq.make_endpoint_final_cuda_quat(p, DT, H, "euler"))
    finals = drive("window endpoints", ("window_eval", "window_eval_wrench", "window_eval_quat"),
                   lambda: [fn(X, V) for fn, X, V in zip(
                       endpoint_fns, (X_rec, X_rec, X13_rec), (U_rec, W_rec, W_rec))])
    roll_q = cq.make_rollout_final_cuda_quat(p, DT, "rk4")
    xqT = drive("K6 quat13 rollout", ("rollout_final_quat",), lambda: roll_q(xq0, TAUq))
    roll_b = ce.make_batched_rollout_cuda(p, cfg, lag, DT, "rk4")
    xbT = drive("K3 batched rollout", ("batched_rollout",), lambda: roll_b(x0, Ub))

    for app, r in (("T2", rmses), ("T3", rmses3), ("T4", rmses4)):
        print(f"{app} endpoint RMSE (Euler): " + ", ".join(f"H={H}: {v:.6f}" for H, v in r.items()))
        if not all(np.isfinite(v) for v in r.values()):
            fail(f"a {app} endpoint RMSE is not finite")
    for name, out, shape in (("rollout", xT, (B_ROLL, 12)), ("quat13 rollout", xqT, (B_ROLL, 13)),
                             ("batched rollout", xbT, (B_ROLL, 12)),
                             ("K2 endpoints", finals[0], (N_REC - H, 12)),
                             ("K4 endpoints", finals[1], (N_REC - H, 12)),
                             ("K5 endpoints", finals[2], (N_REC - H, 13))):
        if out.shape != shape or not torch.isfinite(out).all():
            fail(f"{name} output is not finite {shape}")

    mark("recording and main paths")
    # 4. checks -------------------------------------------------------------------
    # the full recording's start count: random windows of every input contract
    N = N_LARGE + H_APP[-1]
    X12_l = torch.from_numpy((0.1 * rng.normal(size=(N, 12))).astype(np.float32)).to(dev)
    U8_l = torch.from_numpy(np.clip(0.5 * rng.normal(size=(N, 8)), -1, 1).astype(np.float32)).to(dev)
    TAU_l = torch.from_numpy((4.0 * rng.normal(size=(N, 6))).astype(np.float32)).to(dev)
    X13_np_l = 0.1 * rng.normal(size=(N, 13))
    X13_np_l[:, 3] += 1.0
    X13_l = torch.from_numpy(X13_np_l.astype(np.float32)).to(dev)
    tc, rc = cr.thruster_consts(cfg, lag), cr.row_consts(p, DT)
    tau_k = cr.launch_tau_seq(tc, U)
    tau_p = cr.shared_tau_sequence_chunked(cfg, lag, U)
    xT_p = cr.rollout_rows_plain(p, tau_p, x0, DT, "rk4")
    err = {"shared_tau": max_err(tau_k, tau_p, "shared_tau")}
    print("K1 from commands:", end=" ")
    err["rollout_final"] = max_err(xT, xT_p, "rollout_final")
    # K1 on a ready tau_seq against the same plain rollout, and the main
    # path's xT against the plain rollout on the serial (lax.scan) order
    print("K1 on a ready tau_seq:", end=" ")
    err["rollout_final_on_tau_seq"] = max_err(cr.launch_rollout(rc, tau_p, x0, "rk4"), xT_p,
                                              "rollout_final")
    del xT_p
    print("K1 from commands, against the serial order:", end=" ")
    err["rollout_final_serial"] = max_err(
        xT, cr.rollout_rows_plain(p, cr.shared_tau_sequence(cfg, lag, U), x0, DT, "rk4"),
        "rollout_final")
    # the prologue at the chunk edges, a whole recording and T = 0, with and
    # without the lag: alone and inside K1 (block 0 writes its tau_seq), held
    # against the chunked plain version and the serial one (the lax.scan's
    # order); K1's xT against the plain rollout up to T_ROLL steps, and
    # against the two-launch form on the prologue kernel's tau_seq
    tau_checked, xs_checked = {}, {}
    x0s = x0[:512].contiguous()
    for T in TAU_EDGE_T:
        Us = (U_rec if T > T_ROLL else U)[:T].contiguous()
        for use_lag in (True, False):
            alone = cr.launch_tau_seq(tc, Us, use_lag)
            inside = torch.full((T, 6), float("nan"), device=dev)
            xs = cr.launch_rollout_from_commands(rc, tc, Us, x0s, "rk4", use_lag, tau=inside)
            want = cr.shared_tau_sequence_chunked(cfg, lag, Us, use_lag)
            print(f"prologue T={T}, lag {use_lag}:", end=" ")
            e = max(max_err(alone, want, "shared_tau"), max_err(inside, want, "shared_tau"))
            print(f"prologue T={T}, lag {use_lag}, against the serial order:", end=" ")
            max_err(inside, cr.shared_tau_sequence(cfg, lag, Us, use_lag), "shared_tau")
            print(f"K1 from commands T={T}, lag {use_lag}, against the two-launch form:", end=" ")
            max_err(xs, cr.launch_rollout(rc, alone, x0s, "rk4"), "rollout_final")
            if T <= T_ROLL:
                print(f"K1 from commands T={T}, lag {use_lag}:", end=" ")
                xs_checked[f"T={T}, lag {use_lag}"] = max_err(
                    xs, cr.rollout_rows_plain(p, want, x0s, DT, "rk4"), "rollout_final")
            tau_checked[f"T={T}, lag {use_lag}"] = e
    err["shared_tau"] = max(err["shared_tau"], *tau_checked.values())
    err["window_eval"] = max_err(finals[0], ce.endpoint_final_plain(
        p, cfg, lag, X_rec, U_rec, DT, H, "euler"), "window_eval")
    err["window_eval_wrench"] = max_err(
        finals[1], ce.endpoint_final_wrench_plain(p, X_rec, W_rec, DT, H, "euler"),
        "window_eval_wrench")
    err["window_eval_quat"] = max_err(
        finals[2], cq.endpoint_final_quat_plain(p, X13_rec, W_rec, DT, H, "euler"),
        "window_eval_quat")
    # the fused sums: against the plain versions, and the same bits on ten calls
    fused = {  # name: (kernel, plain, X, input)
        "window_sq": (lambda X, V: ce.launch_window_sq(rc, tc, X, V, H, "euler", True),
                      lambda X, V: ce.window_sq_plain(p, cfg, lag, X, V, DT, H, "euler"),
                      X_rec, U_rec),
        "window_sq_wrench": (lambda X, V: ce.launch_window_sq_wrench(rc, X, V, H, "euler"),
                             lambda X, V: ce.window_sq_wrench_plain(p, X, V, DT, H, "euler"),
                             X_rec, W_rec),
        "window_sq_quat": (lambda X, V: cq.launch_window_sq_quat(rc, X, V, H, "euler", True),
                           lambda X, V: cq.window_sq_quat_plain(p, X, V, DT, H, "euler"),
                           X13_rec, W_rec),
    }
    for name, (kern, plain, X, V) in fused.items():
        got, want = float(kern(X, V)), float(plain(X, V))
        close(got, want, TOL[name][0], f"{name}: fused sum vs the plain version's")
        err[name] = abs(got - want)
        bits = {kern(X, V).cpu().numpy().tobytes() for _ in range(10)}
        print(f"{name}: {len(bits)} distinct result(s) in 10 calls")
        if len(bits) != 1:
            fail(f"{name}: ten calls gave {len(bits)} different sums")
    # K4 and K5 in both forms at the apps' and the full recording's starts,
    # H = 1, 10, 100: the endpoints and the fused sums against the plain
    # versions, the sums the same bits on ten calls (each launch as its
    # launcher plans it: a warp pair or one thread a start)
    pair_checks = {  # (endpoint, fused): (kernel, fused kernel, plain endpoints, inputs)
        ("window_eval_wrench", "window_sq_wrench"): (
            lambda X, V, h: ce.launch_window_eval_wrench(rc, X, V, h, "euler"),
            lambda X, V, h: ce.launch_window_sq_wrench(rc, X, V, h, "euler"),
            lambda X, V, h: ce.endpoint_final_wrench_plain(p, X, V, DT, h, "euler"),
            ((X_rec, W_rec), (X12_l, TAU_l))),
        ("window_eval_quat", "window_sq_quat"): (
            lambda X, V, h: cq.launch_window_eval_quat(rc, X, V, h, "euler", True),
            lambda X, V, h: cq.launch_window_sq_quat(rc, X, V, h, "euler", True),
            lambda X, V, h: cq.endpoint_final_quat_plain(p, X, V, DT, h, "euler"),
            ((X13_rec, W_rec), (X13_l, TAU_l))),
    }
    pair_checked = {}
    for (ename, fname), (kern, kern_sq, plain, cases) in pair_checks.items():
        for X_full, V_full in cases:
            n = X_full.shape[0] - H_APP[-1]
            for h in H_APP:
                X, V = X_full[:n + h], V_full[:n + h]
                want = plain(X, V, h)
                print(f"{ename} at {n} starts, H={h}:", end=" ")
                e = max_err(kern(X, V, h), want, ename, tol="window_shapes")
                got, want_sq = float(kern_sq(X, V, h)), float(ce.endpoint_sq(want, X, h))
                close(got, want_sq, TOL[fname][0], f"{fname} at {n} starts, H={h}: fused sum vs "
                      f"the plain version's")
                bits = {kern_sq(X, V, h).cpu().numpy().tobytes() for _ in range(10)}
                if len(bits) != 1:
                    fail(f"{fname} at {n} starts, H={h}: ten calls gave {len(bits)} sums")
                pair_checked.setdefault(ename, {})[f"{n} starts, H={h}"] = e
                pair_checked.setdefault(fname, {})[f"{n} starts, H={h}"] = abs(got - want_sq)
    print("K4 and K5 agree with their plain versions at both start counts and H = 1, 10, 100; "
          "the fused sums give the same bits on ten calls")
    err["rollout_final_quat"] = max_err(xqT, cq.rollout_final_quat_plain(p, xq0, TAUq, DT, "rk4"),
                                        "rollout_final_quat")
    near = gimbal_near(fossen, p, cfg, lag, x0, Ub)
    xb_plain = ce.batched_rollout_plain(p, cfg, lag, x0, Ub, DT, "rk4")
    n_near = int(near.sum())
    near_diff = float((xbT[near] - xb_plain[near]).abs().max()) if n_near else 0.0
    print(f"K3: {n_near} of {B_ROLL} trajectories come within {np.pi / 2 - GIMBAL_MARGIN:.3f} rad "
          f"of the gimbal singularity (max|kernel - plain| there {near_diff:.3e}); "
          f"the check holds the other {B_ROLL - n_near}")
    if n_near > B_ROLL // 100:
        fail(f"K3: {n_near} trajectories near the gimbal singularity, over 1%")
    err["batched_rollout"] = max_err(xbT[~near], xb_plain[~near], "batched_rollout")
    norm_dev = float((torch.linalg.norm(xqT[:, 3:7].double(), dim=1) - 1.0).abs().max())
    print(f"K6 quaternion norms: max |norm - 1| = {norm_dev:.3e}")
    if norm_dev > TOL["quat_norm"][1]:
        fail(f"K6 quaternion norms drift by {norm_dev}")

    step = fossen.make_thruster_step(p, cfg, lag, DT, "euler")
    step3 = fossen.make_wrench_step(p, DT, "euler", state="euler12")
    step4 = fossen.make_wrench_step(p, DT, "euler", state="quat13")
    for H in H_APP:
        loops = {
            "T2": (rmses, metrics.endpoint_rmse_carry(
                step, lambda x: torch.zeros((*x.shape[:-1], 8, 3), device=dev), X_rec, U_rec, H)),
            "T3": (rmses3, metrics.endpoint_rmse(step3, X_rec, W_rec, H)),
            "T4": (rmses4, metrics.endpoint_rmse(step4, X13_rec, W_rec, H)),
        }
        for app, (got, want) in loops.items():
            want = float(want)
            if abs(got[H] - want) > TOL["rmse"][0] * abs(want):
                fail(f"{app} RMSE at H={H}: kernel path {got[H]} vs step loop {want}")
    print("T2/T3/T4 RMSEs agree with the plain step loops to rtol 1e-4")

    # small inputs against the plain versions on the host CPU
    cpu = torch.device("cpu")
    pc, cfgc, lagc = p.to(cpu), cfg.to(cpu), lag.to(cpu)
    max_err(roll(x0[:256].contiguous(), U[:50].contiguous()),
            cr.rollout_final_plain(pc, cfgc, lagc, x0[:256].cpu(), U[:50].cpu(), DT, "rk4"),
            "rollout_final")
    Xs, Uss, Ws, X13s = X_rec[:300], U_rec[:300], W_rec[:300], X13_rec[:300]
    max_err(ce.make_endpoint_final_cuda(p, cfg, lag, DT, 20, "euler")(Xs, Uss),
            ce.endpoint_final_plain(pc, cfgc, lagc, Xs.cpu(), Uss.cpu(), DT, 20, "euler"),
            "window_eval")
    max_err(ce.make_endpoint_final_cuda_wrench(p, DT, 20, "euler")(Xs, Ws),
            ce.endpoint_final_wrench_plain(pc, Xs.cpu(), Ws.cpu(), DT, 20, "euler"),
            "window_eval_wrench")
    max_err(cq.make_endpoint_final_cuda_quat(p, DT, 20, "euler")(X13s, Ws),
            cq.endpoint_final_quat_plain(pc, X13s.cpu(), Ws.cpu(), DT, 20, "euler"),
            "window_eval_quat")
    max_err(roll_q(xq0[:256].contiguous(), TAUq[:50].contiguous()),
            cq.rollout_final_quat_plain(pc, xq0[:256].cpu(), TAUq[:50].cpu(), DT, "rk4"),
            "rollout_final_quat")
    Ubs = Ub[:50, :256].contiguous()
    max_err(roll_b(x0[:256].contiguous(), Ubs),
            ce.batched_rollout_plain(pc, cfgc, lagc, x0[:256].cpu(), Ubs.cpu(), DT, "rk4"),
            "batched_rollout")
    print("small inputs agree with the plain versions on the host CPU")

    mark("checks")
    # 5. timing -------------------------------------------------------------------
    ms, plain_ms, bounds, shapes = {}, {}, {}, {}
    # K1 as the main path launches it (the prologue inside), and the K1
    # kernel alone on a ready tau_seq (the two-launch form's second launch)
    k1_runs = {"from commands": lambda: cr.launch_rollout_from_commands(rc, tc, U, x0, "rk4"),
               "on tau_seq": lambda: cr.launch_rollout(rc, tau_k, x0, "rk4")}
    k1_ms = {k: [] for k in k1_runs}
    for _ in range(2):          # in turns
        for k, fn in k1_runs.items():
            k1_ms[k].append(cuda_event_time(fn, iters=10))
    ms["rollout_final"] = min(k1_ms["from commands"])
    plain_ms["rollout_final"] = cuda_event_time(
        lambda: cr.rollout_final_plain(p, cfg, lag, x0, U, DT, "rk4"), iters=2, warmup=0)
    # the prologue alone is shorter than its launcher's host time: the
    # profiler's device time (CUDA events beside it)
    event_ms = {"shared_tau": cuda_event_time(lambda: cr.launch_tau_seq(tc, U), iters=50)}
    ms["shared_tau"] = device_ms(lambda: cr.launch_tau_seq(tc, U), calls=50)
    if ms["shared_tau"] is None:
        print("shared_tau: no device events; its time is the CUDA-event time")
        ms["shared_tau"] = event_ms["shared_tau"]
    plain_ms["shared_tau"] = cuda_event_time(
        lambda: cr.shared_tau_sequence_chunked(cfg, lag, U), iters=3)
    # the K1 call end to end, in turns with the two-launch form on the
    # scanned prologue kernel (into a new tau_seq, no F buffer, then K1):
    # host clock, each call ended by a synchronise
    k1_calls = {"one call": lambda: roll(x0, U),
                "two launches, scanned prologue kernel":
                    lambda: cr.launch_rollout(rc, cr.launch_tau_seq(tc, U), x0, "rk4")}
    k1_host = {k: [] for k in k1_calls}
    for _ in range(REPEATS):
        for k, fn in k1_calls.items():
            k1_host[k] += host_ms(fn, calls=K1_CALLS // REPEATS)
    k1_e2e = {k: dict(min=min(v), median=sorted(v)[len(v) // 2], max=max(v), calls=len(v))
              for k, v in k1_host.items()}
    ms["rollout_final_quat"] = cuda_event_time(
        lambda: cq.launch_rollout_quat(rc, xq0, TAUq, "rk4", True), iters=10)
    plain_ms["rollout_final_quat"] = cuda_event_time(
        lambda: cq.rollout_final_quat_plain(p, xq0, TAUq, DT, "rk4"), iters=2, warmup=0)
    ms["batched_rollout"] = cuda_event_time(
        lambda: ce.launch_batched_rollout(rc, tc, x0, Ub, "rk4", True), iters=10)
    plain_ms["batched_rollout"] = cuda_event_time(
        lambda: ce.batched_rollout_plain(p, cfg, lag, x0, Ub, DT, "rk4"), iters=2, warmup=0)
    host = {}
    for name, fn, args in (("rollout_final", roll, (x0, U)), ("rollout_final_quat", roll_q, (xq0, TAUq)),
                           ("batched_rollout", roll_b, (x0, Ub))):
        _, host[name] = time_fn(fn, *args, warmup=1, iters=5)
    for name, label in (("rollout_final", "K1 make_rollout_final_cuda"),
                        ("rollout_final_quat", "K6 make_rollout_final_cuda_quat"),
                        ("batched_rollout", "K3 make_batched_rollout_cuda")):
        print(f"{label}: kernel {ms[name]:.4f} ms (plain {plain_ms[name]:.1f} ms); end to end "
              f"{1e3 * host[name]:.4f} ms = {B_ROLL * T_ROLL / host[name]:.4e} RK4 "
              f"trajectory-steps/s")
    print(f"K1 tau_seq kernel alone {ms['shared_tau']:.4f} ms on the device, "
          f"{event_ms['shared_tau']:.4f} ms between CUDA events (plain "
          f"{plain_ms['shared_tau']:.2f} ms); K1 from commands (the prologue inside) " + " / ".join(
              f"{t:.4f}" for t in k1_ms["from commands"]) + " ms against K1 on a ready tau_seq "
          + " / ".join(f"{t:.4f}" for t in k1_ms["on tau_seq"]) + " ms, in turns")
    for k, e in k1_e2e.items():
        print(f"K1 call end to end ({k}): min {e['min']:.4f} / median {e['median']:.4f} / max "
              f"{e['max']:.4f} ms over {e['calls']} synchronised calls, in turns")

    nnz = int((cfg.wrench_map != 0).sum())
    act_ops = actuation_ops(nnz)
    steps = B_ROLL * T_ROLL
    bounds["rollout_final"] = bound(steps * row_ops("rk4") + T_ROLL * act_ops,
                                    4 * (2 * B_ROLL * 12 + T_ROLL * 8))
    bounds["shared_tau"] = bound(T_ROLL * act_ops, 4 * T_ROLL * (8 + 6))
    bounds["rollout_final_quat"] = bound(steps * quat_ops("rk4"), 4 * (2 * B_ROLL * 13 + T_ROLL * 6))
    bounds["batched_rollout"] = bound(steps * (row_ops("rk4") + act_ops),
                                      4 * (2 * B_ROLL * 12 + T_ROLL * B_ROLL * 8))
    shapes["rollout_final"] = f"x0 ({B_ROLL}, 12), U ({T_ROLL}, 8), RK4, the prologue inside"
    shapes["shared_tau"] = f"U ({T_ROLL}, 8) -> tau_seq ({T_ROLL}, 6)"
    shapes["rollout_final_quat"] = f"x0 ({B_ROLL}, 13), TAU ({T_ROLL}, 6), RK4, renormalised"
    shapes["batched_rollout"] = f"x0 ({B_ROLL}, 12), U ({T_ROLL}, {B_ROLL}, 8), RK4, lag"

    # the window kernels at the apps' starts and at the full recording's
    H = H_APP[-1]
    windows = {
        "window_eval": (
            lambda X, Ui: ce.launch_window_eval(rc, tc, X, Ui, H, "euler", True),
            lambda X, Ui: ce.endpoint_final_plain(p, cfg, lag, X, Ui, DT, H, "euler"),
            row_ops("euler") + act_ops, 8, ((X_rec, U_rec), (X12_l, U8_l))),
        "window_eval_wrench": (
            lambda X, Ti: ce.launch_window_eval_wrench(rc, X, Ti, H, "euler"),
            lambda X, Ti: ce.endpoint_final_wrench_plain(p, X, Ti, DT, H, "euler"),
            row_ops("euler"), 6, ((X_rec, W_rec), (X12_l, TAU_l))),
        "window_eval_quat": (
            lambda X, Ti: cq.launch_window_eval_quat(rc, X, Ti, H, "euler", True),
            lambda X, Ti: cq.endpoint_final_quat_plain(p, X, Ti, DT, H, "euler"),
            quat_ops("euler"), 6, ((X13_rec, W_rec), (X13_l, TAU_l))),
    }
    # the fused forms: the same steps, then the squared errors summed in the
    # kernel; inputs read once (the targets are rows of X), one float written
    for name, (kern, plain, _, _) in fused.items():
        windows[name] = (kern, plain, *windows[FUSED[name][1]][2:])
    # the window kernels are as short as their launchers' host time, so
    # their time is the profiler's device time (CUDA events beside it)
    large = {}
    for name, (kern, plain, ops_step, n_in, inputs) in windows.items():
        for X, Ui in inputs:
            n_start, n_state = X.shape[0] - H, X.shape[1]
            e_ms = cuda_event_time(lambda: kern(X, Ui), iters=20)
            k_ms = device_ms(lambda: kern(X, Ui))
            if k_ms is None:
                print(f"{name}: no device events; its time is the CUDA-event time")
                k_ms = e_ms
            p_ms = cuda_event_time(lambda: plain(X, Ui), iters=3)
            nbytes = (4 * (n_start * n_state * 2 + X.shape[0] * n_in) if name.startswith("window_eval")
                      else 4 * (X.shape[0] * (n_state + n_in) + 1))
            b = bound(n_start * H * ops_step, nbytes)
            shape = (f"X ({X.shape[0]}, {n_state}), input ({X.shape[0]}, {n_in}), "
                     f"{n_start} starts x H={H}, Euler")
            print(f"{name} at {n_start} starts: {k_ms:.4f} ms on the device, {e_ms:.4f} ms "
                  f"between CUDA events (plain {p_ms:.1f} ms, bound {b[0]:.4f} ms by {b[1]})")
            if n_start == N_REC - H:
                ms[name], plain_ms[name], bounds[name], shapes[name] = k_ms, p_ms, b, shape
                event_ms[name] = e_ms
            else:
                large[name] = dict(shape=shape, ms=k_ms, event_ms=e_ms, plain_ms=p_ms,
                                   bound_ms=b[0], bound_by=b[1])
    # K2 at the full recording's starts too (the main path held it at the apps')
    X, Ui = windows["window_eval"][4][1]
    print(f"K2 at {X.shape[0] - H} starts:", end=" ")
    max_err(ce.launch_window_eval(rc, tc, X, Ui, H, "euler", True),
            ce.endpoint_final_plain(p, cfg, lag, X, Ui, DT, H, "euler"), "window_eval")

    # the evaluators end to end, in turns with the unfused policy they
    # replace (the endpoint kernel, then metrics.rmse: four more small ops)
    evaluator_ms = {}
    for label, fn, final_fn, X, V in (
            ("fossen_evaluator", evaluate, endpoint_fns[0], X_rec, U_rec),
            ("fossen_wrench_evaluator", evaluate3, endpoint_fns[1], X_rec, W_rec),
            ("fossen_quat_evaluator", evaluate4, endpoint_fns[2], X13_rec, W_rec)):
        runs = {"fused": lambda: fn(H),
                "unfused": lambda: metrics.rmse(X[H:], final_fn(X, V))}
        close(float(runs["fused"]()), float(runs["unfused"]()), TOL["sharded_rmse"][0],
              f"{label}(H={H}): fused vs unfused")
        t = {k: [] for k in runs}
        for _ in range(REPEATS):
            for k, run in runs.items():
                t[k].append(1e3 * time_fn(run, warmup=0, iters=CALLS)[1])
        evaluator_ms[label] = {k: dict(min=min(v), median=sorted(v)[REPEATS // 2], max=max(v))
                               for k, v in t.items()}
        e = evaluator_ms[label]
        print(f"{label}(H={H}) end to end, {N_REC - H} starts: fused min {e['fused']['min']:.4f} "
              f"/ median {e['fused']['median']:.4f} / max {e['fused']['max']:.4f} ms, unfused "
              f"{e['unfused']['min']:.4f} / {e['unfused']['median']:.4f} / "
              f"{e['unfused']['max']:.4f} ms ({REPEATS} repeats of {CALLS} calls, in turns)")

    mark("timing")
    # 6. K7: the sharded window evaluators, world 1 -------------------------------
    m_blk = N_LARGE // K7_BLOCKS
    k7 = {  # name: (fused per-rank kernel, its endpoint form, sharded wrapper, fused and
            #        single-device evaluators, X, input)
        "sharded_window_eval": (
            "window_sq", "window_eval",
            lambda mesh, X, Ui: sharded.shardmap_endpoint_rmse_cuda(
                mesh, p, cfg, lag, X, Ui, DT, H, method="euler"),
            ce.make_endpoint_sq_cuda(p, cfg, lag, DT, H, "euler"),
            ce.make_endpoint_final_cuda(p, cfg, lag, DT, H, "euler"), X12_l, U8_l),
        "sharded_window_eval_wrench": (
            "window_sq_wrench", "window_eval_wrench",
            lambda mesh, X, Ti: sharded.shardmap_endpoint_rmse_cuda_wrench(
                mesh, p, X, Ti, DT, H, method="euler"),
            ce.make_endpoint_sq_cuda_wrench(p, DT, H, "euler"),
            ce.make_endpoint_final_cuda_wrench(p, DT, H, "euler"), X12_l, TAU_l),
        "sharded_window_eval_quat": (
            "window_sq_quat", "window_eval_quat",
            lambda mesh, X, Ti: sharded.shardmap_endpoint_rmse_cuda_quat(
                mesh, p, X, Ti, DT, H, method="euler"),
            cq.make_endpoint_sq_cuda_quat(p, DT, H, "euler"),
            cq.make_endpoint_final_cuda_quat(p, DT, H, "euler"), X13_l, TAU_l),
    }

    def unfused(final_fn):
        """K7's unfused per-rank body: endpoints, then ``torch.sum``."""
        return lambda Xb, Ub: sharded.window_block_sq(final_fn, Xb, Ub, H, 0, Xb.shape[0] - H)

    k7_launches, wrapper_ms, k7_unsharded_err, composition = {}, {}, {}, {}
    pmesh.init_group(K7_BACKEND, device=dev)
    try:
        mesh1 = pmesh.make_mesh(axis_names=("data",), device_type="cuda")
        print(f"K7: {K7_BACKEND} group of {dist.get_world_size()} rank, mesh {mesh1}")

        def k7_path():
            out = {}
            for name, (_, _, wrapper, _, final_fn, X, Ui) in k7.items():
                world1 = wrapper(mesh1, X, Ui)
                sq = sum(sharded.window_block_sq(final_fn, X, Ui, H, r * m_blk, m_blk)
                         for r in range(K7_BLOCKS))
                out[name] = (float(world1), float(torch.sqrt(sq / (N_LARGE * X.shape[1]))))
            return out

        k7_res = drive(f"K7 sharded windows (world 1, then {K7_BLOCKS} unfused offset blocks)",
                       [v[0] for v in k7.values()] + [v[1] for v in k7.values()], k7_path,
                       into=k7_launches)
        for name, (fname, kname, *_) in k7.items():
            if (k7_launches[fname], k7_launches[kname]) != (1, K7_BLOCKS):
                fail(f"K7 {name}: {k7_launches[fname]} fused and {k7_launches[kname]} endpoint "
                     f"launches, not 1 and {K7_BLOCKS}")
        for name, (fname, kname, wrapper, sq_fn, final_fn, X, Ui) in k7.items():
            world1, blocks = k7_res[name]
            plain = windows[kname][1]
            unsharded = float(metrics.rmse(X[H:], final_fn(X, Ui)))
            close(world1, unsharded, TOL["sharded_rmse"][0],
                  f"{name}: world-1 RMSE vs the unsharded kernel's")
            k7_unsharded_err[name] = abs(world1 - unsharded)
            close(blocks, world1, TOL["sharded_rmse"][0],
                  f"{name}: {K7_BLOCKS} unfused offset blocks vs world 1")
            runs = {"fused": lambda: sharded.shardmap_window_rmse(mesh1, sq_fn, X, Ui, H),
                    "unfused": lambda: sharded.shardmap_window_rmse(
                        mesh1, unfused(final_fn), X, Ui, H)}
            close(world1, float(runs["unfused"]()), TOL["sharded_rmse"][0],
                  f"{name}: fused vs unfused composition")
            bits = {runs["fused"]().cpu().numpy().tobytes() for _ in range(10)}
            if len(bits) != 1:
                fail(f"{name}: ten calls gave {len(bits)} different RMSEs")
            want = float(metrics.rmse(X[H:], plain(X, Ui)))
            close(world1, want, TOL["rmse"][0], f"{name}: world-1 RMSE vs the plain versions'")
            err[name] = abs(world1 - want)
            t = {k: [] for k in runs}
            for _ in range(REPEATS):              # in turns: fused, unfused, fused, ...
                for k, fn in runs.items():
                    t[k].append(cuda_event_time(fn, iters=CALLS))
            composition[name] = {k: dict(min=min(v), median=sorted(v)[REPEATS // 2], max=max(v))
                                 for k, v in t.items()}
            ms[name] = composition[name]["fused"]["median"]
            wrapper_ms[name] = cuda_event_time(lambda: wrapper(mesh1, X, Ui), iters=CALLS)
            plain_ms[name] = cuda_event_time(lambda: metrics.rmse(X[H:], plain(X, Ui)), iters=2,
                                             warmup=0)
            bounds[name] = (large[fname]["bound_ms"], large[fname]["bound_by"])
            shapes[name] = large[fname]["shape"] + f", world 1 ({K7_BACKEND})"
            c = composition[name]
            print(f"{name}: composition (kernel, all-reduce, sqrt) fused min {c['fused']['min']:.4f}"
                  f" / median {c['fused']['median']:.4f} / max {c['fused']['max']:.4f} ms, "
                  f"unfused {c['unfused']['min']:.4f} / {c['unfused']['median']:.4f} / "
                  f"{c['unfused']['max']:.4f} ms ({REPEATS} repeats of {CALLS} calls, in turns); "
                  f"the bare fused kernel {large[fname]['ms']:.4f} ms; the wrapper, which reads "
                  f"the coefficients back on every call, {wrapper_ms[name]:.4f} ms")
        name, (_, _, _, sq_fn, _, X, Ui) = next(iter(k7.items()))
        busy = device_busy_share(lambda: sharded.shardmap_window_rmse(mesh1, sq_fn, X, Ui, H))
        composition[name]["device_busy_share"] = busy
        # the Fossen fit with mesh= on the one-rank group (eager; the loss and
        # gradients all-reduced) against mesh=None, at T6's shape
        t0 = time.perf_counter()
        meshed = sysid.fit_thruster(fit_ctx["X_tr"], fit_ctx["U_tr"], DT, steps=FIT_CHECK_STEPS,
                                    mesh=mesh1, **fit_ctx["kw"])
        torch.cuda.synchronize()
        mesh_s = time.perf_counter() - t0
        one = fit_ctx["eager"]
        rel_l = float(((meshed.losses - one.losses).abs() / one.losses.abs()).max())
        d_s = (meshed.log_scales - one.log_scales).abs()
        rel_s = float((d_s / (one.log_scales.abs() + 1e-5 / MESH_RTOL["scales"])).max())
        print(f"Fossen fit with mesh= at world 1 ({K7_BACKEND}) against mesh=None over "
              f"{FIT_CHECK_STEPS} steps: losses rel {rel_l:.3e} (rtol {MESH_RTOL['losses']:g}), "
              f"log-scales max|d| {float(d_s.max()):.3e} (rtol {MESH_RTOL['scales']:g}, atol 1e-5); "
              f"{mesh_s:.3f} s [{card}]")
        if rel_l > MESH_RTOL["losses"] or not torch.allclose(
                meshed.log_scales, one.log_scales, rtol=MESH_RTOL["scales"], atol=1e-5):
            fail("the Fossen fit with mesh= at world 1 differs from mesh=None")
        learned["sysid"]["mesh_world1"] = dict(loss_rel=rel_l, scale_rel=rel_s, seconds=mesh_s)
        estimation["checks"]["sharded_banks_world1"] = est_bank_checks(mesh1, dev, card)
        ctrl["checks"]["mppi_world1"] = control_mesh_check(mesh1, dev, card)
    finally:
        dist.destroy_process_group()

    mark("K7")
    # 7. K8: the ceiling probes -------------------------------------------------------
    def clocks():
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
            check=True).stdout.strip()

    L = cp.LANES
    probes = {  # name: (measure, launch, plain, budget kwargs, work units per call, unit)
        "fma_peak": (cp.measure_fma_peak, cp.launch_fma_peak, cp.fma_peak_plain, {},
                     3 * L * cp.ITERS["fma_peak"] * cp.STREAMS, "flops/s"),
        "transcendental_peak": (
            cp.measure_transcendental_peak, cp.launch_transcendental_peak,
            cp.transcendental_peak_plain, {}, L * cp.ITERS["transcendental_peak"] * cp.STREAMS,
            "sinf/s"),
        "fma_tree_peak": (cp.measure_fma_tree_peak, cp.launch_fma_tree_peak,
                          cp.fma_tree_peak_plain, {},
                          cp.FMA_TREE_FLOPS_PER_ITER * L * cp.ITERS["fma_tree_peak"], "flops/s"),
        "quat_mix_peak": (cp.measure_quat_mix_peak, cp.launch_quat_mix_peak,
                          cp.quat_mix_peak_plain, {"method": "rk4"},
                          L * cp.ITERS["quat_mix_peak"], "quat13 RK4 steps/s"),
    }
    k8_launches = {}

    def k8_path():
        out = {}
        for name, (measure, _, _, kw, _, unit) in probes.items():
            sweep = {b: measure(block=b, device=dev, **kw) for b in PROBE_BLOCKS}
            best = max(sweep, key=sweep.get)
            out[name] = (sweep[best], best, sweep)
            print(f"K8 {name}: " + ", ".join(f"block {b}: {r:.6e}" for b, r in sweep.items())
                  + f" {unit}; clocks.sm, power.draw, power.limit: {clocks()}")
        out["quat_mix_euler"] = cp.measure_quat_mix_peak(
            "euler", block=out["quat_mix_peak"][1], device=dev)
        print(f"K8 quat_mix_peak at the Euler budget: {out['quat_mix_euler']:.6e} quat13 Euler "
              f"steps/s; clocks.sm, power.draw, power.limit: {clocks()}")
        return out

    rates = drive("K8 probes", list(probes), k8_path, into=k8_launches)
    xs = torch.from_numpy(rng.uniform(0.3, 0.7, size=L).astype(np.float32)).to(dev)
    k8_meta = {}

    def probe_err(name, launch, plain, block, kw):
        got, want = launch(xs, CHECK_ITERS, block=block, **kw), plain(xs, CHECK_ITERS, **kw)
        if name == "fma_peak":
            print("fma_peak: held by its increment over the streams' starting sum")
            got, want = cp.fma_peak_increment(xs, got), cp.fma_peak_increment(xs, want)
        return max_err(got, want, name)

    for name, (_, launch, plain, kw, work, unit) in probes.items():
        rate, block, sweep = rates[name]
        err[name] = probe_err(name, launch, plain, block, kw)
        ms[name] = 1e3 * work / rate
        plain_ms[name] = cuda_event_time(lambda: plain(xs, CHECK_ITERS, **kw), iters=2)
        k8_meta[name] = dict(
            rate=rate, rate_unit=unit, block=block, sweep={str(b): r for b, r in sweep.items()},
            lanes=L, iters=cp.ITERS[name], check_iters=CHECK_ITERS,
            kernel_ms_at_check_iters=cuda_event_time(
                lambda: launch(xs, CHECK_ITERS, block=block, **kw), iters=20))
    ops_per_unit = {"fma_peak": 1, "transcendental_peak": TRIG_OPS + 2, "fma_tree_peak": 1,
                    "quat_mix_peak": quat_ops("rk4")}
    for name, (*_, work, _) in probes.items():
        bounds[name] = bound(work * ops_per_unit[name], 8 * L)
        shapes[name] = (f"{L} lanes x {cp.ITERS[name]} iterations at {k8_meta[name]['block']} "
                        f"threads per block; plain version at {CHECK_ITERS} iterations")
    k8_meta["quat_mix_peak"]["rate_euler"] = rates["quat_mix_euler"]
    # the Euler budget's instantiation, quat_mix_kernel<118, 2, 14>, prices K5 and K7
    print("quat_mix_peak at the Euler budget:")
    mix_err = {"rk4": err["quat_mix_peak"],
               "euler": probe_err("quat_mix_peak", cp.launch_quat_mix_peak,
                                  cp.quat_mix_peak_plain, rates["quat_mix_peak"][1],
                                  {"method": "euler"})}
    err["quat_mix_peak"] = max(mix_err.values())
    k8_meta["quat_mix_peak"].update(max_abs_err_rk4=mix_err["rk4"],
                                    max_abs_err_euler=mix_err["euler"])

    # each probe's loop must hold its work: (function name part, probe, check)
    mix_plans = [cp.quat_mix_plan(QUAT_BUDGET[m]) for m in ("rk4", "euler")]
    sass_checks = [
        ("fma_peak_kernel", "fma_peak",
         lambda loop, total: loop["FFMA"] >= cp.STREAMS and loop["FFMA"] == loop["FMUL"]),
        ("sin_peak_kernel", "transcendental_peak",      # exact sinf: no MUFU.SIN
         lambda loop, total: total["MUFU.SIN"] == 0 and loop["FFMA"] >= cp.STREAMS),
        ("fma_tree_kernel", "fma_tree_peak",
         lambda loop, total: loop["FFMA"] >= cp.CHAINS * cp.DEPTH),
    ] + [(f"quat_mix_kernelILi{pl['horner']}ELi{pl['n_rsqrt']}E", "quat_mix_peak",
          lambda loop, total, pl=pl: (loop["FFMA"] >= pl["horner"]
                                      and loop["MUFU.RSQ"] == pl["n_rsqrt"]))
         for pl in mix_plans]
    sass = cp.sass_loop_counts("probes")
    if sass is None:
        print("SASS: cuobjdump not found; loop bodies not read")
    else:
        for key, probe, ok in sass_checks:
            fns = [fn for fn in sass if key in fn]
            if len(fns) != 1:
                fail(f"SASS: {len(fns)} functions match {key}")
            loop, total = sass[fns[0]]["loop"], sass[fns[0]]["total"]
            counts = {op: n for op, n in sorted(loop.items())
                      if op in ("FFMA", "FMUL", "FADD", "FMNMX", "FSEL", "FSETP")
                      or op.startswith("MUFU")}
            print(f"SASS {key}: loop body {counts} of {sum(loop.values())} instructions; "
                  f"whole function FFMA {total['FFMA']}, "
                  f"MUFU {sum(n for op, n in total.items() if op.startswith('MUFU'))}")
            k8_meta[probe].setdefault("sass_loop", {})[key] = counts
            if not ok(loop, total):
                fail(f"SASS of {fns[0]}: the loop body does not hold the probe's work")

    mark("K8")
    # 8. ceilings from the measured rates ----------------------------------------------
    tree = rates["fma_tree_peak"][0]
    sin_rate = rates["transcendental_peak"][0]
    mix = {"rk4": rates["quat_mix_peak"][0], "euler": rates["quat_mix_euler"]}
    sin_price = tree / sin_rate - 2
    rsqrt_price = (tree / mix["rk4"] - 2 * QUAT_BUDGET["rk4"]["slots"]) / QUAT_BUDGET["rk4"]["sqrt"]
    print(f"measured prices in FMA-tree flops: one sinf {sin_price:.2f} (the probe's own FFMA "
          f"taken out), one rsqrtf {rsqrt_price:.2f} (a quat13 RK4 step's {QUAT_BUDGET['rk4']['slots']} "
          f"issue slots at 2 flops each taken out, cheap ops priced as one slot)")
    print(f"FMA-tree rate {tree:.6e} flops/s = {tree / FP32_PEAK:.4f} of {FP32_PEAK:.3g}")

    def row_ceiling(n_steps, method, extra_flops=0):
        b = ROW_BUDGET[method]
        return 1e3 * n_steps * ((b["flops"] + extra_flops + DIV_OPS * b["div"]) / tree
                                + b["trig"] / sin_rate)

    n_app, n_big = (N_REC - H) * H, N_LARGE * H
    ceiling = {
        "rollout_final": row_ceiling(steps, "rk4"),
        "shared_tau": 1e3 * T_ROLL * act_ops / tree,
        "batched_rollout": row_ceiling(steps, "rk4", act_ops),
        "window_eval": row_ceiling(n_app, "euler", act_ops),
        "window_eval_wrench": row_ceiling(n_app, "euler"),
        "window_eval_quat": 1e3 * n_app / mix["euler"],
        "rollout_final_quat": 1e3 * steps / mix["rk4"],
    }
    ceiling_large = {"window_eval": row_ceiling(n_big, "euler", act_ops),
                     "window_eval_wrench": row_ceiling(n_big, "euler"),
                     "window_eval_quat": 1e3 * n_big / mix["euler"]}
    for name, (*_, endpoint) in FUSED.items():      # the fused forms do the same steps
        ceiling[name], ceiling_large[name] = ceiling[endpoint], ceiling_large[endpoint]
    for name, (kname, *_) in k7.items():
        ceiling[name] = ceiling_large[kname]
    for name in ceiling:      # the probes price operations; bytes keep their bound
        if bounds[name][1] == "bytes":
            ceiling[name] = max(ceiling[name], bounds[name][0])
    for name, c in ceiling.items():
        print(f"ceiling {name}: {c:.4f} ms; kernel {ms[name]:.4f} ms = {c / ms[name]:.3f} of it"
              + ("  (FASTER than the additive ceiling)" if ms[name] < c else ""))
    for name, c in ceiling_large.items():
        large[name]["ceiling_ms"] = c
    mark("ceilings")
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s after the device query; phases "
          + json.dumps({k: round(v, 1) for k, v in phase_s.items()}))

    # 9. results ------------------------------------------------------------------
    src = "bluerov2_dynamics_tpu_torch/csrc/"
    k7_src = "bluerov2_dynamics_tpu/parallel/sharded.py:117 _shardmap_window_rmse"
    sum_src = "with the per-shard jnp.sum(d * d) of bluerov2_dynamics_tpu/parallel/sharded.py:179"
    kernels_meta = [
        ("rollout_final", "rollout.cu",
         "bluerov2_dynamics_tpu/ops/pallas_rollout.py:208 make_rollout_final_pallas"),
        ("shared_tau", "rollout.cu",
         "bluerov2_dynamics_tpu/ops/pallas_rollout.py:34 shared_tau_sequence "
         "(the lax.scan feeding K1, :256)"),
        ("window_eval", "window_eval.cu",
         "bluerov2_dynamics_tpu/ops/pallas_eval.py:36 _make_thruster_window_kernel"),
        ("batched_rollout", "batched_rollout.cu",
         "bluerov2_dynamics_tpu/ops/pallas_eval.py:285 make_batched_rollout_pallas"),
        ("window_eval_wrench", "window_eval.cu",
         "bluerov2_dynamics_tpu/ops/pallas_eval.py:250 _make_wrench_window_kernel"),
        ("window_eval_quat", "quat.cu",
         "bluerov2_dynamics_tpu/ops/pallas_quat.py:143 _make_quat_window_kernel"),
        ("rollout_final_quat", "quat.cu",
         "bluerov2_dynamics_tpu/ops/pallas_quat.py:170 make_rollout_final_pallas_quat"),
        ("window_sq", "window_eval.cu",
         "bluerov2_dynamics_tpu/ops/pallas_eval.py:36 _make_thruster_window_kernel " + sum_src),
        ("window_sq_wrench", "window_eval.cu",
         "bluerov2_dynamics_tpu/ops/pallas_eval.py:250 _make_wrench_window_kernel " + sum_src),
        ("window_sq_quat", "quat.cu",
         "bluerov2_dynamics_tpu/ops/pallas_quat.py:143 _make_quat_window_kernel " + sum_src),
        ("sharded_window_eval", "window_eval.cu", k7_src),
        ("sharded_window_eval_wrench", "window_eval.cu", k7_src),
        ("sharded_window_eval_quat", "quat.cu", k7_src),
        ("fma_peak", "probes.cu", "bench.py:115 measure_vpu_fma_peak (pallas_call :150)"),
        ("transcendental_peak", "probes.cu",
         "bench.py:165 measure_vpu_transcendental_peak (pallas_call :196)"),
        ("fma_tree_peak", "probes.cu", "bench.py:209 measure_vpu_fma_tree_peak (pallas_call :250)"),
        ("quat_mix_peak", "probes.cu", "bench.py:263 measure_quat_mix_peak (pallas_call :354)"),
    ]
    counts = {**launches, **k8_launches,
              **{name: k7_launches[v[0]] for name, v in k7.items()}}
    # the redesigned kernels' resources and plans: K2, K4 and K5 at the apps'
    # starts (and the full recording's), their K7 bodies at the full recording's
    app_n = N_REC - H
    for name, pr in (("window_eval", "PR 5"), ("window_sq", "PR 5"), ("window_eval_wrench", "PR 6"),
                     ("window_sq_wrench", "PR 6"), ("window_eval_quat", "PR 6"),
                     ("window_sq_quat", "PR 6")):
        redesigned[name] = dict(redesigned[f"{name} {app_n}"], pr=pr,
                                large=redesigned[f"{name} {N_LARGE}"])
    for name, (fname, *_) in k7.items():
        redesigned[name] = dict(redesigned[f"{fname} {N_LARGE}"],
                                pr="PR 5" if fname == "window_sq" else "PR 6")
    kernels = []
    for name, source, replaces in kernels_meta:
        rtol, atol = TOL["rmse"] if name in k7 else TOL[name]
        entry = dict(name=name, route="cuda", source=src + source, replaces=replaces,
                     launches=counts[name], max_abs_err=err[name], max_abs_diff=err[name],
                     tol=dict(rtol=rtol, atol=atol), ms=ms[name], kernel_ms=ms[name],
                     plain_ms=plain_ms[name], bound_ms=bounds[name][0],
                     bound_by=bounds[name][1], library_ms=None, shape=shapes[name],
                     ceiling_ms=ceiling.get(name))
        if name in large:
            entry["large"] = large[name]
        if name in k8_meta:
            entry.update(k8_meta[name])
        if name in wrapper_ms:
            rtol, atol = TOL["sharded_rmse"]
            entry.update(wrapper_ms=wrapper_ms[name], composition_ms=composition[name],
                         launches_unfused_offset_blocks=k7_launches[k7[name][1]],
                         max_abs_err_vs_unsharded_kernel=k7_unsharded_err[name],
                         tol_vs_unsharded_kernel=dict(rtol=rtol, atol=atol))
        if name in FUSED:
            entry["evaluator_ms"] = evaluator_ms[FUSED[name][0]]
        if name in event_ms:
            entry["event_ms"] = event_ms[name]
        if name in redesigned:
            r = redesigned[name]
            entry.update(regs=r["regs"], blocks_per_sm=r["blocks_per_sm"],
                         redesigned=r.get("pr", "PR 4"))
            if name not in ("rollout_final", "batched_rollout"):
                entry.update(lanes=r["lanes"], warps=r["warps"],
                             **({"plan": r["plan"]} if "plan" in r else {}),
                             **({"large_plan": r["large"]} if "large" in r else {}))
        if name in pair_checked:
            entry["max_abs_err_by_shape"] = pair_checked[name]
        if name == "rollout_final":
            entry.update(e2e_ms=k1_e2e, on_tau_seq_ms=k1_ms["on tau_seq"],
                         kernels_a_call=len(k1_kernels) if k1_events else None,
                         max_abs_err_on_tau_seq=err["rollout_final_on_tau_seq"],
                         max_abs_err_vs_serial_order=err["rollout_final_serial"],
                         max_abs_err_by_shape=xs_checked)
        if name == "shared_tau":
            entry.update(inside="rollout_final",
                         ms_of="the prologue kernel launched alone; the main path runs the "
                               "prologue inside rollout_final and launches this kernel no time",
                         k1_inside_minus_on_tau_seq_ms=ms["rollout_final"] - min(k1_ms["on tau_seq"]),
                         max_abs_err_by_shape=tau_checked)
        if name == "batched_rollout":
            entry["checked"] = (f"{B_ROLL - n_near} of {B_ROLL} trajectories; {n_near} near the "
                                f"gimbal singularity left out (max|kernel - plain| {near_diff:.3e})")
        kernels.append(entry)
    kernels.append(dict(name="sysid_window", route="cuda", source=src + "sysid_window.cu",
                        replaces="none: the JAX fit takes jax.value_and_grad of the window loss "
                                 "through a lax.scan (bluerov2_dynamics_tpu/models/sysid.py:135-173)",
                        **fit_ctx["sysid_window"]))
    kernels.append(lag_history_entry(dev, card, fit_ctx["lag_history_launches"]))
    print(f"measured prices: " + json.dumps({"sinf_flops": sin_price, "rsqrtf_flops": rsqrt_price,
                                              "fma_tree_share_of_peak": tree / FP32_PEAK}))
    print("koopman apps: " + json.dumps(apps, default=float))
    print("learned apps: " + json.dumps(learned, default=float))
    print("demo: " + json.dumps(demos, default=float))
    print("estimation: " + json.dumps(estimation, default=float))
    print("control: " + json.dumps(ctrl, default=float))
    print("ingest: " + json.dumps(ingest, default=float))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
