#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``legged_gym_dev_tpu_torch``).

Runs on one CUDA card (an H100 for the recorded numbers):

1. builds the port's CUDA kernels from ``legged_gym_dev_tpu_torch/csrc``;
2. prints the card's name and power limit (``nvidia-smi``);
3. kernel phase: holds each kernel against its plain PyTorch version on
   random well-conditioned SPD block-tridiagonal systems at the main
   path's shapes (S=51, b=5; B=2048 single-RHS, B=1024 with R=50 and
   B=2048 with R=51 multi-RHS) and times kernel (through its wrapper
   and alone, as a multiple of its bound), plain version and a library
   yardstick (``torch.linalg.solve`` / ``cholesky`` / ``cholesky_solve``
   on the assembled banded system; the port never calls these); the build
   report's registers, spills and shared memory per kernel are printed;
   then the same for the b=10 instances (ExtendedLateralUnicycle's staged
   block; bt_solve at B=2048, bt_factor + bt_msolve at B=1024 with R=50;
   bt_msolve there is ``bt_msolve_kernel_wide``), with their launch
   shapes and waves and the b=8 instances' times alone beside them;
4. main path, through the port's entry points, on bench.py's randomised
   ``gap`` batch: l1 at B=2048 and NN_oneshot (130->128->128->50 softplus
   MLP, random weights from a seed) at B=1024, N=50, with the
   ``certify_staged_batched`` verdicts, then a short closed loop at
   B=1024; the launch counters are zeroed before and read after;
5. a small-input reference check: the same solve on the card (kernels)
   and on the CPU (plain versions) must agree;
6. a ``torch.profiler`` window of each mode: device busy share and the
   kernels with the most device time;
7. substep phase: the physics-substep kernel (``csrc/substep.cu``) against
   its plain PyTorch version at B=4096 on the three test robots
   (``tests/torch_robot_cases.py``: the 12-joint quadruped, the 4-joint
   robot with a prismatic foot and springs, and the hopper of the
   training path, nj=4, nc=5), random well-conditioned states with
   per-env DR rows; kernel, plain and bound times; then each joint count
   that no robot of the robots phase has (2, 3, 5, 7-9, 11, 13-15, 17-23)
   on its synthetic chain: held to the plain version, 20 launches alone,
   its bound;
8. rl phase (main path of the RL slice): the ROM-trajectory task on the
   quadruped at B=4096 (``make_trajectory_env`` with the ANYmal-C
   settings), a random-weight 512-256-128 ``ActorCritic`` and one PPO
   rollout of 24 env steps (96 substep launches, counted), env-steps/s,
   the share of ``_contact_forces``, and a ``torch.profiler`` window of
   one env step;
9. train phase (main path of the training slice), through the port's
   ``cli train`` on the card: ``hopper_trajectory`` on the test hopper at
   B=4096 with a config that takes ``configs/rl/hopper_single_int.yaml``
   (read by the port's ``load_config``: reward scales, the 8-stage
   curriculum, a [128, 64, 32] ELU policy from a seed) and sets
   ``env.urdf_path``, PPO defaults (24 steps, 5 epochs, 4 minibatches,
   adaptive KL), the runner from ``task_registry.make_alg_runner``, 3
   iterations of ``OnPolicyRunner.learn`` (576 substep launches,
   counted), every iteration's metrics, learning env-steps/s, and the
   checkpoint round trip (the run's ``latest`` resumed by
   ``make_alg_runner(resume=True)``: the same inference policy bit for
   bit); then one more iteration driven as ``rollout`` and
   ``ppo_update`` between CUDA events for the rollout / update split and
   the env's ms per step; at the end of the script a ``torch.profiler``
   window of one hopper env step (busy share, device ops) and the share of
   the controller's per-substep contact FK in its time and its ATen ops;
10. train_rnn phase: the same for 1 iteration of
   ``hopper_single_int_recurrent.yaml`` (LSTM 256, [256, 128]; 192
   launches);
11. tube phase (main path of the tube-learning slice), through the port's
   ``cli collect`` / ``cli train-tube`` on the card: ROM-tracking
   collection as ``configs/data_generation/default_custom.yaml`` sets it
   (``rom_tracking``, B=4096, 4 epochs of 8 s, seed 42: 16384 episodes of
   80 ROM ticks, 2 env steps a tick), the rollout written as ``.tdl``
   shards and one epoch streamed through ``make_loader`` (the native C++
   loader), the one-shot tube net of
   ``configs/tube_learning/tube_learning_oneshot.yaml`` (2x128
   softplus_b5, H_rev 25, H_fwd 50, vector loss, batch 2048, lr 1e-3)
   trained for ``TUBE_EPOCHS`` of its 1000 epochs, its split-conformal
   width scale on the held-out split, and the scaled net through
   ``solve_tube_fast_batched`` NN_oneshot on the gap batch (B=1024, N=50,
   H_rev 25; bt_solve, bt_factor and bt_msolve launches zeroed before and
   read after) with a card-against-CPU check at B=8 (scenarios whose two
   CPU linsolve routes disagree, a kink of the tube, left out); then the
   hopper's
   Raibert collection (``collect_tracking``, B=4096, 2 ROM ticks: substep
   launches at nj=4 counted);
12. plan phase (main path of the planning slice, on one card):
   ``[plan goldens]`` BASELINE configs 1-5 through the port's generic
   ``solve_nominal`` / ``solve_tube`` / ``closed_loop_tube_mpc`` /
   ``solve_tube_batched`` at tests/test_goldens.py's bars (the runner of
   tests/test_torch_goldens.py, loaded by path); ``[plan zoo]`` the six
   ROMs (b = 5, 7, 6, 7, 8, 10) through ``solve_tube_fast_batched`` l1 at
   B=2048, N=50, 20x10 on the kernels, and Unicycle (b=6) and
   ExtendedLateralUnicycle (b=10) each with a random NN tube of its ROM's
   widths at B=1024 (solves/s, feasible fraction, launches per kernel and
   b; each NN solve exactly 80 bt_factor and 80 bt_msolve launches);
   ``[plan cr]`` l1 at N=200 (S=201), B=1024
   on "auto" (cyclic reduction) and "pallas" (K1 at S=201), plans within
   2e-3 of each other; ``[plan generic]`` the dense generic l2 solve at
   B=1024 beside the staged l2 solve, and the generic closed loop at
   config 4's shapes (N=20, H=15) on B=1024; ``[plan bucketed]`` the
   two-phase solve at B=2048 beside the single-phase one; ``[plan cli]``
   ``cli plan`` (staged l1; ``--generic --tube-dyn l2_rolling``;
   ``--nominal``) and ``cli mpc`` (staged and ``--generic``, H=75), and
   both with ``--tube-dyn NN_oneshot --H-rev 25`` and the tube phase's
   calibrated net (a seeded random net of its widths when the tube phase
   did not run) in the port's model file, a ``.mat`` read back;
   ``[plan coverage]`` that net through the generic closed loop (H=75,
   N=50) with ``evaluate_tube_on_mpc_trace`` and
   ``trace_conformal_scale``; the launch counters zeroed before and read
   after (``[launches] plan path``, every b of the zoo launched, 80
   bt_factor and 80 bt_msolve at b=10), then the
   b=10 ROM's plans on the card against the CPU at B=8 with the
   ``[tube ref]`` kink screen;
13. robots phase (main path of the robots slice): the nine tasks the
   port newly registers, each from a test robot of
   ``tests/torch_robot_cases.py`` (the A1- and Cassie-topology stand-ins,
   the ANYmal-C-topology quadruped, the 10-joint biped for Adam; the LSTM
   actuator net from a TorchScript file drawn from a seed), at B=4096 for
   one PPO rollout of ``ROBOT_STEPS`` = 8 env steps (cut from a PPO
   rollout's 24 to make room for the play phase) with K3's launches per joint count (32,
   64 for Cassie's 8 substeps, 0 on rough terrain: the reference sends
   non-flat terrain to the plain substep), finite observations and
   rewards, env ms per step; the rough tasks on the 10x20 curriculum
   terrain; then ``cli train`` on the card for 2 iterations each of
   ``anymal_c_velocity`` and ``cassie_velocity``
   (``configs/rl/default.yaml``) and ``anymal_c_rough``
   (``configs/rl/anymal_c_rough.yaml``): learning
   env-steps/s, the rollout/update split, and on rough terrain the plain
   substep's share of an env step; ``[robots eval]``
   ``evaluate_velocity_tracking`` of anymal_c_velocity's learned policy
   at B=4096 for ``ROBOT_EVAL``'s 100 steps (settle 20): the four
   statistics finite and in range, exactly 400 K3 launches, its wall;
   then K3 against its plain version on
   one random step of A1, Cassie, the 10-joint biped and the chains of 1,
   6, 16 and 24 joints, with its time alone and its bound (every K3
   instance is built at the start, one ``nvcc`` each, all at once);
14. play phase (main path of the play slice): ``OnPolicyRunner.learn``
   for 2 iterations of ``anymal_c_trajectory`` (the test quadruped,
   B=4096) and 1 of the recurrent hopper
   (``hopper_single_int_recurrent.yaml``, the test hopper), checkpoints
   under ``build/``; ``[play]`` ``cli.play`` on each resumed runner at
   B=4096 (200 env steps on the quadruped, 20 on the hopper, which plays
   for its LSTM export) with ``--export`` and ``--mat``: env-steps/s with
   the per-step host fetch of env 0's signals, exactly steps x decimation
   K3 launches, the .mat read back with every signal, each export
   (TorchScript, the ``torch.export`` program; the stateful LSTM module
   over 10 calls) within 1e-5 of the inference policy; ``[play eval]``
   ``evaluate_tracking_policy`` with the zero, square and circle fixtures
   at B=4096 and 400 steps (exactly 400 x decimation launches each);
   ``[play rom]`` ``cli train`` and ``cli play`` of ``rom_tracking`` at
   B=4096 as a subprocess, beside ``[dynamics]`` (the autodiff mass
   matrix, bias forces and contact kinematics against the analytic ones
   and ``forward_dynamics`` against ``torch.linalg.solve`` at B=4096 on
   the 12-joint robot, within 1e-4) and ``[array]`` (the array-form staged
   solver against the entry form, l1, B=256, N=50, 20x10: feasible >=
   0.98, co-feasible plans within 2e-3 on >= 90%);
15. mesh phase (main path of the mesh slice, in a process of its own
   beside the robots and play phases, its launches counted there; on a
   mesh of 4 shards of the one card, ``make_mesh(4, devices=[card] * 4)``,
   and over every card where there are several): ``[mesh substep]`` K3s, the sharded route
   (``substep_sharded``, the shard kernel ``substep_shard_kernel`` on each
   shard), on the quadruped at B=4096 with per-env DR rows against its
   plain version shard by shard (max relative error <= TOL_REL) and one
   unsharded K3 launch (<= 1e-6), exactly one shard-kernel launch per
   shard and none of K3, each output on its shard's device; its wrapper
   and device times beside the unsharded one, the plain version's and
   K3's bound; one shard's batch (B=1024) and the whole batch through K3
   and the shard kernel alone, equal bit for bit, timed in turns (K3,
   shard, shard, K3) behind a sleep; the shard kernel's launch shape
   (envs and blocks an SM, waves, registers); ``[mesh train]`` ``cli train --task anymal_c_velocity``
   (``configs/rl/default.yaml``, the test quadruped, B=4096, 2
   iterations) unsharded, with ``--dp-devices 1`` (bit for bit the
   unsharded run) and ``--dp-devices <cards>`` where there are several,
   then ``OnPolicyRunner(mesh=<4 shards>)``: learning env-steps/s, shard
   kernel launches exactly 4 x 24 x 4 x 2, one per shard and substep
   (``--dp-devices 1``: 24 x 4 x 2), and none of K3, replicas
   bit-identical after every update, finite metrics; ``[mesh
   curriculum]`` Cassie's command curriculum, one sharded step against
   one unsharded step (equal ranges on every shard); ``[mesh solve]`` l1
   at B=2048, N=50, 20x10 on the 4 shards and on a (2, 2) host mesh
   against unsharded (plans within 1e-5, 4x the bt_solve launches, equal
   verdict counts, certified on the 4 shards without the escalated
   restorations, solves/s); ``[mesh loop]`` the
   l1 closed loop at B=1024 for 3 ticks (executed z within 1e-5);
   ``[mesh collect]`` a
   ``rom_tracking`` collect step at B=4096 (equal on the envs that drew
   nothing);
16. flagship phase (main path of the flagship slice): the port's two
   end-to-end pipelines, ``scripts/torch_flagship_e2e.py`` (ROM-tracking
   collection with the PD tracker -> the one-shot tube net -> the batched
   NN-tube closed loop) and ``scripts/torch_flagship_rl_e2e.py``
   (``hopper_trajectory`` on the test hopper: PPO -> ``best{stage}``
   selection on the zero/square/circle fixtures beside the Raibert
   heuristic -> collection from the selected policy -> the tube net with
   its split-conformal scale -> the closed loop uncalibrated, calibrated
   and trace-calibrated), each a process on the card started after the
   substep phase and run beside the phases up to the tube phase; widths
   uncut (B=1024, COLLECT_ENVS=1024, TRAIN_ENVS=4096, FIXTURE_ENVS=256,
   N=50, H_rev=10), depth cut (``FLAGSHIP_KNOBS``); each must exit 0 with
   every key of its JAX script's report, finite numbers, adoption above
   0 in every closed loop, a positive conformal scale, calibrated
   per-step coverage >= 0.88, and bt_solve / bt_factor / bt_msolve and
   the substep kernel (nj=4) launched exactly as often as the knobs say
   (``flagship_expected``); per-resolve latency, resolves/s, adoption,
   coverage, each stage's wall and the selected checkpoint are printed;
17. scenarios phase (main path of the scenarios slice), a process of its
   own (``--child scenarios``) started after the plan phase and read after
   the play phase: ``[scenarios]`` bench.py's gap batch at bench width
   (N=50, 20x10; l1 at B=2048, NN_oneshot at B=1024, refresh 3) with a
   per-scenario ROM (``vel_max`` per axis in [0.18, 0.22], ``dt`` in
   [0.09, 0.11]) and, for NN_oneshot, a per-scenario net (the bench net
   plus N(0, 0.01) on its last layer and U(-0.2, 0.2) on its bias),
   timed in turns with the shared form (a warm-up each, then shared,
   per-scenario, per-scenario, shared): solves/s, each rep's wall, the
   feasible fraction and the max violation, every solve's bt_solve /
   bt_factor / bt_msolve launches exactly the schedule's; then
   ``[scenarios ref]`` the per-scenario batch at B=8, 8x6 on the card
   against the CPU (plans within 2e-3, a draw off a kink of the net);
18. routes phase, the JAX package's route switches as an A/B on the card:
   a process of its own (``--child routes``) started with
   ``LGDT_PALLAS_SUBSTEP=0 LGDT_PALLAS_MULTIRHS=0`` beside the robots and
   play phases: ``[routes] physics`` the 12-joint quadruped and the test
   hopper at B=4096 (per-env DR rows, a PD law), one decimated env step
   from a carried state on the sim ``RobotSim.create`` makes there (the
   plain route: no K3 launch) and with ``use_pallas_substep=True`` (K3
   once a substep), each substep of it held within ``TOL_REL`` from the
   same state, each route's median env-step wall; ``[routes]
   NN_oneshot`` ``[NN_oneshot]``'s solve and verdicts with the multi-RHS
   solves on ``factor_solve_entries`` (no K2f or K2s launch, K1 still)
   and on the kernels: feasible >= 0.98 each, the co-feasible plans
   within 2e-3 on >= 90% (the ``[array]`` bars); its launches compare
   kernels with plain routes and are not the main path's;
19. tools phase, the JAX system's profiling and schedule tools
   (``scripts/torch_profile_*.py``, ``torch_measure_imbalance.py``,
   ``torch_sweep_schedule.py``, ``torch_tune_loop_schedule.py``,
   ``torch_compile_time_quadruped.py``): a process of its own (``--child
   tools``) beside the robots and play phases that calls each tool's
   function on the card at B=256 with one timed rep, 2x2 solve schedules,
   loops of one tick, 2 shards and 2 of the sweep's schedules (the test
   robots through ``urdf_path``; the cold K3 build of
   ``compile_time_quadruped`` first): no exception, every number finite,
   each kernel it launches more than 0 times and K3 (and
   ``profile_nn_tube``'s solver kernels) exactly as its arguments give;
   its launches count on the main path;
20. mjcf phase: ``build_mjcf`` of every test robot of
   ``tests/torch_robot_cases.py`` (robots and chains) parsed with
   ``xml.etree``, its bodies and joints the model's;
21. prints one ``{"kernels": [...]}`` line (the b=10 instances and each K3
   joint count on rows of their own, the instances no robot runs measured
   on their chains in the substep phase; ``bt_solve``'s row counts the
   other block sizes' launches; ``substep_sharded``, the shard kernel, a
   row of its own with the mesh runs' launches), then, last, ``{"ok": true,
   "device": {...}}``.

Any failed check raises, so the script exits non-zero and prints no
result line. Without a CUDA device it exits non-zero at once.

Usage: ``python3 chip_smoke.py`` (all phases), or
``python3 chip_smoke.py --phases kernels,l1`` to run a subset while
debugging (phases: kernels, l1, nn, loop, ref, profile, substep, rl,
train, train_rnn, tube, plan, robots, play, mesh, flagship, scenarios,
routes, tools, mjcf; ``--phases plan`` is the planning slice alone,
``--phases robots`` the robots slice, ``--phases play`` the play slice,
``--phases mesh`` the mesh slice, ``--phases flagship`` the two flagship
pipelines, ``--phases scenarios,mjcf`` the scenarios slice, ``--phases
routes`` the route switches, ``--phases tools`` the tools).
"""
import argparse
import concurrent.futures
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

PHASES = ("kernels", "l1", "nn", "loop", "ref", "profile", "substep", "rl",
          "train", "train_rnn", "tube", "plan", "robots", "play", "mesh",
          "flagship", "scenarios", "routes", "tools", "mjcf")
N, H_REV = 50, 10
B_L1, B_NN = 2048, 1024
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12         # H100 SXM fp32 outside the tensor cores
SOURCES = {
    "bt_solve": "legged_gym_dev_tpu_torch/csrc/block_tridiag.cu",
    "bt_factor": "legged_gym_dev_tpu_torch/csrc/block_tridiag.cu",
    "bt_msolve": "legged_gym_dev_tpu_torch/csrc/block_tridiag.cu",
    "substep": "legged_gym_dev_tpu_torch/csrc/substep.cu",
    "substep_sharded": "legged_gym_dev_tpu_torch/csrc/substep.cu",
}
REPLACES = {
    "bt_solve": "legged_gym_dev_tpu/ops/pallas_block_tridiag.py:182",
    "bt_factor": "legged_gym_dev_tpu/ops/pallas_block_tridiag.py:463",
    "bt_msolve": "legged_gym_dev_tpu/ops/pallas_block_tridiag.py:481",
    "substep": "legged_gym_dev_tpu/ops/pallas_substep.py:237",
    "substep_sharded": "legged_gym_dev_tpu/ops/pallas_substep.py:257",
}
TOL_REL = 1e-4   # kernel vs plain version: max |diff| / max |plain|
PTXAS = {}       # nvcc's report per kernel instance of this run's builds
B_RL = 4096      # envs of the RL rollout and of the substep check
ROOT = Path(__file__).resolve().parent
TRAIN_ITERS = {"train": 3, "train_rnn": 1}
TRAIN_CONFIGS = {"train": "configs/rl/hopper_single_int.yaml",
                 "train_rnn": "configs/rl/hopper_single_int_recurrent.yaml"}
TUBE_COLLECT = "configs/data_generation/default_custom.yaml"
TUBE_TRAIN = "configs/tube_learning/tube_learning_oneshot.yaml"
TUBE_EPOCHS = 40     # of the config's 1000
H_REV_TUBE = 25


def ptxas_summary(report):
    """Registers, stack, spills and static shared memory per kernel from
    nvcc's ``-Xptxas -v`` report: {mangled name: dict}."""
    out, name = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            out[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            out[name].update(stack=int(m.group(1)),
                             spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            out[name]["static_smem"] = int(sm.group(1)) if sm else 0
    return out


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


# ---------------------------------------------------------------------------
# work counts for the bound (each input read once, each output written once)
# ---------------------------------------------------------------------------

def _chol_ops(b):
    return sum(2 * j * (b - j) + 3 + (b - j) for j in range(b))


def _cho_solve_ops(b):
    return 2 * b * b


def _factor_ops(S, b):
    nl = b * (b + 1) // 2
    per_stage = b * _cho_solve_ops(b) + nl * 2 * b + _chol_ops(b)
    return _chol_ops(b) + (S - 1) * per_stage


def _subst_ops(S, b):
    fwd = S * _cho_solve_ops(b) + (S - 1) * 2 * b * b
    bwd = (S - 1) * (2 * b * b + _cho_solve_ops(b) + b)
    return fwd + bwd


def work(kernel, S, b, B, R=1):
    """(bytes, operations) of one call at these shapes, fp32: the function's
    own inputs and outputs. bt_factor reads D's lower triangle and L and
    writes the packed factor; bt_msolve reads the factor, L and the
    right-hand sides and writes x. (The stage records that bt_factor writes
    for bt_msolve also carry a copy of L, the reciprocal pivots and float4
    padding: the design's choice, not counted.)"""
    nl = b * (b + 1) // 2
    D, L = 4 * B * S * nl, 4 * B * (S - 1) * b * b
    if kernel == "bt_solve":
        return D + L + 2 * 4 * B * S * b, B * (_factor_ops(S, b)
                                               + _subst_ops(S, b))
    if kernel == "bt_factor":
        return 2 * D + L, B * _factor_ops(S, b)
    return D + L + 2 * 4 * B * S * b * R, B * R * _subst_ops(S, b)


def bound(kernel, S, b, B, R=1):
    nbytes, ops = work(kernel, S, b, B, R)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------

def time_ms(fn, reps, warmup=2):
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(call, reps=20, sleep_cycles=20_000_000):
    """Device time a launch: CUDA events around ``reps`` launches that the
    host queues behind a sleep kernel (``torch.cuda._sleep``, about 10 ms),
    so they run back to back on the device whatever the host's launch
    rate. Returns (ms, host ms to queue them, sleep ms); ms is None when
    the host took more than 80% of the sleep to queue them, and then only
    the plain CUDA-events time stands. (No torch.profiler here: after a
    profiler session every launch costs the host more, which would tax the
    main path that runs after this phase; see
    scripts/torch_profiler_overhead.py.)"""
    import torch

    call()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    torch.cuda._sleep(sleep_cycles)
    ev[1].record()
    t0 = time.perf_counter()
    for _ in range(reps):
        call()
    host_ms = 1e3 * (time.perf_counter() - t0)
    ev[2].record()
    torch.cuda.synchronize()
    sleep_ms = ev[0].elapsed_time(ev[1])
    ms = ev[1].elapsed_time(ev[2]) / reps
    return (ms if host_ms < 0.8 * sleep_ms else None), host_ms, sleep_ms


def fmt_ms(ms, host_ms=None, sleep_ms=None):
    """A device time for the log: 'not measured' where the host could not
    queue the launches ahead of the device."""
    if ms is not None:
        return f"{ms:.4f}"
    return (f"not measured (queueing took {host_ms:.2f} ms of a "
            f"{sleep_ms:.2f} ms sleep)")


def spd_systems(B, S, b, R, seed, dev):
    """Random well-conditioned SPD block-tridiagonal systems (numpy seed):
    D = A A^T + (2+b) I, L = 0.3 N(0, 1)."""
    import torch

    rng = np.random.default_rng(seed)
    A = rng.normal(size=(B, S, b, b)).astype(np.float32)
    D = (np.einsum("bsij,bskj->bsik", A, A)
         + (2.0 + b) * np.eye(b, dtype=np.float32)).astype(np.float32)
    L = (0.3 * rng.normal(size=(B, S - 1, b, b))).astype(np.float32)
    rhs = rng.normal(size=(B, S, b, R)).astype(np.float32)
    return tuple(torch.as_tensor(x, device=dev) for x in (D, L, rhs))


def dense_system(D, L):
    """The assembled (B, S*b, S*b) banded matrix (library yardstick)."""
    import torch

    B, S, b, _ = D.shape
    K = torch.zeros(B, S * b, S * b, device=D.device)
    for k in range(S):
        K[:, k * b:(k + 1) * b, k * b:(k + 1) * b] = D[:, k]
    for k in range(S - 1):
        K[:, (k + 1) * b:(k + 2) * b, k * b:(k + 1) * b] = L[:, k]
        K[:, k * b:(k + 1) * b, (k + 1) * b:(k + 2) * b] = \
            L[:, k].transpose(-1, -2)
    return K


def errs(x, ref):
    ax = float((x - ref).abs().max())
    return ax, ax / max(float(ref.abs().max()), 1e-30)


def entry_lists(D, L):
    """Contiguous (B, T) entries of (B, T, b, b) blocks, as the solver
    hands them over."""
    b = D.shape[-1]
    return ([[D[:, :, i, j].contiguous() for j in range(b)]
             for i in range(b)],
            [[L[:, :, i, j].contiguous() for j in range(b)]
             for i in range(b)])


def kernel_phase(dev):
    import torch

    from legged_gym_dev_tpu_torch.ops import block_tridiag_kernels as btk

    S, b = N + 1, 5
    rec = {}

    # -- bt_solve through the entry-form wrapper (K1), B = 2048 and 1024
    for B in (B_L1, B_NN):
        D, L, rhs = spd_systems(B, S, b, 1, seed=B, dev=dev)
        Df, Lf = entry_lists(D, L)
        r = [rhs[:, :, i, 0].contiguous() for i in range(b)]
        x = torch.stack(btk.block_tridiag_solve_entries(Df, Lf, r, b), -1)
        x_pl = torch.stack(
            btk.block_tridiag_solve_entries_plain(Df, Lf, r, b), -1)
        torch.cuda.synchronize()
        ax, rel = errs(x, x_pl)
        print(f"[kernels] bt_solve entries B={B}: max_abs_err={ax:.3e} "
              f"rel={rel:.3e}")
        check(rel <= TOL_REL, f"bt_solve B={B} rel err {rel}")
        if B != B_L1:
            continue
        ms = time_ms(lambda: btk.block_tridiag_solve_entries(Df, Lf, r, b),
                     20)
        args, _ = btk.prepare_solve_entries(Df, Lf, r, b)
        k_ms = time_ms(lambda: btk._launch_solve(args, S, B, b, dev), 50)
        k_dev, *k_q = device_ms(
            lambda: btk._launch_solve(args, S, B, b, dev))
        p_ms = time_ms(
            lambda: btk.block_tridiag_solve_entries_plain(Df, Lf, r, b), 3,
            warmup=1)
        K = dense_system(D, L)
        rhs_d = rhs[..., 0].reshape(B, S * b, 1)
        lib_ms = time_ms(lambda: torch.linalg.solve(K, rhs_d), 5, warmup=1)
        x_lib = torch.linalg.solve(K, rhs_d).reshape(B, S, b)
        lib_ax, _ = errs(x, x_lib)
        bms, by = bound("bt_solve", S, b, B)
        smem = btk.launch_shape("bt_solve", S, b)["smem_bytes"]
        print(f"[kernels] bt_solve B={B}: wrapper {ms:.4f} ms "
              f"({ms / bms:.1f}x bound), kernel alone {k_ms:.4f} ms "
              f"({k_ms / bms:.1f}x bound; device {fmt_ms(k_dev, *k_q)}), "
              f"plain "
              f"{p_ms:.4f} ms, "
              f"torch.linalg.solve {lib_ms:.4f} ms "
              f"(|kernel-library|={lib_ax:.2e}), bound {bms:.4f} ms ({by}), "
              f"shared memory {smem} B a block")
        rec["bt_solve"] = dict(max_abs_err=ax, ms=ms, kernel_only_ms=k_ms,
                               kernel_device_ms=k_dev,
                               plain_ms=p_ms, bound_ms=bms, bound_by=by,
                               library_ms=lib_ms, x_bound=ms / bms,
                               kernel_only_x_bound=k_ms / bms,
                               shape=[B, S, b])
        del K

        # -- the array-form wrapper over the same kernel (K1b)
        xb = btk.block_tridiag_solve(D, L, rhs[..., 0])
        xb_pl = btk.block_tridiag_solve_plain(D, L, rhs[..., 0])
        torch.cuda.synchronize()
        ax_b, rel_b = errs(xb, xb_pl)
        ms_b = time_ms(lambda: btk.block_tridiag_solve(D, L, rhs[..., 0]),
                       20)
        p_ms_b = time_ms(lambda: btk.block_tridiag_solve_plain(
            D, L, rhs[..., 0]), 3, warmup=1)
        print(f"[kernels] bt_solve array-form wrapper B={B}: "
              f"max_abs_err={ax_b:.3e} rel={rel_b:.3e}, {ms_b:.4f} ms, "
              f"plain {p_ms_b:.4f} ms")
        check(rel_b <= TOL_REL, f"array-form bt_solve rel err {rel_b}")
        rec["bt_solve"].update(array_wrapper_max_abs_err=ax_b,
                               array_wrapper_ms=ms_b,
                               array_wrapper_plain_ms=p_ms_b)

    # -- bt_factor + bt_msolve (K2f, K2s): B=1024 R=50 (main path), then
    #    B=2048 R=51 (parity and time)
    for B, R in ((B_NN, N), (B_L1, N + 1)):
        D, L, rhs = spd_systems(B, S, b, R, seed=B + R, dev=dev)
        Df, Lf = entry_lists(D, L)
        cols = [rhs[:, :, i, :].contiguous() for i in range(b)]
        x = torch.stack(btk.block_tridiag_multirhs_entries(Df, Lf, cols, b),
                        2)
        x_pl = torch.stack(
            btk.block_tridiag_multirhs_entries_plain(Df, Lf, cols, b), 2)
        fargs, frec, rargs, xo = btk.prepare_multirhs_entries(Df, Lf, cols,
                                                              b)

        def factor():
            btk._launch_factor(fargs, S, B, b, dev)

        factor()
        rec_pl = btk.factor_records_plain(Df, Lf, b, B, S)
        torch.cuda.synchronize()
        f_ax, f_rel = errs(frec, rec_pl)
        ax, rel = errs(x, x_pl)
        print(f"[kernels] bt_factor B={B}: max_abs_err={f_ax:.3e} "
              f"rel={f_rel:.3e}; bt_msolve B={B} R={R}: "
              f"max_abs_err={ax:.3e} rel={rel:.3e}")
        check(f_rel <= TOL_REL, f"bt_factor B={B} rel err {f_rel}")
        check(rel <= TOL_REL, f"bt_msolve B={B} R={R} rel err {rel}")

        def msolve():
            btk._launch_msolve(frec, rargs, xo, S, B, R, b, dev)

        f_ms = time_ms(factor, 20)
        f_dev, *f_q = device_ms(factor)
        s_dev, *s_q = device_ms(msolve)

        def factor_with_table():
            fa, out, _, _ = btk.prepare_multirhs_entries(Df, Lf, cols, b)
            btk._launch_factor(fa, S, B, b, dev)
            return out

        ft_ms = time_ms(factor_with_table, 20)
        s_ms = time_ms(msolve, 50)
        w_ms = time_ms(
            lambda: btk.block_tridiag_multirhs_entries(Df, Lf, cols, b), 10)
        pf_ms = time_ms(lambda: btk._factor_plain(D, L), 3, warmup=1)
        chol_list = btk._factor_plain(D, L)
        ps_ms = time_ms(lambda: btk._substitute_plain(chol_list, L, rhs), 3,
                        warmup=1)
        K = dense_system(D, L)
        lf_ms = time_ms(lambda: torch.linalg.cholesky(K), 5, warmup=1)
        Kc = torch.linalg.cholesky(K)
        rhs_d = rhs.reshape(B, S * b, R)
        ls_ms = time_ms(lambda: torch.cholesky_solve(rhs_d, Kc), 5, warmup=1)
        del K, Kc
        fb, fby = bound("bt_factor", S, b, B)
        sb, sby = bound("bt_msolve", S, b, B, R)
        f_smem = btk.launch_shape("bt_factor", S, b)["smem_bytes"]
        s_smem = btk.launch_shape("bt_msolve", S, b, R)["smem_bytes"]
        print(f"[kernels] multi-RHS B={B} R={R}: bt_factor {f_ms:.4f} ms "
              f"({f_ms / fb:.1f}x bound; device {fmt_ms(f_dev, *f_q)}; "
              f"with its "
              f"table and output "
              f"{ft_ms:.4f}; plain {pf_ms:.4f}, "
              f"torch.linalg.cholesky {lf_ms:.4f}, bound {fb:.4f} {fby}, "
              f"shared memory {f_smem} B a block); "
              f"bt_msolve {s_ms:.4f} ms ({s_ms / sb:.1f}x bound; device "
              f"{fmt_ms(s_dev, *s_q)}; plain "
              f"{ps_ms:.4f}, torch.cholesky_solve {ls_ms:.4f}, bound "
              f"{sb:.4f} {sby}, shared memory "
              f"{s_smem} B a block); "
              f"wrapper (factor + msolve) {w_ms:.4f} ms")
        if (B, R) == (B_NN, N):
            rec["bt_factor"] = dict(max_abs_err=f_ax, ms=f_ms, plain_ms=pf_ms,
                                    bound_ms=fb, bound_by=fby,
                                    library_ms=lf_ms, x_bound=f_ms / fb,
                                    kernel_device_ms=f_dev,
                                    with_table_ms=ft_ms,
                                    multirhs_wrapper_ms=w_ms,
                                    shape=[B, S, b])
            rec["bt_msolve"] = dict(max_abs_err=ax, ms=s_ms, plain_ms=ps_ms,
                                    kernel_device_ms=s_dev,
                                    bound_ms=sb, bound_by=sby,
                                    library_ms=ls_ms, wrapper_ms=w_ms,
                                    x_bound=s_ms / sb, shape=[B, S, b, R])
    return rec


# ---------------------------------------------------------------------------
# main path
# ---------------------------------------------------------------------------

def bench_mlp_numpy(seed):
    """bench.py's 130->128->128->50 softplus-head tube MLP as numpy
    (weights (in, out), biases): Kaiming-uniform, the last layer x0.1 and
    bias -2.5."""
    wr = np.random.default_rng(seed + 1000)
    sizes = [H_REV + (H_REV + N) * 2, 128, 128, N]
    ws, bs = [], []
    for fan_in, fan_out in zip(sizes[:-1], sizes[1:]):
        bd = 1.0 / np.sqrt(fan_in)
        ws.append(wr.uniform(-bd, bd, (fan_in, fan_out)))
        bs.append(wr.uniform(-bd, bd, (fan_out,)))
    ws[-1] = ws[-1] * 0.1
    bs[-1] = bs[-1] * 0.0 - 2.5
    return ws, bs


def bench_batch(B, tube, dev, seed=0, mlp=None, h_rev=H_REV):
    """bench.py's randomised gap batch (numpy draws in bench.py's order)
    and, for NN_oneshot, ``mlp`` or else ``bench_mlp_numpy``'s net."""
    from legged_gym_dev_tpu_torch.interop import (
        mlp_from_numpy,
        trajopt_params_from_numpy,
    )
    from legged_gym_dev_tpu_torch.solver import PROBLEM_DICT

    prob = PROBLEM_DICT["gap"]
    nn = mlp
    if tube == "NN_oneshot" and mlp is None:
        nn = mlp_from_numpy(*bench_mlp_numpy(seed), activation="softplus_b5",
                            final_activation="softplus", device=dev)
    rng = np.random.default_rng(seed)
    z0 = prob["start"] + rng.uniform(-0.15, 0.15, (B, 2))
    zf = prob["goal"] + rng.uniform(-0.15, 0.15, (B, 2))
    obs_c = prob["obs"]["c"] + rng.uniform(-0.05, 0.05, (B, 2, 2))
    obs_r = prob["obs"]["r"] * rng.uniform(0.85, 1.0, (B, 2))
    return trajopt_params_from_numpy(
        "SingleInt2D", prob["dt"], [-prob["pos_max"]] * 2,
        [prob["pos_max"]] * 2, [-prob["vel_max"]] * 2, [prob["vel_max"]] * 2,
        N, h_rev, 10 * np.eye(2), 10 * np.eye(2), z0, zf, obs_c, obs_r,
        Qw=(0.1 if tube == "NN_oneshot" else 0.0), w_max=1.0,
        tube_params=nn, device=dev)


def solve_mode(tube, B, dev, tag=None):
    """The batched solve of ``tube`` on bench.py's gap batch and its
    verdicts, printed under ``[tag]`` (default the tube): (record, the
    solve's output)."""
    import torch

    from legged_gym_dev_tpu_torch.ops import block_tridiag_kernels as btk
    from legged_gym_dev_tpu_torch.solver import (
        VERDICT_NAMES,
        ALConfig,
        StagedProblem,
        certify_staged_batched,
        solve_tube_fast_batched,
        staged_bounds,
    )

    p = bench_batch(B, tube, dev)
    cfg = (ALConfig(linsolve="pallas") if tube == "l1"
           else ALConfig(nn_basis_refresh=3, linsolve="pallas"))
    before = btk.launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = solve_tube_fast_batched(p, N, H_REV, tube_kind=tube, scaling=0.5,
                                  cfg=cfg, warm_start="interpolate",
                                  tube_ws="evaluate", device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    solve_launch = {k: v - before[k] for k, v in btk.launches().items()}
    viol = out.sol.viol
    check(out.z.shape == (B, N + 1, 2) and bool(torch.isfinite(out.z).all())
          and bool(torch.isfinite(out.w).all()), f"{tube}: non-finite plan")
    sp = StagedProblem(n=2, m=2, N=N, K=2,
                       tube_kind=("nn" if tube == "NN_oneshot" else "l1"),
                       scaling=0.5, track_ref=False)
    lb, ub = staged_bounds(p, 2, 2, N)
    t1 = time.perf_counter()
    cert = certify_staged_batched(sp, p, out.sol.x.reshape(B, N + 1, -1),
                                  viol, lb, ub, device=dev)
    torch.cuda.synchronize()
    cert_wall = time.perf_counter() - t1
    verdicts = cert.verdict.cpu().numpy()
    counts = {name: int(np.sum(verdicts == i))
              for i, name in enumerate(VERDICT_NAMES)}
    viol_np = viol.cpu().numpy()
    feas = float(np.mean(viol_np < 1e-3))
    after = btk.launches()
    rec = dict(batch=B, solve_wall_s=wall, solves_per_s=B / wall,
               feasible_frac=feas, max_viol=float(viol_np.max()),
               max_viol_feasible=float(viol_np[verdicts == 0].max())
               if (verdicts == 0).any() else 0.0,
               verdicts=counts, certify_wall_s=cert_wall,
               solve_launches=solve_launch,
               launches={k: after[k] - before[k] for k in after})
    tag = tag or tube
    print(f"[{tag}] " + json.dumps(rec))
    check(feas >= 0.98, f"{tag}: feasible fraction {feas} < 0.98")
    check(counts["failed"] <= 0.005 * B, f"{tag}: failed {counts}")
    return rec, out


def closed_loop(dev, B=B_NN, H=3):
    import torch

    from legged_gym_dev_tpu_torch.core import make_rom
    from legged_gym_dev_tpu_torch.ops import block_tridiag_kernels as btk
    from legged_gym_dev_tpu_torch.solver import (
        PROBLEM_DICT,
        ALConfig,
        closed_loop_tube_mpc_fast,
    )

    prob = PROBLEM_DICT["gap"]
    p = bench_batch(B, "NN_oneshot", dev, seed=1)
    robot = make_rom("DoubleInt2D", prob["dt"], [-np.inf, -np.inf, -0.3, -0.3],
                     [np.inf, np.inf, 0.3, 0.3], [-0.5, -0.5], [0.5, 0.5],
                     device=dev)
    cfg_first = ALConfig(nn_basis_refresh=3, linsolve="pallas")
    cfg_loop = ALConfig(outer_iters=4, inner_iters=6, nn_basis_refresh=3,
                        linsolve="pallas")
    before = btk.launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    z, v, w, pzx, viols, adopted = closed_loop_tube_mpc_fast(
        p, robot, tube_kind="NN_oneshot", scaling=0.5, H=H, N=N,
        H_rev=H_REV, cfg_first=cfg_first, cfg_loop=cfg_loop,
        warm_start="interpolate", tube_ws="evaluate", device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    after = btk.launches()
    for name, t in (("z", z), ("v", v), ("w", w), ("pz_x", pzx),
                    ("viol", viols)):
        check(bool(torch.isfinite(t).all()), f"closed loop: non-finite {name}")
    check(z.shape == (B, H + 1, 2), f"closed loop z shape {tuple(z.shape)}")
    rec = dict(batch=B, ticks=H, wall_s=wall,
               ms_per_tick=1e3 * wall / (H + 1),
               adopted_frac=float(adopted.float().mean()),
               launches={k: after[k] - before[k] for k in after})
    print("[loop] " + json.dumps(rec))
    return rec


def sm_clock():
    """The card's SM clock now, and its maximum, as nvidia-smi reads them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()


def profile_window(dev, krec):
    """Where a solve's time goes: one short window (2x10 schedule) of each
    mode under ``torch.profiler``, at bench width. Prints the host wall
    time, the device time summed over the kernels it ran (one stream, so
    they do not overlap), the device's busy share of the wall, the kernels
    with the most device time, and the port's kernels' device time a
    launch beside their time alone from the kernel phase (CUDA events over
    launches back to back, and over launches queued behind a sleep)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from legged_gym_dev_tpu_torch.solver import (
        ALConfig,
        solve_tube_fast_batched,
    )

    for tube, B in (("l1", B_L1), ("NN_oneshot", B_NN)):
        p = bench_batch(B, tube, dev)
        cfg = ALConfig(outer_iters=2, inner_iters=10, linsolve="pallas",
                       nn_basis_refresh=(3 if tube == "NN_oneshot"
                                         else "inner"))

        def run():
            solve_tube_fast_batched(p, N, H_REV, tube_kind=tube, scaling=0.5,
                                    cfg=cfg, warm_start="interpolate",
                                    tube_ws="evaluate", device=dev)
            torch.cuda.synchronize()

        run()                                   # warm caches and allocator
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            wall = time.perf_counter() - t0
        by_name = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                n_us = by_name.setdefault(e.name, [0, 0.0])
                n_us[0] += 1
                n_us[1] += e.time_range.elapsed_us()
        launches = sum(v[0] for v in by_name.values())
        busy_ms = 1e-3 * sum(v[1] for v in by_name.values())
        check(launches > 0, f"profile {tube}: the trace holds no device op")
        top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]
        clock = sm_clock()
        per_launch = {}
        for kernel in ("bt_solve", "bt_factor", "bt_msolve"):
            hits = [(n, us) for name, (n, us) in by_name.items()
                    if f"{kernel}_kernel" in name]
            if hits:
                n = sum(h[0] for h in hits)
                alone = krec.get(kernel, {})
                per_launch[kernel] = dict(
                    launches=n, profiled_ms=1e-3 * sum(h[1] for h in hits) / n,
                    alone_events_ms=alone.get("kernel_only_ms",
                                              alone.get("ms")),
                    alone_device_ms=alone.get("kernel_device_ms"))
        rec = dict(batch=B, schedule="2x10", wall_ms=1e3 * wall,
                   device_busy_ms=busy_ms,
                   busy_share=busy_ms / (1e3 * wall),
                   device_ops=launches,
                   us_per_device_op=1e3 * busy_ms / launches,
                   sm_clock_after=clock, per_launch=per_launch,
                   top=[[name[:60], n, 1e-3 * us] for name, (n, us) in top])
        print(f"[profile {tube}] " + json.dumps(rec))


def reference_check(dev):
    """The port on the card (kernels) against the port on the CPU (plain
    versions) on a small bench batch: l1 and NN_oneshot, B=8, N=50, an 8x6
    schedule. Bar: plans within 2e-3."""
    import torch

    from legged_gym_dev_tpu_torch.solver import (
        ALConfig,
        solve_tube_fast_batched,
    )

    for tube in ("l1", "NN_oneshot"):
        cfg = ALConfig(outer_iters=8, inner_iters=6, linsolve="pallas",
                       nn_basis_refresh=(3 if tube == "NN_oneshot"
                                         else "inner"))
        outs = []
        for d in (dev, torch.device("cpu")):
            p = bench_batch(8, tube, d, seed=2)
            outs.append(solve_tube_fast_batched(
                p, N, H_REV, tube_kind=tube, scaling=0.5, cfg=cfg,
                warm_start="interpolate", tube_ws="evaluate", device=d))
        dz = float((outs[0].z.cpu() - outs[1].z).abs().max())
        dw = float((outs[0].w.cpu() - outs[1].w).abs().max())
        print(f"[ref] {tube} B=8: card vs CPU max|dz|={dz:.3e} "
              f"max|dw|={dw:.3e}")
        check(dz < 2e-3 and dw < 2e-3, f"{tube}: card and CPU disagree")


# ---------------------------------------------------------------------------
# RL slice: the physics substep kernel and the rollout
# ---------------------------------------------------------------------------

def robot_cases():
    """``tests/torch_robot_cases.py`` (the test robots), loaded by path:
    another installed package may own the name ``tests``."""
    import importlib.util

    name = "torch_robot_cases"
    if name not in sys.modules:
        path = ROOT / "tests" / f"{name}.py"
        spec = importlib.util.spec_from_file_location(name, path)
        module = importlib.util.module_from_spec(spec)
        sys.modules[name] = module
        spec.loader.exec_module(module)
    return sys.modules[name]


ARITH_OPS = {"add", "sub", "rsub", "mul", "div", "neg", "sqrt", "sin", "cos",
             "exp", "abs", "clamp", "clamp_min", "clamp_max", "minimum",
             "maximum", "where", "sum", "linalg_vector_norm", "reciprocal",
             "gt", "lt", "ge", "le", "bitwise_or"}


def substep_ops_per_env(robot):
    """Arithmetic operations of one env's substep, counted once from the
    plain version on the CPU at B=1 (DR rows on): every arithmetic aten op
    counts one per output element."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from legged_gym_dev_tpu_torch.ops import substep_kernels as sk

    rc = robot_cases()

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func.__name__.split(".")[0].rstrip("_")
            if name in ARITH_OPS and isinstance(out, torch.Tensor):
                Count.n += out.numel()
            return out

    inp = rc.substep_inputs(robot, 1, 0, dr=True)
    sim = rc.torch_sim(robot, "cpu", inp)
    st, tau = rc.torch_state(inp)
    Count.n = 0
    with Count():
        sk.substep_plain(sim, st, tau)
    return Count.n


def distinct(t):
    """Elements a tensor view holds (those along stride-0 dimensions
    once)."""
    return int(np.prod([n for n, st in zip(t.shape, t.stride()) if st != 0],
                       dtype=np.int64))


def substep_phase(dev):
    """K3 against its plain version at B=4096 on the three test robots;
    times and the bound. Then every other joint count's instance on its
    synthetic chain (those no robot of the robots phase has), 20 launches
    each. Returns the quadruped's record (the rollout's) with the others
    nested, the hopper's (the training path's) and the chains' by nj."""
    rec = {robot: substep_record(robot, dev)
           for robot in ("quadruped", "hopper4", "hopper")}
    out = dict(rec["quadruped"])
    out["hopper4"] = {k: rec["hopper4"][k] for k in
                      ("max_abs_err", "ms", "kernel_only_ms",
                       "kernel_device_ms", "plain_ms", "bound_ms",
                       "bound_by")}
    chains = {nj: dict(substep_record(f"chain{nj}", dev,
                                      tag="substep other nj", quick=True),
                       robot=f"chain{nj}")
              for nj in OTHER_NJ}
    return out, rec["hopper"], chains


def substep_record(robot, dev, tag="substep", quick=False):
    """K3 on one random single-step case of a test robot at B=4096 with
    per-env DR rows, against its plain version (max relative error <=
    TOL_REL); its time through the wrapper, alone and on the device, the
    plain version's time and the bound. ``quick``: 20 launches alone and
    one plain call."""
    import torch

    from legged_gym_dev_tpu_torch.ops import substep_kernels as sk

    rc = robot_cases()
    inp = rc.substep_inputs(robot, B_RL, seed=7, dr=True)
    sim = rc.torch_sim(robot, dev, inp)
    st, tau = rc.torch_state(inp, dev)
    out = sk.substep(sim, st, tau)
    ref = sk.substep_plain(sim, st, tau)
    torch.cuda.synchronize()
    errs_ = {}
    for name in ("base_pos", "base_quat", "q", "v"):
        a, b = getattr(out, name), getattr(ref, name)
        check(bool(torch.isfinite(a).all()), f"{robot}: non-finite {name}")
        errs_[name] = errs(a, b)
    ax = max(e[0] for e in errs_.values())
    print(f"[{tag}] {robot} B={B_RL}: " + ", ".join(
        f"{k} max_abs_err={e[0]:.3e} rel={e[1]:.3e}"
        for k, e in errs_.items()))
    for name, (_, r) in errs_.items():
        check(r <= TOL_REL, f"substep {robot} {name} rel err {r}")
    nj, nv = sim.model.nj, sim.model.nv
    nc = len(sim.model.contact_body)
    outs = [torch.empty((B_RL, n), device=dev) for n in (3, 4, nj, nv)]
    args, views = sk.substep_args(sim, st, tau, outs)
    sk.launch(sim, args, B_RL, dev)        # builds and binds
    launch = sk.raw_launch(sim, args, B_RL, dev)

    ms = time_ms(lambda: sk.substep(sim, st, tau), 20)
    k_ms = time_ms(launch, 20 if quick else 50)
    k_dev, *k_q = device_ms(launch)
    p_ms = time_ms(lambda: sk.substep_plain(sim, st, tau),
                   1 if quick else 3, warmup=0 if quick else 1)
    bms, by, nbytes, ops = k3_bound(robot, sim, st, tau, dev)
    print(f"[{tag}] {robot} B={B_RL} nj={nj} nc={nc}: wrapper "
          f"{ms:.4f} ms, kernel alone {k_ms:.4f} ms (device "
          f"{fmt_ms(k_dev, *k_q)}), plain {p_ms:.4f} "
          f"ms, bound {bms:.6f} ms ({by}: {nbytes / 1e6:.3f} MB, "
          f"{ops / 1e6:.2f} Mop)")
    return dict(max_abs_err=ax, ms=ms, kernel_only_ms=k_ms,
                kernel_device_ms=k_dev, plain_ms=p_ms, bound_ms=bms,
                bound_by=by, library_ms=None, shape=[B_RL, nj, nc],
                ops_per_env=ops // B_RL, bytes=nbytes)


def k3_bound(robot, sim, st, tau, dev):
    """(bound ms, "bytes" or "operations", bytes, operations) of one K3
    call on these inputs: each input read once (the state, the DR values
    as stored, not as broadcast, the model and schedules), each output
    written once; the operations counted per env from the plain graph."""
    import torch

    from legged_gym_dev_tpu_torch.ops import substep_kernels as sk

    B = st.base_pos.shape[0]
    nj, nv = sim.model.nj, sim.model.nv
    outs = [torch.empty((B, n), device=dev) for n in (3, 4, nj, nv)]
    _, views = sk.substep_args(sim, st, tau, outs)
    params, topo = sk._model_tensors(sim, dev)
    ops = substep_ops_per_env(robot) * B
    inputs = [st.base_pos, st.base_quat, st.q, st.v, tau, params, topo]
    nbytes = 4 * (sum(distinct(t) for t in inputs + views
                      if t is not None) + sum(o.numel() for o in outs))
    t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return (1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations",
            nbytes, ops)


def rl_policy(num_obs, num_actions, seed, dev):
    """ActorCritic 512-256-128 ELU with LeCun-normal weights drawn with
    numpy (as flax initializes them), through the interop path."""
    from legged_gym_dev_tpu_torch.interop import actor_critic_from_numpy

    rng = np.random.default_rng(seed)

    def body(dims):
        out = {}
        for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
            out[f"Dense_{i}"] = {
                "kernel": (rng.normal(size=(a, b)) / np.sqrt(a))
                .astype(np.float32),
                "bias": np.zeros(b, np.float32)}
        return out

    params = {"actor": body([num_obs, 512, 256, 128, num_actions]),
              "critic": body([num_obs, 512, 256, 128, 1]),
              "log_std": np.zeros(num_actions, np.float32)}
    return actor_critic_from_numpy({"params": params}, device=dev)


def make_rl_env(dev):
    from legged_gym_dev_tpu_torch.envs.presets import (
        _anymal_c_kwargs,
        make_trajectory_env,
    )

    return make_trajectory_env(robot_cases().QUADRUPED_URDF,
                               **_anymal_c_kwargs({}),
                               max_contact_force=350.0, num_envs=B_RL,
                               device=dev)


def rl_rollout(dev):
    """The RL main path: reset, then one PPO rollout of 24 env steps at
    B=4096. The substep count is zeroed just before and read just after."""
    import torch

    from legged_gym_dev_tpu_torch.ops import substep_kernels as sk
    from legged_gym_dev_tpu_torch.rl import PPOConfig, rollout

    env = make_rl_env(dev)
    check(env.num_obs == 65, f"num_obs {env.num_obs} != 65")
    model = rl_policy(env.num_obs, env.num_actions, 11, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    cfg = PPOConfig()
    state, obs = env.reset(gen)
    torch.cuda.synchronize()
    sk.reset_launches()
    t0 = time.perf_counter()
    state, batch, metrics = rollout(env, model, state, cfg, gen, obs=obs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = sk.launches()["substep"]
    T = cfg.num_steps
    check(tuple(batch.obs.shape) == (T, B_RL, 65),
          f"rollout obs shape {tuple(batch.obs.shape)}")
    for name in ("obs", "values", "advantages", "returns", "means"):
        check(bool(torch.isfinite(getattr(batch, name)).all()),
              f"rollout: non-finite {name}")
    # the mean over all T x B rewards is finite only if every reward is
    check(bool(torch.isfinite(metrics["mean_reward"])),
          "rollout: non-finite reward")
    rec = dict(batch=B_RL, env_steps=T, wall_s=wall,
               env_steps_per_s=T * B_RL / wall,
               ms_per_env_step=1e3 * wall / T,
               substep_launches=launches,
               mean_reward=float(metrics["mean_reward"]))
    check(launches == T * env.sim.decimation,
          f"substep launches {launches} != {T * env.sim.decimation}")
    print("[rl] " + json.dumps(rec))
    return env, model, state, gen, rec


def dispatched_ops(fn):
    """ATen operations ``fn`` dispatches (views included): the host's
    work, which bounds a host-bound step."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    return Count.n


def step_profile(label, env, model, state, contact_fn, contact_calls):
    """Where one env step's time goes: a torch.profiler window of one
    step; CUDA-event times of a step and of its contact FK and forces
    (``contact_fn``, called ``contact_calls`` times a step), and the share
    of the step's dispatched ATen ops that those calls make."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from legged_gym_dev_tpu_torch.utils.runtime import fp32_matmul

    with torch.no_grad(), fp32_matmul():
        obs = env._obs(state)
        actions = model(obs)[0]
        env.step(state, actions)                  # warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            env.step(state, actions)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        step_ms = time_ms(lambda: env.step(state, actions), 5, warmup=1)
        cf_ms = time_ms(contact_fn, 5, warmup=1)
        step_ops = dispatched_ops(lambda: env.step(state, actions))
        cf_ops = dispatched_ops(contact_fn)
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            n_us = by_name.setdefault(e.name, [0, 0.0])
            n_us[0] += 1
            n_us[1] += e.time_range.elapsed_us()
    ops = sum(v[0] for v in by_name.values())
    busy_ms = 1e-3 * sum(v[1] for v in by_name.values())
    check(ops > 0, f"{label} profile: the trace holds no device op")
    k3_ms = 1e-3 * sum(us for name, (_, us) in by_name.items()
                       if "substep_kernel" in name)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]
    rec = dict(batch=B_RL, wall_ms=1e3 * wall, device_busy_ms=busy_ms,
               busy_share=busy_ms / (1e3 * wall), device_ops=ops,
               substep_device_ms=k3_ms,
               substep_share_of_device=k3_ms / busy_ms if busy_ms else 0.0,
               step_ms_events=step_ms, contact_forces_ms=cf_ms,
               contact_calls_per_step=contact_calls,
               contact_forces_share=contact_calls * cf_ms / step_ms,
               aten_ops_step=step_ops, aten_ops_contact=cf_ops,
               contact_aten_op_share=contact_calls * cf_ops / step_ops,
               top=[[name[:60], n, 1e-3 * us] for name, (n, us) in top])
    print(f"[profile {label}] " + json.dumps(rec))
    return rec


def train_phase(dev, phase):
    """The training main path as a user runs it: ``cli train`` on the card
    with a config that takes the repo's YAML and points ``env.urdf_path``
    at the test hopper (``hopper_trajectory`` at B=4096), its runner built
    by ``task_registry.make_alg_runner`` and trained by
    ``OnPolicyRunner.learn``; the substep count is zeroed just before
    ``learn`` and read just after. Then the checkpoint round trip through
    ``make_alg_runner(resume=True)``, and one more iteration as
    ``rollout`` / ``ppo_update`` between CUDA events (not counted)."""
    import shutil

    import torch

    from legged_gym_dev_tpu_torch import cli
    from legged_gym_dev_tpu_torch.envs import task_registry
    from legged_gym_dev_tpu_torch.ops import substep_kernels as sk
    from legged_gym_dev_tpu_torch.rl.ppo import ppo_update, rollout
    from legged_gym_dev_tpu_torch.rl.ppo_recurrent import (
        ppo_update_recurrent,
        rollout_recurrent,
    )

    label = "train rnn" if phase == "train_rnn" else "train"
    iters = TRAIN_ITERS[phase]
    log_root = ROOT / "build" / f"chip_smoke_{phase}"
    shutil.rmtree(log_root, ignore_errors=True)
    log_root.mkdir(parents=True)
    urdf = log_root / "hopper.urdf"
    urdf.write_text(robot_cases().HOPPER_URDF)
    cfg_path = log_root / "config.yaml"
    cfg_path.write_text(
        f"defaults:\n  - {ROOT / TRAIN_CONFIGS[phase]}\n  - _self_\n"
        f"env:\n  urdf_path: {urdf}\n")
    args = cli.build_parser().parse_args([
        "train", "--config", str(cfg_path), "--log-root", str(log_root),
        "--max-iterations", str(iters)])
    runner, n_iter = cli.make_runner(args)
    env, train_cfg = runner.env, runner.cfg
    task = Path(runner.log_dir).parent.name
    check(n_iter == iters and env.device.type == "cuda",
          f"{label}: cli gave {n_iter} iterations on {env.device}")
    check(env.num_envs == B_RL and env.num_obs == 38,
          f"{label}: env B={env.num_envs} obs={env.num_obs}")
    check(env.curriculum is not None and env.curriculum.num_stages == 8,
          f"{label}: not the 8-stage curriculum")
    torch.cuda.synchronize()
    sk.reset_launches()
    t0 = time.perf_counter()
    hist = runner.learn(n_iter)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = sk.launches()["substep"]
    T, dec = train_cfg.num_steps, env.sim.decimation
    keys = ("mean_reward", "loss", "policy_loss", "value_loss", "kl", "lr")
    per_iter = [{k: h[k] for k in keys} for h in hist]
    for i, h in enumerate(per_iter):
        for k, v in h.items():
            check(bool(np.isfinite(v)), f"{label} it {i}: {k} = {v}")
        # lr is a float32 tensor clipped to the float32 bounds
        check(np.float32(train_cfg.min_lr) <= h["lr"]
              <= np.float32(train_cfg.max_lr),
              f"{label} it {i}: lr {h['lr']} out of bounds")
    check(launches == iters * T * dec,
          f"{label}: substep launches {launches} != {iters * T * dec}")

    # checkpoint round trip: the run's latest, resumed by the registry
    obs = torch.randn(64, env.num_obs, device=dev,
                      generator=torch.Generator(device=dev).manual_seed(3))
    want = runner.get_inference_policy()(obs)
    fresh = task_registry.make_alg_runner(
        env, task, log_root=str(log_root), run_name="reload", seed=1,
        resume=True, train_cfg=train_cfg)
    got = fresh.get_inference_policy()(obs)
    check(torch.equal(got, want), f"{label}: checkpoint round trip differs")
    del fresh

    # one more iteration, split into rollout and update by CUDA events
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ts, state = runner.train_state, runner.env_state
    ev[0].record()
    if runner.recurrent:
        state, carry, batch, _ = rollout_recurrent(
            env, runner.model, state, runner.carry, train_cfg, ts.gen)
        ev[1].record()
        ppo_update_recurrent(runner.model, ts, batch, train_cfg)
    else:
        state, batch, _ = rollout(env, runner.model, state, train_cfg,
                                  ts.gen)
        ev[1].record()
        ppo_update(runner.model, ts, batch, train_cfg)
    ev[2].record()
    torch.cuda.synchronize()
    rollout_s = 1e-3 * ev[0].elapsed_time(ev[1])
    update_s = 1e-3 * ev[1].elapsed_time(ev[2])
    steps = train_cfg.num_learning_epochs * train_cfg.num_mini_batches
    rec = dict(
        task=task, config=TRAIN_CONFIGS[phase], batch=B_RL, iterations=iters,
        policy=type(runner.model).__name__, learn_wall_s=wall,
        s_per_iteration=wall / iters,
        learn_env_steps_per_s=iters * T * B_RL / wall,
        split_rollout_s=rollout_s, split_update_s=update_s,
        update_ms_per_optimizer_step=1e3 * update_s / steps,
        env_ms_per_step=1e3 * rollout_s / T,
        substep_launches=launches, checkpoint_round_trip="bit-identical",
        iterations_metrics=per_iter)
    print(f"[{label}] " + json.dumps(rec))
    return rec, (env, runner.model, state)


# ---------------------------------------------------------------------------
# robots slice: every registered robot, rough terrain, K3 at every nj
# ---------------------------------------------------------------------------

# task -> (its test robot in tests/torch_robot_cases.py, observations, K3
# launches in 24 env steps: 4 substeps a step, Cassie's 8; none on rough
# terrain, which the reference sends to the plain substep)
ROBOT_TASKS = {
    "a1_velocity": ("A1_URDF", 48, 96),
    "anymal_c_velocity": ("QUADRUPED_URDF", 48, 96),
    "anymal_b_velocity": ("QUADRUPED_URDF", 48, 96),
    "a1_trajectory": ("A1_URDF", 65, 96),
    "anymal_c_lstm": ("QUADRUPED_URDF", 48, 96),
    "cassie_velocity": ("CASSIE_URDF", 48, 192),
    "adam_velocity": ("BIPED10_URDF", 42, 96),
    "anymal_c_rough": ("QUADRUPED_URDF", 235, 0),
    "anymal_c_rough_trajectory": ("QUADRUPED_URDF", 252, 0),
}
# env steps of each task's rollout: cut from a PPO rollout's 24 to keep
# the script's wall with the play phase added
ROBOT_STEPS = 8
# the learn iterations of the slice's main path: task -> (config, iters)
ROBOT_LEARN = {"anymal_c_velocity": ("configs/rl/default.yaml", 2),
               "cassie_velocity": ("configs/rl/default.yaml", 2),
               "anymal_c_rough": ("configs/rl/anymal_c_rough.yaml", 2)}
# evaluate_velocity_tracking of a learned policy: task -> (env steps,
# settle steps), cut from the evaluation's 500 and 50
ROBOT_EVAL = {"anymal_c_velocity": (100, 20)}
# K3's single-step checks beyond the substep phase's robots: A1 and Cassie
# (nj=12 in other topologies), the Adam stand-in (nj=10) and chains
K3_ROBOTS = {"a1": 12, "cassie": 12, "biped10": 10, "chain1": 1,
             "chain6": 6, "chain16": 16, "chain24": 24}
SUBSTEP_NJ = sorted({4, 12, *K3_ROBOTS.values()})
# the other instances, measured on their chains in the substep phase
OTHER_NJ = [nj for nj in range(1, 25) if nj not in SUBSTEP_NJ]


def robots_work():
    """The phase's directory under build/: the test robots' URDF files and
    a TorchScript actuator net drawn from a seed, set as the presets'
    ``ACTUATOR_NET_PATH`` (the reference's weights are not in the repo)."""
    import shutil

    from legged_gym_dev_tpu_torch.envs import presets

    rc = robot_cases()
    work = ROOT / "build" / "chip_smoke_robots"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    files = {}
    for const in sorted({c for c, _, _ in ROBOT_TASKS.values()}):
        files[const] = work / f"{const.lower()}.urdf"
        files[const].write_text(getattr(rc, const))
    presets.ACTUATOR_NET_PATH = str(
        rc.write_actuator_net(work / "actuator_net.pt", seed=0))
    return work, files


def robot_rollout(task, urdf, dev):
    """One PPO rollout of ``ROBOT_STEPS`` env steps of ``task`` at B=4096
    with a random-weight 512-256-128 policy; K3's launches zeroed just
    before and read just after, per joint count."""
    import torch

    from legged_gym_dev_tpu_torch.envs import task_registry
    from legged_gym_dev_tpu_torch.ops import substep_kernels as sk
    from legged_gym_dev_tpu_torch.rl import PPOConfig, rollout

    _, width, want = ROBOT_TASKS[task]
    want = want * ROBOT_STEPS // 24
    t0 = time.perf_counter()
    env = task_registry.make_env(task, urdf_path=str(urdf), num_envs=B_RL,
                                 device=dev)
    build_s = time.perf_counter() - t0
    check(env.num_obs == width, f"{task}: num_obs {env.num_obs} != {width}")
    model = rl_policy(env.num_obs, env.num_actions, 11, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    cfg = PPOConfig(num_steps=ROBOT_STEPS)
    state, obs = env.reset(gen)
    torch.cuda.synchronize()
    sk.reset_launches()
    t0 = time.perf_counter()
    state, batch, metrics = rollout(env, model, state, cfg, gen, obs=obs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    by_nj = sk.launches_by_nj()
    n = sum(by_nj.values())
    T = cfg.num_steps
    check(tuple(batch.obs.shape) == (T, B_RL, width),
          f"{task}: rollout obs shape {tuple(batch.obs.shape)}")
    for name in ("obs", "values", "advantages", "returns", "means"):
        check(bool(torch.isfinite(getattr(batch, name)).all()),
              f"{task}: non-finite {name}")
    check(bool(torch.isfinite(metrics["mean_reward"])),
          f"{task}: non-finite reward")
    check(n == want, f"{task}: K3 launches {n} != {want}")
    rec = dict(task=task, nj=env.nj, batch=B_RL, env_steps=T,
               ms_per_env_step=1e3 * wall / T,
               env_steps_per_s=T * B_RL / wall, k3_launches=n,
               k3_launches_by_nj=by_nj, substeps_per_step=env.sim.decimation,
               mean_reward=float(metrics["mean_reward"]),
               build_s=build_s)
    if not want:
        rec["k3_route"] = ("none: non-flat terrain, supports_kernel(sim) "
                           "false; the plain substep, as the reference's "
                           "RobotSim.substep")
    print("[robots] " + json.dumps(rec))
    return rec


def robot_learn(task, urdf, work, dev):
    """``cli train`` on the card: ``task`` from its config at B=4096 with
    the test robot's URDF, ``OnPolicyRunner.learn`` for a few iterations
    (K3's launches zeroed before and read after), then one more iteration
    split into rollout and update by CUDA events; on rough terrain, the
    plain substep's share of an env step."""
    import torch

    from legged_gym_dev_tpu_torch import cli
    from legged_gym_dev_tpu_torch.ops import substep_kernels as sk
    from legged_gym_dev_tpu_torch.rl.ppo import ppo_update, rollout

    config, iters = ROBOT_LEARN[task]
    cfg_path = work / f"{task}.yaml"
    cfg_path.write_text(f"defaults:\n  - {ROOT / config}\n  - _self_\n"
                        f"env:\n  urdf_path: {urdf}\n")
    args = cli.build_parser().parse_args([
        "train", "--config", str(cfg_path), "--task", task, "--log-root",
        str(work / "logs"), "--max-iterations", str(iters)])
    runner, n_iter = cli.make_runner(args)
    env, train_cfg = runner.env, runner.cfg
    check(n_iter == iters and env.device.type == "cuda"
          and env.num_envs == B_RL, f"learn {task}: {n_iter} iterations, "
          f"B={env.num_envs} on {env.device}")
    torch.cuda.synchronize()
    sk.reset_launches()
    t0 = time.perf_counter()
    hist = runner.learn(n_iter)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    by_nj = sk.launches_by_nj()
    T, dec = train_cfg.num_steps, env.sim.decimation
    want = ROBOT_TASKS[task][2] // 24 * T * iters
    check(sum(by_nj.values()) == want,
          f"learn {task}: K3 launches {by_nj} != {want}")
    keys = ("mean_reward", "loss", "policy_loss", "value_loss", "kl")
    per_iter = [{k: h[k] for k in keys} for h in hist]
    for i, h in enumerate(per_iter):
        for k, v in h.items():
            check(bool(np.isfinite(v)), f"learn {task} it {i}: {k} = {v}")
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ts, state = runner.train_state, runner.env_state
    ev[0].record()
    state, batch, _ = rollout(env, runner.model, state, train_cfg, ts.gen)
    ev[1].record()
    ppo_update(runner.model, ts, batch, train_cfg)
    ev[2].record()
    torch.cuda.synchronize()
    rollout_s = 1e-3 * ev[0].elapsed_time(ev[1])
    update_s = 1e-3 * ev[1].elapsed_time(ev[2])
    rec = dict(task=task, config=config, batch=B_RL, iterations=iters,
               learn_wall_s=wall, s_per_iteration=wall / iters,
               learn_env_steps_per_s=iters * T * B_RL / wall,
               split_rollout_s=rollout_s, split_update_s=update_s,
               env_ms_per_step=1e3 * rollout_s / T, k3_launches=by_nj,
               iterations_metrics=per_iter)
    if not sk.supports_kernel(env.sim):
        # an env step and its decimation's plain substeps, timed in turns
        # (host-bound times move between calls): the least of three each
        with torch.no_grad():
            actions = torch.zeros((B_RL, env.num_actions), device=dev)
            sim = env._dr_sim(state)
            tau = torch.zeros((B_RL, env.nj), device=dev)

            def substeps():
                for _ in range(dec):
                    sim.substep(state.robot, tau)

            step_ms, sub_ms = [], []
            for i in range(3):
                step_ms.append(time_ms(lambda: env.step(state, actions), 2,
                                       warmup=int(i == 0)))
                sub_ms.append(time_ms(substeps, 2, warmup=int(i == 0)))
            ops = (dispatched_ops(substeps),
                   dispatched_ops(lambda: env.step(state, actions)))
        rec.update(plain_substeps_ms=min(sub_ms), env_step_ms=min(step_ms),
                   plain_substep_share=min(sub_ms) / min(step_ms),
                   plain_substep_aten_op_share=ops[0] / ops[1])
    print("[robots learn] " + json.dumps(rec))
    return rec, by_nj, runner


def robot_eval(task, runner, dev):
    """``evaluate_velocity_tracking`` of the runner's inference policy on
    its env (B=4096), cut to ``ROBOT_EVAL``'s steps; K3's launches zeroed
    just before and read just after, exactly one a substep."""
    import torch

    from legged_gym_dev_tpu_torch.evaluation import (
        evaluate_velocity_tracking,
    )
    from legged_gym_dev_tpu_torch.ops import substep_kernels as sk

    steps, settle = ROBOT_EVAL[task]
    env = runner.env
    policy = runner.get_inference_policy()
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    torch.cuda.synchronize()
    sk.reset_launches()
    t0 = time.perf_counter()
    stats = evaluate_velocity_tracking(env, policy, gen, steps=steps,
                                       settle=settle)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    by_nj = sk.launches_by_nj()
    want = steps * env.sim.decimation
    check(sum(by_nj.values()) == want,
          f"eval {task}: K3 launches {by_nj} != {want}")
    check(np.isfinite(stats["track_err_m_s"])
          and stats["track_err_m_s"] >= 0.0, f"eval {task}: {stats}")
    for k in ("single_stance_frac", "single_stance_moving",
              "done_rate_per_step"):
        check(0.0 <= stats[k] <= 1.0, f"eval {task}: {k} = {stats[k]}")
    rec = dict(task=task, batch=env.num_envs, steps=steps, settle=settle,
               wall_s=wall, ms_per_env_step=1e3 * wall / steps,
               k3_launches=by_nj, **stats)
    print("[robots eval] " + json.dumps(rec))
    return by_nj


def robots_phase(dev):
    """The robots slice's main path: every newly registered task for
    ``ROBOT_STEPS`` env steps at B=4096, then the learn iterations of
    anymal_c_velocity, cassie_velocity and anymal_c_rough, the first
    followed by the velocity-tracking evaluation; then K3 against
    its plain version on a single step of each K3_ROBOTS robot. Returns
    the K3 records by robot and the main path's launches by joint
    count."""
    work, files = robots_work()
    launches = {}
    for task, (const, _, _) in ROBOT_TASKS.items():
        rec = robot_rollout(task, files[const], dev)
        for nj, n in rec["k3_launches_by_nj"].items():
            launches[nj] = launches.get(nj, 0) + n
    evals = {}
    for task in ROBOT_LEARN:
        _, by_nj, runner = robot_learn(task, files[ROBOT_TASKS[task][0]],
                                       work, dev)
        for nj, n in by_nj.items():
            launches[nj] = launches.get(nj, 0) + n
        if task in ROBOT_EVAL:
            evals[task] = robot_eval(task, runner, dev)
    print(f"[launches] robots path by nj: {json.dumps(launches)}")
    for by_nj in evals.values():
        for nj, n in by_nj.items():
            launches[nj] = launches.get(nj, 0) + n
    print(f"[launches] robots path and evaluation by nj: "
          f"{json.dumps(launches)}")
    return {robot: substep_record(robot, dev, tag="robots k3")
            for robot in K3_ROBOTS}, launches


# ---------------------------------------------------------------------------
# tube-learning slice: collect, shards, train, calibrate, plan
# ---------------------------------------------------------------------------

def tube_collect(cli, work):
    """``cli collect`` with the data-generation config, on the card."""
    import torch

    args = cli.build_parser().parse_args([
        "collect", "--config", str(ROOT / TUBE_COLLECT), "--seed", "42",
        "--out", str(work / "rollouts.npz")])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    data = cli.collect_rollouts(args)       # ends in the host transfer
    wall = time.perf_counter() - t0
    B, E = args.num_envs, args.epochs
    T, n = data.v.shape[1], 2
    steps = 2                              # round(rom dt 0.1 / dt_loop 0.05)
    check(data.z.shape == (B * E, T + 1, n) and T == 80
          and data.pz_x.shape == data.z.shape
          and data.v.shape == (B * E, T, 2) and data.done.shape == (B * E, T),
          f"tube collect: shapes {data.z.shape} {data.v.shape}")
    for f in ("z", "v", "pz_x"):
        check(bool(np.isfinite(getattr(data, f)).all()),
              f"tube collect: non-finite {f}")
    err = np.linalg.norm(data.pz_x - data.z, axis=-1)
    rec = dict(config=TUBE_COLLECT, batch=B, epochs=E, rom_ticks=T,
               env_steps_per_tick=steps, shapes=dict(
                   z=data.z.shape, v=data.v.shape, done=data.done.shape),
               wall_s=wall, env_steps_per_s=B * E * T * steps / wall,
               rom_ticks_per_s=B * E * T / wall,
               err_mean=float(err.mean()),
               err_p90=float(np.quantile(err, 0.9)))
    print(cli.save_rollouts(args, data))
    return data, rec


def tube_shards(data, work):
    """The rollout as ``.tdl`` shards, one epoch streamed through
    ``make_loader`` (which must pick the native loader)."""
    from legged_gym_dev_tpu_torch.tube.shards import (
        NativeTubeLoader,
        make_loader,
        write_rollout_shards,
    )

    paths = write_rollout_shards(str(work / "shards"), [data],
                                 variant="scalar")
    loader = make_loader(paths, N=3, dN=1)
    check(isinstance(loader, NativeTubeLoader),
          f"tube shards: loader is {type(loader).__name__}")
    t0 = time.perf_counter()
    rows = sum(x.shape[0] for x, _ in loader.epoch(seed=0, batch=2048,
                                                    n_threads=2))
    wall = time.perf_counter() - t0
    check(rows == loader.num_rows, f"tube shards: {rows} rows streamed of "
          f"{loader.num_rows}")
    loader.close()
    return dict(loader=type(loader).__name__, shards=len(paths), rows=rows,
                row_dim=loader.input_dim, epoch_s=wall, rows_per_s=rows / wall)


def tube_train(cli, work):
    """``cli train-tube`` with the one-shot config, cut to TUBE_EPOCHS,
    then the split-conformal width scale on the trainer's held-out
    split."""
    from legged_gym_dev_tpu_torch.tube.models import MLP
    from legged_gym_dev_tpu_torch.tube.train import (
        conformal_width_scale,
        train_tube,
    )

    args = cli.build_parser().parse_args([
        "train-tube", "--config", str(ROOT / TUBE_TRAIN), "--data",
        str(work / "rollouts.npz"), "--epochs", str(TUBE_EPOCHS),
        "--seed", "42"])
    ds, model, loss_fn, cfg, dev, spec = cli.make_tube_training(args)
    check(dev.type == "cuda" and ds.input_dim == 175
          and ds.output_dim == N and spec["H_rev"] == H_REV_TUBE
          and (cfg.batch_size, cfg.learning_rate) == (2048, 1e-3)
          and spec["num_units"] == 128 and spec["loss"] == "vector",
          f"tube train: {spec} {cfg} on {dev}")
    t0 = time.perf_counter()
    res = train_tube(ds, model, loss_fn, cfg, device=dev)
    wall = time.perf_counter() - t0
    hist = res.history
    steps = sum(h["steps"] for h in hist)
    host_s = sum(h["batch_s"] for h in hist)
    losses = [h["loss"] for h in hist]
    check(all(np.isfinite(losses)), f"tube train: losses {losses}")
    check(losses[-1] < losses[0], f"tube train: loss did not fall {losses}")
    final = [h for h in hist if "coverage" in h][-1]
    _, test_ds = ds.random_split(1.0 - cfg.test_split,
                                 rng=np.random.default_rng(cfg.seed))
    best = res.best_model
    scale = conformal_width_scale(best, test_ds, alpha=spec["alpha"])
    check(np.isfinite(scale) and scale > 0, f"tube train: scale {scale}")
    scaled = MLP(list(best.weights), list(best.biases),
                 activation=best.activation,
                 final_activation=best.final_activation,
                 out_scale=best.weights[0].new_tensor(scale))
    rec = dict(config=TUBE_TRAIN, epochs=TUBE_EPOCHS, of_epochs=1000,
               episodes=len(ds), optimizer_steps=steps, wall_s=wall,
               ms_per_step=1e3 * wall / steps,
               host_batch_ms_per_step=1e3 * host_s / steps,
               device_step_ms_per_step=1e3 * (wall - host_s) / steps,
               loss_first=losses[0], loss_last=losses[-1],
               coverage=final["coverage"],
               eval_mean_err=final["eval_mean_err"], conformal_scale=scale)
    return scaled, rec


def tube_plan(mlp, dev):
    """The learned, scaled tube through the NN_oneshot solve at B=1024,
    N=50, H_rev 25 (launches zeroed before, read after)."""
    import torch

    from legged_gym_dev_tpu_torch.ops import block_tridiag_kernels as btk
    from legged_gym_dev_tpu_torch.solver import (
        ALConfig,
        solve_tube_fast_batched,
    )

    kw = dict(tube_kind="NN_oneshot", scaling=0.5, warm_start="interpolate",
              tube_ws="evaluate")
    p = bench_batch(B_NN, "NN_oneshot", dev, mlp=mlp, h_rev=H_REV_TUBE)
    torch.cuda.synchronize()
    btk.reset_launches()
    t0 = time.perf_counter()
    out = solve_tube_fast_batched(
        p, N, H_REV_TUBE, cfg=ALConfig(nn_basis_refresh=3,
                                        linsolve="pallas"), device=dev, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = btk.launches()
    w_max = float(p.w_max.max())
    w, viol = out.w.cpu().numpy(), out.sol.viol.cpu().numpy()
    rec = dict(batch=B_NN, N=N, H_rev=H_REV_TUBE, wall_s=wall,
               solves_per_s=B_NN / wall,
               feasible_frac=float(np.mean(viol < 1e-3)),
               max_viol=float(viol.max()), w_min=float(w.min()),
               w_max=float(w.max()), w_mean=float(w.mean()),
               launches=launches)
    print("[tube plan] " + json.dumps(rec))
    check(out.z.shape == (B_NN, N + 1, 2) and out.w.shape == (B_NN, N + 1),
          f"tube plan: shapes {tuple(out.z.shape)} {tuple(out.w.shape)}")
    for name, t in (("z", out.z), ("v", out.v), ("w", out.w),
                    ("viol", out.sol.viol)):
        check(bool(torch.isfinite(t).all()), f"tube plan: non-finite {name}")
    check(w.min() >= 0.0 and w.max() <= w_max,
          f"tube plan: widths in [{w.min()}, {w.max()}], w_max {w_max}")
    for k in ("bt_solve", "bt_factor", "bt_msolve"):
        check(launches[k] > 0, f"tube plan: no {k} launch")
    return rec


def tube_reference(mlp, dev, B=8):
    """The learned tube's plans on the card (kernels) against the CPU
    (plain versions) on a small bench batch, an 8x6 schedule. Near a kink
    of the tube fp32 rounding alone moves a plan by 1e-2: a scenario whose
    two CPU routes (linsolve "pallas", the kernels' plain versions, and
    "thomas", the block-Thomas) disagree by 2e-3 is rounding-sensitive and
    left out. Bar: the other scenarios within 2e-3, and at least half the
    batch compared."""
    import torch

    from legged_gym_dev_tpu_torch.solver import (
        ALConfig,
        solve_tube_fast_batched,
    )

    kw = dict(tube_kind="NN_oneshot", scaling=0.5, warm_start="interpolate",
              tube_ws="evaluate")

    def solve(d, linsolve):
        pb = bench_batch(B, "NN_oneshot", d, seed=2, mlp=mlp,
                         h_rev=H_REV_TUBE)
        out = solve_tube_fast_batched(
            pb, N, H_REV_TUBE, cfg=ALConfig(outer_iters=8, inner_iters=6,
                                            linsolve=linsolve,
                                            nn_basis_refresh=3),
            device=d, **kw)
        return torch.cat([out.z.reshape(B, -1), out.w], dim=1).cpu()

    card = solve(dev, "pallas")
    cpu = solve(torch.device("cpu"), "pallas")
    thomas = solve(torch.device("cpu"), "thomas")
    d_card = (card - cpu).abs().amax(dim=1).numpy()
    d_cpu = (thomas - cpu).abs().amax(dim=1).numpy()
    stable = d_cpu < 2e-3
    rec = dict(batch=B, compared=int(stable.sum()),
               max_card_vs_cpu=float(d_card[stable].max())
               if stable.any() else None,
               max_card_vs_cpu_all=float(d_card.max()),
               max_cpu_routes=float(d_cpu.max()))
    print("[tube ref] " + json.dumps(rec))
    check(stable.sum() >= B // 2,
          f"tube ref: only {stable.sum()} of {B} scenarios off a kink")
    check(bool((d_card[stable] < 2e-3).all()),
          "tube ref: card and CPU disagree")
    return rec


def tube_hopper(dev):
    """The hopper's tube data (Raibert heuristic, ``collect_tracking``) at
    B=4096 for 2 ROM ticks on the test hopper: substep launches at nj=4
    zeroed before, read after."""
    import torch

    from legged_gym_dev_tpu_torch.envs.presets import (
        make_hopper_trajectory_env,
    )
    from legged_gym_dev_tpu_torch.ops import substep_kernels as sk
    from legged_gym_dev_tpu_torch.tube.collect import collect_tracking

    work = ROOT / "build" / "chip_smoke_tube"
    urdf = work / "hopper.urdf"
    urdf.write_text(robot_cases().HOPPER_URDF)
    env = make_hopper_trajectory_env(num_envs=B_RL, add_noise=False,
                                     episode_length_s=8.0,
                                     urdf_path=str(urdf), device=dev)
    gen = torch.Generator(device=dev).manual_seed(42)
    torch.cuda.synchronize()
    sk.reset_launches()
    t0 = time.perf_counter()
    data = collect_tracking(env, env.raibert, gen, episode_length_s=0.2,
                            raibert_obs=True)
    wall = time.perf_counter() - t0
    launches = sk.launches()["substep"]
    T, steps = 2, 5
    check(data.z.shape == (B_RL, T + 1, 2) and np.isfinite(data.pz_x).all(),
          f"tube hopper: {data.z.shape}")
    check(launches == T * steps * env.sim.decimation,
          f"tube hopper: substep launches {launches}")
    err = np.linalg.norm(data.pz_x - data.z, axis=-1)
    return dict(batch=B_RL, rom_ticks=T, env_steps_per_tick=steps,
                wall_s=wall, env_steps_per_s=B_RL * T * steps / wall,
                done_frac=float(data.done[:, :-1].mean()),
                err_mean=float(err.mean()), substep_launches=launches)


def tube_phase(dev):
    import shutil

    from legged_gym_dev_tpu_torch import cli

    work = ROOT / "build" / "chip_smoke_tube"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    data, rec = tube_collect(cli, work)
    print("[tube collect] " + json.dumps(rec))
    rec = tube_shards(data, work)
    print("[tube shards] " + json.dumps(rec))
    del data
    mlp, rec = tube_train(cli, work)
    print("[tube train] " + json.dumps(rec))
    plan = tube_plan(mlp, dev)
    tube_reference(mlp, dev)
    hopper = tube_hopper(dev)
    print("[tube hopper] " + json.dumps(hopper))
    return plan["launches"], hopper["substep_launches"], mlp


# ---------------------------------------------------------------------------
# plan phase: the planning layer (ROM zoo, cyclic reduction, generic solver,
# bucketing, cli plan / mpc, executed-loop coverage)
# ---------------------------------------------------------------------------

ZOO = {  # ROM: (n, m); staged block b = n + 1 + m
    "SingleInt2D": (2, 2), "DoubleInt2D": (4, 2), "Unicycle": (3, 2),
    "LateralUnicycle": (3, 3), "ExtendedUnicycle": (5, 2),
    "ExtendedLateralUnicycle": (6, 3)}
B_ZOO, N_CR, B_CR, B_GEN = 2048, 200, 1024, 1024
H_CLI = 75
H_CLI_NN = 40      # the NN-tube `cli mpc`: depth cut, 40 of 75 ticks


def load_by_path(name):
    """A module of tests/ loaded by path (another installed package may
    own the name ``tests``)."""
    import importlib.util

    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            name, ROOT / "tests" / f"{name}.py")
        module = importlib.util.module_from_spec(spec)
        sys.modules[name] = module
        spec.loader.exec_module(module)
    return sys.modules[name]


def random_tube_mlp(n_in, seed, dev, n_out=None):
    """bench.py's tube MLP: n_in -> 128 -> 128 -> n_out, softplus_b5 with a
    softplus head, Kaiming-uniform weights from a numpy seed, the last
    layer x0.1 and its bias -2.5."""
    from legged_gym_dev_tpu_torch.interop import mlp_from_numpy

    wr = np.random.default_rng(seed)
    sizes = [n_in, 128, 128, N if n_out is None else n_out]
    ws, bs = [], []
    for fan_in, fan_out in zip(sizes[:-1], sizes[1:]):
        bd = 1.0 / np.sqrt(fan_in)
        ws.append(wr.uniform(-bd, bd, (fan_in, fan_out)))
        bs.append(wr.uniform(-bd, bd, (fan_out,)))
    ws[-1] = ws[-1] * 0.1
    bs[-1] = bs[-1] * 0.0 - 2.5
    return mlp_from_numpy(ws, bs, activation="softplus_b5",
                          final_activation="softplus", device=dev)


def zoo_batch(rom, B, dev, n_steps=None, seed=0, mlp=None, problem="gap"):
    """bench.py's randomised batch of a ``PROBLEM_DICT`` problem (``gap``
    by default) for any ROM of the zoo: x and y of start and goal drawn as
    bench.py draws them, the other states 0 at both ends; bounds as
    tests/test_fast_tube.py sets them (+-pos_max on the states, +-vel_max
    on the inputs), Q = 10 I, R = 10 I."""
    from legged_gym_dev_tpu_torch.interop import trajopt_params_from_numpy
    from legged_gym_dev_tpu_torch.solver import PROBLEM_DICT

    prob = PROBLEM_DICT[problem]
    n, m = ZOO[rom]
    n_steps = N if n_steps is None else n_steps
    rng = np.random.default_rng(seed)
    z0 = np.zeros((B, n))
    zf = np.zeros((B, n))
    z0[:, :2] = prob["start"] + rng.uniform(-0.15, 0.15, (B, 2))
    zf[:, :2] = prob["goal"] + rng.uniform(-0.15, 0.15, (B, 2))
    obs_c = prob["obs"]["c"] + rng.uniform(-0.05, 0.05, (B, 2, 2))
    obs_r = prob["obs"]["r"] * rng.uniform(0.85, 1.0, (B, 2))
    return trajopt_params_from_numpy(
        rom, prob["dt"], [-prob["pos_max"]] * n, [prob["pos_max"]] * n,
        [-prob["vel_max"]] * m, [prob["vel_max"]] * m, n_steps, H_REV,
        10 * np.eye(n), 10 * np.eye(m), z0, zf, obs_c, obs_r,
        Qw=(0.1 if mlp is not None else 0.0), w_max=1.0, tube_params=mlp,
        device=dev)


def timed(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def solve_record(out, B, wall, n_steps=None):
    n_steps = N if n_steps is None else n_steps
    viol = out.sol.viol.cpu().numpy()
    for name in ("z", "v", "w"):
        t = getattr(out, name)
        check(bool(t.isfinite().all()), f"non-finite plan {name}")
    check(out.z.shape[:2] == (B, n_steps + 1), f"plan shape {out.z.shape}")
    return dict(batch=B, wall_s=wall, solves_per_s=B / wall,
                feasible_frac=float(np.mean(viol < 1e-3)),
                max_viol=float(viol.max()))


def plan_goldens(dev):
    """BASELINE configs 1-5 through the port's generic solver and closed
    loop on the card, at tests/test_goldens.py's bars
    (tests/test_torch_goldens.py's runner)."""
    goldens = load_by_path("test_torch_goldens")
    out = {}
    for k in sorted(goldens.CONFIGS):
        res, wall = timed(lambda: goldens.run_config(k, dev))
        res["wall_s"] = wall
        print("[plan goldens] " + json.dumps(res))
        out[k] = res
    for k, res in out.items():
        check(res["ok"], f"golden config {k}: {res}")
    return out


def plan_zoo(dev):
    """Every ROM of the zoo through ``solve_tube_fast_batched`` (l1, B=2048,
    N=50, 20x10, the kernels), then Unicycle (b=6) and
    ExtendedLateralUnicycle (b=10) with the NN tube at B=1024, each a
    seeded tube MLP of its ROM's widths: solves/s, feasible fraction (no
    bar), launches per kernel and b, the NN solves' bt_factor and
    bt_msolve launches exactly the schedule's."""
    from legged_gym_dev_tpu_torch.ops import block_tridiag_kernels as btk
    from legged_gym_dev_tpu_torch.solver import (
        ALConfig,
        solve_tube_fast_batched,
    )

    recs = {}
    runs = [(rom, "l1", B_ZOO) for rom in ZOO] + [
        ("Unicycle", "NN_oneshot", B_NN),
        ("ExtendedLateralUnicycle", "NN_oneshot", B_NN)]
    for rom, tube, B in runs:
        n, m = ZOO[rom]
        mlp = (random_tube_mlp(H_REV + (n - 2) + (H_REV + N) * m, 1001, dev)
               if tube == "NN_oneshot" else None)
        p = zoo_batch(rom, B, dev, mlp=mlp)
        cfg = ALConfig(linsolve="pallas", nn_basis_refresh=(
            3 if tube == "NN_oneshot" else "inner"))
        before = btk.launches_by_b()
        out, wall = timed(lambda: solve_tube_fast_batched(
            p, N, H_REV, tube_kind=tube, scaling=0.5, cfg=cfg,
            warm_start="interpolate", tube_ws="evaluate", device=dev))
        after = btk.launches_by_b()
        b = n + 1 + m
        rec = dict(rom=rom, tube=tube, b=b, **solve_record(out, B, wall),
                   launches={k: after[k].get(b, 0) - before[k].get(b, 0)
                             for k in after})
        print("[plan zoo] " + json.dumps(rec))
        check(rec["launches"]["bt_solve"] > 0, f"zoo {rom}: no bt_solve")
        if tube == "NN_oneshot":
            want = solve_launches(cfg.outer_iters, cfg.inner_iters, 3)
            for k in ("bt_factor", "bt_msolve"):
                check(rec["launches"][k] == want[k],
                      f"zoo {rom} NN: {k} launches {rec['launches'][k]} "
                      f"!= {want[k]}")
        recs[f"{rom}/{tube}"] = rec
    return recs


def plan_zoo_reference(dev, rom="ExtendedLateralUnicycle", B=8):
    """The b=10 ROM's plans on the card (kernels) against the CPU (plain
    versions), B=8, an 8x6 schedule, with the ``[tube ref]`` kink screen:
    a scenario whose two CPU linsolve routes ("pallas", the plain versions,
    and "thomas") disagree by 2e-3 is left out. Bar: the rest within 2e-3,
    at least half the batch compared. The batch is of the ``right_wide``
    problem: on ``gap`` this ROM's problems do not converge (feasible
    fraction 0.017 at B=2048) and their iterates fork under rounding alone
    (the two CPU routes 1.4e-2 apart after 8x6; 1.6e-6 on right_wide)."""
    import torch

    from legged_gym_dev_tpu_torch.solver import (
        ALConfig,
        solve_tube_fast_batched,
    )

    def solve(d, linsolve):
        out = solve_tube_fast_batched(
            zoo_batch(rom, B, d, seed=2, problem="right_wide"), N, H_REV,
            tube_kind="l1", scaling=0.5,
            cfg=ALConfig(outer_iters=8, inner_iters=6, linsolve=linsolve),
            warm_start="interpolate", tube_ws="evaluate", device=d)
        return torch.cat([out.z.reshape(B, -1), out.w], dim=1).cpu()

    card = solve(dev, "pallas")
    cpu = solve(torch.device("cpu"), "pallas")
    thomas = solve(torch.device("cpu"), "thomas")
    d_card = (card - cpu).abs().amax(dim=1).numpy()
    d_cpu = (thomas - cpu).abs().amax(dim=1).numpy()
    stable = d_cpu < 2e-3
    rec = dict(rom=rom, b=10, batch=B, compared=int(stable.sum()),
               max_card_vs_cpu=float(d_card[stable].max())
               if stable.any() else None,
               max_card_vs_cpu_all=float(d_card.max()),
               max_cpu_routes=float(d_cpu.max()))
    print("[plan zoo ref] " + json.dumps(rec))
    check(stable.sum() >= B // 2,
          f"zoo ref: only {stable.sum()} of {B} scenarios off a kink")
    check(bool((d_card[stable] < 2e-3).all()),
          "zoo ref: card and CPU disagree")
    return rec


def plan_cr(dev):
    """l1 at N=200 (S=201), B=1024: "auto" takes cyclic reduction (plain
    PyTorch), "pallas" the bt_solve kernel at S=201 (fewer teams a
    block), on the same batch. Bar: the plans of the scenarios both routes
    solve to convergence (the solver's own test: viol < 1e-5 and a small
    projected gradient) within 2e-3 of each other, off a kink of the tube,
    on at least 40% of the batch (at N=200 the 20x10 schedule converges
    about half of it). A scenario the schedule leaves
    unconverged stops wherever its last step left it, and two linear
    solvers' rounding leave it in two places; near a kink of |v| rounding
    alone moves a plan by more than 2e-3 (the ``[tube ref]`` screen): a
    scenario whose "pallas" plan moves by 2e-3 when its start moves by
    1e-7 is at a kink and left out."""
    import torch

    from legged_gym_dev_tpu_torch.ops import block_tridiag_kernels as btk
    from legged_gym_dev_tpu_torch.solver import (
        ALConfig,
        solve_tube_fast_batched,
    )
    from legged_gym_dev_tpu_torch.solver.staged_scalar import _linsolve

    check(_linsolve(ALConfig(), N_CR + 1) == "cr", "auto does not take cr")
    p = zoo_batch("SingleInt2D", B_CR, dev, n_steps=N_CR)
    moved = p.replace(z0=p.z0 + 1e-7)
    outs, recs = {}, {}
    for linsolve, pb in (("auto", p), ("pallas", p), ("pallas_moved", moved)):
        before = btk.launches()["bt_solve"]
        out, wall = timed(lambda: solve_tube_fast_batched(
            pb, N_CR, H_REV, tube_kind="l1", scaling=0.5,
            cfg=ALConfig(linsolve=linsolve.split("_")[0]),
            warm_start="interpolate", tube_ws="evaluate", device=dev))
        recs[linsolve] = dict(linsolve=linsolve, N=N_CR,
                              **solve_record(out, B_CR, wall, N_CR),
                              bt_solve_launches=btk.launches()["bt_solve"]
                              - before)
        outs[linsolve] = (torch.cat([out.z.reshape(B_CR, -1), out.w], dim=1),
                          out.sol.converged, out.sol.viol)
        recs[linsolve]["converged_frac"] = float(
            out.sol.converged.float().mean())
    def diff(a, b):
        return (outs[a][0] - outs[b][0]).abs().amax(dim=1).cpu().numpy()

    d, d_moved = diff("auto", "pallas"), diff("pallas", "pallas_moved")
    both = (outs["auto"][1] & outs["pallas"][1]).cpu().numpy()
    feas = ((outs["auto"][2] < 1e-3)
            & (outs["pallas"][2] < 1e-3)).cpu().numpy()
    kept = both & (d_moved < 2e-3)
    rec = dict(runs=recs, shape=btk.launch_shape("bt_solve", N_CR + 1, 5),
               both_converge=int(both.sum()), compared=int(kept.sum()),
               max_plan_diff=float(d[kept].max()) if kept.any() else None,
               both_feasible=int(feas.sum()),
               max_plan_diff_both_feasible=float(d[feas].max()),
               frac_feasible_within_2e3=float(np.mean(d[feas] < 2e-3)),
               max_plan_diff_all=float(d.max()),
               max_moved_start_diff=float(d_moved.max()))
    print("[plan cr] " + json.dumps(rec))
    check(recs["auto"]["bt_solve_launches"] == 0
          and recs["pallas"]["bt_solve_launches"] > 0, "cr routes")
    check(kept.mean() >= 0.4, f"cr: {kept.sum()} of {B_CR} compared")
    check(rec["max_plan_diff"] < 2e-3, "cr and pallas plans disagree")
    return rec


def plan_generic(dev):
    """The dense generic solver (``solve_tube_batched``, l2) at B=1024,
    N=50 beside the staged l2 solve of the same batch; then the generic
    closed loop (``closed_loop_tube_mpc_batched``) at config 4's shapes
    (N=20, H=15, H_rev 10; l2 tube; 20x10 first solve, 8x8 re-solves) on
    B=1024 randomised starts."""
    from legged_gym_dev_tpu_torch.core import make_rom
    from legged_gym_dev_tpu_torch.solver import (
        PROBLEM_DICT,
        ALConfig,
        get_tube_dynamics,
        solve_tube_batched,
        solve_tube_fast_batched,
    )
    from legged_gym_dev_tpu_torch.solver.mpc import (
        MPCConfig,
        closed_loop_tube_mpc_batched,
    )

    p = zoo_batch("SingleInt2D", B_GEN, dev)
    gen, wall = timed(lambda: solve_tube_batched(
        p, get_tube_dynamics("l2", N, scaling=0.5), N, H_REV, ALConfig(),
        warm_start="interpolate", tube_ws="evaluate", device=dev))
    rec_g = solve_record(gen, B_GEN, wall)
    staged, wall = timed(lambda: solve_tube_fast_batched(
        p, N, H_REV, tube_kind="l2", scaling=0.5,
        cfg=ALConfig(linsolve="pallas"), warm_start="interpolate",
        tube_ws="evaluate", device=dev))
    rec_s = solve_record(staged, B_GEN, wall)
    feas = ((gen.sol.viol < 1e-3) & (staged.sol.viol < 1e-3)).cpu().numpy()
    dz = (gen.z - staged.z).abs().amax(dim=(1, 2)).cpu().numpy()
    rec = dict(generic_l2=rec_g, staged_l2=rec_s,
               max_dz_cofeasible=float(dz[feas].max()) if feas.any()
               else None)
    print("[plan generic] " + json.dumps(rec))

    prob = PROBLEM_DICT["gap"]
    n_loop, h_loop = 20, 15
    p = zoo_batch("SingleInt2D", B_GEN, dev, n_steps=n_loop, seed=4)
    robot = make_rom("DoubleInt2D", prob["dt"], [-np.inf, -np.inf, -0.3,
                                                 -0.3],
                     [np.inf, np.inf, 0.3, 0.3], [-0.5, -0.5], [0.5, 0.5],
                     device=dev)
    trace, wall = timed(lambda: closed_loop_tube_mpc_batched(
        p, get_tube_dynamics("l2", n_loop, scaling=0.5), robot,
        MPCConfig(H=h_loop, N=n_loop, H_rev=H_REV), al_first=ALConfig(),
        al_loop=ALConfig(outer_iters=8, inner_iters=8),
        warm_start="interpolate", device=dev))
    for name in ("z", "v", "w", "pz_x", "viol"):
        check(bool(getattr(trace, name).isfinite().all()),
              f"generic loop: non-finite {name}")
    rec_l = dict(batch=B_GEN, N=n_loop, H=h_loop, wall_s=wall,
                 s_per_tick=wall / (h_loop + 1),
                 adopted_frac=float(trace.adopted.float().mean()),
                 max_resolve_viol=float(trace.viol.max()))
    print("[plan generic loop] " + json.dumps(rec_l))
    return rec, rec_l


def plan_bucketed(dev, zoo):
    """``solve_tube_fast_bucketed`` (l1, B=2048, N=50; phase 1 16 of the
    20 outers) beside the single-phase SingleInt2D row of ``[plan zoo]``
    (the same batch)."""
    from legged_gym_dev_tpu_torch.solver import ALConfig
    from legged_gym_dev_tpu_torch.solver.bucketed import (
        solve_tube_fast_bucketed,
    )

    p = zoo_batch("SingleInt2D", B_ZOO, dev)
    (out, stats), wall = timed(lambda: solve_tube_fast_bucketed(
        p, N, H_REV, tube_kind="l1", scaling=0.5,
        cfg=ALConfig(linsolve="pallas"), warm_start="interpolate",
        tube_ws="evaluate", device=dev))
    single = zoo["SingleInt2D/l1"]
    rec = dict(stats=stats, **solve_record(out, B_ZOO, wall),
               single_phase_feasible_frac=single["feasible_frac"],
               single_phase_solves_per_s=single["solves_per_s"])
    print("[plan bucketed] " + json.dumps(rec))
    check(rec["feasible_frac"] >= single["feasible_frac"] - 1e-9,
          "bucketed solve less feasible than the single phase")
    return rec


def start_plan_cli(mlp, work):
    """The port's ``cli plan`` / ``cli mpc`` on the card, each command in
    a process of its own (``python -m legged_gym_dev_tpu_torch.cli``, as a
    user runs it), all started together: the staged commands' verdicts
    and loops are bound by the host's launch rate, one core each. The NN
    tube commands take ``mlp`` in the port's model file. Returns the
    running commands for ``finish_plan_cli``."""
    from legged_gym_dev_tpu_torch.tube.models import save_mlp

    model = work / "tube.pt"
    save_mlp(mlp, model)
    nn = ["--tube-dyn", "NN_oneshot", "--H-rev", str(H_REV_TUBE),
          "--tube-model", str(model)]
    H = ["--H", str(H_CLI)]
    commands = [
        ("plan", ["plan", "--out", str(work / "plan.mat")]),
        ("plan_generic_l2_rolling", ["plan", "--generic", "--tube-dyn",
                                     "l2_rolling"]),
        ("plan_nominal", ["plan", "--nominal"]),
        ("mpc", ["mpc", *H, "--out", str(work / "mpc.mat")]),
        ("mpc_generic", ["mpc", "--generic", *H]),
        ("plan_nn", ["plan", *nn]),
        ("mpc_nn", ["mpc", "--H", str(H_CLI_NN), *nn]),
    ]
    running = []
    for name, argv in commands:
        cmd = [sys.executable, "-m", "legged_gym_dev_tpu_torch.cli", *argv,
               "--N", str(N)]
        with open(work / f"{name}.out", "w") as out, \
                open(work / f"{name}.err", "w") as err:
            proc = subprocess.Popen(cmd, cwd=ROOT, stdout=out, stderr=err)
        running.append((name, argv[0], time.time(), proc))
    return running


def kill_all(running):
    for _, _, _, proc in running:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def finish_plan_cli(running, work, timeout_s=900):
    """Waits for the commands of ``start_plan_cli``, prints and checks
    each one's JSON line (the JAX package's keys) and reads the ``.mat``
    files back; a command that fails or outlives ``timeout_s`` fails the
    phase, and every command still running is killed."""
    from scipy.io import loadmat

    recs = {}
    try:
        for name, cmd, t0, proc in running:
            proc.wait(timeout=max(1.0, timeout_s - (time.time() - t0)))
            # its wall: from its start to its output's last write
            wall = (work / f"{name}.out").stat().st_mtime - t0
            out = (work / f"{name}.out").read_text()
            err = (work / f"{name}.err").read_text()
            check(proc.returncode == 0,
                  f"cli {name} exited {proc.returncode}: {err[-2000:]}")
            line = [ln for ln in out.splitlines() if ln.startswith("{")][-1]
            rec = json.loads(line)
            print(f"[plan cli] {name} ({wall:.2f} s): {line}")
            if cmd == "plan":
                check(rec["viol"] < 1e-3, f"cli {name}: viol {rec['viol']}")
                check(rec.get("verdict") != "failed", f"cli {name}: failed")
            else:
                check(np.isfinite(rec["goal_dist"]),
                      f"cli {name}: goal_dist")
                check(rec.get("plan_verdict") != "failed",
                      f"cli {name}: failed")
            recs[name] = dict(wall_s=wall, **rec)
    finally:
        kill_all(running)
    for name, keys in (("plan.mat", ("z", "v", "w")),
                       ("mpc.mat", ("z", "v", "w", "pz_x", "adopted"))):
        m = loadmat(work / name)
        check(all(k in m and np.isfinite(m[k]).all() for k in keys),
              f"cli {name}: {sorted(m)}")
    print(f"[plan cli] .mat files read back: mpc z {m['z'].shape}")
    return recs


def plan_coverage(dev, mlp):
    """The one-shot net through the generic closed loop (H=75, N=50,
    H_rev 25, one scenario of the gap problem), then the executed-loop
    coverage and the trace's conformal scale."""
    from legged_gym_dev_tpu_torch.core import make_rom
    from legged_gym_dev_tpu_torch.evaluation import (
        evaluate_tube_on_mpc_trace,
        trace_conformal_scale,
    )
    from legged_gym_dev_tpu_torch.interop import trajopt_params_from_numpy
    from legged_gym_dev_tpu_torch.solver import (
        PROBLEM_DICT,
        get_tube_dynamics,
    )
    from legged_gym_dev_tpu_torch.solver.mpc import (
        MPCConfig,
        closed_loop_tube_mpc,
    )

    prob = PROBLEM_DICT["gap"]
    p = trajopt_params_from_numpy(
        "SingleInt2D", prob["dt"], [-prob["pos_max"]] * 2,
        [prob["pos_max"]] * 2, [-prob["vel_max"]] * 2,
        [prob["vel_max"]] * 2, N, H_REV_TUBE, 10 * np.eye(2),
        10 * np.eye(2), prob["start"], prob["goal"], prob["obs"]["c"],
        prob["obs"]["r"], Qw=0.0, w_max=1.0, tube_params=mlp, device=dev)
    robot = make_rom("DoubleInt2D", prob["dt"], [-np.inf, -np.inf, -0.3,
                                                 -0.3],
                     [np.inf, np.inf, 0.3, 0.3], [-0.5, -0.5], [0.5, 0.5],
                     device=dev)
    trace, wall = timed(lambda: closed_loop_tube_mpc(
        p, get_tube_dynamics("NN_oneshot", N), robot,
        MPCConfig(H=H_CLI, N=N, H_rev=H_REV_TUBE), device=dev))
    cov = evaluate_tube_on_mpc_trace(trace)
    scale = trace_conformal_scale(trace)
    rec = dict(H=H_CLI, N=N, H_rev=H_REV_TUBE, wall_s=wall,
               adopted_frac=float(trace.adopted.float().mean()), **cov,
               trace_conformal_scale=scale)
    print("[plan coverage] " + json.dumps(rec))
    check(np.isfinite(cov["mean_error"]) and np.isfinite(scale),
          "coverage: non-finite")
    return rec


def plan_phase(dev, mlp=None):
    """The planning layer on the card; ``mlp`` the tube phase's calibrated
    one-shot net, else a seeded random net of its widths. Returns the
    launches (per kernel, and per kernel and b) of its solves."""
    import shutil

    from legged_gym_dev_tpu_torch.ops import block_tridiag_kernels as btk

    work = ROOT / "build" / "chip_smoke_plan"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    if mlp is None:
        mlp = random_tube_mlp(H_REV_TUBE + (H_REV_TUBE + N) * 2, 1002, dev)
    btk.reset_launches()
    t0 = time.perf_counter()
    plan_goldens(dev)
    zoo = plan_zoo(dev)
    # the CLI's processes run beside the rest of the phase (the zoo's rates
    # are taken before they start); their launches are their own
    # processes' and are not counted here
    running = start_plan_cli(mlp, work)
    try:
        plan_cr(dev)
        plan_generic(dev)
        plan_bucketed(dev, zoo)
        plan_coverage(dev, mlp)
    except BaseException:
        kill_all(running)
        raise
    finish_plan_cli(running, work)
    launches, by_b = btk.launches(), btk.launches_by_b()
    print(f"[launches] plan path: {json.dumps(launches)} by b "
          f"{json.dumps(by_b)} in {time.perf_counter() - t0:.1f} s")
    for b in sorted({n + 1 + m for n, m in ZOO.values()}):
        check(by_b["bt_solve"].get(b, 0) > 0, f"plan path: no b={b} launch")
    want = solve_launches(20, 10, 3)    # the b=10 NN solve of [plan zoo]
    for k in ("bt_factor", "bt_msolve"):
        check(by_b[k].get(10, 0) == want[k],
              f"plan path: {k} b=10 launches {by_b[k].get(10, 0)} != "
              f"{want[k]}")
    plan_zoo_reference(dev)
    return launches, by_b


# ---------------------------------------------------------------------------
# play slice: play, export and evaluate a trained policy; reference forms
# ---------------------------------------------------------------------------

PLAY_TASK = "anymal_c_trajectory"
PLAY_STEPS = 200          # [play] env steps at B=4096
PLAY_RNN_STEPS = 20       # the recurrent hopper's play, for its export
PLAY_TRAIN_ITERS = 2
EVAL_STEPS = 400          # evaluate_tracking_policy's default
ROM_PLAY_STEPS = 100
B_ARRAY = 256
RIGID_KEYS = {"reward", "dof_pos", "dof_vel", "base_vel_x", "base_vel_y",
              "base_vel_z", "base_vel_yaw", "dof_torque", "dof_pos_target",
              "command_x", "command_y", "command_yaw", "tracking_error",
              "contact_forces_z"}
# the hopper has no commands and no default joint positions
PLAY_KEYS = {PLAY_TASK: RIGID_KEYS, "hopper_trajectory": RIGID_KEYS - {
    "dof_pos_target", "command_x", "command_y", "command_yaw"}}
EXPORT_TOL = 1e-5


def play_train(work, dev):
    """``OnPolicyRunner.learn`` on the card for the runs play resumes:
    ``anymal_c_trajectory`` (the test quadruped, B=4096, 2 iterations) and
    the recurrent hopper (``hopper_single_int_recurrent.yaml`` through
    ``cli.make_runner``, the test hopper, 1 iteration); checkpoints under
    ``work``. K3's launches zeroed before each ``learn`` and read after.
    Returns {task: (run dir, launches by nj)}."""
    import torch

    from legged_gym_dev_tpu_torch import cli
    from legged_gym_dev_tpu_torch.envs import task_registry
    from legged_gym_dev_tpu_torch.ops import substep_kernels as sk

    rc = robot_cases()
    quad, hopper = work / "quadruped.urdf", work / "hopper.urdf"
    quad.write_text(rc.QUADRUPED_URDF)
    hopper.write_text(rc.HOPPER_URDF)
    env = task_registry.make_env(PLAY_TASK, urdf_path=str(quad),
                                 num_envs=B_RL, device=dev)
    runners = {PLAY_TASK: task_registry.make_alg_runner(
        env, PLAY_TASK, log_root=str(work / "logs"), run_name="train",
        seed=0)}
    cfg_path = work / "hopper_rnn.yaml"
    cfg_path.write_text(
        f"defaults:\n  - {ROOT / TRAIN_CONFIGS['train_rnn']}\n"
        f"  - _self_\nenv:\n  urdf_path: {hopper}\n")
    runner, _ = cli.make_runner(cli.build_parser().parse_args([
        "train", "--config", str(cfg_path), "--log-root",
        str(work / "logs"), "--run-name", "train", "--num-envs",
        str(B_RL), *cpu_flag(dev)]))
    runners["hopper_trajectory"] = runner
    out = {}
    for task, runner in runners.items():
        iters = PLAY_TRAIN_ITERS if task == PLAY_TASK else 1
        torch.cuda.synchronize()
        sk.reset_launches()
        t0 = time.perf_counter()
        hist = runner.learn(iters)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        by_nj = sk.launches_by_nj()
        want = iters * runner.cfg.num_steps * runner.env.sim.decimation
        check(sum(by_nj.values()) == want,
              f"play train {task}: K3 launches {by_nj} != {want}")
        for k in ("mean_reward", "loss"):
            check(bool(np.isfinite(hist[-1][k])),
                  f"play train {task}: {k} = {hist[-1][k]}")
        out[task] = (runner.log_dir, by_nj)
        print("[play train] " + json.dumps(dict(
            task=task, batch=B_RL, iterations=iters, recurrent=bool(
                runner.recurrent), learn_wall_s=wall,
            learn_env_steps_per_s=iters * runner.cfg.num_steps * B_RL / wall,
            k3_launches=by_nj, mean_reward=hist[-1]["mean_reward"],
            run_dir=str(runner.log_dir))))
    return out


def resumed(task, urdf, run_dir, work, dev):
    """The env of ``cli play`` (no observation noise) and a runner
    resumed from ``run_dir``'s latest checkpoint."""
    from legged_gym_dev_tpu_torch.envs import task_registry

    env = task_registry.make_env(task, urdf_path=str(urdf), num_envs=B_RL,
                                 add_noise=False, device=dev)
    return env, task_registry.make_alg_runner(
        env, task, log_root=str(work / "logs"), seed=0, resume=True,
        load_dir=str(run_dir))


def export_parity(runner, exports, obs, dev):
    """max |actions| between the inference policy and each export loaded
    back on the card: the feed-forward exports on the whole obs batch, the
    LSTM module over 10 calls on single rows (its state is one row)."""
    import torch

    from legged_gym_dev_tpu_torch.utils.export import load_policy_exported
    from legged_gym_dev_tpu_torch.utils.runtime import fp32_matmul

    policy = runner.get_inference_policy()
    errs = {}
    with torch.no_grad(), fp32_matmul():
        if runner.recurrent:
            lstm = torch.jit.load(exports["lstm_torchscript"],
                                  map_location=dev)
            policy.reset()
            e = 0.0
            for i in range(10):
                x = obs[i:i + 1]
                e = max(e, float((lstm(x) - policy(x)).abs().max()))
            errs["lstm_torchscript"] = e
        else:
            want = policy(obs)
            loaded = {"torchscript": torch.jit.load(exports["torchscript"],
                                                    map_location=dev),
                      "exported": load_policy_exported(exports["exported"])}
            for kind, f in loaded.items():
                errs[kind] = float((f(obs) - want).abs().max())
    for kind, e in errs.items():
        check(e <= EXPORT_TOL, f"play export {kind}: max |da| {e}")
    return errs


def play_run(task, urdf, run_dir, steps, work, dev):
    """``cli.play`` on a resumed runner at B=4096 with ``--export`` and
    ``--mat`` into ``work``: env-steps/s (with the per-step host fetch of
    env 0's signals), K3's launches (exactly steps x decimation), the
    .mat read back, and each export against the inference policy."""
    import torch
    from scipy.io import loadmat

    from legged_gym_dev_tpu_torch import cli
    from legged_gym_dev_tpu_torch.ops import substep_kernels as sk

    env, runner = resumed(task, urdf, run_dir, work, dev)
    tag = task.split("_")[0]
    mat = work / f"play_{tag}.mat"
    torch.cuda.synchronize()
    sk.reset_launches()
    t0 = time.perf_counter()
    out = cli.play(env, runner, steps, export=str(work / f"export_{tag}"),
                   mat=str(mat))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    by_nj = sk.launches_by_nj()
    want = steps * env.sim.decimation
    check(sum(by_nj.values()) == want,
          f"play {task}: K3 launches {by_nj} != {want}")
    d = loadmat(str(mat))
    keys = {k for k in d if not k.startswith("__")} - {"dt"}
    check(keys == PLAY_KEYS[task], f"play {task}: .mat keys {sorted(keys)}")
    for k in keys:
        check(d[k].shape[0] == steps or d[k].shape[-1] == steps,
              f"play {task}: .mat {k} shape {d[k].shape}")
        check(bool(np.isfinite(d[k]).all()), f"play {task}: {k} not finite")
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    _, obs = env.reset(gen)
    errs = export_parity(runner, out["exports"], obs, dev)
    rec = dict(task=task, batch=B_RL, steps=steps, wall_s=wall,
               rollout_s=out["rollout_s"],
               env_steps_per_s=steps * B_RL / out["rollout_s"],
               env_steps_per_s_note="includes the per-step host fetch of "
               "env 0's signals, as the reference's play does",
               k3_launches=by_nj, mat_keys=sorted(keys),
               exports={k: v for k, v in out["exports"].items()},
               export_max_abs_diff=errs)
    print("[play] " + json.dumps(rec))
    return rec, env, runner, by_nj


def play_eval(env, runner, dev):
    """``evaluate_tracking_policy`` with each fixture on the trained
    quadruped's deterministic policy at B=4096 and the default 400 steps;
    K3's launches zeroed before each and read after."""
    import torch

    from legged_gym_dev_tpu_torch.evaluation import evaluate_tracking_policy
    from legged_gym_dev_tpu_torch.ops import substep_kernels as sk
    from legged_gym_dev_tpu_torch.trajgen import TRAJ_GEN_REGISTRY

    policy = runner.get_inference_policy()
    total = {}
    for name in ("ZeroTrajectoryGenerator", "SquareTrajectoryGenerator",
                 "CircleTrajectoryGenerator"):
        torch.cuda.synchronize()
        sk.reset_launches()
        t0 = time.perf_counter()
        res = evaluate_tracking_policy(env, policy, TRAJ_GEN_REGISTRY[name],
                                       steps=EVAL_STEPS)
        wall = time.perf_counter() - t0
        by_nj = sk.launches_by_nj()
        want = EVAL_STEPS * env.sim.decimation
        check(sum(by_nj.values()) == want,
              f"eval {name}: K3 launches {by_nj} != {want}")
        for k, v in res.items():
            check(bool(np.isfinite(v)), f"eval {name}: {k} = {v}")
        for nj, n in by_nj.items():
            total[nj] = total.get(nj, 0) + n
        print("[play eval] " + json.dumps(dict(
            fixture=name, batch=B_RL, steps=EVAL_STEPS, wall_s=wall,
            env_steps_per_s=EVAL_STEPS * B_RL / wall, k3_launches=by_nj,
            **res)))
    return total


def cpu_flag(dev):
    """The CLI's ``--cpu`` where ``dev`` is the CPU (a rehearsal)."""
    return ["--cpu"] if dev.type == "cpu" else []


def start_play_rom(work, dev):
    """``cli train`` then ``cli play`` of ``rom_tracking`` at B=4096 as one
    subprocess chain on the card (the real CLI end to end)."""
    logs, exp = work / "rom_logs", work / "export_rom"
    py = [sys.executable, "-m", "legged_gym_dev_tpu_torch.cli"]
    py_args = cpu_flag(dev)
    train = py + ["train", "--task", "rom_tracking", "--num-envs",
                  str(B_RL), "--max-iterations", "1", "--log-root",
                  str(logs), "--run-name", "t", *py_args]
    play = py + ["play", "--task", "rom_tracking", "--num-envs", str(B_RL),
                 "--steps", str(ROM_PLAY_STEPS), "--log-root", str(logs),
                 "--export", str(exp), "--mat", str(work / "play_rom.mat"),
                 *py_args]
    log = open(work / "play_rom.log", "w")
    script = (f"import subprocess, sys; "
              f"sys.exit(subprocess.run({train!r}).returncode "
              f"or subprocess.run({play!r}).returncode)")
    proc = subprocess.Popen([sys.executable, "-c", script], cwd=ROOT,
                            stdout=log, stderr=subprocess.STDOUT)
    return proc, log, time.perf_counter()


def finish_play_rom(running, work, timeout_s=600):
    from scipy.io import loadmat

    proc, log, t0 = running
    try:
        rc = proc.wait(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        rc = "timeout"
    log.close()
    text = (work / "play_rom.log").read_text()
    check(rc == 0, f"[play rom] exit {rc}: {text[-2000:]}")
    rec = json.loads([line for line in text.splitlines()
                      if line.startswith('{"steps"')][-1])
    d = loadmat(str(work / "play_rom.mat"))
    check(d["reward"].shape[-1] == ROM_PLAY_STEPS
          and bool(np.isfinite(d["reward"]).all()), "[play rom] .mat")
    for kind in ("torchscript", "exported"):
        check(Path(rec["exports"][kind]).is_file(),
              f"[play rom] no {kind} export")
    print("[play rom] " + json.dumps(dict(
        rec, wall_s=time.perf_counter() - t0,
        env_steps_per_s=ROM_PLAY_STEPS * B_RL / rec["rollout_s"],
        mat_keys=sorted(k for k in d if not k.startswith("__")))))


def dynamics_check(dev):
    """The autodiff dynamics against the analytic ``sim/kinematics.py`` at
    B=4096 on the 12-joint test quadruped, random states (numpy draws,
    random base orientations): max relative error <= 1e-4 each;
    ``forward_dynamics`` against ``torch.linalg.solve`` on the same M (a
    check only); the ms of each."""
    import torch

    from legged_gym_dev_tpu_torch.sim import dynamics as dyn
    from legged_gym_dev_tpu_torch.sim import kinematics as kin

    rc = robot_cases()
    inp = rc.substep_inputs("quadruped", B_RL, seed=9)
    quat = np.random.default_rng(9).normal(size=(B_RL, 4))
    inp["base_quat"] = (quat / np.linalg.norm(quat, axis=1, keepdims=True)
                        ).astype(np.float32)
    model = rc.torch_sim("quadruped", dev).model
    st, tau = rc.torch_state(inp, dev)
    f_ext = torch.as_tensor(np.random.default_rng(10).normal(
        0, 5.0, (B_RL, model.nv)).astype(np.float32), device=dev)

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    pairs = {"mass_matrix": (dyn.mass_matrix_autodiff, kin.mass_matrix),
             "bias_forces": (dyn.bias_forces_autodiff, kin.bias_forces),
             "contact_kinematics": (dyn.contact_kinematics_autodiff,
                                    kin.contact_kinematics)}
    rec = dict(batch=B_RL, nj=model.nj)
    with torch.no_grad():
        for name, (auto, ana) in pairs.items():
            a, b = auto(model, st), ana(model, st)
            if not isinstance(a, tuple):
                a, b = (a,), (b,)
            err = max(rel(x, y) for x, y in zip(a, b))
            check(err <= 1e-4, f"[dynamics] {name}: rel err {err}")
            rec[name] = dict(
                max_rel_err=err,
                autodiff_ms=time_ms(lambda: auto(model, st), 3, warmup=1),
                analytic_ms=time_ms(lambda: ana(model, st), 3, warmup=1))
        M, c = kin.mass_matrix(model, st), kin.bias_forces(model, st)
        rhs = f_ext - c
        rhs = torch.cat([rhs[:, :6], rhs[:, 6:] + tau], dim=-1)
        qdd = dyn.forward_dynamics(model, st, tau, f_ext)
        ref = torch.linalg.solve(M, rhs[..., None])[..., 0]
        err = rel(qdd, ref)
        check(err <= 1e-4, f"[dynamics] forward_dynamics: rel err {err}")
        rec["forward_dynamics"] = dict(
            max_rel_err_vs_linalg_solve=err,
            ms=time_ms(lambda: dyn.forward_dynamics(model, st, tau, f_ext),
                       3, warmup=1))
    print("[dynamics] " + json.dumps(rec))
    return rec


def array_check(dev):
    """The array-form staged solver against the entry form on bench.py's
    gap batch: l1, B=256, N=50, SingleInt2D, the 20x10 schedule, the same
    warm start. The array form runs no kernel (the JAX package's has
    none); the entry form takes K1 (``linsolve="pallas"``). Solves/s of
    each, the array form's feasible fraction (>= 0.98) and, on the
    scenarios feasible in both, max |dz| within 2e-3 on at least 90%."""
    import torch

    from legged_gym_dev_tpu_torch.ops import block_tridiag_kernels as btk
    from legged_gym_dev_tpu_torch.solver import ALConfig
    from legged_gym_dev_tpu_torch.solver import fast_tube as ft
    from legged_gym_dev_tpu_torch.solver.trajopt import (
        get_tube_warm_start,
        get_warm_start,
    )
    from legged_gym_dev_tpu_torch.solver.tube_dynamics import (
        get_tube_dynamics,
    )
    from legged_gym_dev_tpu_torch.utils.runtime import fp32_matmul

    B = B_ARRAY
    p = bench_batch(B, "l1", dev)
    cfg = ALConfig(linsolve="pallas")
    sp = ft._staged_problem(p, N, "l1", 0.5, False)
    with fp32_matmul():
        z, v = get_warm_start("interpolate", p, N, cfg)
        w = get_tube_warm_start("evaluate", get_tube_dynamics("l1", N, 0.5),
                                z, v, p, N)
    u0 = ft.pack_staged(z, w, v, sp.n, sp.m, N)
    lb, ub = ft.staged_bounds(p, sp.n, sp.m, N)
    before = btk.launches()
    out, walls = {}, {}
    for form, solve in (("entry", ft.solve_tube_fast_single),
                        ("array", ft.solve_tube_fast_single_array)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[form] = solve(sp, p, u0, lb, ub, cfg)
        torch.cuda.synchronize()
        walls[form] = time.perf_counter() - t0
        if form == "entry":
            launches = {k: v - before[k] for k, v in btk.launches().items()}
            before = btk.launches()
    check(btk.launches() == before, "[array] the array form launched K1")
    viol = {f: o.viol.cpu().numpy() for f, o in out.items()}
    feas = {f: float(np.mean(v < 1e-3)) for f, v in viol.items()}
    both = (viol["array"] < 1e-3) & (viol["entry"] < 1e-3)
    zs = {f: o.x.reshape(B, N + 1, -1)[:, :, :sp.n].cpu().numpy()
          for f, o in out.items()}
    dz = np.abs(zs["array"] - zs["entry"]).max(axis=(1, 2))[both]
    within = float(np.mean(dz <= 2e-3)) if dz.size else 0.0
    rec = dict(batch=B, N=N, schedule="20x10", rom="SingleInt2D",
               solves_per_s={f: B / w for f, w in walls.items()},
               wall_s=walls, feasible_frac=feas, co_feasible=int(both.sum()),
               max_dz_co_feasible=float(dz.max()) if dz.size else None,
               within_2e3=within, entry_launches=launches)
    print("[array] " + json.dumps(rec))
    check(feas["array"] >= 0.98, f"[array] feasible {feas['array']}")
    check(within >= 0.9, f"[array] co-feasible within 2e-3: {within}")
    return launches


def play_phase(dev):
    """The play slice's main path: train the runs play resumes, ``cli
    play`` with its exports and .mat on the quadruped and the recurrent
    hopper, ``evaluate_tracking_policy`` with the three fixtures, the
    ``rom_tracking`` CLI end to end (a subprocess beside the reference
    forms), ``[dynamics]`` and ``[array]``. Returns K3's launches by nj
    and the block-tridiagonal kernels' launches."""
    import shutil

    work = ROOT / "build" / "chip_smoke_play"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    runs = play_train(work, dev)
    k3 = {}

    def add(by_nj):
        for nj, n in by_nj.items():
            k3[nj] = k3.get(nj, 0) + n

    for _, by_nj in runs.values():
        add(by_nj)
    _, env, runner, by_nj = play_run(PLAY_TASK, work / "quadruped.urdf",
                                     runs[PLAY_TASK][0], PLAY_STEPS, work,
                                     dev)
    add(by_nj)
    *_, by_nj = play_run("hopper_trajectory", work / "hopper.urdf",
                         runs["hopper_trajectory"][0], PLAY_RNN_STEPS, work,
                         dev)
    add(by_nj)
    add(play_eval(env, runner, dev))
    del env, runner
    rom = start_play_rom(work, dev)
    try:
        dynamics_check(dev)
        bt = array_check(dev)
    except BaseException:
        rom[0].kill()
        rom[0].wait()
        rom[1].close()
        raise
    finish_play_rom(rom, work)
    print(f"[launches] play path: K3 by nj {json.dumps(k3)}, "
          f"{json.dumps(bt)}")
    return k3, bt


# ---------------------------------------------------------------------------
# mesh slice: data-parallel training and solving over a device mesh
# ---------------------------------------------------------------------------

MESH_SHARDS = 4          # the repeated-device mesh of the one card
# The verdicts of the sharded solve run without the escalated restorations
# (``escalate=False``, on both sides): the verdict pass issues a fixed
# count of small launches whatever the batch (polish loops of 256, 128 and
# 512 steps, restoration solves), so its wall is the host's and each shard
# costs about what the whole batch does; with escalation that is 35-55 s a
# shard. The escalated pass runs unsharded in the l1 phase.
B_MESH_LOOP = 1024


def mesh_of(dev, n=MESH_SHARDS):
    from legged_gym_dev_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(n, devices=[dev] * n)


def mesh_substep(dev):
    """K3s, the sharded route (``substep_sharded``: the shard kernel
    ``substep_shard_kernel`` on each shard), on the 4-shard mesh of the
    card against its plain version shard by shard on the same inputs (max
    relative error <= TOL_REL) and against one unsharded K3 launch (<=
    1e-6; the two kernels work env by env in the same order, so it is 0):
    the ANYmal-C-topology quadruped (nj=12) at B=4096 with per-env DR rows
    from a seed (base payload mass, friction, contact stiffness and
    damping); one launch of the shard kernel per shard and none of K3,
    each output on its shard's device; wrapper times sharded and
    unsharded, the call's device time, the plain version's, K3's bound at
    the same work. Then ``shard_turns`` (one shard's batch and the whole
    batch through both kernels alone, in turns) and the shard kernel's
    launch shape."""
    import torch

    from legged_gym_dev_tpu_torch.ops import substep_kernels as sk
    from legged_gym_dev_tpu_torch.parallel.mesh import (
        Sharded,
        gather,
        shard_batch,
    )

    rc = robot_cases()
    mesh = mesh_of(dev)
    inp = rc.substep_inputs("quadruped", B_RL, seed=13, dr=True)
    sim = rc.torch_sim("quadruped", dev, inp)
    st, tau = rc.torch_state(inp, dev)
    st_sh = shard_batch(st, mesh, batch_size=B_RL)
    tau_sh = shard_batch(tau, mesh, batch_size=B_RL)
    ref = sk.substep(sim, st, tau)
    sk.reset_launches()
    out = sk.substep_sharded(sim, st_sh, tau_sh, mesh, "dp")
    torch.cuda.synchronize()
    n = sk.launches()
    check(n == {"substep": 0, "substep_sharded": MESH_SHARDS},
          f"[mesh substep] launches {n}: want {MESH_SHARDS} of the shard "
          "kernel and none of K3")
    check([s.base_pos.device for s in out] == list(mesh.devices.flat),
          "[mesh substep] an output off its shard's device")
    shard_sims = sim.shard(mesh)
    plain = gather(Sharded([sk.substep_plain(s, a, b) for s, a, b in
                            zip(shard_sims, st_sh, tau_sh)], mesh, B_RL))
    got = gather(out)
    fields = ("base_pos", "base_quat", "q", "v")
    errs_ = {f: errs(getattr(got, f), getattr(plain, f)) for f in fields}
    errs_k3 = {f: errs(getattr(got, f), getattr(ref, f)) for f in fields}
    for f in fields:
        check(bool(torch.isfinite(getattr(got, f)).all()),
              f"[mesh substep] non-finite {f}")
        check(errs_[f][1] <= TOL_REL,
              f"[mesh substep] {f} rel err {errs_[f][1]} against plain")
        check(errs_k3[f][1] <= 1e-6, f"[mesh substep] {f} rel err "
              f"{errs_k3[f][1]} against unsharded K3 > 1e-6")
    ms_sh = time_ms(lambda: sk.substep_sharded(sim, st_sh, tau_sh, mesh,
                                               "dp"), 20)
    # the call's 4 launches on the device, queued behind a sleep
    dev_ms, *dev_q = device_ms(lambda: sk.substep_sharded(
        sim, st_sh, tau_sh, mesh, "dp"))
    ms = time_ms(lambda: sk.substep(sim, st, tau), 20)
    p_ms = time_ms(lambda: [sk.substep_plain(s, a, b) for s, a, b in
                            zip(shard_sims, st_sh, tau_sh)], 3, warmup=1)
    bms, by, nbytes, ops = k3_bound("quadruped", sim, st, tau, dev)
    turns = shard_turns({B_RL // MESH_SHARDS: (shard_sims[0], st_sh[0],
                                               tau_sh[0]),
                         B_RL: (sim, st, tau)}, dev)
    shape = sk.shard_launch_shape(sim, dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    shape.update(
        sms=sms, ptxas=PTXAS.get("substep_shard_kernel<12>"),
        waves={B: -(-B // shape["envs"]) / (shape["blocks_per_sm"] * sms)
               for B in (B_RL // MESH_SHARDS, B_RL)})
    print("[mesh substep] shape " + json.dumps(shape))
    rec = dict(kernel="substep_shard_kernel<12>",
               max_abs_err=max(e[0] for e in errs_.values()),
               max_rel_err=max(e[1] for e in errs_.values()),
               max_abs_err_vs_unsharded_k3=max(e[0] for e in
                                               errs_k3.values()),
               max_rel_err_vs_unsharded_k3=max(e[1] for e in
                                               errs_k3.values()), ms=ms_sh,
               device_ms=dev_ms, device_ms_shown=fmt_ms(dev_ms, *dev_q),
               unsharded_ms=ms, plain_ms=p_ms, bound_ms=bms, bound_by=by,
               library_ms=None, shards=MESH_SHARDS, shape=[B_RL, 12],
               bytes=nbytes, ops=ops, in_turns=turns, launch_shape=shape)
    print("[mesh substep] " + json.dumps(rec))
    return rec


def shard_turns(cases, dev):
    """K3 and the shard kernel alone (their bound C functions, counting no
    launch) on each {B: (sim, state, tau)}: outputs equal bit for bit, then
    the device time a launch of each, 20 launches queued behind a sleep,
    in turns (K3, shard, shard, K3). Returns {B: [[kernel, ms], ...]}."""
    import torch

    from legged_gym_dev_tpu_torch.ops import substep_kernels as sk

    out = {}
    for B, (sim, st, tau) in cases.items():
        nj, nv = sim.model.nj, sim.model.nv
        calls, outs = {}, {}
        for name, form in (("K3", "team"), ("shard", "shard")):
            o = [torch.empty((B, n), device=dev) for n in (3, 4, nj, nv)]
            args, views = sk.substep_args(sim, st, tau, o)

            def call(launch=sk.raw_launch(sim, args, B, dev, form),
                     keep=(args, views)):
                launch()

            calls[name], outs[name] = call, o
            call()
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(outs["K3"],
                                                    outs["shard"])),
              f"[mesh substep] B={B}: the shard kernel differs from K3")
        turns = []
        for name in ("K3", "shard", "shard", "K3"):
            ms, *q = device_ms(calls[name])
            turns.append([name, ms, fmt_ms(ms, *q)])
        out[B] = turns
        print(f"[mesh substep] B={B} nj={nj} in turns (device ms a launch): "
              + ", ".join(f"{n} {shown}" for n, _, shown in turns))
    return out


def mesh_learn_runner(args_extra, cfg_path, work, iters, cli):
    args = cli.build_parser().parse_args([
        "train", "--config", str(cfg_path), "--task", "anymal_c_velocity",
        "--log-root", str(work / "logs"), "--num-envs", str(B_RL),
        "--max-iterations", str(iters)] + args_extra)
    runner, n_iter = cli.make_runner(args)
    check(n_iter == iters, f"[mesh train] {n_iter} iterations")
    return runner


def mesh_learn(runner, iters, tag):
    """``iters`` learn iterations one at a time (the replicas checked equal
    after each update); (history, wall s, launches of K3 and of the shard
    kernel)."""
    import torch

    from legged_gym_dev_tpu_torch.ops import substep_kernels as sk

    torch.cuda.synchronize()
    sk.reset_launches()
    wall, hist = 0.0, []
    for _ in range(iters):
        t0 = time.perf_counter()
        hist = runner.learn(1)
        torch.cuda.synchronize()
        wall += time.perf_counter() - t0
        ref = runner.models[0].state_dict()
        for m in list(runner.models)[1:]:
            check(all(torch.equal(v, ref[k])
                      for k, v in m.state_dict().items()),
                  f"[mesh train] {tag}: a replica differs after an update")
    for h in hist:
        for k in ("mean_reward", "loss", "policy_loss", "value_loss", "kl"):
            check(bool(np.isfinite(h[k])), f"[mesh train] {tag}: {k}")
    return hist, wall, sk.launches()


def mesh_train(dev, work):
    """``cli train --task anymal_c_velocity`` (the test quadruped, B=4096,
    ``configs/rl/default.yaml``) through ``cli.make_runner``, 2 iterations
    each: unsharded, with ``--dp-devices 1`` (a 1-device mesh: bit for bit
    the unsharded run) and, where there are several cards, with
    ``--dp-devices <cards>``; then ``OnPolicyRunner(mesh=<4 shards of the
    card>)`` on the same config: shard kernel launches exactly 4 x 24 x 4
    x 2 (one per shard and substep) and none of K3, replicas bit-identical
    after every update. Returns the record, K3's launches in the unsharded
    run and the shard kernel's in the sharded runs."""
    import torch

    from legged_gym_dev_tpu_torch import cli
    from legged_gym_dev_tpu_torch.rl.runner import OnPolicyRunner

    rc = robot_cases()
    urdf = work / "quadruped.urdf"
    urdf.write_text(rc.QUADRUPED_URDF)
    cfg_path = work / "anymal_c_velocity.yaml"
    cfg_path.write_text(f"defaults:\n  - {ROOT / 'configs/rl/default.yaml'}"
                        f"\n  - _self_\nenv:\n  urdf_path: {urdf}\n")
    cards, iters = torch.cuda.device_count(), 2
    steps = iters * 24 * B_RL
    keys = ("mean_reward", "loss", "kl")
    out, runs, k3 = {"cards": cards}, {}, 0
    for name, extra in (("unsharded", []), ("dp1", ["--dp-devices", "1"]),
                        *([("dp_cards", ["--dp-devices", str(cards)])]
                          if cards > 1 else [])):
        runner = mesh_learn_runner(extra, cfg_path, work, iters, cli)
        n = 1 if name == "unsharded" else runner.mesh.size
        check(name == "unsharded" or all(
            d.type == "cuda" for d in runner.mesh.devices.flat),
            f"[mesh train] {name}: a shard off the card")
        hist, wall, n_k = mesh_learn(runner, iters, name)
        want = iters * 24 * 4 * n
        key = "substep" if name == "unsharded" else "substep_sharded"
        check(n_k == {"substep": 0, "substep_sharded": 0, key: want},
              f"[mesh train] {name}: launches {n_k}, want {want} {key}")
        if name == "unsharded":
            k3_u = want
        else:
            k3 += want
        runs[name] = hist
        out[f"{name}_env_steps_per_s"] = steps / wall
        out[f"{name}_metrics"] = [{k: h[k] for k in keys} for h in hist]
    same = all(a[k] == b[k] for a, b in zip(runs["unsharded"], runs["dp1"])
               for k in ("loss", "mean_reward", "kl", "value_loss"))
    check(same, "[mesh train] the 1-device mesh differs from the unsharded "
          "runner")
    sharded = OnPolicyRunner(runner.env, model=type(runner.model)(
        runner.env.num_obs, runner.env.num_actions,
        runner.model.actor_hidden_dims, runner.model.critic_hidden_dims,
        runner.model.activation, runner.model.init_noise_std,
        generator=torch.Generator().manual_seed(0)), cfg=runner.cfg,
        mesh=mesh_of(dev))
    hist, wall, n_k = mesh_learn(sharded, iters, "4 shards")
    k3_4 = MESH_SHARDS * 24 * 4 * iters
    check(n_k == {"substep": 0, "substep_sharded": k3_4},
          f"[mesh train] 4 shards: launches {n_k}, want {k3_4} "
          "substep_sharded")
    k3 += k3_4
    out.update(mesh4_env_steps_per_s=steps / wall,
               mesh4_s_per_iteration=wall / iters,
               mesh4_metrics=[{k: h[k] for k in keys} for h in hist],
               one_device_mesh_bit_identical=same, k3_launches_mesh4=k3_4)
    print("[mesh train] " + json.dumps(out))
    return out, k3_u, k3


def mesh_curriculum(dev):
    """Cassie's command curriculum (the test biped, B=4096, 4 shards): one
    step from a state in which some envs time out with tracking sums set
    so that the whole batch widens the ranges while shard 1 alone would
    not; the sharded step's ranges equal the unsharded step's on every
    shard."""
    import torch

    from legged_gym_dev_tpu_torch.envs import ShardedEnv, presets
    from legged_gym_dev_tpu_torch.parallel.mesh import (
        shard_batch,
        shard_generators,
    )

    rc = robot_cases()
    env = presets.make_cassie_env(urdf_path=rc.CASSIE_URDF, num_envs=B_RL,
                                  add_noise=False, device=dev)
    check(env.command_curriculum, "[mesh curriculum] curriculum off")
    mesh = mesh_of(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    state, _ = env.reset(gen)
    L, b = env.max_episode_length, B_RL // MESH_SHARDS
    good = 1.2 * dict(env.reward_scales)["tracking_lin_vel"] * env.dt * L
    done_envs = [0, 1, 2, b + 5]          # shard 0: 3 good; shard 1: 1 bad
    step = state.episode_step.clone()
    step[done_envs] = L - 1
    track = torch.zeros(B_RL, device=dev)
    track[:3] = good
    state = state.replace(episode_step=step, episode_sums=dict(
        state.episode_sums, tracking_lin_vel=track))
    actions = torch.zeros(B_RL, env.num_actions, device=dev)
    ref, tr = env.step(state, actions)
    senv = ShardedEnv(env, mesh)
    shards = senv.shard_state(state, shard_generators(mesh, 0))
    out, trs = senv.step(shards, shard_batch(actions, mesh))
    torch.cuda.synchronize()
    widened = not torch.equal(ref.command_ranges, state.command_ranges)
    equal = all(torch.equal(s.command_ranges, ref.command_ranges)
                for s in out)
    rec = dict(resets=int(tr.done.sum()), widened=widened,
               equal_on_every_shard=equal,
               command_ranges=ref.command_ranges.cpu().tolist())
    print("[mesh curriculum] " + json.dumps(rec))
    check(widened, "[mesh curriculum] the ranges did not widen")
    check(equal, "[mesh curriculum] a shard's ranges differ")
    return rec


def mesh_solve(dev):
    """l1 at B=2048, N=50, 20x10 (bench.py's gap batch) on the 4-shard
    mesh and on a (2, 2) host mesh of the card against the unsharded
    solve: plans within 1e-5, bt_solve launched 4x as often; the 4-shard
    solve's verdicts, certified on its 4 shards without the
    escalated restorations, in counts equal to the unsharded pass's.
    Returns the record and the sharded runs' bt_solve launches."""
    import torch

    from legged_gym_dev_tpu_torch.ops import block_tridiag_kernels as btk
    from legged_gym_dev_tpu_torch.parallel.mesh import (
        gather,
        make_host_mesh,
        map_shards,
        shard_batch,
    )
    from legged_gym_dev_tpu_torch.solver import (
        VERDICT_NAMES,
        ALConfig,
        StagedProblem,
        certify_staged_batched,
        solve_tube_fast_batched,
        staged_bounds,
    )

    B = B_L1
    p = bench_batch(B, "l1", dev)
    cfg = ALConfig(linsolve="pallas")
    sp = StagedProblem(n=2, m=2, N=N, K=2, tube_kind="l1", scaling=0.5,
                       track_ref=False)

    def solve(pp):      # device None: the shard's card (map_shards)
        return solve_tube_fast_batched(pp, N, H_REV, tube_kind="l1",
                                       scaling=0.5, cfg=cfg,
                                       warm_start="interpolate",
                                       tube_ws="evaluate")

    def certify(pp, o):
        lb, ub = staged_bounds(pp, 2, 2, N)
        return certify_staged_batched(sp, pp, o.sol.x.reshape(
            pp.batch_size, N + 1, -1), o.sol.viol, lb, ub,
            escalate=False).verdict

    def timed_solve(fn):
        btk.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        o = fn()
        torch.cuda.synchronize()
        return o, time.perf_counter() - t0, btk.launches()["bt_solve"]

    ref, wall_u, k1_u = timed_solve(lambda: solve(p))
    mesh = mesh_of(dev)
    out_sh, wall_4, k1_4 = timed_solve(lambda: map_shards(
        solve, shard_batch(p, mesh, batch_size=B)))
    host = make_host_mesh(2, 2, devices=[dev] * 4)
    out_h, wall_h, k1_h = timed_solve(lambda: map_shards(
        solve, shard_batch(p, host, axis=("dcn", "ici"), batch_size=B)))
    z4, zh = gather(out_sh).z, gather(out_h).z
    dz4 = float((z4 - ref.z).abs().max())
    dzh = float((zh - ref.z).abs().max())
    check(dz4 <= 1e-5, f"[mesh solve] 4 shards: plans differ by {dz4}")
    check(dzh <= 1e-5, f"[mesh host] (2, 2): plans differ by {dzh}")
    check(k1_4 == MESH_SHARDS * k1_u and k1_h == MESH_SHARDS * k1_u,
          f"[mesh solve] bt_solve launches {k1_4}, {k1_h} != 4 x {k1_u}")
    t0 = time.perf_counter()
    v4 = gather(map_shards(certify, shard_batch(p, mesh, batch_size=B),
                           out_sh), batch_size=B).cpu().numpy()
    cert_4 = time.perf_counter() - t0
    counts_4 = {n: int(np.sum(v4 == i)) for i, n in enumerate(VERDICT_NAMES)}
    t0 = time.perf_counter()
    vu = certify(p, ref).cpu().numpy()
    cert_u = time.perf_counter() - t0
    counts_u = {n: int(np.sum(vu == i)) for i, n in enumerate(VERDICT_NAMES)}
    rec = dict(batch=B, shards=MESH_SHARDS, unsharded_solves_per_s=B / wall_u,
               mesh4_solves_per_s=B / wall_4, host2x2_solves_per_s=B / wall_h,
               max_abs_dz_mesh4=dz4, max_abs_dz_host2x2=dzh,
               bt_solve_launches_unsharded=k1_u, bt_solve_launches_mesh4=k1_4,
               bt_solve_launches_host2x2=k1_h, verdicts_mesh4=counts_4,
               verdicts_unsharded=counts_u, certify_shards=MESH_SHARDS,
               certify_wall_sharded_s=cert_4,
               certify_wall_unsharded_s=cert_u)
    print("[mesh solve] " + json.dumps(rec))
    print("[mesh host] " + json.dumps(dict(
        mesh=dict(host.shape), solves_per_s=B / wall_h, max_abs_dz=dzh,
        bt_solve_launches=k1_h)))
    check(counts_4 == counts_u, f"[mesh solve] verdicts {counts_4} != "
          f"{counts_u}")
    return rec, k1_4 + k1_h


def mesh_loop(dev):
    """The l1 closed loop at B=1024 for 3 ticks (bench.py's gap batch, the
    DoubleInt2D plant) on the 4-shard mesh against unsharded: executed z
    within 1e-5. Returns the record and the sharded run's bt_solve
    launches."""
    import torch

    from legged_gym_dev_tpu_torch.core import make_rom
    from legged_gym_dev_tpu_torch.ops import block_tridiag_kernels as btk
    from legged_gym_dev_tpu_torch.parallel.mesh import (
        gather,
        map_shards,
        replicate,
        shard_batch,
    )
    from legged_gym_dev_tpu_torch.solver import (
        PROBLEM_DICT,
        ALConfig,
        closed_loop_tube_mpc_fast,
    )

    prob = PROBLEM_DICT["gap"]
    B = B_MESH_LOOP
    p = bench_batch(B, "l1", dev, seed=1)
    robot = make_rom("DoubleInt2D", prob["dt"], [-np.inf, -np.inf, -0.3, -0.3],
                     [np.inf, np.inf, 0.3, 0.3], [-0.5, -0.5], [0.5, 0.5],
                     device=dev)
    mesh = mesh_of(dev)

    def run(pp, rob):
        return closed_loop_tube_mpc_fast(
            pp, rob, tube_kind="l1", scaling=0.5, H=3, N=N, H_rev=H_REV,
            cfg_first=ALConfig(linsolve="pallas"),
            cfg_loop=ALConfig(outer_iters=4, inner_iters=6,
                              linsolve="pallas"),
            warm_start="interpolate", tube_ws="evaluate")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = run(p, robot)
    torch.cuda.synchronize()
    wall_u = time.perf_counter() - t0
    btk.reset_launches()
    t0 = time.perf_counter()
    out = gather(map_shards(run, shard_batch(p, mesh, batch_size=B),
                            replicate(robot, mesh)), batch_size=B)
    torch.cuda.synchronize()
    wall_4 = time.perf_counter() - t0
    k1 = btk.launches()["bt_solve"]
    dz = float((out[0] - ref[0]).abs().max())
    rec = dict(batch=B, ticks=3, shards=MESH_SHARDS, max_abs_dz=dz,
               unsharded_ms_per_tick=1e3 * wall_u / 4,
               mesh4_ms_per_tick=1e3 * wall_4 / 4,
               adopted_equal=bool(torch.equal(out[5], ref[5])),
               bt_solve_launches=k1)
    print("[mesh loop] " + json.dumps(rec))
    check(all(bool(torch.isfinite(t).all()) for t in out[:5]),
          "[mesh loop] non-finite trace")
    check(dz <= 1e-5, f"[mesh loop] executed z differs by {dz}")
    return rec, k1


def mesh_collect(dev):
    """A ``rom_tracking`` collect step (4 steps of the ROM sim under its PD
    tracker) at B=4096 on the 4-shard mesh, each shard with its own
    generator, against unsharded from the same state: finite, equal on
    every env that resampled nothing in the window."""
    import torch

    from legged_gym_dev_tpu_torch.controllers import DoubleSingleTracking
    from legged_gym_dev_tpu_torch.envs import presets
    from legged_gym_dev_tpu_torch.envs.base import shard_env_state
    from legged_gym_dev_tpu_torch.parallel.mesh import (
        Sharded,
        gather,
        map_shards,
        shard_generators,
    )

    mesh = mesh_of(dev)
    sim = presets.make_rom_tracking_env(num_envs=B_RL, device=dev).sim
    policy = DoubleSingleTracking.create(4.0, 4.0, sim.model.clip_v_z)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    state = sim.reset(gen)
    shards = shard_env_state(state, mesh, B_RL, shard_generators(mesh, 1))

    def collect(s_, st):
        for _ in range(4):
            st = s_.step(st, policy(s_.get_observations(st)))
        return st, s_.rom.proj_z(st.root_states)

    ref, proj = collect(sim, state)
    t0 = time.perf_counter()
    out = gather(map_shards(collect, Sharded(sim.shard(mesh), mesh), shards),
                 batch_size=B_RL)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    quiet = ref.traj_gen.t_final == state.traj_gen.t_final
    dz = float((out[1][quiet] - proj[quiet]).abs().max())
    rec = dict(batch=B_RL, steps=4, quiet_envs=int(quiet.sum()),
               max_abs_diff_quiet=dz, finite=bool(torch.isfinite(out[1])
                                                   .all()),
               mesh4_env_steps_per_s=4 * B_RL / wall)
    print("[mesh collect] " + json.dumps(rec))
    check(rec["finite"], "[mesh collect] non-finite")
    check(0 < rec["quiet_envs"], "[mesh collect] every env resampled")
    check(dz <= 1e-5, f"[mesh collect] quiet envs differ by {dz}")
    return rec


def mesh_phase(dev):
    """The mesh slice's main path on one card (a 4-shard mesh of it; over
    the real cards too where there are several). Returns K3's sharded
    record and the phase's launches: K3 and bt_solve of the sharded
    runs."""
    import shutil

    work = ROOT / "build" / "chip_smoke_mesh_runs"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    t0 = time.perf_counter()
    rec = mesh_substep(dev)
    _, k3_u, k3 = mesh_train(dev, work)
    mesh_curriculum(dev)
    _, k1_solve = mesh_solve(dev)
    _, k1_loop = mesh_loop(dev)
    mesh_collect(dev)
    # each kernel counts where it launches: the sharded runs' launches
    # are the shard kernel's (substep_sharded), the unsharded run's K3's
    launches = {"substep": k3_u, "substep_sharded": k3,
                "bt_solve": k1_solve + k1_loop}
    print(f"[launches] mesh path: {json.dumps(launches)} in "
          f"{time.perf_counter() - t0:.1f} s")
    return rec, launches


# ---------------------------------------------------------------------------
# flagship phase: the port's two end-to-end pipelines, a process each
# ---------------------------------------------------------------------------

FLAGSHIP_SCRIPTS = {"rom": "scripts/torch_flagship_e2e.py",
                    "rl": "scripts/torch_flagship_rl_e2e.py"}
# Environment knobs of the two scripts. Widths are the JAX scripts' (B,
# COLLECT_ENVS, TRAIN_ENVS, FIXTURE_ENVS; N=50 and H_rev=10 are the
# scripts' own); only depth is cut: H (75), TRAIN_ITERS (2000),
# FIXTURE_STEPS (400), EPISODE_S (10; 5.5 s holds N + 2 = 52 ROM ticks),
# COLLECT_EPOCHS (2) and REPS (3). The RL pipeline plans on right_wide,
# the problem the JAX package's hopper flagship runs: hopper-scale tubes
# close gap's 0.52 m corridor (after 2 PPO iterations the loops adopted
# 0.0007 and 0.0013 of the re-solves there).
FLAGSHIP_KNOBS = {
    "rom": {"B": 1024, "COLLECT_ENVS": 1024, "H": 3, "EPOCHS": 40,
            "REPS": 1},
    "rl": {"TASK": "hopper_trajectory", "TRAIN_ENVS": 4096,
           "TRAIN_ITERS": 2, "FIXTURE_ENVS": 256, "FIXTURE_STEPS": 10,
           "COLLECT_ENVS": 1024, "COLLECT_EPOCHS": 1, "EPISODE_S": 5.5,
           "B": 1024, "H": 3, "EPOCHS": 40, "REPS": 1,
           "PROBLEM": "right_wide"},
}
# the scripts' schedules, (outer, inner, Woodbury basis refresh): the
# closed loop's first solve (and its nominal warm start) and each re-solve
FLAGSHIP_SCHEDULES = ((20, 10, 3), (4, 6, 3))
FIXTURES = ("zero", "square", "circle")
TRACE_KEYS = ("coverage", "mean_width", "mean_error", "max_error",
              "mean_margin", "solver_converged_frac", "max_solver_viol")
LOOP_TIMING = ("wall_s", "compile_plus_first_s", "per_resolve_batched_s",
               "rom_tick_budget_s", "realtime_batched", "resolves_per_s")
RL_LOOP = ("problem", "scenarios", "H", *LOOP_TIMING, "adopted_frac",
           "median_goal_dist", "tube_coverage_on_trace", "tube_mean_width",
           "tube_mean_error")
# every key of the JAX scripts' reports (scripts/flagship_e2e.py,
# scripts/flagship_rl_e2e.py), each section with its keys
FLAGSHIP_KEYS = {
    "rom": {
        "collect": ("episodes", "rom_steps", "wall_s"),
        "tube_train": ("epochs", "one_step_coverage", "final_loss",
                       "wall_s"),
        "mpc": ("scenarios", "H", *LOOP_TIMING, "adopted_frac",
                "max_adopted_viol", "median_goal_dist",
                "goal_reach_frac_10cm"),
        "tube_on_trace": TRACE_KEYS,
    },
    "rl": {
        "task": (), "curriculum": (), "weight_sampler": (),
        "rl_train": ("iters", "envs", "wall_s", "reward_first",
                     "reward_last", "env_steps_per_s"),
        "checkpoint_selection": ("candidates", "selected"),
        "fixture_tracking": (*FIXTURES, *(f"raibert_{f}" for f in FIXTURES),
                             "wall_s"),
        "collect": ("episodes", "rom_steps", "wall_s", "mean_tracking_err",
                    "p95_tracking_err"),
        "tube_train": ("epochs", "one_step_coverage", "conformal_scale",
                       "cal_step_coverage_pre", "cal_step_coverage_post",
                       "wall_s"),
        "mpc_env": ("v_max_data", "v_plan", "robot_vel", "robot_acc"),
        "mpc_uncalibrated": RL_LOOP, "mpc": RL_LOOP,
        "trace_conformal": ("scale_q", "out_scale"),
        "mpc_trace_cal": RL_LOOP,
    },
}
FLAGSHIP_LOOPS = {"rom": ("mpc",),
                  "rl": ("mpc_uncalibrated", "mpc", "mpc_trace_cal")}
CAL_COVERAGE_MIN = 0.88  # split-conformal at 0.9, less 8192 draws' noise


def solve_launches(outer, inner, refresh, nn=True):
    """Kernel launches of one staged solve with ``linsolve="pallas"``: one
    bt_solve an inner step (the l1 step, or the NN step's gradient
    column), and for the NN tube one multi-RHS solve (bt_factor +
    bt_msolve) for the Woodbury basis per chunk of ``refresh`` inner
    steps."""
    chunks = -(-inner // refresh) if nn else 0
    return {"bt_solve": outer * inner, "bt_factor": outer * chunks,
            "bt_msolve": outer * chunks}


def loop_launches(H, schedules=FLAGSHIP_SCHEDULES):
    """One call of the flagships' NN-tube closed loop: the nominal (l1)
    warm start and the first NN solve on the first schedule, then H
    re-solves on the loop's."""
    first, loop = schedules
    parts = ([solve_launches(*first, nn=False), solve_launches(*first)]
             + [solve_launches(*loop)] * H)
    return {k: sum(p[k] for p in parts) for k in parts[0]}


def flagship_expected(kind, knobs, report, hopper=None,
                      schedules=FLAGSHIP_SCHEDULES):
    """The launches a flagship run with these knobs must count: each
    closed-loop call's (the ROM flagship's warm-up and REPS timed calls;
    the RL flagship's three loops so, and its trace-calibration call),
    and for the RL flagship the substep kernel at the hopper's joint count
    once a substep of every env step: the learn iterations' rollouts, the
    fixtures of each checkpoint candidate (the report's) and of the
    Raibert heuristic, and the collection's ROM ticks. ``hopper`` holds
    the env's constants: nj, decimation, dt, the ROM's dt and PPO's
    steps an iteration."""
    calls = 1 + knobs["REPS"]
    if kind == "rl":
        calls = 3 * calls + 1
    out = {k: calls * v
           for k, v in loop_launches(knobs["H"], schedules).items()}
    out["substep"] = {}
    if kind == "rl":
        ticks = int(round(float(knobs["EPISODE_S"]) / hopper["rom_dt"]))
        per_tick = max(1, int(round(hopper["rom_dt"] / hopper["dt"])))
        n_cand = len(report["checkpoint_selection"]["candidates"])
        steps = (knobs["TRAIN_ITERS"] * hopper["num_steps"]
                 + (n_cand + 1) * len(FIXTURES) * knobs["FIXTURE_STEPS"]
                 + knobs["COLLECT_EPOCHS"] * ticks * per_tick)
        out["substep"] = {str(hopper["nj"]): hopper["decimation"] * steps}
    return out


def hopper_constants(urdf, dev):
    """The test hopper's env constants that ``flagship_expected`` reads,
    from a one-env ``hopper_trajectory`` env."""
    from legged_gym_dev_tpu_torch.envs import task_registry

    env = task_registry.make_env("hopper_trajectory", num_envs=1,
                                 urdf_path=str(urdf), device=dev)
    return {"nj": env.sim.model.nj, "decimation": env.sim.decimation,
            "dt": float(env.dt), "rom_dt": float(env.rom.dt),
            "num_steps": task_registry.get(
                "hopper_trajectory").train_cfg.num_steps}


def start_flagship(running):
    """Both flagship scripts, each a process on the card (as a user runs
    them, ``URDF`` naming the test hopper's file for the RL pipeline),
    started together and appended to ``running``. Returns their working
    directory."""
    import shutil

    work = ROOT / "build" / "chip_smoke_flagship"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    urdf = work / "hopper.urdf"
    urdf.write_text(robot_cases().HOPPER_URDF)
    extra = {"rom": {}, "rl": {"URDF": str(urdf),
                               "REPORT": str(work / "rl_report.json")}}
    for kind, script in FLAGSHIP_SCRIPTS.items():
        env = {**os.environ, **{k: str(v) for k, v in
                                {**FLAGSHIP_KNOBS[kind],
                                 **extra[kind]}.items()}}
        env.pop("E2E_CPU", None)
        with open(work / f"{kind}.out", "w") as out, \
                open(work / f"{kind}.err", "w") as err:
            proc = subprocess.Popen([sys.executable, str(ROOT / script)],
                                    cwd=ROOT, env=env, stdout=out,
                                    stderr=err)
        running.append((kind, script, time.time(), proc))
    return work


def _numbers(tree, path=""):
    """(path, value) of every number in a report."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _numbers(v, f"{path}.{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _numbers(v, f"{path}[{i}]")
    elif isinstance(tree, (int, float)) and not isinstance(tree, bool):
        yield path, tree


def check_flagship(kind, rep, expected):
    """The report's keys, finite numbers, adoption, conformal scale and
    calibration coverage, and its launches against ``expected``."""
    for section, keys in FLAGSHIP_KEYS[kind].items():
        check(section in rep, f"flagship {kind}: no {section}")
        missing = [k for k in keys if k not in rep[section]]
        check(not missing, f"flagship {kind} {section}: missing {missing}")
    bad = [p for p, v in _numbers(rep) if not np.isfinite(v)]
    check(not bad, f"flagship {kind}: non-finite {bad}")
    for loop in FLAGSHIP_LOOPS[kind]:
        check(rep[loop]["adopted_frac"] > 0,
              f"flagship {kind} {loop}: nothing adopted")
    if kind == "rl":
        tt = rep["tube_train"]
        check(tt["conformal_scale"] > 0, f"flagship rl: scale {tt}")
        check(tt["cal_step_coverage_post"] >= CAL_COVERAGE_MIN,
              f"flagship rl: calibrated coverage {tt}")
    got = rep["launches"]
    check(got == expected,
          f"flagship {kind}: launches {got}, expected {expected}")
    for k in ("bt_solve", "bt_factor", "bt_msolve"):
        check(got[k] > 0, f"flagship {kind}: no {k} launch")
    if kind == "rl":
        check(sum(got["substep"].values()) > 0,
              "flagship rl: no substep launch")


def print_flagship(kind, rep, wall):
    """The phase's lines: latency, rate, adoption, coverage, each stage's
    wall and the selected checkpoint."""
    for loop in FLAGSHIP_LOOPS[kind]:
        r = rep[loop]
        cov = (r["tube_coverage_on_trace"] if kind == "rl"
               else rep["tube_on_trace"]["coverage"])
        print(f"[flagship {kind}] {loop}: per_resolve_batched_s "
              f"{r['per_resolve_batched_s']} resolves_per_s "
              f"{r['resolves_per_s']} adopted_frac {r['adopted_frac']} "
              f"coverage {cov}")
    walls = {s: v["wall_s"] for s, v in rep.items()
             if isinstance(v, dict) and "wall_s" in v}
    print(f"[flagship {kind}] wall per stage (s): {json.dumps(walls)}; "
          f"process {wall:.1f} s")
    if kind == "rl":
        print(f"[flagship rl] selected checkpoint "
              f"{rep['checkpoint_selection']['selected']} of "
              f"{sorted(rep['checkpoint_selection']['candidates'])}; "
              f"tube_train {json.dumps(rep['tube_train'])}; "
              f"trace_conformal {json.dumps(rep['trace_conformal'])}")
    print(f"[flagship {kind}] report " + json.dumps(rep))


def finish_flagship(running, work, dev, timeout_s=900):
    """Waits for the flagship processes, checks and prints their reports.
    Returns the launches of both runs, per kernel (the substep kernel per
    joint count)."""
    hopper = hopper_constants(work / "hopper.urdf", dev)
    total = {"bt_solve": 0, "bt_factor": 0, "bt_msolve": 0, "substep": {}}
    for kind, script, t0, proc in running:
        if kind not in FLAGSHIP_SCRIPTS:
            continue
        proc.wait(timeout=max(1.0, timeout_s - (time.time() - t0)))
        wall = (work / f"{kind}.out").stat().st_mtime - t0
        err = (work / f"{kind}.err").read_text()
        check(proc.returncode == 0,
              f"{script} exited {proc.returncode}: {err[-3000:]}")
        lines = (work / f"{kind}.out").read_text().splitlines()
        for line in lines:
            if not line.startswith("{"):
                print(f"[flagship {kind}] {line}")
        rep = json.loads([ln for ln in lines if ln.startswith("{")][-1])
        if kind == "rl":
            check(rep == json.loads((work / "rl_report.json").read_text()),
                  "flagship rl: REPORT differs from the printed report")
        expected = flagship_expected(kind, FLAGSHIP_KNOBS[kind], rep, hopper)
        print_flagship(kind, rep, wall)
        check_flagship(kind, rep, expected)
        for k in ("bt_solve", "bt_factor", "bt_msolve"):
            total[k] += rep["launches"][k]
        for nj, n in rep["launches"]["substep"].items():
            total["substep"][int(nj)] = total["substep"].get(int(nj), 0) + n
    print(f"[launches] flagship path: {json.dumps(total)}")
    return total


# ---------------------------------------------------------------------------
# Scenarios slice: per-scenario ROMs and tube networks; the MJCF export
# ---------------------------------------------------------------------------

SCEN_SEED = 0        # the draws of the timed batches
SCEN_REF_SEED = 1    # the [scenarios ref] batch: away from a kink of the net


def scenario_draws(B, seed, mlp=None):
    """Each scenario's own ``vel_max`` per axis in [0.18, 0.22], ``dt`` in
    [0.09, 0.11] and, given the case net ``mlp`` (numpy weights, biases),
    its own net: ``mlp`` plus N(0, 0.01) on the last layer and U(-0.2,
    0.2) on its bias (leading axis B)."""
    rng = np.random.default_rng(seed + 2000)
    d = dict(vel_max=rng.uniform(0.18, 0.22, (B, 2)).astype(np.float32),
             dt=rng.uniform(0.09, 0.11, B).astype(np.float32))
    if mlp is not None:
        ws = [np.repeat(np.float32(w)[None], B, 0) for w in mlp[0]]
        bs = [np.repeat(np.float32(b)[None], B, 0) for b in mlp[1]]
        ws[-1] += rng.normal(0.0, 0.01, ws[-1].shape).astype(np.float32)
        bs[-1] += rng.uniform(-0.2, 0.2, bs[-1].shape).astype(np.float32)
        d.update(ws=ws, bs=bs)
    return d


def scenario_batch(B, tube, dev, seed=SCEN_SEED):
    """``bench_batch`` (the same starts, goals and obstacles) with a
    per-scenario ROM and, for NN_oneshot, a per-scenario tube net of
    ``scenario_draws``."""
    from legged_gym_dev_tpu_torch.core import make_rom
    from legged_gym_dev_tpu_torch.interop import mlp_from_numpy
    from legged_gym_dev_tpu_torch.solver import PROBLEM_DICT

    prob = PROBLEM_DICT["gap"]
    p = bench_batch(B, tube, dev, seed=seed)
    d = scenario_draws(B, seed, bench_mlp_numpy(seed)
                       if tube == "NN_oneshot" else None)
    rom = make_rom("SingleInt2D", d["dt"], [-prob["pos_max"]] * 2,
                   [prob["pos_max"]] * 2, -d["vel_max"], d["vel_max"],
                   device=dev)
    nn = None
    if tube == "NN_oneshot":
        nn = mlp_from_numpy(d["ws"], d["bs"], activation="softplus_b5",
                            final_activation="softplus", device=dev)
    return p.replace(rom=rom, tube_params=nn)


def scenario_solve(p, tube, dev, cfg):
    """One staged solve with its wall and launches."""
    import torch

    from legged_gym_dev_tpu_torch.ops import block_tridiag_kernels as btk
    from legged_gym_dev_tpu_torch.solver import solve_tube_fast_batched

    before = btk.launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = solve_tube_fast_batched(p, N, H_REV, tube_kind=tube, scaling=0.5,
                                  cfg=cfg, warm_start="interpolate",
                                  tube_ws="evaluate", device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return out, wall, {k: v - before[k] for k, v in btk.launches().items()}


def scenarios_phase(dev):
    """``[scenarios]``: the gap batch at bench width (N=50, 20x10; l1 at
    B=2048, NN_oneshot at B=1024, refresh 3, ``linsolve="pallas"``) with
    per-scenario ROMs and nets (``scenario_batch``) beside the shared
    form, in turns: a warm-up of each, then shared, per-scenario,
    per-scenario, shared. Every solve's K1 / K2f / K2s launches are
    exactly the schedule's. Returns the record and the phase's launches."""
    import torch

    from legged_gym_dev_tpu_torch.solver import ALConfig

    rec, total = {}, {"bt_solve": 0, "bt_factor": 0, "bt_msolve": 0}
    for tube, B in (("l1", B_L1), ("NN_oneshot", B_NN)):
        nn = tube == "NN_oneshot"
        cfg = (ALConfig(nn_basis_refresh=3, linsolve="pallas") if nn
               else ALConfig(linsolve="pallas"))
        want = solve_launches(cfg.outer_iters, cfg.inner_iters, 3, nn=nn)
        forms = {"shared": bench_batch(B, tube, dev, seed=SCEN_SEED),
                 "per_scenario": scenario_batch(B, tube, dev)}
        check(forms["per_scenario"].rom.per_scenario
              and (not nn or forms["per_scenario"].tube_params.per_scenario),
              f"[scenarios] {tube}: the batch is not per scenario")
        walls = {f: [] for f in forms}
        last = {}
        for i, form in enumerate(("shared", "per_scenario", "shared",
                                  "per_scenario", "per_scenario",
                                  "shared")):
            out, wall, launched = scenario_solve(forms[form], tube, dev, cfg)
            check(launched == want, f"[scenarios] {tube} {form}: launches "
                  f"{launched}, the schedule's {want}")
            for k in total:
                total[k] += launched[k]
            if i >= 2:                       # the first two warm up
                walls[form].append(wall)
            last[form] = out
        r = {"batch": B, "launches_per_solve": want}
        for form, out in last.items():
            viol = out.sol.viol.cpu().numpy()
            check(tuple(out.z.shape) == (B, N + 1, 2)
                  and bool(torch.isfinite(out.z).all())
                  and bool(torch.isfinite(out.w).all()),
                  f"[scenarios] {tube} {form}: non-finite plan")
            r[form] = dict(
                solves_per_s=B / float(np.mean(walls[form])),
                rep_wall_s=walls[form],
                feasible_frac=float(np.mean(viol < 1e-3)),
                max_viol=float(viol.max()))
        vmax = forms["per_scenario"].rom.v_max[:, None, :]
        check(bool(torch.all(last["per_scenario"].v.abs() <= vmax + 1e-6)),
              f"[scenarios] {tube}: a plan leaves its scenario's bound")
        r["per_scenario_over_shared"] = (r["per_scenario"]["solves_per_s"]
                                         / r["shared"]["solves_per_s"])
        print(f"[scenarios] {tube} " + json.dumps(r))
        check(r["per_scenario"]["feasible_frac"] >= 0.9,
              f"[scenarios] {tube}: feasible fraction "
              f"{r['per_scenario']['feasible_frac']}")
        rec[tube] = r
    print(f"[launches] scenarios path: {json.dumps(total)}")
    return rec, total


def scenarios_reference(dev, B=8):
    """``[scenarios ref]``: the per-scenario batch (B=8, 8x6) on the card
    (kernels) against the CPU (plain versions), l1 and NN_oneshot, on a
    draw away from a kink of the net. Bar: plans within 2e-3, as
    ``[ref]``."""
    import torch

    from legged_gym_dev_tpu_torch.solver import (
        ALConfig,
        solve_tube_fast_batched,
    )

    rec = {}
    for tube in ("l1", "NN_oneshot"):
        cfg = ALConfig(outer_iters=8, inner_iters=6, linsolve="pallas",
                       nn_basis_refresh=(3 if tube == "NN_oneshot"
                                         else "inner"))
        outs = [solve_tube_fast_batched(
            scenario_batch(B, tube, d, seed=SCEN_REF_SEED), N, H_REV,
            tube_kind=tube, scaling=0.5, cfg=cfg, warm_start="interpolate",
            tube_ws="evaluate", device=d)
            for d in (dev, torch.device("cpu"))]
        dz = float((outs[0].z.cpu() - outs[1].z).abs().max())
        dw = float((outs[0].w.cpu() - outs[1].w).abs().max())
        print(f"[scenarios ref] {tube} B={B}: card vs CPU max|dz|={dz:.3e} "
              f"max|dw|={dw:.3e}")
        check(dz < 2e-3 and dw < 2e-3,
              f"[scenarios ref] {tube}: card and CPU disagree")
        rec[tube] = dict(max_dz=dz, max_dw=dw)
    return rec


def scenarios_child(dev):
    """The scenarios slice in a process of its own, beside the parent's
    phases: ``[scenarios]`` then ``[scenarios ref]``."""
    rec, launches = scenarios_phase(dev)
    return dict(scenarios=rec, ref=scenarios_reference(dev),
                launches=launches)


# ---------------------------------------------------------------------------
# Routes: the JAX package's kernel-route switches, kernel against plain
# ---------------------------------------------------------------------------

ROUTES_ENV = {"LGDT_PALLAS_SUBSTEP": "0", "LGDT_PALLAS_MULTIRHS": "0"}
ROUTES_ROBOTS = ("quadruped", "hopper")    # nj=12 and the test hopper, nj=4
ROUTES_WARM = 3      # kernel-route steps from the random state: the carry
ROUTES_REPS = 5      # timed env steps of each route, from the same state


def routes_physics(robot, dev):
    """One decimated env step of a test robot at B=4096 (per-env DR rows,
    a PD torque law to its default pose) from a carried state, on the sim
    ``RobotSim.create`` makes (the plain route where
    ``LGDT_PALLAS_SUBSTEP=0``) and on the same sim with
    ``use_pallas_substep=True``: the plain route launches no K3, the
    kernel route one a substep; each route's median env-step wall over
    ``ROUTES_REPS``. The routes are held within ``TOL_REL`` substep by
    substep, each substep of the step taken by both from the same state
    (the kernel route's); the whole step's difference, four or eight
    substeps chained, is recorded beside it."""
    import torch

    from legged_gym_dev_tpu_torch.ops import substep_kernels as sk

    rc = robot_cases()
    inp = rc.substep_inputs(robot, B_RL, seed=17, dr=True)
    sim = rc.torch_sim(robot, dev, inp)
    kernel = sim.replace(use_pallas_substep=True)
    q0 = torch.as_tensor(rc.robot_config(robot)["q0"], device=dev)

    def pd(s):
        return 20.0 * (q0 - s.q) - 0.5 * s.v[:, 6:]

    state, _ = rc.torch_state(inp, dev)
    for _ in range(ROUTES_WARM):
        state = kernel.step(state, pd)
    fields = ("base_pos", "base_quat", "q", "v")
    out, walls, launches = {}, {}, {}
    for route, s in (("plain", sim), ("kernel", kernel)):
        sk.reset_launches()
        out[route] = s.step(state, pd)
        torch.cuda.synchronize()
        launches[route] = sk.launches()["substep"]
        ts = []
        for _ in range(ROUTES_REPS):
            t0 = time.perf_counter()
            s.step(state, pd)
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t0)
        walls[route] = float(np.median(ts)) * 1e3
    rel = dict.fromkeys(fields, 0.0)
    st = state
    for _ in range(sim.decimation):
        tau = pd(st)
        a, b = kernel.substep(st, tau), sim.substep(st, tau)
        for name in fields:
            x, y = getattr(a, name), getattr(b, name)
            check(bool(torch.isfinite(x).all() and torch.isfinite(y).all()),
                  f"[routes] {robot}: non-finite {name}")
            rel[name] = max(rel[name], errs(x, y)[1])
        st = a
    step_rel = {name: errs(getattr(out["kernel"], name),
                           getattr(out["plain"], name))[1]
                for name in fields}
    rec = dict(robot=robot, nj=sim.model.nj, batch=B_RL,
               decimation=sim.decimation,
               default_route=sim.use_pallas_substep, env_step_ms=walls,
               plain_over_kernel=walls["plain"] / walls["kernel"],
               k3_launches=launches, max_rel_err_substep=rel,
               max_rel_err_step=step_rel)
    print(f"[routes] physics {robot}: " + json.dumps(rec))
    check(sim.use_pallas_substep is False,
          f"[routes] {robot}: the variable did not set the plain route")
    check(launches == {"plain": 0, "kernel": sim.decimation},
          f"[routes] {robot}: K3 launches {launches}")
    check(max(rel.values()) <= TOL_REL, f"[routes] {robot}: rel err {rel}")
    return rec


def routes_solver(dev):
    """``[NN_oneshot]``'s solve and verdicts (B=1024, N=50, the gap batch,
    ``linsolve="pallas"``) on the multi-RHS route ``LGDT_PALLAS_MULTIRHS``
    gives (``factor_solve_entries``: no K2f or K2s launch, K1 still) and
    on the kernel route (``_PALLAS_MULTIRHS`` set back): each feasible on
    >= 0.98 of the batch, and the plans of the scenarios feasible in both
    within 2e-3 on >= 90% of them (the ``[array]`` bars)."""
    from legged_gym_dev_tpu_torch.solver import staged_scalar as tss

    rec, plans = {}, {}
    check(not tss._PALLAS_MULTIRHS,
          "[routes] LGDT_PALLAS_MULTIRHS=0 left the kernel route on")
    for route in ("factor_solve_entries", "kernel"):
        tss._PALLAS_MULTIRHS = route == "kernel"
        r, out = solve_mode("NN_oneshot", B_NN, dev,
                            tag=f"routes NN_oneshot {route}")
        plans[route] = (out.z.cpu().numpy(), out.sol.viol.cpu().numpy())
        rec[route] = {k: r[k] for k in ("solve_wall_s", "solves_per_s",
                                        "feasible_frac", "verdicts",
                                        "certify_wall_s", "launches")}
    off = rec["factor_solve_entries"]["launches"]
    check(off["bt_factor"] == 0 and off["bt_msolve"] == 0
          and off["bt_solve"] > 0, f"[routes] multi-RHS off: launches {off}")
    on = rec["kernel"]["launches"]
    check(on["bt_factor"] > 0 and on["bt_msolve"] > 0,
          f"[routes] kernel route: launches {on}")
    (z0, v0), (z1, v1) = plans.values()
    both = (v0 < 1e-3) & (v1 < 1e-3)
    dz = np.abs(z0 - z1).max(axis=(1, 2))
    within = float(np.mean(dz[both] <= 2e-3)) if both.any() else 0.0
    rec.update(max_dz=float(dz.max()), co_feasible=int(both.sum()),
               max_dz_co_feasible=float(dz[both].max()) if both.any()
               else None, within_2e3=within)
    print("[routes] NN_oneshot " + json.dumps(
        {k: rec[k] for k in ("max_dz", "co_feasible", "max_dz_co_feasible",
                             "within_2e3")}))
    check(within >= 0.9, f"[routes] co-feasible within 2e-3: {within}")
    return rec


def routes_child(dev):
    """``[routes]`` in a process of its own started with ``ROUTES_ENV``
    (the JAX package's switches off), beside the parent's robots and play
    phases: the physics step on both routes for each robot of
    ``ROUTES_ROBOTS``, then the NN_oneshot solve on both multi-RHS
    routes. Its launches compare kernels with their plain routes and are
    not the main path's."""
    return dict(physics={r: routes_physics(r, dev) for r in ROUTES_ROBOTS},
                solver=routes_solver(dev))


# ---------------------------------------------------------------------------
# Tools: the JAX system's profiling and schedule tools, small, on the card
# ---------------------------------------------------------------------------

TOOLS_B = 256          # batch of every tool here (the JAX defaults 1024-4096)
TOOLS_REPS = 1         # timed reps of every timing
TOOLS_SCHEDULE = (2, 2)   # outer x inner of every solve and loop re-solve


def tool(name):
    """``scripts/torch_<name>.py``, imported from the scripts directory."""
    import importlib

    scripts = str(ROOT / "scripts")
    if scripts not in sys.path:
        sys.path.insert(0, scripts)
    return importlib.import_module(f"torch_{name}")


def tools_cases(dev):
    """(tool, call, expected launches) of each tool at the phase's size;
    an expected count is exact where the tool's arguments fix it, else
    None (more than 0). Keys of the counts: bt_solve, bt_factor,
    bt_msolve, substep (nj=12) and substep_nj4."""
    from legged_gym_dev_tpu_torch.solver import ALConfig

    rc = robot_cases()
    B, r = TOOLS_B, TOOLS_REPS
    outer, inner = TOOLS_SCHEDULE
    small = ALConfig(outer_iters=outer, inner_iters=inner, linsolve="pallas")
    first = ALConfig(outer_iters=outer, inner_iters=inner,
                     nn_basis_refresh=3, linsolve="pallas")
    quad = {"urdf_path": rc.QUADRUPED_URDF}
    iters, k = outer * inner, 2
    T = 24                              # PPOConfig().num_steps
    solves = {"bt_solve": None}
    loops = {"bt_solve": None, "bt_factor": None, "bt_msolve": None}
    return [
        # the cold build first: no K3 library is loaded in this process yet
        ("compile_time_quadruped",
         lambda: tool("compile_time_quadruped").compile_time(
             "ppo", B=B, overrides=quad, device=dev),
         lambda out: {"substep": T * out["decimation"]}),
        ("profile_solver", lambda: tool("profile_solver").profile_solver(
            B=B, cfg=small, reps=r, device=dev), lambda out: solves),
        ("profile_staged", lambda: tool("profile_staged").profile_staged(
            B=B, cfg=small, reps=r, device=dev), lambda out: solves),
        ("profile_nn_tube", lambda: tool("profile_nn_tube").profile_nn_tube(
            B=B, iters=iters, reps=r, jac_ad=True, chol_xla=True,
            device=dev),
         lambda out: dict.fromkeys(("bt_solve", "bt_factor", "bt_msolve"),
                                   (1 + r) * (iters + 1))),
        ("profile_tick", lambda: tool("profile_tick").profile_tick(
            B=B, H=1, reps=r, cfg_first=first, device=dev),
         lambda out: loops),
        ("profile_sim", lambda: tool("profile_sim").profile_sim(
            B=B, reps=r, env_reps=r,
            overrides={"urdf_path": rc.HOPPER_URDF}, device=dev),
         lambda out: {"substep_nj4": (1 + r) + (1 + r) * out["decimation"]}),
        ("profile_quadruped",
         lambda: tool("profile_quadruped").profile_quadruped(
             B=B, reps=r, learn_reps=r, overrides=quad, device=dev),
         lambda out: {"substep": (1 + r) * (1 + 2 * out["decimation"])
                      + (1 + r) * out["num_steps"] * out["decimation"]}),
        ("profile_rough", lambda: tool("profile_rough").profile_rough(
            B=B, k=k, reps=r, overrides=quad, device=dev),
         lambda out: {"substep": (1 + r) * k * out["decimation"]}),
        ("measure_imbalance",
         lambda: tool("measure_imbalance").measure_imbalance(
             B=B, shards=2, cfg=small, reps=r, device=dev),
         lambda out: solves),
        ("sweep_schedule", lambda: tool("sweep_schedule").sweep_schedule(
            B=B, default=(outer, inner, 10), schedules=((outer, 1, 8),
                                                         (1, inner, 8)),
            reps=r, device=dev), lambda out: solves),
        ("tune_loop_schedule",
         lambda: tool("tune_loop_schedule").tune_loop_schedule(
             B=B, H=1, combos=((5, 6, 3), (4, 4, 4)), first=TOOLS_SCHEDULE,
             reps=r, device=dev), lambda out: loops),
    ]


def tools_child(dev):
    """``[tools]``: each of the eleven tools' functions on the card at
    ``TOOLS_B`` with one timed rep, 4-step solve schedules, loops of one
    tick, 2 shards and 2 of the sweep's schedules, in a process of its own
    beside the robots and play phases: no exception, every number it
    returns finite, each kernel it launches counted and more than 0 (K3
    and, in ``profile_nn_tube``, the solver kernels exactly as its
    arguments give). Returns the launches summed over the tools."""
    import torch

    from legged_gym_dev_tpu_torch.ops import block_tridiag_kernels as btk
    from legged_gym_dev_tpu_torch.ops import substep_kernels as sk

    total = dict.fromkeys(("bt_solve", "bt_factor", "bt_msolve", "substep",
                           "substep_nj4"), 0)
    recs = {}
    for name, call, expected in tools_cases(dev):
        t0 = time.perf_counter()
        out = call()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {**btk.launches(), "substep": sk.launches_by_nj().get(12, 0),
               "substep_nj4": sk.launches_by_nj().get(4, 0)}
        want = expected(out)
        print(f"[tools] {name}: {wall:.1f} s, launches {json.dumps(got)}")
        bad = [p for p, v in _numbers(out) if not np.isfinite(v)]
        check(not bad, f"[tools] {name}: non-finite {bad}")
        for kname, n in want.items():
            check(got[kname] > 0 if n is None else got[kname] == n,
                  f"[tools] {name}: {kname} launches {got[kname]}, "
                  f"expected {'> 0' if n is None else n}")
        others = {kn: v for kn, v in got.items() if kn not in want and v}
        check(not others, f"[tools] {name}: launches {others} not expected")
        for kname in total:
            total[kname] += got[kname]
        recs[name] = dict(wall_s=wall, launches=got)
    return dict(tools=recs, launches=total)


def mesh_child(dev):
    """The mesh phase in a process of its own, beside the parent's robots
    and play phases: K3s's record and the phase's launches, counted in
    this process where the kernels launch."""
    rec, launches = mesh_phase(dev)
    return dict(substep_sharded=rec, launches=launches)


CHILDREN = {"scenarios": scenarios_child, "routes": routes_child,
            "mesh": mesh_child, "tools": tools_child}
CHILD_ENV = {"routes": ROUTES_ENV}


def run_child(kind, out_path):
    """``CHILDREN[kind]`` on the card (``--child KIND OUT``), its record
    and wall written to ``out_path`` as JSON."""
    import torch

    from legged_gym_dev_tpu_torch.utils.runtime import fp32_matmul

    dev = torch.device("cuda", torch.cuda.current_device())
    t0 = time.perf_counter()
    with fp32_matmul():
        rec = CHILDREN[kind](dev)
    rec["wall_s"] = time.perf_counter() - t0
    Path(out_path).write_text(json.dumps(rec))
    return 0


def start_child(kind, running):
    """``chip_smoke.py --child KIND`` as a process on the card, with
    ``CHILD_ENV[kind]`` in its environment, appended to ``running``.
    Returns its working directory."""
    import shutil

    work = ROOT / "build" / f"chip_smoke_{kind}"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    env = {**os.environ, **CHILD_ENV.get(kind, {})}
    with open(work / "out", "w") as out, open(work / "err", "w") as err:
        proc = subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--child", kind,
             str(work / "rec.json")],
            cwd=ROOT, env=env, stdout=out, stderr=err)
    running.append((kind, "chip_smoke.py", time.time(), proc))
    return work


def finish_child(kind, running, work, timeout_s=600):
    """Waits for the ``kind`` process, prints its lines and checks its
    exit. Returns its record."""
    for k, _, t0, proc in running:
        if k != kind:
            continue
        proc.wait(timeout=max(1.0, timeout_s - (time.time() - t0)))
        for line in (work / "out").read_text().splitlines():
            print(line)
        err = (work / "err").read_text()
        check(proc.returncode == 0,
              f"{kind} process exited {proc.returncode}: {err[-3000:]}")
        rec = json.loads((work / "rec.json").read_text())
        print(f"[{kind}] process wall {time.time() - t0:.1f} s "
              f"(its phases {rec['wall_s']:.1f} s)")
        return rec
    raise RuntimeError(f"no {kind} process was started")


def mjcf_phase():
    """``[mjcf]``: ``build_mjcf`` of every test robot of
    ``tests/torch_robot_cases.py`` (the robots and the chains), parsed with
    ``xml.etree``: one body a link of the composed model, one joint a
    joint (the model's names, in order) and a free joint on the base."""
    import xml.etree.ElementTree as ET

    from legged_gym_dev_tpu_torch.sim.dynamics import RobotModel
    from legged_gym_dev_tpu_torch.sim.mjcf import build_mjcf
    from legged_gym_dev_tpu_torch.sim.urdf import parse_urdf

    cases = robot_cases()
    rec = {}
    for name in (*cases.ROBOTS, *cases.CHAINS):
        spec = parse_urdf(cases.robot_config(name)["urdf"])
        model = RobotModel.from_spec(spec)
        root = ET.fromstring(build_mjcf(spec))
        bodies = root.findall(".//body")
        joints = root.findall(".//joint")
        check(len(bodies) == model.nb and len(joints) == model.nj
              and len(root.findall(".//freejoint")) == 1
              and [j.get("name") for j in joints] == list(model.dof_names),
              f"[mjcf] {name}: {len(bodies)} bodies, {len(joints)} joints "
              f"for a model of {model.nb} bodies, {model.nj} joints")
        rec[name] = [model.nb, model.nj]
    print("[mjcf] bodies, joints of each test robot's MJCF: "
          + json.dumps(rec))
    return rec


def kernels_alone_ms(b, dev):
    """The three block-tridiagonal kernels alone (CUDA events over
    back-to-back launches) at block size b and the zoo's shapes, each
    checked against its plain version first: {kernel: ms}."""
    import torch

    from legged_gym_dev_tpu_torch.ops import block_tridiag_kernels as btk

    S, out = N + 1, {}
    D, L, rhs = spd_systems(B_ZOO, S, b, 1, seed=b, dev=dev)
    Df, Lf = entry_lists(D, L)
    r = [rhs[:, :, i, 0].contiguous() for i in range(b)]
    args, x = btk.prepare_solve_entries(Df, Lf, r, b)
    btk._launch_solve(args, S, B_ZOO, b, dev)
    x_pl = btk.block_tridiag_solve_entries_plain(Df, Lf, r, b)
    torch.cuda.synchronize()
    check(errs(x, torch.stack(x_pl))[1] <= TOL_REL, f"bt_solve b={b}")
    out["bt_solve"] = time_ms(
        lambda: btk._launch_solve(args, S, B_ZOO, b, dev), 50)
    D, L, rhs = spd_systems(B_NN, S, b, N, seed=b + 1, dev=dev)
    Df, Lf = entry_lists(D, L)
    cols = [rhs[:, :, i, :].contiguous() for i in range(b)]
    fargs, frec, rargs, xo = btk.prepare_multirhs_entries(Df, Lf, cols, b)
    btk._launch_factor(fargs, S, B_NN, b, dev)
    btk._launch_msolve(frec, rargs, xo, S, B_NN, N, b, dev)
    x_pl = btk.block_tridiag_multirhs_entries_plain(Df, Lf, cols, b)
    torch.cuda.synchronize()
    check(errs(xo, torch.stack(x_pl))[1] <= TOL_REL, f"bt_msolve b={b}")
    out["bt_factor"] = time_ms(
        lambda: btk._launch_factor(fargs, S, B_NN, b, dev), 20)
    out["bt_msolve"] = time_ms(
        lambda: btk._launch_msolve(frec, rargs, xo, S, B_NN, N, b, dev), 20)
    return out


def kernel_phase_b10(dev):
    """The b=10 instances (ExtendedLateralUnicycle's staged block) of the
    three block-tridiagonal kernels against their plain versions at the
    zoo's shapes (S=51; bt_solve at B=2048, bt_factor + bt_msolve at
    B=1024 with R=50), timed as the b=5 ones, with their launch shapes.
    Returns the kernels-line records bt_solve_b10, bt_factor_b10 and
    bt_msolve_b10."""
    import torch

    from legged_gym_dev_tpu_torch.ops import block_tridiag_kernels as btk

    S, b = N + 1, 10
    rec = {}
    shapes = {k: btk.launch_shape(k, S, b, R=N)
              for k in ("bt_solve", "bt_factor", "bt_msolve")}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for k, B in (("bt_solve", B_ZOO), ("bt_factor", B_NN),
                 ("bt_msolve", B_NN)):
        # waves of blocks at the zoo's batch over the card's resident ones
        blocks = -(-B // shapes[k]["teams"]) * (
            -(-N // shapes[k]["RC"]) if k == "bt_msolve" else 1)
        shapes[k]["waves"] = blocks / (shapes[k]["blocks_per_sm"] * sms)
    print(f"[kernels] b=10 launch shapes at S={S}, R={N} ({sms} SMs): "
          + json.dumps(shapes))
    b8 = kernels_alone_ms(8, dev)
    print(f"[kernels] b=8 alone at the same shapes: {json.dumps(b8)}")
    for k, sh in shapes.items():
        check(sh["smem_bytes"] > 0, f"b=10 {k} does not fit: {sh}")

    B = B_ZOO
    D, L, rhs = spd_systems(B, S, b, 1, seed=B + b, dev=dev)
    Df, Lf = entry_lists(D, L)
    r = [rhs[:, :, i, 0].contiguous() for i in range(b)]
    x = torch.stack(btk.block_tridiag_solve_entries(Df, Lf, r, b), -1)
    x_pl = torch.stack(btk.block_tridiag_solve_entries_plain(Df, Lf, r, b),
                       -1)
    torch.cuda.synchronize()
    ax, rel = errs(x, x_pl)
    check(rel <= TOL_REL, f"bt_solve b=10 rel err {rel}")
    ms = time_ms(lambda: btk.block_tridiag_solve_entries(Df, Lf, r, b), 20)
    args, _ = btk.prepare_solve_entries(Df, Lf, r, b)
    k_ms = time_ms(lambda: btk._launch_solve(args, S, B, b, dev), 50)
    k_dev, *k_q = device_ms(lambda: btk._launch_solve(args, S, B, b, dev))
    p_ms = time_ms(lambda: btk.block_tridiag_solve_entries_plain(
        Df, Lf, r, b), 3, warmup=1)
    K = dense_system(D, L)
    rhs_d = rhs[..., 0].reshape(B, S * b, 1)
    lib_ms = time_ms(lambda: torch.linalg.solve(K, rhs_d), 3, warmup=1)
    del K
    bms, by = bound("bt_solve", S, b, B)
    print(f"[kernels] bt_solve b=10 B={B}: max_abs_err={ax:.3e} "
          f"rel={rel:.3e}; wrapper {ms:.4f} ms, kernel alone {k_ms:.4f} ms "
          f"({k_ms / bms:.1f}x bound; device {fmt_ms(k_dev, *k_q)}), plain "
          f"{p_ms:.4f} ms, torch.linalg.solve {lib_ms:.4f} ms, bound "
          f"{bms:.4f} ms ({by})")
    rec["bt_solve_b10"] = dict(
        max_abs_err=ax, ms=ms, kernel_only_ms=k_ms, kernel_device_ms=k_dev,
        plain_ms=p_ms, bound_ms=bms, bound_by=by, library_ms=lib_ms,
        x_bound=ms / bms, kernel_only_x_bound=k_ms / bms, shape=[B, S, b],
        launch_shape=shapes["bt_solve"], b8_alone_ms=b8["bt_solve"])

    B, R = B_NN, N
    D, L, rhs = spd_systems(B, S, b, R, seed=B + R + b, dev=dev)
    Df, Lf = entry_lists(D, L)
    cols = [rhs[:, :, i, :].contiguous() for i in range(b)]
    x = torch.stack(btk.block_tridiag_multirhs_entries(Df, Lf, cols, b), 2)
    x_pl = torch.stack(
        btk.block_tridiag_multirhs_entries_plain(Df, Lf, cols, b), 2)
    fargs, frec, rargs, xo = btk.prepare_multirhs_entries(Df, Lf, cols, b)

    def factor():
        btk._launch_factor(fargs, S, B, b, dev)

    def msolve():
        btk._launch_msolve(frec, rargs, xo, S, B, R, b, dev)

    factor()
    rec_pl = btk.factor_records_plain(Df, Lf, b, B, S)
    torch.cuda.synchronize()
    f_ax, f_rel = errs(frec, rec_pl)
    ax, rel = errs(x, x_pl)
    check(f_rel <= TOL_REL, f"bt_factor b=10 rel err {f_rel}")
    check(rel <= TOL_REL, f"bt_msolve b=10 rel err {rel}")
    f_ms = time_ms(factor, 20)
    f_dev, *f_q = device_ms(factor)
    s_ms = time_ms(msolve, 20)
    s_dev, *s_q = device_ms(msolve)
    pf_ms = time_ms(lambda: btk._factor_plain(D, L), 3, warmup=1)
    chol_list = btk._factor_plain(D, L)
    ps_ms = time_ms(lambda: btk._substitute_plain(chol_list, L, rhs), 3,
                    warmup=1)
    K = dense_system(D, L)
    lf_ms = time_ms(lambda: torch.linalg.cholesky(K), 3, warmup=1)
    Kc = torch.linalg.cholesky(K)
    rhs_d = rhs.reshape(B, S * b, R)
    ls_ms = time_ms(lambda: torch.cholesky_solve(rhs_d, Kc), 3, warmup=1)
    del K, Kc
    fb, fby = bound("bt_factor", S, b, B)
    sb, sby = bound("bt_msolve", S, b, B, R)
    print(f"[kernels] b=10 multi-RHS B={B} R={R}: bt_factor "
          f"max_abs_err={f_ax:.3e} rel={f_rel:.3e}, {f_ms:.4f} ms "
          f"({f_ms / fb:.1f}x bound; device {fmt_ms(f_dev, *f_q)}), plain "
          f"{pf_ms:.4f}, torch.linalg.cholesky {lf_ms:.4f}, bound "
          f"{fb:.4f} {fby}; bt_msolve max_abs_err={ax:.3e} rel={rel:.3e}, "
          f"{s_ms:.4f} ms ({s_ms / sb:.1f}x bound; device "
          f"{fmt_ms(s_dev, *s_q)}), plain {ps_ms:.4f}, "
          f"torch.cholesky_solve {ls_ms:.4f}, bound {sb:.4f} {sby}")
    rec["bt_factor_b10"] = dict(
        max_abs_err=f_ax, ms=f_ms, kernel_device_ms=f_dev, plain_ms=pf_ms,
        bound_ms=fb, bound_by=fby, library_ms=lf_ms, x_bound=f_ms / fb,
        shape=[B, S, b], launch_shape=shapes["bt_factor"],
        b8_alone_ms=b8["bt_factor"])
    rec["bt_msolve_b10"] = dict(
        max_abs_err=ax, ms=s_ms, kernel_device_ms=s_dev, plain_ms=ps_ms,
        bound_ms=sb, bound_by=sby, library_ms=ls_ms, x_bound=s_ms / sb,
        shape=[B, S, b, R], launch_shape=shapes["bt_msolve"],
        b8_alone_ms=b8["bt_msolve"])
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES))
    ap.add_argument("--child", nargs=2, metavar=("KIND", "OUT"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        return run_child(*args.child)
    phases = [s for s in args.phases.split(",") if s]
    unknown = sorted(set(phases) - set(PHASES))
    if unknown:
        ap.error(f"unknown phases {unknown}")
    running = []     # processes started by the phases, stopped at the end
    try:
        return run_phases(phases, running)
    finally:
        kill_all(running)


def run_phases(phases, running):
    """The phases named, in the script's order; every process a phase
    starts is appended to ``running``."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2

    from legged_gym_dev_tpu_torch.ops import _build
    from legged_gym_dev_tpu_torch.ops import block_tridiag_kernels as btk
    from legged_gym_dev_tpu_torch.ops import substep_kernels as sk
    from legged_gym_dev_tpu_torch.utils.runtime import fp32_matmul

    dev = torch.device("cuda", torch.cuda.current_device())
    t0 = time.perf_counter()
    # one nvcc per source and substep instance, all started together
    jobs = [("block_tridiag.cu", ())] + [
        (sk.SOURCE, sk.kernel(nj).defines) for nj in SUBSTEP_NJ + OTHER_NJ]
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        builds = list(pool.map(lambda j: _build.build(*j), jobs))
    print(f"[build] {[str(lib) for lib, _ in builds]} in "
          f"{time.perf_counter() - t0:.1f} s")
    for _, report in builds:
        for line in report.splitlines():
            print(f"[build] {line.strip()}")
        for name, info in ptxas_summary(report).items():
            m = re.search(r"(bt_solve_kernel(?:_wide)?|bt_factor_kernel"
                          r"(?:_wide)?|bt_msolve_kernel(?:_wide)?"
                          r"|substep_kernel"
                          r"|substep_shard_kernel)ILi(\d+)E", name)
            if m:
                PTXAS[f"{m.group(1)}<{m.group(2)}>"] = info
                print(f"[ptxas] {m.group(1)}<{m.group(2)}>: "
                      + json.dumps(info))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    krec = {}
    if "kernels" in phases:
        with fp32_matmul():
            krec = kernel_phase(dev)
            krec.update(kernel_phase_b10(dev))
    if "substep" in phases:
        krec["substep"], krec["substep_nj4"], chains = substep_phase(dev)
        krec.update({f"substep_nj{nj}": r for nj, r in chains.items()})
    if "flagship" in phases:
        # the flagship pipelines run as processes of their own beside the
        # phases up to the tube phase's end (after the kernel timings)
        flagship_work = start_flagship(running)
    btk.reset_launches()
    if "l1" in phases:
        solve_mode("l1", B_L1, dev)
        check(btk.launches()["bt_solve"] > 0, "l1 path: no bt_solve launch")
    if "nn" in phases:
        before = btk.launches()
        solve_mode("NN_oneshot", B_NN, dev)
        after = btk.launches()
        for k in ("bt_solve", "bt_factor", "bt_msolve"):
            check(after[k] > before[k], f"NN path: no {k} launch")
    if "loop" in phases:
        closed_loop(dev)
    main_launches = btk.launches()
    if "rl" in phases:
        rl_state = rl_rollout(dev)          # zeroes and reads its count
        main_launches["substep"] = rl_state[-1]["substep_launches"]
        check(main_launches["substep"] > 0, "rl path: no substep launch")
    main_launches["substep_nj4"] = 0
    for phase in ("train", "train_rnn"):
        if phase in phases:
            rec, trained = train_phase(dev, phase)
            main_launches["substep_nj4"] += rec["substep_launches"]
            if phase == "train":
                hopper = trained
    tube_mlp = None
    if "tube" in phases:
        tube_launches, tube_nj4, tube_mlp = tube_phase(dev)
        for k, v in tube_launches.items():
            main_launches[k] += v
        main_launches["substep_nj4"] += tube_nj4
        print(f"[launches] tube path: {json.dumps(tube_launches)} "
              f"substep_nj4 {tube_nj4}")
    if "flagship" in phases:
        flagship = finish_flagship(running, flagship_work, dev)
        for k in ("bt_solve", "bt_factor", "bt_msolve"):
            main_launches[k] += flagship[k]
        for nj, n in flagship["substep"].items():
            name = "substep" if nj == 12 else f"substep_nj{nj}"
            main_launches[name] = main_launches.get(name, 0) + n
    if "plan" in phases:
        plan_launches, by_b = plan_phase(dev, tube_mlp)
        for k, v in plan_launches.items():
            # the b=10 instances have rows of their own in the kernels line
            main_launches[k] += v - by_b[k].get(10, 0)
            main_launches[f"{k}_b10"] = by_b[k].get(10, 0)
    # per-scenario ROMs and nets (the shared form timed in turns with
    # them), the kernel routes against the plain ones and the mesh phase:
    # processes of their own beside the robots and play phases
    children = {kind: start_child(kind, running)
                for kind in ("scenarios", "routes", "mesh", "tools")
                if kind in phases}
    t_overlap = time.perf_counter()
    if "robots" in phases:
        k3, by_nj = robots_phase(dev)
        # each K3 instance has a row: nj=12 is "substep" (the A1 and
        # Cassie records nested), nj=4 "substep_nj4"
        if "substep" not in krec:
            krec["substep"] = dict(k3["a1"])
        krec["substep"].update(a1=k3["a1"], cassie=k3["cassie"])
        for robot, nj in K3_ROBOTS.items():
            if nj != 12:
                krec[f"substep_nj{nj}"] = dict(k3[robot], robot=robot)
        for nj, n in by_nj.items():
            name = "substep" if nj == 12 else f"substep_nj{nj}"
            main_launches[name] = main_launches.get(name, 0) + n
    if "play" in phases:
        k3_play, bt_play = play_phase(dev)
        for nj, n in k3_play.items():
            name = "substep" if nj == 12 else f"substep_nj{nj}"
            main_launches[name] = main_launches.get(name, 0) + n
        for k, v in bt_play.items():
            main_launches[k] += v
    if children:
        print(f"[{', '.join(children)}] beside the robots and play phases, "
              f"which took {time.perf_counter() - t_overlap:.1f} s")
    if "scenarios" in children:
        scen = finish_child("scenarios", running, children["scenarios"])
        for k, v in scen["launches"].items():
            main_launches[k] += v
    if "routes" in children:
        finish_child("routes", running, children["routes"])
    if "mesh" in children:
        mesh = finish_child("mesh", running, children["mesh"])
        krec["substep_sharded"] = mesh["substep_sharded"]
        mesh_launches = mesh["launches"]
        for k, v in mesh_launches.items():
            main_launches[k] = main_launches.get(k, 0) + v
        check(mesh_launches["substep_sharded"] > 0
              and mesh_launches["bt_solve"] > 0,
              "mesh path: no substep_sharded or bt_solve launch")
    if "tools" in children:
        tools = finish_child("tools", running, children["tools"])
        for k, v in tools["launches"].items():
            main_launches[k] = main_launches.get(k, 0) + v
        print(f"[launches] tools path: {json.dumps(tools['launches'])}")
    if "mjcf" in phases:
        mjcf_phase()
    print(f"[launches] main path: {json.dumps(main_launches)}")
    if "ref" in phases:
        reference_check(dev)
    if "profile" in phases:
        profile_window(dev, krec)
    if "rl" in phases:
        env, model, state = rl_state[:3]
        sim = env._dr_sim(state)
        step_profile("rl", env, model, state,
                     lambda: env._contact_forces(state.robot, sim), 1)
    if "train" in phases:
        env, model, state = hopper
        # the controller's gating in each substep, and the termination
        step_profile("train", env, model, state,
                     lambda: env._sphere_forces(state.robot),
                     env.sim.decimation + 1)

    if krec:
        kernels = []
        for name in ("bt_solve", "bt_factor", "bt_msolve", "bt_solve_b10",
                     "bt_factor_b10", "bt_msolve_b10", "substep",
                     *(f"substep_nj{nj}" for nj in range(1, 25)
                       if nj != 12), "substep_sharded"):
            if name not in krec:
                continue
            r = krec[name]
            base = re.sub(r"_(nj\d+|b10)$", "", name)
            kernels.append({
                "name": name, "route": "cuda", "source": SOURCES[base],
                "replaces": REPLACES[base],
                "launches": main_launches.get(name, 0),
                "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                **{k: v for k, v in r.items()
                   if k not in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                "bound_by", "library_ms")}})
        print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
