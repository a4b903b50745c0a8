"""Helpers shared by the port's profiling and schedule tools
(``scripts/torch_profile_*.py``, ``torch_sweep_schedule.py``,
``torch_tune_loop_schedule.py``, ``torch_measure_imbalance.py``,
``torch_compile_time_quadruped.py``): the command line, the timers, the
``gap`` scenario batches and the tube net the JAX tools build.

Timing: the JAX tools force completion by moving a result to the host;
here ``torch.cuda.synchronize()`` comes before every clock reading. Each
timer makes one untimed call first, which builds the kernels and makes
each card's first launch of them; the port compiles nothing else.
"""
import argparse
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_flagship_e2e import (  # noqa: E402
    flat_trace,
    launch_counts,
    reset_launches,
    surrogate_robot,
)
from torch_train_velocity_task import env_overrides  # noqa: E402

N, H_REV = 50, 10

__all__ = ["N", "H_REV", "parse", "sync", "best_of", "mean_of",
           "gap_params", "tube_mlp", "env_overrides", "flat_trace",
           "launch_counts", "reset_launches", "surrogate_robot",
           "print_launches", "device_name"]


def parse(argv, doc, positional=()):
    """The tool's command line: the JAX file's positional arguments
    (``(name, type, default, help)`` each), ``--cpu`` (or ``E2E_CPU`` in
    the environment) and ``--reps``, a cut of every timed count. Sets
    ``args.device``: the CPU where asked for, else the card; raises
    without one, before any work."""
    from legged_gym_dev_tpu_torch.utils.runtime import resolve_device

    ap = argparse.ArgumentParser(
        description=doc, formatter_class=argparse.RawDescriptionHelpFormatter)
    for name, typ, default, text in positional:
        ap.add_argument(name, nargs="?", type=typ, default=default,
                        help=text)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (as E2E_CPU=1 does)")
    ap.add_argument("--reps", type=int, default=None,
                    help="timed reps of every timing (default: the JAX "
                         "file's counts)")
    args = ap.parse_args(argv)
    cpu = args.cpu or bool(os.environ.get("E2E_CPU"))
    args.device = resolve_device("cpu" if cpu else None)
    return args


def device_name(dev) -> str:
    """The card's name, or "cpu"."""
    return (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else dev.type)


def sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def best_of(fn, reps: int, dev):
    """One untimed call, then ``reps`` timed ones, each ended by a
    synchronize: (the least seconds, the last call's output)."""
    out = fn()
    ts = []
    for _ in range(reps):
        sync(dev)
        t0 = time.perf_counter()
        out = fn()
        sync(dev)
        ts.append(time.perf_counter() - t0)
    return min(ts), out


def mean_of(fn, reps: int, dev) -> float:
    """One untimed call, then ``reps`` calls back to back and one
    synchronize: seconds a call (the JAX tools' throughput timer)."""
    fn()
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sync(dev)
    return (time.perf_counter() - t0) / reps


def gap_params(B: int, seed: int, perturb, dev, N: int = N,
               H_rev: int = H_REV, Qw: float = 0.0, tube=None):
    """The JAX tools' ``gap`` batch of B scenarios (Q = R = 10 I, w_max 1):
    the fields ``perturb`` names moved by ``np.random.default_rng(seed)``
    draws, float32, in the order z0 and zf (U(-0.15, 0.15)), obs_c
    (U(-0.05, 0.05)), obs_r (scaled by U(0.85, 1.0)); ``tube`` the NN tube
    shared by every scenario."""
    from legged_gym_dev_tpu_torch.core import make_rom
    from legged_gym_dev_tpu_torch.solver import PROBLEM_DICT, TrajOptParams

    f32 = np.float32
    prob = PROBLEM_DICT["gap"]
    pm = make_rom("SingleInt2D", prob["dt"], [-prob["pos_max"]] * 2,
                  [prob["pos_max"]] * 2, [-prob["vel_max"]] * 2,
                  [prob["vel_max"]] * 2, device=dev)
    rng = np.random.default_rng(seed)
    z0 = np.broadcast_to(np.asarray(prob["start"], f32), (B, 2))
    zf = np.broadcast_to(np.asarray(prob["goal"], f32), (B, 2))
    obs_c = np.broadcast_to(np.asarray(prob["obs"]["c"], f32), (B, 2, 2))
    obs_r = np.broadcast_to(np.asarray(prob["obs"]["r"], f32), (B, 2))
    if "z0" in perturb:
        z0 = z0 + rng.uniform(-0.15, 0.15, (B, 2)).astype(f32)
    if "zf" in perturb:
        zf = zf + rng.uniform(-0.15, 0.15, (B, 2)).astype(f32)
    if "obs_c" in perturb:
        obs_c = obs_c + rng.uniform(-0.05, 0.05, (B, 2, 2)).astype(f32)
    if "obs_r" in perturb:
        obs_r = obs_r * rng.uniform(0.85, 1.0, (B, 2)).astype(f32)
    return TrajOptParams.create(
        pm, N, H_rev, 10 * np.eye(2), 10 * np.eye(2), z0, zf, obs_c, obs_r,
        Qw=Qw, w_max=1.0, tube_params=tube, batch=B, device=dev)


def tube_mlp(dev, seed: int = 0, N: int = N, H_rev: int = H_REV):
    """The JAX loop tools' tube net: ``MLP.create`` of (H_rev + (H_rev +
    N) * 2) -> 128 -> 128 -> N with a softplus head, drawn from a
    ``torch.Generator`` seeded ``seed`` (the JAX files' PRNGKey(0)), the
    last layer's weights x0.1 and its biases -2.5."""
    from legged_gym_dev_tpu_torch.tube.models import MLP

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    nn = MLP.create(gen, H_rev + (H_rev + N) * 2, N, num_units=128,
                    num_layers=2, final_activation="softplus")
    ws, bs = list(nn.weights), list(nn.biases)
    return nn.replace(weights=ws[:-1] + [ws[-1] * 0.1],
                      biases=bs[:-1] + [bs[-1] * 0.0 - 2.5])


def print_launches() -> dict:
    """Prints and returns each kernel's launches since
    ``reset_launches`` (read where the kernels launch)."""
    counts = launch_counts()
    print(f"launches: {json.dumps(counts)}", flush=True)
    return counts
