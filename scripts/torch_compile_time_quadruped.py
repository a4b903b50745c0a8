"""Cold-start time of the quadruped (nj=12) programs, on the PyTorch/CUDA
port.

The counterpart of ``scripts/compile_time_quadruped.py`` on
``legged_gym_dev_tpu_torch``. The JAX file times a program's trace and its
XLA compile with the persistent cache pointed at a throwaway directory.
The port traces and compiles nothing: its cold start is the ``nvcc``
build of the CUDA kernel ``substep`` at the robot's joint count, then the
first call (Python runs through the program once, the library loads, the
first launches). This points the kernels' build directory
(``ops/_build.BUILD_DIR``) at a throwaway directory for the build and the
first call, so every run builds cold, and times the two apart.

Knobs (environment, the JAX file's):
  TARGET  = substep | envstep | ppo   (default substep; ppo is one learn
            iteration with a 512-256-128 actor and critic)
  BARRIER = auto                      (the JAX file's XLA fusion barriers
            have no counterpart in the port; any other value raises)
  B       = batch size                (default 4096)
and ``OVERRIDES``, JSON keywords for ``anymal_c_trajectory``'s env factory
(the reference's ANYmal-C URDF lies outside this repository;
``urdf_path`` names another).

Run on the card:  OVERRIDES='{"urdf_path": "anymal_c.urdf"}' TARGET=ppo \\
                  python scripts/torch_compile_time_quadruped.py
On the CPU:       ... --cpu  (or E2E_CPU=1; nothing is built there)
``main`` prints the JAX file's lines (``trace`` is the first call) and
returns their numbers as a dict.
"""
import contextlib
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_tool_common import (  # noqa: E402
    env_overrides,
    parse,
    print_launches,
    reset_launches,
    sync,
)

TARGETS = ("substep", "envstep", "ppo")


@contextlib.contextmanager
def throwaway_build_dir():
    """``ops/_build.BUILD_DIR`` pointed at a new temporary directory inside
    the block, restored and the directory removed after."""
    from legged_gym_dev_tpu_torch.ops import _build

    prev = _build.BUILD_DIR
    tmp = tempfile.mkdtemp(prefix="torch_kernels_cold_")
    _build.BUILD_DIR = Path(tmp)
    try:
        yield
    finally:
        _build.BUILD_DIR = prev
        shutil.rmtree(tmp, ignore_errors=True)


def program(target, env, state, dev):
    """The timed program: a function of no arguments."""
    B, nj = env.num_envs, env.sim.model.nj
    if target == "substep":
        tau = torch.zeros(B, nj, device=dev)
        return lambda: env.sim.substep(state.robot, tau)
    if target == "envstep":
        act = torch.zeros(B, env.num_actions, device=dev)
        return lambda: env.step(state, act)
    from legged_gym_dev_tpu_torch.rl import ActorCritic, PPOConfig
    from legged_gym_dev_tpu_torch.rl.ppo import (
        init_train_state,
        make_learn_iteration,
    )

    # the weights drawn on the CPU, as the runner draws them
    ac = ActorCritic(env.num_obs, env.num_actions,
                     actor_hidden_dims=(512, 256, 128),
                     critic_hidden_dims=(512, 256, 128),
                     generator=torch.Generator().manual_seed(0)).to(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    cfg = PPOConfig()
    ts = init_train_state(ac, cfg, gen)
    learn = make_learn_iteration(env, ac, cfg)
    return lambda: learn(ts, state)


def leaves(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        return [t for v in x.values() for t in leaves(v)]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in leaves(v)]
    if hasattr(x, "__dataclass_fields__"):
        return [t for k in x.__dataclass_fields__
                for t in leaves(getattr(x, k))]
    return []


def compile_time(target: str = "substep", barrier: str = "auto",
                 B: int = 4096, overrides=None, device=None) -> dict:
    """The cold build and the first call of ``target`` at batch B."""
    from legged_gym_dev_tpu_torch.envs import task_registry
    from legged_gym_dev_tpu_torch.ops import substep_kernels as sk
    from legged_gym_dev_tpu_torch.utils.runtime import resolve_device

    if barrier != "auto":
        raise ValueError(
            f"BARRIER={barrier!r}: the JAX package's XLA fusion barriers "
            "(sim/kinematics._barrier_lists) have no counterpart in the "
            "port; only 'auto' runs")
    if target not in TARGETS:
        raise ValueError(f"TARGET={target!r} is not one of {TARGETS}")
    dev = resolve_device(device)
    env = task_registry.make_env("anymal_c_trajectory", num_envs=B,
                                 device=dev, **(overrides or {}))
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    state, _ = env.reset(gen)
    fn = program(target, env, state, dev)
    reset_launches()
    with throwaway_build_dir():
        t0 = time.perf_counter()
        if dev.type == "cuda":
            sk.build([env.sim.model.nj])
        t_build = time.perf_counter() - t0
        sync(dev)
        t0 = time.perf_counter()
        out = fn()
        sync(dev)
        t_first = time.perf_counter() - t0
    print(f"target={target} barrier={barrier} B={B}: trace={t_first:.1f}s "
          f"build={t_build:.1f}s", flush=True)
    finite = all(bool(torch.isfinite(t).all()) for t in leaves(out)
                 if t.is_floating_point())
    if not finite:
        raise RuntimeError(f"{target}: the first call gave non-finite "
                           "values")
    print("runs ok", flush=True)
    return dict(target=target, barrier=barrier, batch=B,
                first_call_s=t_first, build_s=t_build,
                decimation=env.sim.decimation)


def main(argv=None):
    args = parse(argv, __doc__)
    out = compile_time(
        target=os.environ.get("TARGET", "substep"),
        barrier=os.environ.get("BARRIER", "auto"),
        B=int(os.environ.get("B", "4096")), overrides=env_overrides(),
        device=args.device)
    out["launches"] = print_launches()
    return out


if __name__ == "__main__":
    main()
