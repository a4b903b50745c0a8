"""Carry parameters and problem data from the JAX package's form (given as
numpy arrays) into the port's, so both packages compute the same problem.
Numpy only: nothing here imports JAX.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .core.rom import make_rom
from .solver.trajopt import TrajOptParams
from .tube.models import MLP
from .utils.runtime import resolve_device


def mlp_from_numpy(weights: Sequence[np.ndarray],
                   biases: Sequence[np.ndarray],
                   activation: str = "softplus_b5",
                   final_activation: str = "none",
                   out_scale: Optional[float] = None,
                   device=None) -> MLP:
    """The JAX ``MLP`` (``weights`` as ``(in, out)`` arrays, ``biases`` as
    ``(out,)``) as the port's ``MLP``, which stores W in the same
    ``(in, out)`` layout (``x @ W + b``), so no transpose is needed."""
    dev = resolve_device(device)

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    return MLP([t(w) for w in weights], [t(b) for b in biases],
               activation=activation, final_activation=final_activation,
               out_scale=None if out_scale is None else t(out_scale))


def trajopt_params_from_numpy(rom_name: str, dt, z_min, z_max, v_min, v_max,
                              N: int, H_rev: int, Q, R, z0, zf, obs_c, obs_r,
                              Qw=0.0, Qf=None, w_max=1.0, e_hist=None,
                              v_prev=None, z_ref=None, v_ref=None,
                              tube_params=None, batch=None,
                              device=None) -> TrajOptParams:
    """Batch-leading ``TrajOptParams`` with its ROM (``make_rom(rom_name,
    ...)``). Per-scenario inputs may be given once for the batch or with a
    leading batch axis (see ``TrajOptParams.create``); the same numpy
    arrays given to the JAX package's ``TrajOptParams.create`` (and
    broadcast there) describe the same problem."""
    dev = resolve_device(device)
    rom = make_rom(rom_name, dt, z_min, z_max, v_min, v_max, device=dev)
    return TrajOptParams.create(
        rom, N, H_rev, Q, R, z0, zf, obs_c, obs_r, Qw=Qw, Qf=Qf,
        w_max=w_max, e_hist=e_hist, v_prev=v_prev, z_ref=z_ref, v_ref=v_ref,
        tube_params=tube_params, batch=batch, device=dev)


def actor_critic_from_numpy(flax_params, device=None):
    """The JAX package's ``ActorCritic`` parameters (the flax tree as
    numpy arrays, with or without the outer ``"params"`` key) as the
    port's ``ActorCritic``. flax ``Dense`` kernels are ``(in, out)``;
    ``torch.nn.Linear`` weights are their transpose."""
    from .rl.networks import ActorCritic

    dev = resolve_device(device)
    p = flax_params.get("params", flax_params)

    def dense(body):
        names = sorted(body, key=lambda n: int(n.split("_")[-1]))
        return [(np.array(body[n]["kernel"], np.float32),
                 np.array(body[n]["bias"], np.float32)) for n in names]

    actor, critic = dense(p["actor"]), dense(p["critic"])
    model = ActorCritic(actor[0][0].shape[0], actor[-1][0].shape[1],
                        [k.shape[1] for k, _ in actor[:-1]],
                        [k.shape[1] for k, _ in critic[:-1]])
    with torch.no_grad():
        for seq, layers in ((model.actor, actor), (model.critic, critic)):
            linears = [m for m in seq if isinstance(m, torch.nn.Linear)]
            for lin, (k, b) in zip(linears, layers):
                lin.weight.copy_(torch.as_tensor(k.T.copy()))
                lin.bias.copy_(torch.as_tensor(b))
        model.log_std.copy_(torch.as_tensor(
            np.array(p["log_std"], np.float32)))
    return model.to(dev)


def env_state_from_numpy(jax_state, env, generator=None):
    """A JAX ``TrajectoryEnvState`` whose leaves are numpy arrays (for
    example ``jax.tree.map(np.asarray, state)``) as the port's
    ``TrajectoryEnvState`` on ``env``'s device, so both packages step from
    the same state. The JAX PRNG keys have no counterpart: the port's state
    draws from ``generator`` (a new one seeded 0 by default), and the JAX
    actuator-net, terrain and scripted-generator fields, which the port
    does not have, are dropped."""
    from .envs.legged_robot_trajectory import TrajectoryEnvState
    from .sim.dynamics import RobotState

    dev = env.device
    if generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(0)

    def t(x):
        return torch.as_tensor(np.array(x), device=dev)

    r = jax_state.robot
    robot = RobotState(*(t(getattr(r, k)) for k in
                         ("base_pos", "base_quat", "q", "v")))
    fields = {f: t(getattr(jax_state, f)) for f in (
        "commands", "actions", "last_actions", "last_dof_vel", "torques",
        "feet_air_time", "last_contacts", "episode_step", "command_ranges",
        "friction", "base_mass", "contact_mult", "trajectory",
        "prev_error", "time_until_next_push")}
    return TrajectoryEnvState(
        gen=generator, robot=robot,
        episode_sums={k: t(v) for k, v in jax_state.episode_sums.items()},
        traj_gen=traj_gen_state_from_numpy(jax_state.traj_gen, generator),
        **fields)


def traj_gen_state_from_numpy(jax_tg, generator):
    """A JAX ``TrajGenState`` with numpy leaves as the port's, on the
    generator's device, drawing from ``generator`` (the JAX key is
    dropped)."""
    from .trajgen.generator import TrajGenState

    dev = generator.device
    return TrajGenState(gen=generator, **{
        f: torch.as_tensor(np.array(getattr(jax_tg, f)), device=dev)
        for f in ("t", "k", "t_final", "weights", "sample_hold_input",
                  "extreme_input", "ramp_t_start", "ramp_v_start",
                  "ramp_v_end", "sin_mag", "sin_freq", "sin_off",
                  "sin_mean", "trajectory", "v_trajectory", "v",
                  "stationary")})
