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
    ``(in, out)`` layout (``x @ W + b``), so no transpose is needed. A
    vmapped JAX MLP's leaves (``(B, in, out)``, ``(B, out)``, an
    ``out_scale`` of ``(B,)``) give the per-scenario form."""
    dev = resolve_device(device)

    def t(x):
        return torch.as_tensor(np.array(x, np.float32), device=dev)

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
    broadcast there) describe the same problem. A ``(B,)`` ``dt`` or
    ``(B, n)`` / ``(B, m)`` bounds make the ROM per scenario, as the
    leaves of a vmapped JAX ``TrajOptParams``, and ``tube_params`` may be
    a per-scenario ``MLP`` (``mlp_from_numpy`` of such leaves)."""
    dev = resolve_device(device)
    rom = make_rom(rom_name, dt, z_min, z_max, v_min, v_max, device=dev)
    return TrajOptParams.create(
        rom, N, H_rev, Q, R, z0, zf, obs_c, obs_r, Qw=Qw, Qf=Qf,
        w_max=w_max, e_hist=e_hist, v_prev=v_prev, z_ref=z_ref, v_ref=v_ref,
        tube_params=tube_params, batch=batch, device=dev)


def _dense_layers(body):
    """A flax MLP body's (kernel, bias) pairs in layer order."""
    names = sorted(body, key=lambda n: int(n.split("_")[-1]))
    return [(np.array(body[n]["kernel"], np.float32),
             np.array(body[n]["bias"], np.float32)) for n in names]


def state_dict_from_flax(flax_tree) -> dict:
    """A flax ``ActorCritic`` / ``ActorCriticRecurrent`` tree (parameters,
    or an Adam moment of the same structure; numpy leaves, with or without
    the outer ``"params"`` key) as the port model's ``state_dict`` entries
    (numpy). ``Dense`` kernels (in, out) become ``Linear`` weights
    (out, in). flax's ``OptimizedLSTMCell`` holds per-gate kernels
    ``ii``/``if``/``ig``/``io`` (input, no bias) and ``hi``/``hf``/``hg``/
    ``ho`` (hidden, with bias); the port's ``LSTMCell`` stacks them in gate
    order i, f, g, o: ``weight_ih`` (4H, in), ``weight_hh`` (4H, H),
    ``bias_hh`` (4H,). (``torch.nn.LSTMCell`` would need a second bias,
    ``b_ih = 0``, and returns (h, c) where flax's carry is (c, h).)"""
    p = flax_tree.get("params", flax_tree)
    out = {"log_std": np.array(p["log_std"], np.float32)}
    for net in ("actor", "critic"):
        for i, (k, b) in enumerate(_dense_layers(p[net])):
            out[f"{net}.{2 * i}.weight"] = np.ascontiguousarray(k.T)
            out[f"{net}.{2 * i}.bias"] = b
    if "lstm" in p:
        cell = p["lstm"]

        def stack(prefix):
            return np.ascontiguousarray(np.concatenate(
                [np.array(cell[prefix + g]["kernel"], np.float32)
                 for g in "ifgo"], axis=1).T)

        out["lstm.weight_ih"] = stack("i")
        out["lstm.weight_hh"] = stack("h")
        out["lstm.bias_hh"] = np.concatenate(
            [np.array(cell["h" + g]["bias"], np.float32) for g in "ifgo"])
    return out


def actor_critic_from_numpy(flax_params, device=None):
    """The JAX package's ``ActorCritic`` or ``ActorCriticRecurrent``
    parameters (the flax tree as numpy arrays) as the port's model of the
    same dims (``state_dict_from_flax``)."""
    from .rl.networks import ActorCritic, ActorCriticRecurrent

    dev = resolve_device(device)
    p = flax_params.get("params", flax_params)
    actor, critic = _dense_layers(p["actor"]), _dense_layers(p["critic"])
    dims = dict(actor_hidden_dims=[k.shape[1] for k, _ in actor[:-1]],
                critic_hidden_dims=[k.shape[1] for k, _ in critic[:-1]])
    if "lstm" in p:
        hidden = np.shape(p["lstm"]["hi"]["kernel"])[0]
        model = ActorCriticRecurrent(
            np.shape(p["lstm"]["ii"]["kernel"])[0], actor[-1][0].shape[1],
            rnn_hidden_size=hidden, **dims)
    else:
        model = ActorCritic(actor[0][0].shape[0], actor[-1][0].shape[1],
                            **dims)
    model.load_state_dict({k: torch.as_tensor(v) for k, v in
                           state_dict_from_flax(p).items()})
    return model.to(dev)



def train_state_from_numpy(flax_params, mu, nu, count, lr, generator=None,
                           device=None):
    """The JAX package's ``TrainState`` parts (flax parameters, the Adam
    moments ``mu`` / ``nu`` of optax's state, its step ``count`` and the
    learning rate, all numpy) as ``(model, TrainState)`` of the port. The
    JAX key has no counterpart: the state draws from ``generator`` (a new
    one seeded 0 on the device by default)."""
    from .rl.ppo import AdamState, TrainState

    dev = resolve_device(device)
    model = actor_critic_from_numpy(flax_params, dev)
    if generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(0)
    names = [n for n, _ in model.named_parameters()]
    moments = [state_dict_from_flax(m) for m in (mu, nu)]
    mu_t, nu_t = ([torch.as_tensor(m[n], device=dev) for n in names]
                  for m in moments)
    return model, TrainState(
        params=list(model.parameters()),
        opt_state=AdamState(count=torch.tensor(int(count), dtype=torch.int32,
                                                device=dev),
                            mu=mu_t, nu=nu_t),
        lr=torch.tensor(float(np.float32(lr)), device=dev),
        gen=generator)


def env_state_from_numpy(jax_state, env, generator=None):
    """A JAX ``TrajectoryEnvState`` whose leaves are numpy arrays (for
    example ``jax.tree.map(np.asarray, state)``) as the port's
    ``TrajectoryEnvState`` on ``env``'s device, so both packages step from
    the same state. The JAX PRNG keys have no counterpart: the port's state
    draws from ``generator`` (a new one seeded 0 by default)."""
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
        "friction", "base_mass", "contact_mult", "sea_hidden", "sea_cell",
        "terrain_levels", "env_origin", "trajectory", "prev_error",
        "time_until_next_push")}
    return TrajectoryEnvState(
        gen=generator, robot=robot,
        episode_sums={k: t(v) for k, v in jax_state.episode_sums.items()},
        traj_gen=traj_gen_state_from_numpy(jax_state.traj_gen, generator),
        **fields)


def velocity_env_state_from_numpy(jax_state, env, generator=None):
    """A JAX ``VelocityEnvState`` with numpy leaves as the port's on
    ``env``'s device, drawing from ``generator`` (a new one seeded 0 by
    default); the JAX key has no counterpart."""
    from .envs.legged_robot_velocity import VelocityEnvState
    from .sim.dynamics import RobotState

    dev = env.device
    if generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(0)

    def t(x):
        return torch.as_tensor(np.array(x), device=dev)

    r = jax_state.robot
    return VelocityEnvState(
        gen=generator,
        robot=RobotState(*(t(getattr(r, k)) for k in
                           ("base_pos", "base_quat", "q", "v"))),
        episode_sums={k: t(v) for k, v in jax_state.episode_sums.items()},
        **{f: t(getattr(jax_state, f)) for f in (
            "commands", "actions", "last_actions", "last_dof_vel",
            "torques", "feet_air_time", "last_contacts", "episode_step",
            "command_ranges", "sea_hidden", "sea_cell", "terrain_levels",
            "env_origin", "friction", "base_mass", "contact_mult")})


def terrain_from_numpy(jax_terrain):
    """A JAX ``Terrain`` (its config, ``height_field_raw`` and
    ``env_origins``) as the port's, without generating anything."""
    import dataclasses

    from .utils.terrain import Terrain, TerrainCfg

    cfg = TerrainCfg(**dataclasses.asdict(jax_terrain.cfg))
    return Terrain.from_arrays(cfg, np.asarray(jax_terrain.height_field_raw),
                               np.asarray(jax_terrain.env_origins))


def actuator_net_from_numpy(jax_net, device=None):
    """A JAX ``ActuatorNetLSTM``'s weights (numpy or JAX arrays) as the
    port's ``ActuatorNetLSTM`` on ``device`` (``None``: the card)."""
    from .sim.actuator_net import ActuatorNetLSTM

    dev = resolve_device(device)

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    return ActuatorNetLSTM(
        **{f: tuple(t(w) for w in getattr(jax_net, f))
           for f in ("w_ih", "w_hh", "b_ih", "b_hh")},
        **{f: t(getattr(jax_net, f))
           for f in ("out_w", "out_b", "out_scale", "in_scale")})


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
                  "stationary", "center")})


def hopper_env_state_from_numpy(jax_state, env, generator=None):
    """A JAX ``HopperEnvState`` or ``HopperVelEnvState`` with numpy leaves
    as the port's state of the same task on ``env``'s device (``common_step``
    and ``curriculum_stage`` as ints), drawing from ``generator`` (a new one
    seeded 0 by default); the JAX key is dropped."""
    from .envs.hopper_trajectory import HopperDR, HopperEnvState
    from .envs.hopper_velocity import HopperVelEnvState
    from .sim.dynamics import RobotState

    dev = env.device
    if generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(0)

    def t(x):
        return torch.as_tensor(np.array(x), device=dev)

    r, d = jax_state.robot, jax_state.dr
    common = dict(
        gen=generator,
        robot=RobotState(*(t(getattr(r, k)) for k in
                           ("base_pos", "base_quat", "q", "v"))),
        episode_sums={k: t(v) for k, v in jax_state.episode_sums.items()},
        dr=HopperDR(**{f: t(getattr(d, f)) for f in (
            "spring_k", "spring_d", "spring_set", "p_gain", "d_gain",
            "torque", "speed", "ts_slope", "base_mass")}),
        common_step=int(jax_state.common_step),
        **{f: t(getattr(jax_state, f)) for f in (
            "actions", "last_actions", "last_dof_vel", "torques",
            "time_until_next_push", "episode_step")})
    if hasattr(jax_state, "commands"):
        return HopperVelEnvState(commands=t(jax_state.commands), **common)
    return HopperEnvState(
        traj_gen=traj_gen_state_from_numpy(jax_state.traj_gen, generator),
        curriculum_stage=int(jax_state.curriculum_stage),
        trajectory=t(jax_state.trajectory),
        prev_error=t(jax_state.prev_error), **common)


def rom_sim_state_from_numpy(jax_state, sim, generator=None):
    """A JAX ``RomSimState`` with numpy leaves as the port's, on ``sim``'s
    device, drawing from ``generator`` (a new one seeded 0 on the device by
    default); the JAX key is dropped."""
    from .sim.rom_sim import RomSimState

    dev = sim.device
    if generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(0)
    return RomSimState(
        gen=generator,
        root_states=torch.as_tensor(np.array(jax_state.root_states),
                                    device=dev),
        traj_gen=traj_gen_state_from_numpy(jax_state.traj_gen, generator),
        trajectory=torch.as_tensor(np.array(jax_state.trajectory),
                                   device=dev))


def rom_tracking_env_state_from_numpy(jax_state, env, generator=None):
    """A JAX ``RomTrackingEnvState`` with numpy leaves as the port's on
    ``env``'s device (its sim state by ``rom_sim_state_from_numpy``), both
    drawing from ``generator``; the JAX keys are dropped."""
    from .envs.rom_tracking import RomTrackingEnvState

    sim = rom_sim_state_from_numpy(jax_state.sim, env.sim, generator)

    def t(x):
        return torch.as_tensor(np.array(x), device=env.device)

    return RomTrackingEnvState(
        gen=sim.gen, sim=sim, prev_action=t(jax_state.prev_action),
        prev_error=t(jax_state.prev_error),
        episode_step=t(jax_state.episode_step),
        episode_sums={k: t(v) for k, v in jax_state.episode_sums.items()})


def tube_mlp_from_numpy(jax_mlp, device=None) -> MLP:
    """The JAX package's tube ``MLP`` with numpy leaves (as its
    ``train-tube --out`` pickles it, after ``jax.tree.map(np.asarray,
    ...)``) as the port's ``MLP``: weights, biases, both activations and
    ``out_scale``; a vmapped MLP's leaves give the per-scenario form."""
    out_scale = getattr(jax_mlp, "out_scale", None)
    return mlp_from_numpy(
        list(jax_mlp.weights), list(jax_mlp.biases),
        activation=jax_mlp.activation,
        final_activation=jax_mlp.final_activation,
        out_scale=None if out_scale is None else np.asarray(out_scale),
        device=device)


def mpc_trace_from_numpy(jax_trace, device=None):
    """A JAX ``MPCTrace`` with numpy leaves (one scenario, or vmapped over
    a batch) as the port's batch-leading ``solver.mpc.MPCTrace`` on
    ``device``: a single scenario's trace gains a batch axis of 1."""
    from .solver.mpc import MPCTrace

    dev = resolve_device(device)
    single = np.ndim(jax_trace.z) == 2
    return MPCTrace(**{
        f: torch.as_tensor(np.array(getattr(jax_trace, f))[None] if single
                           else np.array(getattr(jax_trace, f)), device=dev)
        for f in MPCTrace._fields})
