"""Velocity-command locomotion environment (generic legged robot).

Counterpart of ``legged_gym_dev_tpu/envs/legged_robot_velocity.py``: PD
joint control (or the LSTM actuator net, its hidden and cell state carried
per env and zeroed on reset) with decimation, velocity/heading command
resampling, domain randomization (friction buckets, base payload mass,
contact stiffness/damping multipliers), pushes and the reward-term table;
on a heightfield, the perceptive height scan (a yaw-rotated grid of
points, 17 x 11 = 187 on the quadrupeds), per-env spawn origins (the
terrain cell's origin +-1 m) and the terrain-level curriculum in the
reset. Contact spheres are sorted into feet / penalized / termination sets
by link-name substrings.

State updates are functional (a new state per step), and randomness comes
from the ``torch.Generator`` the state carries.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from ..core.maths import masked_update as _mwhere
from ..core.maths import quat_apply, quat_to_rotmat, wrap_to_pi
from ..sim.actuator_net import ActuatorNetLSTM
from ..sim.contact import contact_forces
from ..sim.dynamics import RobotState
from ..sim.kinematics import contact_kinematics
from ..sim.robot_sim import RobotSim
from ..utils.terrain import height_scan
from .base import (
    Transition,
    guard_finite_state,
    shard_env,
    shard_env_state,
)


def classify_contacts(model, foot_name: str, penalize_on, terminate_on):
    """Sphere index sets from link-name substrings."""
    feet, pen, term = [], [], []
    for i, name in enumerate(model.contact_link_names):
        if foot_name and foot_name in name:
            feet.append(i)
        if any(s in name for s in penalize_on):
            pen.append(i)
        if any(s in name for s in terminate_on):
            term.append(i)
    return tuple(feet), tuple(pen), tuple(term)


def _uniform(gen, shape, lo, hi, device):
    """U(lo, hi) as jax.random.uniform draws it: lo + u * (hi - lo)."""
    u = torch.rand(shape, generator=gen, device=device)
    return lo + u * (hi - lo)


@dataclasses.dataclass
class VelocityEnvState:
    gen: torch.Generator
    robot: RobotState
    commands: torch.Tensor       # (B, 4): vx, vy, wyaw, heading
    actions: torch.Tensor        # (B, nj)
    last_actions: torch.Tensor
    last_dof_vel: torch.Tensor
    torques: torch.Tensor
    feet_air_time: torch.Tensor  # (B, n_feet)
    last_contacts: torch.Tensor  # (B, n_feet) bool
    episode_step: torch.Tensor   # (B,) int32
    episode_sums: Dict[str, torch.Tensor]
    command_ranges: torch.Tensor  # (4, 2)
    sea_hidden: torch.Tensor     # (2, B * nj or 0, 8) actuator-net LSTM state
    sea_cell: torch.Tensor
    terrain_levels: torch.Tensor  # (B,) int32 terrain-curriculum rows
    env_origin: torch.Tensor     # (B, 3) current spawn origins
    friction: torch.Tensor       # (B,) per-env Coulomb mu
    base_mass: torch.Tensor      # (B,) payload mass added to the base
    contact_mult: torch.Tensor   # (B, 2) contact stiffness/damping factors

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass
class LeggedRobotVelocityEnv:
    sim: RobotSim
    default_dof_pos: torch.Tensor   # (nj,)
    p_gains: torch.Tensor           # (nj,)
    d_gains: torch.Tensor           # (nj,)
    base_init_pos: torch.Tensor     # (3,)
    noise_vec: torch.Tensor         # (num_obs,)
    init_command_ranges: torch.Tensor  # (4, 2)
    tracking_sigma: float
    base_height_target: float
    max_contact_force: float
    soft_dof_vel_limit: float
    soft_torque_limit: float
    # per-env spawn origins (B, 3) (terrain cells; None: one shared origin)
    env_origins: Optional[torch.Tensor] = None
    # terrain-level curriculum: origins table [level (row), type (col)]
    # and each env's fixed column
    terrain_origins: Optional[torch.Tensor] = None   # (rows, cols, 3)
    terrain_types: Optional[torch.Tensor] = None     # (B,) int32
    actuator_net: Optional[ActuatorNetLSTM] = None
    # perceptive height scan: clip(base_z - 0.5 - h, -1, 1) * 5 at a
    # yaw-rotated grid of points (None: blind)
    measured_points_x: Optional[tuple] = None
    measured_points_y: Optional[tuple] = None
    action_scale: float = 0.25
    control_type: str = "P"
    heading_command: bool = True
    resampling_time_s: float = 10.0
    episode_length_s: float = 20.0
    push_interval_s: float = 15.0
    max_push_vel: float = 1.0
    terrain_curriculum: bool = False
    add_noise: bool = True
    randomize_friction: bool = True
    friction_range: tuple = (0.5, 1.25)
    num_friction_buckets: int = 64
    randomize_base_mass: bool = False
    added_mass_range: tuple = (-1.0, 1.0)
    randomize_contact: bool = False
    contact_mult_range: tuple = (0.7, 1.3)
    command_curriculum: bool = False
    only_positive_rewards: bool = True
    reward_scales: tuple = ()
    feet_spheres: tuple = ()
    penalized_spheres: tuple = ()
    termination_spheres: tuple = ()
    num_envs: int = 4096

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)

    # ------------------------------------------------------------------
    @property
    def device(self) -> torch.device:
        return self.default_dof_pos.device

    @property
    def nj(self) -> int:
        return self.sim.model.nj

    @property
    def num_actions(self) -> int:
        return self.nj

    @property
    def num_height_points(self) -> int:
        if self.measured_points_x is None:
            return 0
        return len(self.measured_points_x) * len(self.measured_points_y)

    @property
    def num_obs(self) -> int:
        return 3 + 3 + 3 + 3 + 3 * self.nj + self.num_height_points

    @property
    def dt(self) -> float:
        return self.sim.dt * self.sim.decimation

    @property
    def max_episode_length(self) -> int:
        return int(round(self.episode_length_s / self.dt))

    def _limit(self, name):
        return self.sim.model.tensor(name, self.device)

    # ---- control --------------------------------------------------------
    def _compute_torques(self, state, robot: RobotState) -> torch.Tensor:
        a_scaled = state.actions * self.action_scale
        q, qd = robot.q, robot.v[:, 6:]
        if self.control_type == "P":
            tau = (self.p_gains * (a_scaled + self.default_dof_pos - q)
                   - self.d_gains * qd)
        elif self.control_type == "V":
            tau = (self.p_gains * (a_scaled - qd)
                   - self.d_gains * (qd - state.last_dof_vel) / self.sim.dt)
        else:  # "T"
            tau = a_scaled
        eff = self._limit("effort_limit")
        return torch.clamp(tau, -eff, eff)

    def _contact_forces(self, robot: RobotState,
                        sim: Optional[RobotSim] = None) -> torch.Tensor:
        sim = sim if sim is not None else self.sim
        pos, vel, _ = contact_kinematics(sim.model, robot)
        return contact_forces(sim.contact, pos, vel,
                              sim.model.tensor("contact_radius", self.device),
                              sim.terrain_fn)

    # ---- observations ---------------------------------------------------
    def _height_obs(self, robot: RobotState) -> torch.Tensor:
        """The perceptive observation block."""
        h = height_scan(self.sim.terrain_fn, robot.base_pos, robot.base_quat,
                        self.measured_points_x, self.measured_points_y)
        return torch.clamp(robot.base_pos[:, 2:3] - 0.5 - h, -1.0, 1.0) * 5.0

    def _with_heights(self, parts, robot: RobotState) -> torch.Tensor:
        if self.num_height_points:
            parts.append(self._height_obs(robot))
        return torch.cat(parts, dim=-1)

    def _noisy(self, state, obs):
        if self.add_noise:
            u = torch.rand(obs.shape, generator=state.gen, device=obs.device)
            obs = obs + (2.0 * u - 1.0) * self.noise_vec[None, :]
        return torch.clamp(obs, -100.0, 100.0)

    def _obs(self, state) -> torch.Tensor:
        robot = state.robot
        R = quat_to_rotmat(robot.base_quat)
        lin_vel_body = torch.einsum("bji,bj->bi", R, robot.v[:, :3])
        gravity_body = R[:, 2, :] * -1.0
        cmd_scale = torch.tensor([2.0, 2.0, 0.25], device=self.device)
        obs = self._with_heights([
            lin_vel_body * 2.0,
            robot.v[:, 3:6] * 0.25,
            gravity_body,
            state.commands[:, :3] * cmd_scale,
            (robot.q - self.default_dof_pos) * 1.0,
            robot.v[:, 6:] * 0.05,
            state.actions,
        ], robot)
        return self._noisy(state, obs)

    # ---- commands -------------------------------------------------------
    def _resample_commands(self, state, mask, gen):
        B, dev = self.num_envs, self.device
        cr = state.command_ranges
        new = torch.stack([_uniform(gen, (B,), cr[i, 0], cr[i, 1], dev)
                           for i in range(4)], dim=-1)
        small = torch.linalg.vector_norm(new[:, :2], dim=-1) < 0.2
        new = torch.cat([new[:, :2] * torch.where(small, 0.0, 1.0)[:, None],
                         new[:, 2:]], dim=-1)
        return _mwhere(mask, new, state.commands)

    def _heading_to_yaw_cmd(self, commands, robot: RobotState):
        fwd = quat_apply(robot.base_quat, torch.tensor(
            [1.0, 0.0, 0.0], device=self.device).expand(self.num_envs, 3))
        heading = torch.atan2(fwd[:, 1], fwd[:, 0])
        yaw_cmd = torch.clamp(0.5 * wrap_to_pi(commands[:, 3] - heading),
                              -1.0, 1.0)
        commands = commands.clone()
        commands[:, 2] = yaw_cmd
        return commands

    # ---- resets ---------------------------------------------------------
    def _initial_state(self, gen: torch.Generator, **extra):
        B, nj, dev = self.num_envs, self.nj, self.device

        def z(*shape):
            return torch.zeros(shape, device=dev)

        n_feet = len(self.feet_spheres)
        n_sea = B * nj if self.actuator_net is not None else 0
        return dict(
            gen=gen,
            robot=self.sim.default_state(B, base_pos=tuple(
                self.base_init_pos.tolist()), q=self.default_dof_pos),
            commands=z(B, 4), actions=z(B, nj), last_actions=z(B, nj),
            last_dof_vel=z(B, nj), torques=z(B, nj),
            feet_air_time=z(B, n_feet),
            last_contacts=torch.zeros((B, n_feet), dtype=torch.bool,
                                      device=dev),
            episode_step=torch.zeros(B, dtype=torch.int32, device=dev),
            episode_sums={n: z(B) for n, _ in self.reward_scales},
            command_ranges=self.init_command_ranges,
            sea_hidden=z(2, n_sea, 8), sea_cell=z(2, n_sea, 8),
            terrain_levels=torch.zeros(B, dtype=torch.int32, device=dev),
            env_origin=(self.env_origins if self.env_origins is not None
                        else z(B, 3)),
            friction=self.sim.contact.friction.expand(B).clone(),
            base_mass=z(B),
            contact_mult=torch.ones((B, 2), device=dev),
            **extra)

    def reset(self, gen: torch.Generator):
        state = VelocityEnvState(**self._initial_state(gen))
        B = self.num_envs
        state = self._do_reset(state, torch.ones(B, dtype=torch.bool,
                                                 device=self.device))
        return state, self._obs(state)

    # ---- domain randomization --------------------------------------------
    def _resample_dr(self, state, mask, gen):
        B, dev = self.num_envs, self.device
        friction, base_mass = state.friction, state.base_mass
        if self.randomize_friction:
            vals = _uniform(gen, (self.num_friction_buckets,),
                            self.friction_range[0], self.friction_range[1],
                            dev)
            ids = torch.randint(0, self.num_friction_buckets, (B,),
                                generator=gen, device=dev)
            friction = torch.where(mask, vals[ids], friction)
        if self.randomize_base_mass:
            dm = _uniform(gen, (B,), self.added_mass_range[0],
                          self.added_mass_range[1], dev)
            base_mass = torch.where(mask, dm, base_mass)
        contact_mult = state.contact_mult
        if self.randomize_contact:
            cm = _uniform(gen, (B, 2), self.contact_mult_range[0],
                          self.contact_mult_range[1], dev)
            contact_mult = _mwhere(mask, cm, contact_mult)
        return state.replace(friction=friction, base_mass=base_mass,
                             contact_mult=contact_mult)

    def _dr_sim(self, state) -> RobotSim:
        """Sim with this step's per-env DR applied (friction (B, 1, 1),
        payload mass (B,), stiffness/damping (B, 1))."""
        sim = self.sim
        if self.randomize_friction:
            sim = sim.replace(contact=sim.contact.replace(
                friction=state.friction[:, None, None]))
        if self.randomize_base_mass:
            sim = sim.replace(base_mass_delta=state.base_mass)
        if self.randomize_contact:
            sim = sim.replace(contact=sim.contact.replace(
                stiffness=sim.contact.stiffness * state.contact_mult[:, 0:1],
                damping=sim.contact.damping * state.contact_mult[:, 1:2]))
        return sim

    def _do_reset(self, state, mask):
        B, nj, dev = self.num_envs, self.nj, self.device
        gen = state.gen
        robot = state.robot
        # DOFs at 0.5-1.5x default, zero velocity
        q = self.default_dof_pos * _uniform(gen, (B, nj), 0.5, 1.5, dev)
        q = torch.clamp(q, self._limit("q_lower"), self._limit("q_upper"))
        # root at the init position, random velocity in [-0.5, 0.5]
        v = torch.cat([_uniform(gen, (B, 6), -0.5, 0.5, dev),
                       torch.zeros((B, nj), device=dev)], dim=-1)
        base_pos = self.base_init_pos.expand(B, 3)
        levels, origin = state.terrain_levels, state.env_origin
        if self.terrain_curriculum and self.terrain_origins is not None:
            # walked far enough: a harder row; under half the commanded
            # distance: an easier one; past the top: a random row. Only
            # envs that ran an episode are scored.
            max_level = self.terrain_origins.shape[0]
            dist = torch.linalg.vector_norm(
                state.robot.base_pos[:, :2] - origin[:, :2], dim=-1)
            cmd_dist = (torch.linalg.vector_norm(state.commands[:, :2],
                                                 dim=-1)
                        * self.episode_length_s)
            ran = state.episode_step > 0
            move_up = (dist > 4.0) & ran
            move_down = (dist < cmd_dist * 0.5) & ~move_up & ran
            new_levels = (levels + move_up.to(torch.int32)
                          - move_down.to(torch.int32))
            rand_lvl = torch.randint(0, max_level, (B,), generator=gen,
                                     device=dev, dtype=torch.int32)
            new_levels = torch.where(new_levels >= max_level, rand_lvl,
                                     torch.clamp(new_levels, min=0))
            levels = torch.where(mask, new_levels, levels)
            origin = _mwhere(mask, self.terrain_origins[
                levels.long(), self.terrain_types.long()], origin)
        if self.env_origins is not None or self.terrain_origins is not None:
            # spawn at the terrain cell's origin +-1 m in x and y
            base_pos = base_pos + origin + torch.cat([
                _uniform(gen, (B, 2), -1.0, 1.0, dev),
                torch.zeros((B, 1), device=dev)], dim=-1)
        base_quat = torch.tensor([0.0, 0.0, 0.0, 1.0],
                                 device=dev).expand(B, 4)
        robot = RobotState(
            base_pos=_mwhere(mask, base_pos, robot.base_pos),
            base_quat=_mwhere(mask, base_quat, robot.base_quat),
            q=_mwhere(mask, q, robot.q),
            v=_mwhere(mask, v, robot.v),
        )
        commands = self._resample_commands(state.replace(robot=robot), mask,
                                           gen)
        state = self._resample_dr(state, mask, gen)
        zeros = torch.zeros((B, nj), device=dev)
        return state.replace(
            robot=robot, commands=commands,
            actions=_mwhere(mask, zeros, state.actions),
            last_actions=_mwhere(mask, zeros, state.last_actions),
            last_dof_vel=_mwhere(mask, zeros, state.last_dof_vel),
            feet_air_time=_mwhere(mask, torch.zeros_like(state.feet_air_time),
                                  state.feet_air_time),
            episode_step=torch.where(mask, 0, state.episode_step),
            episode_sums={k: torch.where(mask, 0.0, v)
                          for k, v in state.episode_sums.items()},
            sea_hidden=self._mask_sea(state.sea_hidden, mask),
            sea_cell=self._mask_sea(state.sea_cell, mask),
            terrain_levels=levels, env_origin=origin,
        )

    def _mask_sea(self, sea: torch.Tensor, mask) -> torch.Tensor:
        """Actuator-net states of the envs in ``mask`` zeroed."""
        if self.actuator_net is None:
            return sea
        B, nj = self.num_envs, self.nj
        per_env = sea.reshape(2, B, nj, 8)
        return torch.where(mask[None, :, None, None], 0.0,
                           per_env).reshape(2, B * nj, 8)

    # ---- rewards ----------------------------------------------------------
    def _rewards(self, state, robot, f_contact, term_contact, first_contact,
                 air_time, names=None) -> Dict[str, torch.Tensor]:
        """Reward-term table; ``names`` restricts it to a subset."""
        R = quat_to_rotmat(robot.base_quat)
        lin_vel_body = torch.einsum("bji,bj->bi", R, robot.v[:, :3])
        gravity_body = -R[:, 2, :]
        q, qd = robot.q, robot.v[:, 6:]
        cmd = state.commands
        feet = list(self.feet_spheres)
        pen = list(self.penalized_spheres)

        def norm(x):
            return torch.linalg.vector_norm(x, dim=-1)

        out = {}
        for name in (names if names is not None
                     else [n for n, _ in self.reward_scales]):
            if name == "lin_vel_z":
                out[name] = torch.square(lin_vel_body[:, 2])
            elif name == "ang_vel_xy":
                out[name] = torch.sum(torch.square(robot.v[:, 3:5]), dim=-1)
            elif name == "orientation":
                out[name] = torch.sum(torch.square(gravity_body[:, :2]),
                                      dim=-1)
            elif name == "base_height":
                h = robot.base_pos[:, 2] - self.sim.terrain_fn(
                    robot.base_pos[:, :2])
                out[name] = torch.square(h - self.base_height_target)
            elif name == "torques":
                out[name] = torch.sum(torch.square(state.torques), dim=-1)
            elif name == "dof_vel":
                out[name] = torch.sum(torch.square(qd), dim=-1)
            elif name == "dof_acc":
                out[name] = torch.sum(torch.square(
                    (state.last_dof_vel - qd) / self.dt), dim=-1)
            elif name == "action_rate":
                out[name] = torch.sum(torch.square(
                    state.last_actions - state.actions), dim=-1)
            elif name == "collision":
                out[name] = (torch.sum(
                    (norm(f_contact[:, pen, :]) > 0.1).float(), dim=-1)
                    if pen else torch.zeros(self.num_envs,
                                            device=self.device))
            elif name == "termination":
                out[name] = term_contact.float()
            elif name == "dof_pos_limits":
                low = torch.clamp(q - self._limit("q_lower"), max=0.0)
                high = torch.clamp(q - self._limit("q_upper"), min=0.0)
                out[name] = torch.sum(-low + high, dim=-1)
            elif name == "dof_vel_limits":
                out[name] = torch.sum(torch.clamp(
                    torch.abs(qd) - self._limit("vel_limit")
                    * self.soft_dof_vel_limit, 0.0, 1.0), dim=-1)
            elif name == "torque_limits":
                out[name] = torch.sum(torch.clamp(
                    torch.abs(state.torques) - self._limit("effort_limit")
                    * self.soft_torque_limit, min=0.0), dim=-1)
            elif name == "tracking_lin_vel":
                err = torch.sum(torch.square(cmd[:, :2]
                                             - lin_vel_body[:, :2]), dim=-1)
                out[name] = torch.exp(-err / self.tracking_sigma)
            elif name == "tracking_ang_vel":
                err = torch.square(cmd[:, 2] - robot.v[:, 5])
                out[name] = torch.exp(-err / self.tracking_sigma)
            elif name == "feet_air_time":
                rew = torch.sum((air_time - 0.5) * first_contact, dim=-1)
                out[name] = rew * (norm(cmd[:, :2]) > 0.1)
            elif name == "stumble":
                fxy = norm(f_contact[:, feet, :2])
                fz = torch.abs(f_contact[:, feet, 2])
                out[name] = torch.any(fxy > 5.0 * fz, dim=-1).float()
            elif name == "stand_still":
                out[name] = torch.sum(torch.abs(q - self.default_dof_pos),
                                      dim=-1) * (norm(cmd[:, :2]) < 0.1)
            elif name == "no_fly":
                contacts = f_contact[:, feet, 2] > 0.1
                out[name] = (torch.sum(contacts.int(), dim=-1) == 1).float()
            elif name == "feet_contact_forces":
                out[name] = torch.sum(torch.clamp(
                    norm(f_contact[:, feet, :]) - self.max_contact_force,
                    min=0.0), dim=-1)
            else:
                raise ValueError(f"unknown reward term {name}")
        return out

    def _update_command_curriculum(self, state, stats):
        """Widen lin-vel command ranges by 0.5 (up to +-5) when the mean
        episode tracking reward of reset envs exceeds 80% of its max.
        ``stats`` is ``batch_stats``, summed over the whole batch."""
        if not any(n == "tracking_lin_vel" for n, _ in self.reward_scales):
            return state.command_ranges
        scale = dict(self.reward_scales)["tracking_lin_vel"] * self.dt
        n_done, track = stats[0], stats[1]
        mean_track = track / torch.clamp(n_done, min=1.0) \
            / self.max_episode_length
        good = (mean_track > 0.8 * scale) & (n_done > 0)
        delta = torch.where(good, 0.5, 0.0)
        cr = state.command_ranges.clone()
        for i in (0, 1):
            cr[i, 0] = torch.clamp(cr[i, 0] - delta, -5.0, 0.0)
            cr[i, 1] = torch.clamp(cr[i, 1] + delta, 0.0, 5.0)
        return cr

    @property
    def reduces_batch(self) -> bool:
        """Whether ``step`` reduces over the whole batch: the command
        curriculum does. A sharded step then runs ``step_begin`` on every
        shard, sums ``batch_stats`` over the shards and finishes each
        shard with ``step_end`` (``envs.base.ShardedEnv``)."""
        return self.command_curriculum

    def batch_stats(self, ctx) -> torch.Tensor:
        """What the command curriculum reduces over the batch: (envs reset
        this step, their summed tracking episode sums), float32."""
        done = ctx["done"]
        track = ctx["episode_sums"].get("tracking_lin_vel")
        return torch.stack([
            done.sum().to(torch.float32),
            (torch.sum(torch.where(done, track, 0.0)) if track is not None
             else torch.zeros((), device=done.device))])

    # ---- step -------------------------------------------------------------
    def _physics(self, state):
        """Decimated physics under PD or actuator-net torques and the
        non-finite guard, shared by the velocity and trajectory tasks."""
        B, nj = self.num_envs, self.nj
        zeros = torch.zeros((B, nj), device=self.device)
        if self.actuator_net is not None:
            net, eff = self.actuator_net, self._limit("effort_limit")

            def sea_torque(carry, rs):
                h, c, _ = carry
                pos_err = (state.actions * self.action_scale
                           + self.default_dof_pos - rs.q)
                x = torch.stack([pos_err.reshape(-1),
                                 rs.v[:, 6:].reshape(-1)], dim=-1)
                tau, h, c = net(x, h, c)
                # the joint drive's effort clamp
                tau = torch.clamp(tau.reshape(B, nj), -eff, eff)
                return (h, c, tau), tau

            robot, (sea_h, sea_c, torques) = self._dr_sim(state)\
                .step_with_carry(state.robot,
                                 (state.sea_hidden, state.sea_cell, zeros),
                                 sea_torque)
            state = state.replace(sea_hidden=sea_h, sea_cell=sea_c)
        else:
            def pd_torque(carry, rs):
                tau = self._compute_torques(state, rs)
                return tau, tau

            robot, torques = self._dr_sim(state).step_with_carry(
                state.robot, zeros, pd_torque)
        # Non-finite backstop: sanitize + force-terminate exploded envs
        # before any reward/obs math sees them; this step's torques (and
        # actuator-net states) came from the same blow-up, so scrub them.
        robot, nonfinite = guard_finite_state(robot, self.sim.default_state(B))
        state = state.replace(torques=torch.where(nonfinite[:, None], 0.0,
                                                  torques))
        if state.sea_hidden.numel():
            nf_sea = nonfinite.repeat_interleave(nj)[None, :, None]
            state = state.replace(
                sea_hidden=torch.where(nf_sea, 0.0, state.sea_hidden),
                sea_cell=torch.where(nf_sea, 0.0, state.sea_cell))
        return state, robot, nonfinite

    def _contacts_and_done(self, state, robot, nonfinite):
        B = self.num_envs
        f_contact = self._contact_forces(robot, self._dr_sim(state))
        feet = list(self.feet_spheres)
        contact = f_contact[:, feet, 2] > 1.0
        contact_filt = contact | state.last_contacts
        first_contact = (state.feet_air_time > 0.0) & contact_filt
        air_time = state.feet_air_time + self.dt
        term = list(self.termination_spheres)
        term_contact = (torch.any(torch.linalg.vector_norm(
            f_contact[:, term, :], dim=-1) > 1.0, dim=-1)
            if term else torch.zeros(B, dtype=torch.bool,
                                     device=self.device)) | nonfinite
        episode_step = state.episode_step + 1
        time_out = episode_step >= self.max_episode_length
        done = term_contact | time_out
        return dict(f_contact=f_contact, contact=contact,
                    contact_filt=contact_filt, first_contact=first_contact,
                    air_time=air_time, term_contact=term_contact,
                    episode_step=episode_step, time_out=time_out, done=done)

    def _total_reward(self, state, rews, done):
        scales = dict(self.reward_scales)
        total = sum(r * (scales[k] * self.dt) for k, r in rews.items()
                    if k != "termination")
        if self.only_positive_rewards:
            total = torch.clamp(total, min=0.0)
        if "termination" in scales:
            total = total + rews["termination"] * scales["termination"]
        episode_sums = {
            k: state.episode_sums[k] + rews[k]
            * (scales[k] * (self.dt if k != "termination" else 1.0))
            for k in state.episode_sums}
        # per-term sums of the envs that reset this step, per episode second
        episode_info = {
            "rew_" + k: torch.sum(torch.where(done, v, 0.0))
            / self.episode_length_s for k, v in episode_sums.items()}
        return total, episode_sums, episode_info

    def step(self, state, actions) -> Tuple[VelocityEnvState, Transition]:
        ctx = self.step_begin(state, actions)
        return self.step_end(ctx, self.batch_stats(ctx)
                             if self.command_curriculum else None)

    def step_begin(self, state, actions) -> dict:
        """The step up to its batch reduction: physics, contacts, rewards,
        command resampling, the heading command and the push."""
        B, dev = self.num_envs, self.device
        actions = torch.clamp(actions, -100.0, 100.0)
        state = state.replace(actions=actions)
        state, robot, nonfinite = self._physics(state)
        c = self._contacts_and_done(state, robot, nonfinite)
        done = c["done"]
        rews = self._rewards(state, robot, c["f_contact"], c["term_contact"],
                             c["first_contact"].float(), c["air_time"])
        total, episode_sums, episode_info = self._total_reward(state, rews,
                                                               done)

        # command resampling + heading controller + pushes
        gen = state.gen
        resample_every = int(round(self.resampling_time_s / self.dt))
        resample = (c["episode_step"] % resample_every) == 0
        commands = self._resample_commands(state, resample, gen)
        if self.heading_command:
            commands = self._heading_to_yaw_cmd(commands, robot)
        push_every = int(round(self.push_interval_s / self.dt))
        do_push = (c["episode_step"] % push_every) == 0
        push_vel = _uniform(gen, (B, 2), -self.max_push_vel,
                            self.max_push_vel, dev)
        robot = robot.replace(v=torch.cat([
            torch.where(do_push[:, None], push_vel, robot.v[:, :2]),
            robot.v[:, 2:]], dim=-1))
        return dict(state=state, robot=robot, c=c, done=done, total=total,
                    episode_sums=episode_sums, episode_info=episode_info,
                    commands=commands, actions=actions)

    def step_end(self, ctx, stats) -> Tuple[VelocityEnvState, Transition]:
        """The rest of the step, given ``batch_stats`` of the whole batch
        (None without the command curriculum): the curriculum, the resets
        and the observations."""
        state, robot, c, done = (ctx["state"], ctx["robot"], ctx["c"],
                                 ctx["done"])
        command_ranges = (
            self._update_command_curriculum(state, stats)
            if self.command_curriculum else state.command_ranges)
        new_state = state.replace(
            robot=robot, commands=ctx["commands"],
            command_ranges=command_ranges,
            last_actions=ctx["actions"], last_dof_vel=robot.v[:, 6:],
            feet_air_time=torch.where(c["contact_filt"], 0.0, c["air_time"]),
            last_contacts=c["contact"], episode_step=c["episode_step"],
            episode_sums=ctx["episode_sums"])
        new_state = self._do_reset(new_state, done)
        obs = self._obs(new_state)
        info = {"episode": ctx["episode_info"], "time_outs": c["time_out"],
                "n_resets": done.sum()}
        return new_state, Transition(obs=obs, privileged_obs=None,
                                     reward=ctx["total"], done=done,
                                     info=info)

    # ---- sharding ---------------------------------------------------------
    def shard(self, mesh, axis="dp") -> list:
        """One env per shard of ``mesh`` (``envs.base.shard_env``); the
        spawn origins and terrain types are per env."""
        return shard_env(self, mesh, axis,
                         per_env=("env_origins", "terrain_types"))

    def shard_state(self, state, mesh, generators, axis="dp"):
        """``state`` cut into shards (``envs.base.shard_env_state``); the
        actuator net's states (2, B nj, 8) are cut along their env rows."""
        from ..parallel.mesh import Sharded

        sea = (state.sea_hidden, state.sea_cell)
        out = shard_env_state(state.replace(sea_hidden=None, sea_cell=None),
                              mesh, self.num_envs, generators, axis)
        n = sea[0].shape[1] // mesh.extent(axis)
        return Sharded([
            s.replace(**{f: x[:, i * n:(i + 1) * n].to(dev, copy=True)
                         for f, x in zip(("sea_hidden", "sea_cell"), sea)})
            for i, (s, dev) in enumerate(zip(out, mesh.devices.flat))],
            mesh, self.num_envs)
