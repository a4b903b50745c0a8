"""Hopper trajectory-tracking RL environment on the batched rigid-body sim.

Counterpart of ``legged_gym_dev_tpu/envs/hopper_trajectory.py``: a 3D
hopper with three reaction wheels and a spring-loaded prismatic foot
tracks a rolling ROM trajectory window.

- Contact-gated hybrid torque controller, recomputed in every physics
  substep: stance = foot spring force, flight = PD to the foot-extension
  setpoint; the wheels follow an SO(3) quaternion-error PD whose body
  torque maps to the actuator frame as ``local_tau @ rot_actuator``;
  optional 'spindown' damping in stance; torque-speed-curve clipping.
  The policy's actions are (w,x,y,z) quaternions; the math library is
  (x,y,z,w).
- Observations (38): [z, quat, body lin vel, body ang vel, wheel vels,
  trajectory window relative to the base, normalized action quat], scaled,
  with additive uniform noise, clipped to +-100.
- Rewards: tracking_rom, differential_error, raibert and the shared hopper
  penalties; termination on body-sphere contact or a non-finite state.
- Domain randomization (spring, PD gains, torque/speed/slope multipliers,
  payload mass), yaw-randomized resets, pushes on per-env timers, and the
  stage-indexed curriculum tables.

The curriculum stage depends only on how many steps the env has taken, so
``common_step`` and ``curriculum_stage`` are Python ints here (the JAX
state holds them as device scalars): a stage's multipliers are host floats,
and each stage's scaled trajectory generator is built once. Random draws
come from the ``torch.Generator`` the state carries.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch

from ..controllers import RaibertHeuristic
from ..core.maths import masked_update as _mwhere
from ..core.maths import (
    quat_inverse,
    quat_mul,
    quat_to_rotmat,
    so3_log,
    yaw_to_quat,
)
from ..sim.contact import contact_forces
from ..sim.dynamics import RobotState
from ..sim.kinematics import contact_points
from ..sim.robot_sim import RobotSim
from ..trajgen.generator import TrajectoryGenerator, TrajGenState
from ..trajgen.samplers import f32
from .base import Transition, guard_finite_state, shard_env
from .legged_robot_velocity import _uniform


@dataclasses.dataclass
class HopperDR:
    """Per-env multiplicative domain-randomization factors."""

    spring_k: torch.Tensor      # (B,)
    spring_d: torch.Tensor      # (B,)
    spring_set: torch.Tensor    # (B,)
    p_gain: torch.Tensor        # (B, 4)
    d_gain: torch.Tensor        # (B, 4)
    torque: torch.Tensor        # (B,)
    speed: torch.Tensor         # (B,)
    ts_slope: torch.Tensor      # (B,)
    base_mass: torch.Tensor     # (B,) additive payload

    def replace(self, **kw) -> "HopperDR":
        return dataclasses.replace(self, **kw)

    @classmethod
    def ones(cls, B: int, device) -> "HopperDR":
        def one(*shape):
            return torch.ones(shape, device=device)

        return cls(spring_k=one(B), spring_d=one(B), spring_set=one(B),
                   p_gain=one(B, 4), d_gain=one(B, 4), torque=one(B),
                   speed=one(B), ts_slope=one(B),
                   base_mass=torch.zeros(B, device=device))


@dataclasses.dataclass(frozen=True)
class CurriculumTables:
    """Stage-indexed multiplier tables (float32 values). The stage is the
    number of ``steps`` thresholds the env's step counter has crossed;
    every affected quantity is nominal * table[stage]."""

    push_magnitude: tuple
    push_time: tuple
    rom_v: tuple
    sigma_tracking_rom: tuple
    reward_mult: tuple
    t_samp: tuple
    freq_low: Optional[tuple] = None
    freq_high: Optional[tuple] = None
    steps: tuple = (2500, 5000)
    enabled: bool = False

    def __post_init__(self):
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if f.name not in ("steps", "enabled") and v is not None:
                object.__setattr__(self, f.name, tuple(f32(x) for x in v))

    def replace(self, **kw) -> "CurriculumTables":
        return dataclasses.replace(self, **kw)

    @property
    def num_stages(self) -> int:
        return len(self.push_magnitude)

    @classmethod
    def default(cls):
        """The 3-stage config tables."""
        return cls(push_magnitude=(0.1, 0.5, 1.0), push_time=(3.0, 2.0, 1.0),
                   rom_v=(0.5, 0.75, 1.0), sigma_tracking_rom=(1.0, 0.8, 0.6),
                   reward_mult=(1.0, 1.0, 1.0), t_samp=(3.0, 2.0, 1.0),
                   freq_low=(0.01, 0.1, 1.0), freq_high=(0.1, 0.5, 1.0))

    @classmethod
    def hopper_single_int(cls):
        """The 8-stage schedule the hopper trains with: pushes ramp in over
        four stages, hold times and sinusoid frequencies tighten, ROM
        velocity stays at 0.5x, the tracking sigma sharpens 10x in the last
        two stages."""
        return cls(
            push_magnitude=(0.0, 0.3, 0.6, 1.0, 1.0, 1.0, 1.0, 1.0),
            push_time=(4., 3., 2., 1., 1., 1., 1., 1.),
            rom_v=(0.5,) * 8,
            sigma_tracking_rom=(1., 1., 1., 1., 1., 1., 0.1, 0.1),
            reward_mult=(1.0,) * 8,
            t_samp=(3., 2., 1., 1., 1., 1., 1., 1.),
            freq_low=(0.01, 0.1, 1., 1., 1., 1., 1., 1.),
            freq_high=(0.1, 0.5, 1., 1., 1., 1., 1., 1.),
            steps=(2500, 5000, 7500, 10000, 12500, 15000, 17500),
            enabled=True)


@dataclasses.dataclass
class HopperEnvState:
    gen: torch.Generator
    robot: RobotState
    traj_gen: TrajGenState
    trajectory: torch.Tensor          # (B, N_traj, 2)
    actions: torch.Tensor             # (B, 4) raw policy actions (quat wxyz)
    last_actions: torch.Tensor
    last_dof_vel: torch.Tensor        # (B, 4)
    torques: torch.Tensor             # (B, 4) last applied torques
    prev_error: torch.Tensor          # (B, 2) squared tracking error
    time_until_next_push: torch.Tensor  # (B,) seconds
    episode_step: torch.Tensor        # (B,) int32
    episode_sums: Dict[str, torch.Tensor]
    dr: HopperDR
    curriculum_stage: int = 0
    common_step: int = 0              # env steps taken (all envs)

    def replace(self, **kw) -> "HopperEnvState":
        return dataclasses.replace(self, **kw)


class HopperCommon:
    """The controller, resets, DR and penalty terms the trajectory and
    velocity hopper tasks share (fields of both dataclasses)."""

    @property
    def device(self) -> torch.device:
        return self.p_gains.device

    @property
    def num_actions(self) -> int:
        return 4

    @property
    def dt(self) -> float:
        return self.sim.dt * self.sim.decimation

    @property
    def max_episode_length(self) -> int:
        return int(round(self.episode_length_s / self.dt))

    def shard(self, mesh, axis="dp") -> list:
        """One env per shard of ``mesh`` (``envs.base.shard_env``)."""
        return shard_env(self, mesh, axis)

    def _sphere_forces(self, robot: RobotState) -> torch.Tensor:
        pos, vel = contact_points(self.sim.model, robot)
        return contact_forces(
            self.sim.contact, pos, vel,
            self.sim.model.tensor("contact_radius", self.device),
            self.sim.terrain_fn)

    def _identity_actions(self) -> torch.Tensor:
        """The zero action: the identity quaternion (w,x,y,z)."""
        return torch.tensor([1.0, 0.0, 0.0, 0.0],
                            device=self.device).expand(self.num_envs, 4)

    # ---- controller ------------------------------------------------------
    def _compute_torques(self, state, robot: RobotState) -> torch.Tensor:
        foot_pos = robot.q[:, 0]
        foot_vel = robot.v[:, 6]
        wheel_vel = robot.v[:, 7:10]

        # contact gating from the foot sphere's normal force, this substep
        contact = self._sphere_forces(robot)[:, self.foot_sphere, 2] > 0.1

        dr = state.dr
        p_g = self.p_gains[None, :] * dr.p_gain
        d_g = self.d_gains[None, :] * dr.d_gain

        # foot: flight PD to the setpoint, stance spring force
        tau_foot_flight = (-p_g[:, 0] * (foot_pos - self.foot_pos_des)
                           - d_g[:, 0] * foot_vel)
        spring_set = self.spring_setpoint * dr.spring_set
        tau_foot_stance = (
            -self.spring_stiffness * dr.spring_k * (foot_pos - spring_set)
            - self.spring_damping * dr.spring_d * foot_vel)
        tau_foot = torch.where(contact, tau_foot_stance, tau_foot_flight)

        # wheels: SO(3) orientation PD in the body frame -> actuator frame
        qd = state.actions / torch.clamp(torch.linalg.vector_norm(
            state.actions, dim=-1, keepdim=True), min=1e-8)
        quat_des = torch.cat([qd[:, 1:], qd[:, :1]], dim=-1)   # wxyz->xyzw
        log_err = so3_log(quat_mul(quat_inverse(quat_des), robot.base_quat))
        local_tau = -p_g[:, 1:] * log_err - d_g[:, 1:] * robot.v[:, 3:6]
        # row-vector convention (p @ R): local_tau @ R, not @ R^T
        tau_wheel = local_tau @ self.rot_actuator
        if "spindown" in self.control_type:
            kd_sp = self.kd_spindown[None, :] * dr.d_gain[:, 1:]
            tau_wheel = torch.where(contact[:, None], -kd_sp * wheel_vel,
                                    tau_wheel)

        # torque-speed curve on the wheels, then the torque bounds
        t_bound = self.torque_limits[None, :] * dr.torque[:, None]
        w_bound = self.wheel_speed_limit * dr.speed[:, None]
        slope = self.ts_ratio * dr.ts_slope[:, None]
        upper = -slope * t_bound[:, 1:] / w_bound * (wheel_vel - w_bound)
        lower = -slope * t_bound[:, 1:] / w_bound * (wheel_vel + w_bound)
        tau = torch.cat([tau_foot[:, None],
                         torch.clamp(tau_wheel, lower, upper)], dim=-1)
        return torch.clamp(tau, -t_bound, t_bound)

    def _scaled_obs(self, state, parts) -> torch.Tensor:
        """[z, quat, body lin vel, body ang vel, wheel vels, *parts,
        normalized action quat (qw > 0)] scaled, noised, clipped."""
        robot = state.robot
        a = state.actions
        an = a / torch.clamp(torch.linalg.vector_norm(a, dim=-1,
                                                      keepdim=True), min=1e-8)
        an = torch.where(an[:, :1] < 0, -an, an)
        R = quat_to_rotmat(robot.base_quat)
        lin_vel_body = torch.einsum("bji,bj->bi", R, robot.v[:, :3])
        obs = torch.cat([robot.base_pos[:, 2:3], robot.base_quat,
                         lin_vel_body, robot.v[:, 3:6], robot.v[:, 7:10],
                         *parts, an], dim=-1)
        obs = obs * self.obs_scales[None, :]
        if self.add_noise:
            u = torch.rand(obs.shape, generator=state.gen, device=obs.device)
            obs = obs + (2.0 * u - 1.0) * self.noise_vec[None, :]
        return obs

    # ---- resets ------------------------------------------------------------
    def _reset_robot(self, state, mask, gen) -> RobotState:
        B, dev = self.num_envs, self.device
        robot = state.robot
        # spawn with the foot sphere at ground contact
        base_pos = torch.cat([torch.zeros((B, 2), device=dev),
                              0.36 + _uniform(gen, (B, 1), 0.0, 0.06, dev)],
                             dim=-1)
        yaw = _uniform(gen, (B,), -math.pi, math.pi, dev)
        quat = yaw_to_quat(yaw) + _uniform(gen, (B, 4), -0.03, 0.03, dev)
        quat = quat / torch.linalg.vector_norm(quat, dim=-1, keepdim=True)
        q = torch.cat([_uniform(gen, (B, 1), -0.02, 0.02, dev) + 0.03,
                       torch.zeros((B, 3), device=dev)], dim=-1)
        v = torch.cat([_uniform(gen, (B, 3), -0.05, 0.05, dev),
                       _uniform(gen, (B, 3), -0.2, 0.2, dev),
                       torch.zeros((B, 4), device=dev)], dim=-1)
        model = self.sim.model
        q = torch.clamp(q, model.tensor("q_lower", dev),
                        model.tensor("q_upper", dev))
        return RobotState(
            base_pos=_mwhere(mask, base_pos, robot.base_pos),
            base_quat=_mwhere(mask, quat, robot.base_quat),
            q=_mwhere(mask, q, robot.q),
            v=_mwhere(mask, v, robot.v))

    def _resample_dr(self, dr: HopperDR, mask, gen) -> HopperDR:
        if not self.domain_rand:
            return dr
        B, dev = self.num_envs, self.device

        def u(lo, hi, shape=(B,)):
            return _uniform(gen, shape, lo, hi, dev)

        new = HopperDR(spring_k=u(0.9, 1.1), spring_d=u(0.9, 1.1),
                       spring_set=u(0.75, 1.25), p_gain=u(0.9, 1.1, (B, 4)),
                       d_gain=u(0.9, 1.1, (B, 4)), torque=u(0.95, 1.05),
                       speed=u(0.9, 1.1), ts_slope=u(0.9, 1.1),
                       base_mass=u(-1.0, 1.0))
        return HopperDR(**{f.name: _mwhere(mask, getattr(new, f.name),
                                           getattr(dr, f.name))
                           for f in dataclasses.fields(HopperDR)})

    def _base_state(self, gen, **extra) -> dict:
        B, dev = self.num_envs, self.device
        ident = self._identity_actions().clone()
        return dict(
            gen=gen, robot=self.sim.default_state(B, base_pos=(0, 0, 0.3)),
            actions=ident, last_actions=ident.clone(),
            last_dof_vel=torch.zeros((B, 4), device=dev),
            torques=torch.zeros((B, 4), device=dev),
            time_until_next_push=torch.zeros(B, device=dev),
            episode_step=torch.zeros(B, dtype=torch.int32, device=dev),
            episode_sums={name: torch.zeros(B, device=dev)
                          for name, _ in self.reward_scales},
            dr=HopperDR.ones(B, dev), **extra)

    # ---- physics and termination ------------------------------------------
    def _physics(self, state):
        """Decimated physics with the controller in every substep; the
        recorded torques are those of the last substep."""

        def ctrl(carry, rs):
            tau = self._compute_torques(state, rs)
            return tau, tau

        sim = (self.sim.replace(base_mass_delta=state.dr.base_mass)
               if self.domain_rand else self.sim)
        return sim.step_with_carry(
            state.robot, torch.zeros((self.num_envs, 4), device=self.device),
            ctrl)

    def _term_contact(self, robot: RobotState) -> torch.Tensor:
        f = self._sphere_forces(robot)[:, list(self.termination_spheres), :]
        return torch.any(torch.linalg.vector_norm(f, dim=-1) > 1.0, dim=-1)

    def _push(self, state, robot, push_mag, push_t):
        """Pushes SET the 6-dim base velocity on per-env random timers;
        returns (robot, timer)."""
        if not self.push_robots:
            return robot, state.time_until_next_push
        B, dev, gen = self.num_envs, self.device, state.gen
        timer = state.time_until_next_push - self.dt
        need_push = timer <= 0.0
        push_vel = _uniform(gen, (B, 6), -push_mag, push_mag, dev)
        robot = robot.replace(v=torch.cat([
            torch.where(need_push[:, None], push_vel, robot.v[:, :6]),
            robot.v[:, 6:]], dim=-1))
        next_t = _uniform(gen, (B,), self.time_between_pushes[0] * push_t,
                          self.time_between_pushes[1] * push_t, dev)
        return robot, torch.where(need_push, next_t, timer)

    # ---- rewards ------------------------------------------------------------
    def _common_rewards(self, state, robot: RobotState, actions, torques,
                        term_contact, names) -> Dict[str, torch.Tensor]:
        """Hopper reward terms shared by the trajectory and velocity
        tasks."""
        out = {}
        for name in names:
            if name == "orientation":
                R = quat_to_rotmat(robot.base_quat)
                out[name] = torch.sum(torch.square(R[:, 2, :2]), dim=-1)
            elif name == "ang_vel_xy":
                out[name] = torch.sum(torch.square(robot.v[:, 3:5]), dim=-1)
            elif name == "lin_vel_z":
                out[name] = torch.square(robot.v[:, 2])
            elif name == "torques":
                out[name] = torch.sum(torch.square(torques), dim=-1)
            elif name == "torque_limits":
                out[name] = torch.sum(torch.abs(torques[:, 1:]), dim=-1)
            elif name == "dof_acc":
                # wheel joints only: the foot's touchdown would swamp it
                out[name] = torch.sum(torch.square(
                    (robot.v[:, 7:10] - state.last_dof_vel[:, 1:]) / self.dt),
                    dim=-1)
            elif name == "action_rate":
                out[name] = torch.sum(torch.square(
                    actions - state.last_actions), dim=-1)
            elif name == "unit_quat":
                out[name] = torch.square(
                    1.0 - torch.linalg.vector_norm(actions, dim=-1))
            elif name == "collision":
                out[name] = term_contact.float()
            elif name == "termination":
                out[name] = torch.zeros(self.num_envs, device=self.device)
            else:
                raise ValueError(f"unknown reward term {name}")
        return out

    def _total_reward(self, state, rews, term_contact, done, rmult=1.0):
        """(total, episode_sums, episode_info); ``rmult`` scales every term
        and the logged sums."""
        scales = dict(self.reward_scales)
        total = sum(r * (scales[k] * self.dt) for k, r in rews.items()
                    if k != "termination") * rmult
        if "termination" in scales:
            term = term_contact.float()
            total = total + term * scales["termination"] * rmult
            rews["termination"] = term
        episode_sums = {
            k: state.episode_sums[k] + rews[k] * rmult
            * (scales[k] * (self.dt if k != "termination" else 1.0))
            for k in state.episode_sums}
        # per-term sums of the envs that reset this step, per episode second
        episode_info = {
            "rew_" + k: torch.sum(torch.where(done, v, 0.0))
            / self.episode_length_s for k, v in episode_sums.items()}
        return total, episode_sums, episode_info


@dataclasses.dataclass
class HopperTrajectoryEnv(HopperCommon):
    sim: RobotSim                  # hopper model, dt=2.5 ms, decimation=8
    traj_gen: TrajectoryGenerator  # SingleInt2D ROM window

    # controller parameters (float32 values)
    p_gains: torch.Tensor          # (4,) [foot, w1, w2, w3]
    d_gains: torch.Tensor
    kd_spindown: torch.Tensor      # (3,)
    spring_stiffness: float
    spring_damping: float
    spring_setpoint: float
    foot_pos_des: float
    rot_actuator: torch.Tensor     # (3, 3)
    torque_limits: torch.Tensor    # (4,)
    wheel_speed_limit: float
    ts_ratio: float
    obs_scales: torch.Tensor       # (38,)
    noise_vec: torch.Tensor        # (38,)
    reward_weighting: torch.Tensor  # (2,)
    tracking_sigma: float
    raibert: RaibertHeuristic
    curriculum: Optional[CurriculumTables] = None
    reward_scales: tuple = ()
    diff_err_slopes: tuple = (-4.0, -1.0)
    control_type: str = "orientation"
    add_noise: bool = True
    domain_rand: bool = True
    episode_length_s: float = 20.0
    push_robots: bool = True
    max_push_vel: tuple = (0.25, 0.25, 0.25, 0.75, 0.75, 0.75)
    time_between_pushes: tuple = (0.5, 10.0)
    # contact sphere indices in URDF order: torso, foot, wheels
    foot_sphere: int = 1
    termination_spheres: tuple = (0, 2, 3, 4)
    num_envs: int = 4096

    def __post_init__(self):
        cur = self.curriculum
        self._stages = (cur.num_stages if cur is not None and cur.enabled
                        else 1)
        self._stage_gens = [self._scaled_traj_gen(s)
                            for s in range(self._stages)]
        self._push_mags = [
            torch.tensor([f32(f32(m) * self._cur(s, "push_magnitude"))
                          for m in self.max_push_vel], device=self.device)
            for s in range(self._stages)]

    def replace(self, **kw) -> "HopperTrajectoryEnv":
        return dataclasses.replace(self, **kw)

    @property
    def n_traj(self) -> int:
        return self.traj_gen.N

    @property
    def num_obs(self) -> int:
        return 1 + 4 + 3 + 3 + 3 + 2 * self.n_traj + 4

    @property
    def rom(self):
        return self.traj_gen.rom

    # ---- curriculum ---------------------------------------------------------
    def _cur(self, stage: int, table: str) -> float:
        """A table's multiplier at ``stage`` (1.0 when disabled)."""
        cur = self.curriculum
        if cur is None or not cur.enabled:
            return 1.0
        vals = getattr(cur, table)
        return vals[min(max(stage, 0), len(vals) - 1)]

    def _scaled_traj_gen(self, stage: int) -> TrajectoryGenerator:
        """The generator with curriculum-scaled ROM input bounds, hold
        times and sinusoid frequency band."""
        cur = self.curriculum
        if cur is None or not cur.enabled:
            return self.traj_gen
        mv, mt = self._cur(stage, "rom_v"), self._cur(stage, "t_samp")
        gen = self.traj_gen
        rom = dataclasses.replace(gen.rom, v_min=gen.rom.v_min * mv,
                                  v_max=gen.rom.v_max * mv)
        ts = dataclasses.replace(gen.t_sampler,
                                 t_low=f32(gen.t_sampler.t_low * mt),
                                 t_high=f32(gen.t_sampler.t_high * mt))
        gen = dataclasses.replace(gen, rom=rom, t_sampler=ts)
        if cur.freq_low is not None:
            gen = dataclasses.replace(
                gen,
                freq_low=f32(gen.freq_low * self._cur(stage, "freq_low")),
                freq_high=f32(gen.freq_high * self._cur(stage, "freq_high")))
        return gen

    def _traj_gen_cur(self, state: HopperEnvState) -> TrajectoryGenerator:
        return self._stage_gens[min(state.curriculum_stage,
                                    self._stages - 1)]

    # ---- observations ------------------------------------------------------
    def _obs(self, state: HopperEnvState) -> torch.Tensor:
        mod_traj = state.trajectory - self.rom.proj_z(
            state.robot.root_states)[:, None, :2]
        obs = self._scaled_obs(state, [mod_traj.reshape(self.num_envs, -1)])
        return torch.clamp(obs, -100.0, 100.0)

    # ---- resets ------------------------------------------------------------
    def reset(self, gen: torch.Generator
              ) -> Tuple[HopperEnvState, torch.Tensor]:
        B, dev = self.num_envs, self.device
        state = HopperEnvState(**self._base_state(
            gen, traj_gen=self.traj_gen.init_state(gen, B),
            trajectory=torch.zeros((B, self.n_traj, 2), device=dev),
            prev_error=torch.zeros((B, 2), device=dev)))
        state = self._do_reset(state, torch.ones(B, dtype=torch.bool,
                                                 device=dev))
        return state, self._obs(state)

    def _do_reset(self, state: HopperEnvState, mask) -> HopperEnvState:
        B, dev, gen = self.num_envs, self.device, state.gen
        robot = self._reset_robot(state, mask, gen)
        dr = self._resample_dr(state.dr, mask, gen)
        p_zx = self.rom.proj_z(robot.root_states)
        tg = self._traj_gen_cur(state).reset(state.traj_gen, mask, p_zx)
        ident = self._identity_actions()
        push_t = self._cur(state.curriculum_stage, "push_time")
        first_push = _uniform(gen, (B,), self.time_between_pushes[0] * push_t,
                              self.time_between_pushes[1] * push_t, dev)
        zeros = torch.zeros((B, 4), device=dev)
        return state.replace(
            robot=robot, traj_gen=tg,
            trajectory=self.traj_gen.get_trajectory(tg)[..., :2],
            actions=_mwhere(mask, ident, state.actions),
            last_actions=_mwhere(mask, ident, state.last_actions),
            last_dof_vel=_mwhere(mask, zeros, state.last_dof_vel),
            prev_error=_mwhere(mask, zeros[:, :2], state.prev_error),
            time_until_next_push=torch.where(mask, first_push,
                                             state.time_until_next_push),
            episode_step=torch.where(mask, 0, state.episode_step),
            episode_sums={k: torch.where(mask, 0.0, v)
                          for k, v in state.episode_sums.items()},
            dr=dr)

    # ---- rewards ------------------------------------------------------------
    def _rewards(self, state: HopperEnvState, robot: RobotState, actions,
                 torques, term_contact) -> Dict[str, torch.Tensor]:
        desired = state.trajectory[:, 0, :]
        pz_x = self.rom.proj_z(robot.root_states)
        sq_err = torch.square(pz_x - desired)
        sigma = f32(self.tracking_sigma * self._cur(
            state.curriculum_stage, "sigma_tracking_rom"))
        out, rest = {}, []
        for name, _ in self.reward_scales:
            if name == "tracking_rom":
                out[name] = torch.exp(-(sq_err @ self.reward_weighting)
                                      / sigma)
            elif name == "differential_error":
                err = torch.linalg.vector_norm(sq_err, dim=-1)
                diff = err - torch.linalg.vector_norm(state.prev_error,
                                                      dim=-1)
                pos_s, neg_s = self.diff_err_slopes
                out[name] = torch.where(diff < 0, neg_s, pos_s) * diff
            elif name == "raibert":
                # deviation from the Raibert-heuristic action: target the
                # current trajectory node, body-frame planar velocity
                R = quat_to_rotmat(robot.base_quat)
                vel_body = torch.einsum("bji,bj->bi", R, robot.v[:, :3])
                rh_obs = torch.cat([desired - pz_x, vel_body[:, :2],
                                    state.traj_gen.v[:, :2],
                                    robot.base_quat], dim=-1)
                out[name] = torch.sum(torch.square(
                    actions - self.raibert(rh_obs)), dim=-1)
            else:
                rest.append(name)
        out.update(self._common_rewards(state, robot, actions, torques,
                                        term_contact, rest))
        return out

    # ---- step ---------------------------------------------------------------
    def step(self, state: HopperEnvState,
             actions) -> Tuple[HopperEnvState, Transition]:
        B = self.num_envs
        actions = torch.clamp(actions, -100.0, 100.0)
        state = state.replace(actions=actions)
        robot, torques = self._physics(state)
        robot, nonfinite = guard_finite_state(robot, self.sim.default_state(B))
        torques = torch.where(nonfinite[:, None], 0.0, torques)

        # trajectory-generator tick at the policy rate
        tgen = self._traj_gen_cur(state)
        tg = tgen.step(state.traj_gen)
        trajectory = tgen.get_trajectory(tg)[..., :2]
        mid = state.replace(robot=robot, traj_gen=tg, trajectory=trajectory)

        term_contact = self._term_contact(robot) | nonfinite
        episode_step = state.episode_step + 1
        time_out = episode_step >= self.max_episode_length
        done = term_contact | time_out

        stage = state.curriculum_stage
        rews = self._rewards(mid, robot, actions, torques, term_contact)
        total, episode_sums, episode_info = self._total_reward(
            state, rews, term_contact, done,
            self._cur(stage, "reward_mult"))

        robot, timer = self._push(
            state, robot, self._push_mags[min(stage, self._stages - 1)],
            self._cur(stage, "push_time"))

        pz_x = self.rom.proj_z(robot.root_states)
        common_step = state.common_step + 1
        if self._stages > 1:
            stage = sum(common_step >= s for s in self.curriculum.steps)
        new_state = mid.replace(
            robot=robot, curriculum_stage=stage, common_step=common_step,
            last_actions=actions, last_dof_vel=robot.v[:, 6:],
            torques=torques,
            prev_error=torch.square(pz_x - trajectory[:, 0, :]),
            time_until_next_push=timer, episode_step=episode_step,
            episode_sums=episode_sums)
        new_state = self._do_reset(new_state, done)
        obs = self._obs(new_state)
        info = {"episode": episode_info, "time_outs": time_out,
                "n_resets": done.sum()}
        return new_state, Transition(obs=obs, privileged_obs=None,
                                     reward=total, done=done, info=info)
