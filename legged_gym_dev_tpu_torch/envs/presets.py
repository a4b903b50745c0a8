"""Preset task factories encoding the reference robot configurations.

Counterpart of ``legged_gym_dev_tpu/envs/presets.py``, with the same
numbers: the legged velocity and trajectory tasks (``make_velocity_env``,
``make_trajectory_env``) and their robots (A1, ANYmal-B and -C on flat
and rough terrain, ANYmal-C with the LSTM actuator net, Cassie, Adam), the
hopper tasks (``make_hopper_trajectory_env``,
``make_hopper_velocity_env``) and the physics-free ROM-tracking task
(``make_rom_tracking_env``); the registry's 13 tasks.

The robots' URDF files and the actuator net's weights are not in this
repository. Every robot factory takes ``urdf_path=`` (a path or a URDF
string) and defaults, as the JAX package's do, to the reference project's
file (paths relative to that project's root: ``HOPPER_URDF``,
``A1_URDF``, ``ANYMAL_B_URDF``, ``ANYMAL_C_URDF``, ``CASSIE_URDF``;
``ACTUATOR_NET_PATH``), raising ``FileNotFoundError`` where it is absent.
The Adam preset has no default file: it raises without ``urdf_path``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..controllers import RaibertHeuristic
from ..core.rom import DoubleInt2D, SingleInt2D, make_rom
from ..rl.ppo import PPOConfig
from ..sim.actuator_net import ActuatorNetLSTM
from ..sim.contact import ContactParams
from ..sim.dynamics import RobotModel
from ..sim.robot_sim import RobotSim
from ..sim.rom_sim import RomSim
from ..sim.urdf import parse_urdf
from ..trajgen.generator import TrajectoryGenerator
from ..trajgen.samplers import (
    SAMPLER_REGISTRY,
    UniformSampleHoldDT,
    UniformWeightSampler,
    UniformWeightSamplerNoRamp,
    f32,
)
from ..utils.runtime import resolve_device
from .registry import task_registry
from .rom_tracking import RomTrackingEnv

# The reference project's robot files (relative to its root); not in this
# repository.
A1_URDF = "resources/robots/a1/urdf/a1.urdf"
ANYMAL_C_URDF = "resources/robots/anymal_c/urdf/anymal_c.urdf"
ANYMAL_B_URDF = "resources/robots/anymal_b/urdf/anymal_b.urdf"
CASSIE_URDF = "resources/robots/cassie/urdf/cassie.urdf"
ACTUATOR_NET_PATH = "resources/actuator_nets/anydrive_v3_lstm.pt"

# ref a1_config.py:36-50 default joint angles (URDF joint order FR FL RR RL).
A1_DEFAULT_ANGLES = {
    "FR_hip_joint": -0.1, "FR_thigh_joint": 0.8, "FR_calf_joint": -1.5,
    "FL_hip_joint": 0.1, "FL_thigh_joint": 0.8, "FL_calf_joint": -1.5,
    "RR_hip_joint": -0.1, "RR_thigh_joint": 1.0, "RR_calf_joint": -1.5,
    "RL_hip_joint": 0.1, "RL_thigh_joint": 1.0, "RL_calf_joint": -1.5,
}

A1_REWARD_SCALES = (
    ("tracking_lin_vel", 1.0),
    ("tracking_ang_vel", 0.5),
    ("lin_vel_z", -2.0),
    ("ang_vel_xy", -0.05),
    ("torques", -0.0002),
    ("dof_acc", -2.5e-7),
    ("feet_air_time", 1.0),
    ("collision", -1.0),
    ("action_rate", -0.01),
    ("dof_pos_limits", -10.0),
    ("termination", -0.0),
)


def make_velocity_env(urdf_path: str, num_envs: int = 4096,
                      default_angles: dict = A1_DEFAULT_ANGLES,
                      sim_dt: float = 0.005, sim_decimation: int = 4,
                      contact=None, p_gain=20.0, d_gain=0.5,
                      action_scale: float = 0.25, base_height: float = 0.42,
                      base_height_target: float = 0.25,
                      foot_name: str = "foot",
                      penalize_on=("thigh", "calf"),
                      terminate_on=("base", "trunk"),
                      reward_scales=A1_REWARD_SCALES,
                      add_noise: bool = True,
                      episode_length_s: float = 20.0,
                      only_positive_rewards: bool = False,
                      max_contact_force: float = 100.0,
                      measure_heights: bool = False,
                      command_curriculum: bool = False,
                      init_lin_vel_range: float = 1.0,
                      randomize_friction: bool = True,
                      friction_range=(0.5, 1.25),
                      randomize_base_mass: bool = False,
                      added_mass_range=(-1.0, 1.0),
                      randomize_contact: bool = False,
                      contact_mult_range=(0.7, 1.3),
                      terrain=None, device=None):
    """Velocity-command task for any URDF robot (path or string)."""
    from .legged_robot_velocity import (
        LeggedRobotVelocityEnv,
        classify_contacts,
    )

    dev = resolve_device(device)
    model = RobotModel.from_spec(parse_urdf(urdf_path))

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    terrain_fn = (terrain.make_terrain_fn(device=dev)
                  if terrain is not None else None)
    env_origins = terrain_origins = terrain_types = None
    rough = terrain is not None and terrain.type not in ("none", "plane")
    if rough:
        # origins table [row (level), col (type)]: cell centers in world
        # coordinates (the sampler's pixel map carries the border)
        terrain_origins = t(terrain.env_origins)
        # a fixed terrain type (column) per env, starting at level 0
        terrain_types = torch.as_tensor(
            np.arange(num_envs) % terrain.env_origins.shape[1],
            dtype=torch.int32, device=dev)
        env_origins = terrain_origins[0, terrain_types.long()]
    sim = RobotSim.create(
        model, contact=contact or ContactParams.create(
            stiffness=5000.0, damping=50.0, device=dev),
        dt=sim_dt, decimation=sim_decimation, device=dev,
        **({"terrain_fn": terrain_fn} if terrain_fn else {}))

    default_dof = t([default_angles.get(n, 0.0) for n in model.dof_names])

    def _gains(g):
        """Scalar, or a dict matched by name substring (first key contained
        in the dof name wins)."""
        if isinstance(g, dict):
            vals = []
            for n in model.dof_names:
                v = 0.0
                for k, gv in g.items():
                    if k in n:
                        v = float(gv)
                        break
                vals.append(v)
            return t(vals)
        return t(np.full(model.nj, float(g)))

    feet, pen, term = classify_contacts(model, foot_name, penalize_on,
                                        terminate_on)
    nj = model.nj
    # the perceptive height-scan grid: 17 x 11 = 187 points
    mpx = (tuple(np.round(np.arange(-0.8, 0.81, 0.1), 2))
           if measure_heights else None)
    mpy = (tuple(np.round(np.arange(-0.5, 0.51, 0.1), 2))
           if measure_heights else None)
    n_hpts = len(mpx) * len(mpy) if measure_heights else 0
    noise_vec = np.concatenate([
        0.1 * 2.0 * np.ones(3), 0.2 * 0.25 * np.ones(3), 0.05 * np.ones(3),
        np.zeros(3), 0.01 * np.ones(nj), 1.5 * 0.05 * np.ones(nj),
        np.zeros(nj), 0.1 * 5.0 * np.ones(n_hpts)])
    return LeggedRobotVelocityEnv(
        sim=sim,
        default_dof_pos=default_dof,
        p_gains=_gains(p_gain),
        d_gains=_gains(d_gain),
        base_init_pos=t([0.0, 0.0, base_height]),
        noise_vec=t(noise_vec),
        command_curriculum=command_curriculum,
        init_command_ranges=t(
            [[-init_lin_vel_range, init_lin_vel_range],
             [-init_lin_vel_range, init_lin_vel_range], [-1.0, 1.0],
             [-np.pi, np.pi]]),
        tracking_sigma=f32(0.25),
        base_height_target=f32(base_height_target),
        max_contact_force=f32(max_contact_force),
        only_positive_rewards=only_positive_rewards,
        measured_points_x=mpx,
        measured_points_y=mpy,
        soft_dof_vel_limit=1.0,
        soft_torque_limit=1.0,
        env_origins=env_origins,
        terrain_origins=terrain_origins,
        terrain_types=terrain_types,
        terrain_curriculum=rough,
        randomize_friction=randomize_friction,
        friction_range=tuple(friction_range),
        randomize_base_mass=randomize_base_mass,
        added_mass_range=tuple(added_mass_range),
        randomize_contact=randomize_contact,
        contact_mult_range=tuple(contact_mult_range),
        action_scale=action_scale,
        reward_scales=tuple(reward_scales),
        feet_spheres=feet,
        penalized_spheres=pen,
        termination_spheres=term,
        add_noise=add_noise,
        episode_length_s=episode_length_s,
        num_envs=num_envs,
    )


@dataclasses.dataclass
class RewardWeighting:
    """Per-dim tracking-reward weights consumed by each ROM's
    ``weighting_vector``."""

    position: float = 1.0
    velocity: float = 1.0
    orientation: float = 1.0
    angular_velocity: float = 1.0


def make_trajectory_env(urdf_path: str, num_envs: int = 4096,
                        rom_dt: float = 0.1, vel_max: float = 0.35,
                        rom_cls: str = "SingleInt2D",
                        rom_z_min=None, rom_z_max=None,
                        rom_v_min=None, rom_v_max=None,
                        reward_weighting: RewardWeighting | None = None,
                        n_traj: int = 10, dn_traj: int = 1,
                        t_low: float = 1.0, t_high: float = 2.0,
                        max_rom_distance=None,
                        zero_rom_dist_llh: float = 0.25,
                        reward_scales=None, device=None, **kw):
    """Trajectory-tracking task for any URDF robot: the velocity env's
    machinery with the commands replaced by a rolling ROM window.
    ``device=None`` means the CUDA card."""
    from ..core.rom import ROM_REGISTRY
    from .legged_robot_trajectory import LeggedRobotTrajectoryEnv

    dev = resolve_device(device)
    rom_type = ROM_REGISTRY[rom_cls]
    rn, rm = rom_type.n, rom_type.m
    if reward_scales is None:
        # ANYmal flat-trajectory set (tracking_rom at its nominal 6.0)
        reward_scales = (
            ("tracking_rom", 6.0),
            ("termination", -0.5),
            ("orientation", -5.0),
            ("torques", -2.5e-5),
            ("feet_air_time", 0.5),
            ("action_rate", -0.01),
            ("dof_acc", -2.5e-7),
        )
    base = make_velocity_env(
        urdf_path, num_envs=num_envs, reward_scales=reward_scales,
        only_positive_rewards=kw.pop("only_positive_rewards", False),
        device=dev, **kw)
    rom = make_rom(
        rom_cls, rom_dt,
        rom_z_min if rom_z_min is not None else [-1e9] * rn,
        rom_z_max if rom_z_max is not None else [1e9] * rn,
        rom_v_min if rom_v_min is not None else [-vel_max] * rm,
        rom_v_max if rom_v_max is not None else [vel_max] * rm,
        device=dev)
    gen = TrajectoryGenerator.create(
        rom, UniformSampleHoldDT.create(t_low, t_high),
        UniformWeightSampler(),
        dt_loop=base.dt, N=n_traj, dN=dn_traj, prob_stationary=0.01)
    weighting = rom.weighting_vector(reward_weighting or RewardWeighting())
    if max_rom_distance is None:
        max_rom_distance = (0.1,) * rn
    nj = base.nj
    noise_vec = np.concatenate([
        0.1 * 2.0 * np.ones(3), 0.2 * 0.25 * np.ones(3), 0.05 * np.ones(3),
        np.zeros(rom.n * n_traj), 0.01 * np.ones(nj),
        1.5 * 0.05 * np.ones(nj), np.zeros(nj),
        0.1 * 5.0 * np.ones(base.num_height_points)])
    fields = {f.name: getattr(base, f.name)
              for f in dataclasses.fields(base)}
    fields["noise_vec"] = torch.as_tensor(noise_vec.astype(np.float32),
                                          device=dev)
    return LeggedRobotTrajectoryEnv(
        **fields,
        traj_gen=gen,
        reward_weighting=weighting,
        max_rom_distance=torch.as_tensor(
            np.asarray(max_rom_distance, np.float32), device=dev),
        zero_rom_dist_llh=f32(zero_rom_dist_llh),
    )


def _anymal_c_kwargs(kw):
    """ANYmal-C's robot settings, shared by the velocity and trajectory
    presets (no reward scales: the trajectory task sets its own)."""
    kw.setdefault("default_angles", {
        "LF_HAA": 0.0, "LF_HFE": 0.4, "LF_KFE": -0.8,
        "RF_HAA": 0.0, "RF_HFE": 0.4, "RF_KFE": -0.8,
        "LH_HAA": 0.0, "LH_HFE": -0.4, "LH_KFE": 0.8,
        "RH_HAA": 0.0, "RH_HFE": -0.4, "RH_KFE": 0.8,
    })
    kw.setdefault("p_gain", 80.0)
    kw.setdefault("d_gain", 2.0)
    kw.setdefault("action_scale", 0.5)
    kw.setdefault("base_height", 0.6)
    kw.setdefault("base_height_target", 0.5)
    kw.setdefault("foot_name", "FOOT")
    kw.setdefault("penalize_on", ("SHANK", "THIGH"))
    kw.setdefault("terminate_on", ("base",))
    return kw


def make_a1_env(urdf_path: str = A1_URDF, **kw):
    return make_velocity_env(urdf_path, **kw)


# ANYmal-C reward scales: upstream legged_gym's base scales with the
# anymal_c_flat overrides (orientation -5.0, torques -2.5e-5,
# feet_air_time 2.0).
ANYMAL_FLAT_REWARD_SCALES = (
    ("tracking_lin_vel", 1.0),
    ("tracking_ang_vel", 0.5),
    ("lin_vel_z", -2.0),
    ("ang_vel_xy", -0.05),
    ("orientation", -5.0),
    ("torques", -2.5e-5),
    ("dof_acc", -2.5e-7),
    ("feet_air_time", 2.0),
    ("collision", -1.0),
    ("action_rate", -0.01),
    ("termination", -0.0),
)
# rough terrain: upstream's base scales (torques -1e-5, feet_air_time 1.0,
# no orientation term)
ANYMAL_ROUGH_REWARD_SCALES = (
    ("tracking_lin_vel", 1.0),
    ("tracking_ang_vel", 0.5),
    ("lin_vel_z", -2.0),
    ("ang_vel_xy", -0.05),
    ("torques", -1.0e-5),
    ("dof_acc", -2.5e-7),
    ("feet_air_time", 1.0),
    ("collision", -1.0),
    ("action_rate", -0.01),
    ("termination", -0.0),
)


def make_anymal_c_env(urdf_path: str = ANYMAL_C_URDF, **kw):
    kw.setdefault("reward_scales", ANYMAL_FLAT_REWARD_SCALES)
    return make_velocity_env(urdf_path, **_anymal_c_kwargs(kw))


def make_anymal_b_env(urdf_path: str = ANYMAL_B_URDF, **kw):
    """ANYmal B velocity task: ANYmal C's settings on the anymal_b URDF."""
    kw.setdefault("reward_scales", ANYMAL_FLAT_REWARD_SCALES)
    return make_velocity_env(urdf_path, **_anymal_c_kwargs(kw))


def _rough_terrain(num_envs: int, num_rows: int, num_cols: int):
    from ..utils.terrain import Terrain, TerrainCfg

    return Terrain(TerrainCfg(mesh_type="trimesh", num_rows=num_rows,
                              num_cols=num_cols, curriculum=True),
                   num_robots=num_envs)


def make_anymal_c_rough_env(num_envs: int = 4096, terrain_rows: int = 10,
                            terrain_cols: int = 20,
                            urdf_path: str = ANYMAL_C_URDF, **kw):
    """ANYmal C on the procedural curriculum terrain with the perceptive
    height scan (235 observations), max_contact_force 500 and a base
    payload of +-5 kg."""
    kw.setdefault("reward_scales", ANYMAL_ROUGH_REWARD_SCALES)
    kw = _anymal_c_kwargs(kw)
    kw.setdefault("measure_heights", True)
    kw.setdefault("max_contact_force", 500.0)
    kw.setdefault("randomize_base_mass", True)
    kw.setdefault("added_mass_range", (-5.0, 5.0))
    if "terrain" not in kw:  # the procedural build only when none is given
        kw["terrain"] = _rough_terrain(num_envs, terrain_rows, terrain_cols)
    return make_velocity_env(urdf_path, num_envs=num_envs, **kw)


def make_anymal_c_rough_trajectory_env(num_envs: int = 4096,
                                       terrain_rows: int = 10,
                                       terrain_cols: int = 20,
                                       urdf_path: str = ANYMAL_C_URDF, **kw):
    """ANYmal C tracking a ROM trajectory on the curriculum terrain, with
    the height scan (252 observations)."""
    kw = _anymal_c_kwargs(kw)
    kw.setdefault("measure_heights", True)
    kw.setdefault("max_contact_force", 500.0)
    if "terrain" not in kw:
        kw["terrain"] = _rough_terrain(num_envs, terrain_rows, terrain_cols)
    return make_trajectory_env(urdf_path, num_envs=num_envs, **kw)


def make_anymal_c_trajectory_env(urdf_path: str = ANYMAL_C_URDF, **kw):
    """ANYmal C (or a robot with its joint and link names) on the
    trajectory-tracking task (flat variant)."""
    kw = _anymal_c_kwargs(kw)
    kw.setdefault("max_contact_force", 350.0)
    return make_trajectory_env(urdf_path, **kw)


def make_a1_trajectory_env(urdf_path: str = A1_URDF, **kw):
    return make_trajectory_env(urdf_path, **kw)


def make_anymal_c_lstm_env(**kw):
    """ANYmal C with the ANYdrive LSTM actuator net (``ACTUATOR_NET_PATH``)
    in place of PD."""
    env = make_anymal_c_env(**kw)
    return env.replace(actuator_net=ActuatorNetLSTM.from_torchscript(
        ACTUATOR_NET_PATH, device=env.device))


def make_adam_env(**kw):
    """The Adam biped. The reference project ships no Adam URDF, so the
    file comes from the caller (``urdf_path``); rewards as A1's with the
    bipeds' single-stance ``no_fly`` term."""
    urdf = kw.pop("urdf_path", None)
    if urdf is None:
        raise FileNotFoundError("no Adam URDF in the reference project; "
                                "pass urdf_path=")
    kw.setdefault("reward_scales", A1_REWARD_SCALES + (("no_fly", 0.25),))
    kw.setdefault("terminate_on", ("base", "trunk", "pelvis"))
    return make_velocity_env(urdf, **kw)


# Cassie's crouched standing pose (an all-zero straight-legged pose is
# kinematically singular)
CASSIE_DEFAULT_ANGLES = {
    "hip_abduction_left": 0.1, "hip_rotation_left": 0.0,
    "hip_flexion_left": 1.0, "thigh_joint_left": -1.8,
    "ankle_joint_left": 1.57, "toe_joint_left": -1.57,
    "hip_abduction_right": -0.1, "hip_rotation_right": 0.0,
    "hip_flexion_right": 1.0, "thigh_joint_right": -1.8,
    "ankle_joint_right": 1.57, "toe_joint_right": -1.57,
}


def make_cassie_env(urdf_path: str = CASSIE_URDF, **kw):
    """Cassie: 2.5 ms substeps at the 50 Hz policy rate (8 a step),
    contact 20000/100, per-joint PD tables, action scale 0.25, the command
    curriculum from +-0.4 m/s, termination -50 and the bipeds' ``no_fly``
    term."""
    kw.setdefault("default_angles", CASSIE_DEFAULT_ANGLES)
    kw.setdefault("sim_dt", 0.0025)
    kw.setdefault("sim_decimation", 8)
    kw.setdefault("contact", ContactParams.create(
        stiffness=20000.0, damping=100.0, device=kw.get("device")))
    kw.setdefault("p_gain", {"hip_abduction": 100.0, "hip_rotation": 100.0,
                             "hip_flexion": 200.0, "thigh_joint": 200.0,
                             "ankle_joint": 200.0, "toe_joint": 40.0})
    kw.setdefault("d_gain", {"hip_abduction": 3.0, "hip_rotation": 3.0,
                             "hip_flexion": 6.0, "thigh_joint": 6.0,
                             "ankle_joint": 6.0, "toe_joint": 1.0})
    kw.setdefault("action_scale", 0.25)
    kw.setdefault("command_curriculum", True)
    kw.setdefault("init_lin_vel_range", 0.4)
    kw.setdefault("base_height", 1.0)
    kw.setdefault("base_height_target", 0.9)
    kw.setdefault("foot_name", "toe")
    kw.setdefault("penalize_on", ())
    kw.setdefault("terminate_on", ("pelvis",))
    kw.setdefault("only_positive_rewards", False)
    kw.setdefault("max_contact_force", 300.0)
    kw.setdefault("reward_scales", (
        ("tracking_lin_vel", 1.0),
        ("tracking_ang_vel", 1.0),
        ("lin_vel_z", -0.5),
        ("torques", -5.0e-6),
        ("dof_acc", -2.0e-7),
        ("feet_air_time", 5.0),
        ("dof_pos_limits", -1.0),
        ("no_fly", 0.25),
        ("action_rate", -0.01),
        ("termination", -50.0),
    ))
    return make_velocity_env(urdf_path, **kw)


# The reference project's hopper URDF (relative to its root); not in this
# repository.
HOPPER_URDF = "resources/robots/hopper/urdf/hopper.urdf"

# Rows map body-frame wheel torques to the three wheel actuators.
HOPPER_ROT_ACTUATOR = [
    [-0.8165, 0.2511, 0.2511],
    [-0.0, -0.7643, 0.7643],
    [-0.5773, -0.5939, -0.5939],
]

# configs/rl/hopper_single_int.yaml reward scales
HOPPER_REWARD_SCALES = (
    ("termination", -500.0),
    ("tracking_rom", 6.0),
    ("ang_vel_xy", -0.01),
    ("orientation", -80.0),
    ("torques", -0.000001),
    ("dof_acc", -2.5e-8),
    ("unit_quat", -0.01),
    ("collision", -1.0),
    ("action_rate", -0.01),
    ("differential_error", 10.0),
    ("raibert", -0.1),
)


def _hopper_sim(urdf_path, dev):
    """The hopper's sim: dt 2.5 ms, decimation 8 (50 Hz policy), stiff
    compliant contact; its foot spring is the controller's."""
    return RobotSim.create(
        RobotModel.from_spec(parse_urdf(urdf_path)),
        contact=ContactParams.create(stiffness=16000.0, damping=80.0,
                                     friction=1.0, slip_vel=0.05,
                                     device=dev),
        dt=0.0025, decimation=8, device=dev)


def _hopper_controller(dev, p_gains, d_gains, spring_stiffness,
                       spring_damping, foot_pos_des):
    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    return dict(
        p_gains=t(p_gains), d_gains=t(d_gains),
        kd_spindown=t([0.1, 0.1, 0.1]),
        spring_stiffness=f32(spring_stiffness),
        spring_damping=f32(spring_damping), spring_setpoint=0.0,
        foot_pos_des=f32(foot_pos_des),
        rot_actuator=t(HOPPER_ROT_ACTUATOR),
        torque_limits=t([25000.0, 2.1, 2.1, 2.1]),
        wheel_speed_limit=600.0, ts_ratio=6.0, tracking_sigma=0.25)


def _hopper_obs_vectors(mid_scales, dev):
    """(obs_scales, noise_vec): z, quat, lin vel, ang vel, wheel vels, the
    task's block (scales ``mid_scales``, no noise), action quat."""
    n = len(mid_scales)
    scales = np.concatenate([[1.0], np.ones(4), 0.5 * np.ones(3),
                             0.25 * np.ones(3), 0.01 * np.ones(3),
                             mid_scales, np.ones(4)])
    noise = np.concatenate([[0.02], 0.05 * np.ones(4), 0.1 * 0.5 * np.ones(3),
                            0.2 * 0.25 * np.ones(3),
                            1.5 * 0.01 * np.ones(3), np.zeros(n),
                            np.zeros(4)])
    return tuple(torch.as_tensor(x.astype(np.float32), device=dev)
                 for x in (scales, noise))


def make_hopper_trajectory_env(
        num_envs: int = 4096, vel_max: float = 0.2, rom_dt: float = 0.1,
        n_traj: int = 10, episode_length_s: float = 20.0,
        add_noise: bool = True, domain_rand: bool = True,
        push_robots: bool = True,
        max_push_vel=(0.25, 0.25, 0.25, 0.75, 0.75, 0.75),
        time_between_pushes=(0.5, 10.0), push_interval_s=None,
        urdf_path: str = HOPPER_URDF, reward_scales=HOPPER_REWARD_SCALES,
        curriculum=None, weight_sampler=None, device=None):
    """Hopper tracking a SingleInt2D ROM.

    ``curriculum``: None (off), "single_int" (the 8-stage schedule) or
    "default" (the 3-stage tables). Pushes SET the 6-dim base velocity on
    per-env timers in ``time_between_pushes`` seconds; ``push_interval_s``
    is a legacy alias mapped onto the timer, ``(min(0.5, s), s)``.
    ``weight_sampler``: None (the sampler without the ramp mode), a
    ``SAMPLER_REGISTRY`` name (e.g. "UniformWeightSamplerTurnBiased") or a
    sampler instance. ``device=None`` means the CUDA card."""
    from .hopper_trajectory import CurriculumTables, HopperTrajectoryEnv

    if push_interval_s is not None:
        time_between_pushes = (min(0.5, push_interval_s), push_interval_s)
    if weight_sampler is None:
        weight_sampler = UniformWeightSamplerNoRamp()
    elif isinstance(weight_sampler, str):
        weight_sampler = SAMPLER_REGISTRY[weight_sampler]()
    dev = resolve_device(device)
    rom = SingleInt2D.create(rom_dt, [-10.0, -10.0], [10.0, 10.0],
                             [-vel_max, -vel_max], [vel_max, vel_max],
                             device=dev)
    gen = TrajectoryGenerator.create(
        rom, UniformSampleHoldDT.create(2.0, 6.0), weight_sampler,
        dt_loop=0.02, N=n_traj, dN=1, freq_low=0.01, freq_high=2.0,
        prob_stationary=0.01)
    obs_scales, noise_vec = _hopper_obs_vectors(np.ones(2 * n_traj), dev)
    tables = {
        None: None,
        "default": CurriculumTables.default().replace(enabled=True),
        "single_int": CurriculumTables.hopper_single_int(),
    }[curriculum]
    return HopperTrajectoryEnv(
        sim=_hopper_sim(urdf_path, dev), traj_gen=gen, curriculum=tables,
        **_hopper_controller(dev, [400.0, 15.0, 15.0, 15.0],
                             [40.0, 3.0, 3.0, 3.0], 11732.0, 50.0, 0.03),
        obs_scales=obs_scales, noise_vec=noise_vec,
        reward_weighting=torch.ones(2, device=dev),
        raibert=RaibertHeuristic.create(-0.3, -0.9, 0.0, 0.5, 1.0, 0.2),
        reward_scales=tuple(reward_scales), add_noise=add_noise,
        domain_rand=domain_rand, push_robots=push_robots,
        max_push_vel=tuple(max_push_vel),
        time_between_pushes=tuple(time_between_pushes),
        episode_length_s=episode_length_s, num_envs=num_envs)


def make_hopper_velocity_env(num_envs: int = 4096, add_noise: bool = True,
                             domain_rand: bool = True,
                             episode_length_s: float = 20.0,
                             urdf_path: str = HOPPER_URDF,
                             reward_scales=None, device=None):
    """Velocity-command hopper: the trajectory hopper's physics with
    commands in place of the ROM window (spring 7000/4, foot PD 900/60,
    wheels 15/3, foot setpoint 0.021). ``device=None`` means the CUDA
    card."""
    from .hopper_velocity import (
        HOPPER_VELOCITY_REWARD_SCALES,
        HopperVelocityEnv,
    )

    dev = resolve_device(device)
    obs_scales, noise_vec = _hopper_obs_vectors([0.5, 0.5, 0.25], dev)
    return HopperVelocityEnv(
        sim=_hopper_sim(urdf_path, dev),
        **_hopper_controller(dev, [900.0, 15.0, 15.0, 15.0],
                             [60.0, 3.0, 3.0, 3.0], 7000.0, 4.0, 0.021),
        obs_scales=obs_scales, noise_vec=noise_vec,
        command_ranges=torch.tensor([[-0.35, 0.35], [-0.35, 0.35],
                                     [-1.0, 1.0]], device=dev),
        max_push_vel=torch.tensor([0.25, 0.25, 0.1, 0.75, 0.75, 0.75],
                                  device=dev),
        reward_scales=(tuple(reward_scales) if reward_scales is not None
                       else HOPPER_VELOCITY_REWARD_SCALES),
        add_noise=add_noise, domain_rand=domain_rand,
        episode_length_s=episode_length_s, num_envs=num_envs)


def make_rom_tracking_env(num_envs: int = 4096,
                          episode_length_s: float = 8.0,
                          rom_dt: float = 0.1, dt_loop: float = 0.05,
                          add_noise: bool = False, device=None):
    """A double integrator (dt ``dt_loop``) tracking a SingleInt2D ROM
    (dt ``rom_dt``). ``add_noise`` is accepted for a uniform factory
    interface and ignored: this env has no observation noise.
    ``device=None`` means the CUDA card."""
    del add_noise
    dev = resolve_device(device)
    rom = SingleInt2D.create(rom_dt, [-10, -10], [10, 10], [-1, -1], [1, 1],
                             device=dev)
    model = DoubleInt2D.create(dt_loop, [-20, -20, -2, -2], [20, 20, 2, 2],
                               [-4, -4], [4, 4], device=dev)
    gen = TrajectoryGenerator.create(
        rom, UniformSampleHoldDT.create(0.5, 2.0), UniformWeightSampler(),
        dt_loop=dt_loop, N=4, dN=1, prob_stationary=0.01)
    sim = RomSim.create(model, gen, num_envs=num_envs,
                        init_noise_lower=[-0.5, -0.5, -0.1, -0.1],
                        init_noise_upper=[0.5, 0.5, 0.1, 0.1],
                        max_rom_distance=[0.3, 0.3])
    return RomTrackingEnv(sim=sim,
                          reward_weighting=torch.tensor([1.0, 1.0],
                                                        device=dev),
                          tracking_sigma=f32(0.25),
                          episode_length_s=episode_length_s)


# the reference PPO block (the hopper's [128, 64, 32] nets are the policy's)
HOPPER_PPO = PPOConfig()

task_registry.register("hopper_trajectory", make_hopper_trajectory_env,
                       HOPPER_PPO)
task_registry.register("rom_tracking", make_rom_tracking_env, PPOConfig())
task_registry.register("a1_velocity", make_a1_env, PPOConfig())
task_registry.register("anymal_c_velocity", make_anymal_c_env, PPOConfig())
task_registry.register("anymal_c_trajectory", make_anymal_c_trajectory_env,
                       PPOConfig())
task_registry.register("a1_trajectory", make_a1_trajectory_env, PPOConfig())
task_registry.register("anymal_c_lstm", make_anymal_c_lstm_env, PPOConfig())
task_registry.register("cassie_velocity", make_cassie_env, PPOConfig())
task_registry.register("hopper_velocity", make_hopper_velocity_env,
                       HOPPER_PPO)
task_registry.register("anymal_b_velocity", make_anymal_b_env, PPOConfig())
task_registry.register("anymal_c_rough", make_anymal_c_rough_env,
                       PPOConfig())
task_registry.register("anymal_c_rough_trajectory",
                       make_anymal_c_rough_trajectory_env, PPOConfig())
task_registry.register("adam_velocity", make_adam_env, PPOConfig())
