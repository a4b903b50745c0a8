"""Robots written into the tests, as URDF strings (``parse_urdf`` takes a
string), and the random single-step inputs the substep is held on.

JAX-free: ``chip_smoke.py`` and the card tests import it on a machine
without JAX.

- ``QUADRUPED_URDF``: a 12-revolute-joint quadruped with ANYmal-C's
  topology and joint and link names (LF/RF/LH/RH legs of HAA, HFE, KFE;
  ``*_FOOT`` links on fixed joints, a fixed ``base_inertia`` link), so the
  kernel's widths are ANYmal-C's: nj=12, nv=18, nb=13. Masses, lengths and
  limits are close to ANYmal-C's; the contact spheres (13) are this file's.
- ``HOPPER4_URDF``: a 4-joint robot with a prismatic foot (joint springs
  act on it) and three revolute flywheels whose joint frames are rotated,
  covering the kernel's prismatic and spring rows.
- ``HOPPER_URDF``: the hopper of the hopper tasks: a torso, a prismatic
  foot (the controller's spring acts on it) and three rotated revolute
  reaction wheels, each link with one collision sphere, in the order the
  tasks index them (torso 0, foot 1, wheels 2-4; nj=4, nc=5). Effort
  limits are the task's torque limits (25000 N foot, 2.1 Nm wheels), the
  wheels' speed limit 600 rad/s; masses and sizes are this file's.
"""
import numpy as np

_LEGS = {"LF": (1, 1), "RF": (1, -1), "LH": (-1, 1), "RH": (-1, -1)}


def _inertial(mass, com, ixx, iyy, izz, ixy=0.0):
    return (f'<inertial><origin xyz="{com[0]} {com[1]} {com[2]}"/>'
            f'<mass value="{mass}"/><inertia ixx="{ixx}" ixy="{ixy}" '
            f'ixz="0" iyy="{iyy}" iyz="0" izz="{izz}"/></inertial>')


def _sphere(xyz, r, kind="sphere"):
    geom = (f'<sphere radius="{r}"/>' if kind == "sphere"
            else f'<cylinder radius="{r}" length="0.2"/>')
    return (f'<collision><origin xyz="{xyz[0]} {xyz[1]} {xyz[2]}"/>'
            f'<geometry>{geom}</geometry></collision>')


def _joint(name, kind, parent, child, xyz, axis="0 1 0", rpy="0 0 0",
           lower=None, upper=None, effort=80.0, velocity=7.5):
    lim = ("" if kind == "fixed" else
           f'<limit lower="{lower}" upper="{upper}" effort="{effort}" '
           f'velocity="{velocity}"/>')
    ax = "" if kind == "fixed" else f'<axis xyz="{axis}"/>'
    return (f'<joint name="{name}" type="{kind}"><parent link="{parent}"/>'
            f'<child link="{child}"/><origin xyz="{xyz[0]} {xyz[1]} '
            f'{xyz[2]}" rpy="{rpy}"/>{ax}{lim}</joint>')


def _quadruped():
    parts = ['<robot name="quadruped">',
             '<link name="base">' + _inertial(6.2, (-0.018, -0.002, 0.024),
                                              0.024, 0.065, 0.073)
             + '<collision><geometry><box size="0.531 0.27 0.24"/>'
             '</geometry></collision></link>',
             '<link name="base_inertia">'
             + _inertial(16.8, (-0.002, 0.0, 0.0), 0.26, 0.52, 0.55, 0.001)
             + '</link>',
             _joint("base_to_base_inertia", "fixed", "base", "base_inertia",
                    (0, 0, 0))]
    for leg, (sx, sy) in _LEGS.items():
        haa_lo, haa_hi = (-0.72, 0.49) if sy > 0 else (-0.49, 0.72)
        parts += [
            f'<link name="{leg}_HIP">'
            + _inertial(1.42, (sx * 0.064, sy * -0.003, 0.0), 0.0024,
                        0.0023, 0.0039) + '</link>',
            f'<link name="{leg}_THIGH">'
            + _inertial(1.634, (0.0, sy * 0.018, -0.169), 0.0204, 0.0207,
                        0.0026)
            + _sphere((0.0, sy * 0.035, -0.12), 0.055, "cylinder")
            + '</link>',
            f'<link name="{leg}_SHANK">'
            + _inertial(0.207, (sx * 0.03, sy * -0.005, -0.008), 0.0004,
                        0.0006, 0.0004)
            + _sphere((sx * 0.05, 0.0, -0.15), 0.04, "cylinder")
            + '</link>',
            f'<link name="{leg}_FOOT">'
            + _inertial(0.14, (0.0, 0.0, 0.0), 2e-5, 2e-5, 2e-5)
            + _sphere((0.0, 0.0, 0.0), 0.031) + '</link>',
            _joint(f"{leg}_HAA", "revolute", "base", f"{leg}_HIP",
                   (sx * 0.2999, sy * 0.104, 0.0), axis="1 0 0",
                   lower=haa_lo, upper=haa_hi),
            _joint(f"{leg}_HFE", "revolute", f"{leg}_HIP", f"{leg}_THIGH",
                   (sx * 0.0599, sy * 0.08381, 0.0), lower=-9.42,
                   upper=9.42),
            _joint(f"{leg}_KFE", "revolute", f"{leg}_THIGH", f"{leg}_SHANK",
                   (0.0, sy * 0.1003, -0.285), lower=-9.42, upper=9.42),
            _joint(f"{leg}_SHANK_TO_FOOT", "fixed", f"{leg}_SHANK",
                   f"{leg}_FOOT", (sx * 0.08795, sy * 0.01305, -0.33797)),
        ]
    return "".join(parts) + "</robot>"


QUADRUPED_URDF = _quadruped()

HOPPER4_URDF = "".join([
    '<robot name="hopper4">',
    '<link name="torso">' + _inertial(4.5, (0.0, 0.0, 0.02), 0.06, 0.06,
                                      0.04)
    + '<collision><geometry><box size="0.2 0.2 0.2"/></geometry>'
    '</collision></link>',
    '<link name="foot">' + _inertial(0.5, (0.0, 0.0, -0.25), 0.003, 0.003,
                                     0.0005)
    + _sphere((0.0, 0.0, -0.45), 0.03) + '</link>',
    '<link name="wheel1">' + _inertial(0.4, (0, 0, 0), 0.001, 0.001, 0.002)
    + '</link>',
    '<link name="wheel2">' + _inertial(0.4, (0, 0, 0), 0.001, 0.001, 0.002)
    + '</link>',
    '<link name="wheel3">' + _inertial(0.4, (0, 0, 0), 0.001, 0.001, 0.002)
    + '</link>',
    _joint("foot_slide", "prismatic", "torso", "foot", (0.0, 0.0, -0.1),
           axis="0 0 1", lower=-0.15, upper=0.15, effort=1000.0,
           velocity=20.0),
    _joint("wheel1_joint", "revolute", "torso", "wheel1", (0.1, 0.0, 0.05),
           axis="0 0 1", rpy="0 1.5708 0", lower=-1e9, upper=1e9,
           effort=2.1, velocity=600.0),
    _joint("wheel2_joint", "revolute", "torso", "wheel2",
           (-0.05, 0.087, 0.05), axis="0 0 1", rpy="1.5708 0 0.5236",
           lower=-1e9, upper=1e9, effort=2.1, velocity=600.0),
    _joint("wheel3_joint", "revolute", "torso", "wheel3",
           (-0.05, -0.087, 0.05), axis="0 0 1", rpy="-1.5708 0 -0.5236",
           lower=-1e9, upper=1e9, effort=2.1, velocity=600.0),
    "</robot>",
])

HOPPER_URDF = "".join([
    '<robot name="hopper">',
    '<link name="torso">' + _inertial(4.0, (0.0, 0.0, 0.02), 0.05, 0.05,
                                      0.035)
    + _sphere((0.0, 0.0, 0.0), 0.09) + '</link>',
    '<link name="foot">' + _inertial(0.4, (0.0, 0.0, -0.1), 0.002, 0.002,
                                     0.0004)
    + _sphere((0.0, 0.0, -0.18), 0.02) + '</link>',
    *(f'<link name="wheel{i}">' + _inertial(0.35, (0, 0, 0), 0.0008,
                                            0.0008, 0.0015)
      + _sphere((0, 0, 0), 0.06) + '</link>' for i in (1, 2, 3)),
    _joint("foot_slide", "prismatic", "torso", "foot", (0.0, 0.0, -0.2),
           axis="0 0 1", lower=-0.1, upper=0.2, effort=25000.0,
           velocity=20.0),
    _joint("wheel1_joint", "revolute", "torso", "wheel1", (0.1, 0.0, 0.05),
           axis="0 0 1", rpy="0 1.5708 0", lower=-1e9, upper=1e9,
           effort=2.1, velocity=600.0),
    _joint("wheel2_joint", "revolute", "torso", "wheel2",
           (-0.05, 0.087, 0.05), axis="0 0 1", rpy="1.5708 0 0.5236",
           lower=-1e9, upper=1e9, effort=2.1, velocity=600.0),
    _joint("wheel3_joint", "revolute", "torso", "wheel3",
           (-0.05, -0.087, 0.05), axis="0 0 1", rpy="-1.5708 0 -0.5236",
           lower=-1e9, upper=1e9, effort=2.1, velocity=600.0),
    "</robot>",
])

# Joint springs of the 4-joint robot (on the prismatic foot only).
HOPPER4_SPRINGS = dict(stiffness=[3000.0, 0.0, 0.0, 0.0],
                       damping=[30.0, 0.0, 0.0, 0.0],
                       setpoint=[0.02, 0.0, 0.0, 0.0])

# ANYmal-C's default joint angles (envs/presets.py _anymal_c_kwargs).
QUADRUPED_DEFAULT_Q = np.asarray([0.0, 0.4, -0.8] * 2 + [0.0, -0.4, 0.8] * 2,
                                 np.float32)

# Robot -> (URDF, sim settings, base height of the random states, the
# default joint angles the states scatter around). Sim settings follow the
# presets: the quadruped at dt 5 ms, contact 5000/50; the 4-joint robot as
# the hopper, dt 2.5 ms, contact 16000/80, slip 0.05.
ROBOTS = {
    "quadruped": dict(urdf=QUADRUPED_URDF, dt=0.005, decimation=4,
                      contact=dict(stiffness=5000.0, damping=50.0,
                                   friction=1.0, slip_vel=0.1),
                      springs=None, height=0.56, q0=QUADRUPED_DEFAULT_Q),
    "hopper4": dict(urdf=HOPPER4_URDF, dt=0.0025, decimation=8,
                    contact=dict(stiffness=16000.0, damping=80.0,
                                 friction=1.0, slip_vel=0.05),
                    springs=HOPPER4_SPRINGS, height=0.5,
                    q0=np.zeros(4, np.float32)),
    # the hopper tasks' sim (no joint springs: the controller's spring)
    "hopper": dict(urdf=HOPPER_URDF, dt=0.0025, decimation=8,
                   contact=dict(stiffness=16000.0, damping=80.0,
                                friction=1.0, slip_vel=0.05),
                   springs=None, height=0.38,
                   q0=np.asarray([0.03, 0.0, 0.0, 0.0], np.float32)),
}


def substep_inputs(robot, B, seed, dr=False):
    """Random well-conditioned single-step inputs (numpy), drawn as the
    JAX package's tests/test_pallas_substep.py draws them, around a base
    height at which most envs touch the ground; with ``dr``, per-env DR
    rows as the envs make them: friction (B, 1, 1), contact stiffness and
    damping multipliers (B, 1), base payload mass (B,)."""
    cfg = ROBOTS[robot]
    nj = len(cfg["q0"])
    rng = np.random.default_rng(seed)
    f32 = np.float32
    out = dict(
        base_pos=(np.asarray([0.0, 0.0, cfg["height"]])
                  + rng.normal(0, 0.05, (B, 3))).astype(f32),
        base_quat=np.tile(np.asarray([0, 0, 0, 1], f32), (B, 1)),
        q=(cfg["q0"] + rng.normal(0, 0.1, (B, nj))).astype(f32),
        v=rng.normal(0, 0.3, (B, 6 + nj)).astype(f32),
        tau=rng.normal(0, 3.0, (B, nj)).astype(f32),
    )
    if dr:
        out.update(
            friction=rng.uniform(0.5, 1.25, (B, 1, 1)).astype(f32),
            stiff_mult=rng.uniform(0.7, 1.3, (B, 1)).astype(f32),
            damp_mult=rng.uniform(0.7, 1.3, (B, 1)).astype(f32),
            base_mass=rng.uniform(-1.0, 1.0, (B,)).astype(f32),
        )
    return out


def torch_sim(robot, device="cpu", inputs=None):
    """The port's ``RobotSim`` of a test robot; with DR ``inputs`` (from
    ``substep_inputs(..., dr=True)``) applied as the envs apply them."""
    import torch

    from legged_gym_dev_tpu_torch.sim.contact import ContactParams
    from legged_gym_dev_tpu_torch.sim.dynamics import RobotModel
    from legged_gym_dev_tpu_torch.sim.robot_sim import JointSprings, RobotSim
    from legged_gym_dev_tpu_torch.sim.urdf import parse_urdf

    cfg = ROBOTS[robot]
    model = RobotModel.from_spec(parse_urdf(cfg["urdf"]))
    springs = None
    if cfg["springs"] is not None:
        springs = JointSprings(*(torch.tensor(cfg["springs"][k],
                                              device=device)
                                 for k in ("stiffness", "damping",
                                           "setpoint")))
    contact = ContactParams.create(**cfg["contact"], device=device)
    sim = RobotSim.create(model, contact=contact, springs=springs,
                          dt=cfg["dt"], decimation=cfg["decimation"],
                          device=device)
    if inputs is not None and "friction" in inputs:
        t = {k: torch.as_tensor(inputs[k], device=device)
             for k in ("friction", "stiff_mult", "damp_mult", "base_mass")}
        sim = sim.replace(
            contact=contact.replace(
                friction=t["friction"],
                stiffness=contact.stiffness * t["stiff_mult"],
                damping=contact.damping * t["damp_mult"]),
            base_mass_delta=t["base_mass"])
    return sim


def torch_state(inputs, device="cpu"):
    """(RobotState, tau) of ``substep_inputs`` on ``device``."""
    import torch

    from legged_gym_dev_tpu_torch.sim.dynamics import RobotState

    t = {k: torch.as_tensor(inputs[k], device=device)
         for k in ("base_pos", "base_quat", "q", "v", "tau")}
    return RobotState(t["base_pos"], t["base_quat"], t["q"], t["v"]), t["tau"]


# Broadcast forms of the per-env contact parameters the substep kernel's
# table reads (stride 0 along what is broadcast).
DR_FORMS = ("scalar", "per_sphere", "B1", "B11", "Bnc")


def dr_form_sims(sim, form, B, payload, seed=0):
    """Two sims with the same contact stiffness and damping multipliers and
    friction, drawn with numpy: the first holds each in one broadcast form
    of ``DR_FORMS`` (scalar, (nc,), (B, 1), (B, 1, 1), (B, nc)), as the
    kernel's table reads them; the second as (B, nc), (B, nc) and
    (B, nc, 1), the shapes the plain contact model broadcasts. With
    ``payload`` both carry a (B,) base payload mass."""
    import torch

    nc = len(sim.model.contact_body)
    dev = sim.contact.stiffness.device
    rng = np.random.default_rng(seed)
    shape = {"scalar": (), "per_sphere": (nc,), "B1": (B, 1),
             "B11": (B, 1, 1), "Bnc": (B, nc)}[form]

    def draw(shape, lo=0.5, hi=1.5):
        return torch.as_tensor(rng.uniform(lo, hi, shape).astype(np.float32),
                               device=dev)

    def full(p):
        return (p.reshape(B, -1) if p.ndim == 3 else p).expand(B, nc)

    c = sim.contact
    k, d, mu = c.stiffness * draw(shape), c.damping * draw(shape), \
        draw(shape)
    bmd = draw((B,), -1.0, 1.0) if payload else None
    return (sim.replace(contact=c.replace(stiffness=k, damping=d,
                                          friction=mu),
                        base_mass_delta=bmd),
            sim.replace(contact=c.replace(stiffness=full(k), damping=full(d),
                                          friction=full(mu)[..., None]),
                        base_mass_delta=bmd))


def strided_state(state):
    """The same state handed as views, as the env can hand it on: base_pos,
    q and v as rows of one (n, B) tensor (strided), and env 0's base
    quaternion broadcast over the envs (``substep_inputs`` draws the same
    quaternion for every env)."""
    import torch

    B, nj = state.q.shape
    wide = torch.cat([state.base_pos, state.q, state.v], 1).t().contiguous()
    return type(state)(wide[0:3].t(), state.base_quat[:1].expand(B, 4),
                       wide[3:3 + nj].t(), wide[3 + nj:].t())
