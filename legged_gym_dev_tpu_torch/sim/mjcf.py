"""MJCF construction for sim2sim validation against MuJoCo.

Counterpart of ``legged_gym_dev_tpu/sim/mjcf.py``. The export reads the
model's float32 numpy constants with numpy and scipy alone (it needs no
mujoco): for the same ``RobotSpec`` the XML string is the JAX package's,
character for character. Builds an equivalent MuJoCo model from
a parsed URDF spec (same numbers, quaternions derived from the same rpy->R
conversion to sidestep euler-convention ambiguity). Used by the sim2sim
evaluation (``evaluation.evaluate_sim2sim_hopper``) and the renderers
(``utils.video``, ``utils.live_viewer``).

The MJCF is emitted from the COMPOSED ``RobotModel`` (fixed-joint subtrees
merged into their moving parent, same collapse as the simulator itself and
Isaac Gym's importer) with the true nested body topology — a flat export of
raw link inertials drops the mass of fixed links (e.g. 46 of ANYmal-C's
52 kg live on fixed links) and mis-places chained joints.
"""
from __future__ import annotations

import numpy as np
from scipy.spatial.transform import Rotation

from .dynamics import PRISMATIC, RobotModel
from .urdf import RobotSpec


def build_mjcf(spec: RobotSpec, timestep: float = 0.005) -> str:
    return build_mjcf_from_model(RobotModel.from_spec(spec),
                                 timestep=timestep)


def _quat_wxyz(R) -> str:
    q = Rotation.from_matrix(np.asarray(R)).as_quat()
    return f"{q[3]} {q[0]} {q[1]} {q[2]}"


def _inertial_xml(model: RobotModel, b: int) -> str:
    com = np.asarray(model.com[b])
    I = np.asarray(model.inertia[b])
    return (f'<inertial pos="{com[0]} {com[1]} {com[2]}" '
            f'mass="{float(model.mass[b])}" '
            f'fullinertia="{I[0,0]} {I[1,1]} {I[2,2]} '
            f'{I[0,1]} {I[0,2]} {I[1,2]}"/>')


def _visual_geoms(model: RobotModel, b: int, children) -> str:
    """Skeleton visuals for body ``b``: a COM sphere, a capsule "bone" to
    every child joint frame, and contact-point spheres (collision-disabled:
    rendering only — physics stays in the port's sim). The reference renders
    URDF meshes in the Isaac viewer (ref legged_gym/envs/base/
    base_task.py:120-148); the meshes are LFS-missing from the reference
    checkout, so a skeleton render is the honest equivalent."""
    parts = []
    com = np.asarray(model.com[b])
    parts.append(
        f'<geom type="sphere" size="0.035" pos="{com[0]} {com[1]} {com[2]}" '
        f'rgba="0.85 0.3 0.2 1" contype="0" conaffinity="0" mass="0"/>')
    for c in children[b]:
        p = np.asarray(model.origin_pos[c - 1])
        if np.linalg.norm(p) > 1e-6:
            parts.append(
                f'<geom type="capsule" size="0.02" '
                f'fromto="0 0 0 {p[0]} {p[1]} {p[2]}" '
                f'rgba="0.3 0.45 0.7 1" contype="0" conaffinity="0" '
                f'mass="0"/>')
    for ci, cb in enumerate(model.contact_body):
        if cb != b:
            continue
        off = np.asarray(model.contact_offset[ci])
        r = max(float(model.contact_radius[ci]), 0.015)
        parts.append(
            f'<geom type="sphere" size="{r}" '
            f'pos="{off[0]} {off[1]} {off[2]}" rgba="0.2 0.7 0.3 1" '
            f'contype="0" conaffinity="0" mass="0"/>')
    return "\n".join(parts)


def build_mjcf_from_model(model: RobotModel, timestep: float = 0.005,
                          visual: bool = False) -> str:
    """Nested-body MJCF mirroring the composed articulated tree.

    ``visual=True`` adds skeleton geoms, a checker ground plane and a light
    so the model renders with ``mujoco.Renderer`` (utils/video.py); geoms
    are collision- and mass-free, so the physics-validation role of the
    export is unchanged."""
    children = [[] for _ in range(model.nb)]
    for j in range(model.nj):
        children[model.parent[j]].append(j + 1)

    def body_xml(b: int) -> str:
        j = b - 1
        pos = np.asarray(model.origin_pos[j])
        ax = np.asarray(model.axis[j])
        jtype = "slide" if model.jtype[j] == PRISMATIC else "hinge"
        name = (model.body_names[b] if model.body_names
                else f"body_{b}")
        jname = model.dof_names[j]
        inner = "\n".join(body_xml(c) for c in children[b])
        vis = _visual_geoms(model, b, children) if visual else ""
        return (
            f'<body name="{name}" pos="{pos[0]} {pos[1]} {pos[2]}" '
            f'quat="{_quat_wxyz(model.origin_rot[j])}">\n'
            f'<joint name="{jname}" type="{jtype}" '
            f'axis="{ax[0]} {ax[1]} {ax[2]}" limited="false"/>\n'
            f'{_inertial_xml(model, b)}\n{vis}\n{inner}\n</body>'
        )

    root_name = model.body_names[0] if model.body_names else "base"
    inner = "\n".join(body_xml(c) for c in children[0])
    g = np.asarray(model.gravity)
    assets, world_extra, root_vis = "", "", ""
    if visual:
        assets = (
            '<asset><texture type="skybox" builtin="gradient" '
            'rgb1="0.6 0.75 0.9" rgb2="0.9 0.95 1.0" '
            'width="128" height="128"/>'
            '<texture name="grid" type="2d" builtin="checker" '
            'rgb1="0.22 0.26 0.3" rgb2="0.3 0.34 0.38" '
            'width="256" height="256"/>'
            '<material name="grid" texture="grid" texrepeat="8 8" '
            'reflectance="0.1"/></asset>'
            '<visual><global offwidth="1280" offheight="720"/></visual>'
        )
        world_extra = (
            '<light directional="true" pos="0 0 4" dir="0 -0.2 -1" '
            'diffuse="0.9 0.9 0.9"/>'
            '<geom name="floor" type="plane" size="20 20 0.1" '
            'material="grid" contype="0" conaffinity="0"/>'
        )
        root_vis = _visual_geoms(model, 0, children)
    return f"""<mujoco>{assets}<option gravity="{g[0]} {g[1]} {g[2]}" timestep="{timestep}"/>
    <worldbody>{world_extra}<body name="{root_name}" pos="0 0 0">
      <freejoint/>
      {_inertial_xml(model, 0)}
      {root_vis}
      {inner}
    </body></worldbody></mujoco>"""
