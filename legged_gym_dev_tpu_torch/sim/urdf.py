"""Minimal URDF parser for the robot zoo (numpy only).

A copy of ``legged_gym_dev_tpu/sim/urdf.py``, kept in the port so that the
port imports nothing of the JAX package. Parses links (mass, COM, inertia,
collision spheres), joints (revolute/prismatic/fixed with origins, axes,
limits) from a file path or a URDF string, and returns a kinematic-tree
spec ordered root-to-leaf.

Collision geometries are approximated by spheres (sphere directly;
cylinder/box by a sphere of the bounding radius at the origin): contact in
this engine is sphere-vs-terrain (see sim/contact.py).
"""
from __future__ import annotations

import dataclasses
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class LinkSpec:
    name: str
    mass: float
    com: np.ndarray                 # (3,) inertial origin in link frame
    inertia: np.ndarray             # (3,3) about COM, in inertial frame
    collision_spheres: List[Tuple[np.ndarray, float]]  # [(center, radius)]


@dataclasses.dataclass
class JointSpec:
    name: str
    joint_type: str                 # 'revolute' | 'prismatic' | 'fixed'
    parent: str
    child: str
    origin_pos: np.ndarray          # (3,) in parent frame
    origin_rpy: np.ndarray          # (3,) fixed-axis rpy
    axis: np.ndarray                # (3,) in child frame
    lower: float
    upper: float
    effort: float
    velocity: float


@dataclasses.dataclass
class RobotSpec:
    name: str
    root: str
    links: Dict[str, LinkSpec]
    joints: List[JointSpec]         # topologically ordered (parent first)

    @property
    def dof_names(self) -> List[str]:
        return [j.name for j in self.joints if j.joint_type != "fixed"]


def _floats(s: Optional[str], default):
    if s is None:
        return np.asarray(default, np.float64)
    return np.asarray([float(x) for x in s.split()], np.float64)


def _rpy_to_mat(rpy: np.ndarray) -> np.ndarray:
    r, p, y = rpy
    cr, sr, cp, sp, cy, sy = np.cos(r), np.sin(r), np.cos(p), np.sin(p), np.cos(y), np.sin(y)
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    return Rz @ Ry @ Rx


def _parse_link(el) -> LinkSpec:
    name = el.get("name")
    mass, com, inertia = 0.0, np.zeros(3), np.zeros((3, 3))
    inertial = el.find("inertial")
    if inertial is not None:
        mass_el = inertial.find("mass")
        mass = float(mass_el.get("value")) if mass_el is not None else 0.0
        origin = inertial.find("origin")
        com = _floats(origin.get("xyz") if origin is not None else None,
                      [0, 0, 0])
        rpy = _floats(origin.get("rpy") if origin is not None else None,
                      [0, 0, 0])
        in_el = inertial.find("inertia")
        if in_el is not None:
            ixx = float(in_el.get("ixx", 0))
            iyy = float(in_el.get("iyy", 0))
            izz = float(in_el.get("izz", 0))
            ixy = float(in_el.get("ixy", 0))
            ixz = float(in_el.get("ixz", 0))
            iyz = float(in_el.get("iyz", 0))
            inertia = np.array(
                [[ixx, ixy, ixz], [ixy, iyy, iyz], [ixz, iyz, izz]]
            )
        R = _rpy_to_mat(rpy)
        inertia = R @ inertia @ R.T  # rotate into link frame

    spheres = []
    for col in el.findall("collision"):
        origin = col.find("origin")
        center = _floats(origin.get("xyz") if origin is not None else None,
                         [0, 0, 0])
        geom = col.find("geometry")
        if geom is None:
            continue
        sph = geom.find("sphere")
        cyl = geom.find("cylinder")
        box = geom.find("box")
        if sph is not None:
            spheres.append((center, float(sph.get("radius"))))
        elif cyl is not None:
            spheres.append((center, float(cyl.get("radius"))))
        elif box is not None:
            size = _floats(box.get("size"), [0, 0, 0])
            spheres.append((center, float(np.linalg.norm(size) / 2)))
    return LinkSpec(name=name, mass=mass, com=com, inertia=inertia,
                    collision_spheres=spheres)


def parse_urdf(path_or_string: str) -> RobotSpec:
    if path_or_string.lstrip().startswith("<"):
        root_el = ET.fromstring(path_or_string)
    else:
        root_el = ET.parse(path_or_string).getroot()

    links = {l.name: l for l in (_parse_link(el)
                                 for el in root_el.findall("link"))}
    joints = []
    for el in root_el.findall("joint"):
        jtype = el.get("type")
        if jtype == "continuous":
            jtype = "revolute"
        origin = el.find("origin")
        limit = el.find("limit")
        axis_el = el.find("axis")
        joints.append(JointSpec(
            name=el.get("name"),
            joint_type=jtype,
            parent=el.find("parent").get("link"),
            child=el.find("child").get("link"),
            origin_pos=_floats(origin.get("xyz") if origin is not None else None,
                               [0, 0, 0]),
            origin_rpy=_floats(origin.get("rpy") if origin is not None else None,
                               [0, 0, 0]),
            axis=_floats(axis_el.get("xyz") if axis_el is not None else None,
                         [1, 0, 0]),
            lower=float(limit.get("lower", "-inf") or "-inf")
            if limit is not None else -np.inf,
            upper=float(limit.get("upper", "inf") or "inf")
            if limit is not None else np.inf,
            effort=float(limit.get("effort", "inf"))
            if limit is not None else np.inf,
            velocity=float(limit.get("velocity", "inf"))
            if limit is not None else np.inf,
        ))

    children = {j.child for j in joints}
    roots = [n for n in links if n not in children]
    if len(roots) != 1:
        raise ValueError(f"expected one root link, found {roots}")

    # Topological order (parent before child).
    ordered: List[JointSpec] = []
    placed = {roots[0]}
    pending = list(joints)
    while pending:
        progress = False
        for j in list(pending):
            if j.parent in placed:
                ordered.append(j)
                placed.add(j.child)
                pending.remove(j)
                progress = True
        if not progress:
            raise ValueError(f"disconnected joints: {[j.name for j in pending]}")

    return RobotSpec(name=root_el.get("name", "robot"), root=roots[0],
                     links=links, joints=ordered)
