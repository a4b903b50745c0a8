"""Compliant sphere-vs-terrain contact model.

Counterpart of ``legged_gym_dev_tpu/sim/contact.py``: a spring-damper
normal force with a regularized Coulomb friction cone at the robot's
collision spheres. The port has flat terrain only: ``contact_forces``
takes a height function that carries an analytic ``value_and_grad``
(``flat_terrain`` does) and raises for any other.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..utils.runtime import resolve_device


@dataclasses.dataclass
class ContactParams:
    stiffness: torch.Tensor   # () or broadcastable per env: normal spring k
    damping: torch.Tensor     # () normal damper d
    friction: torch.Tensor    # () Coulomb mu, (B, 1, 1) under friction DR
    slip_vel: torch.Tensor    # () friction regularization velocity

    def replace(self, **kw) -> "ContactParams":
        return dataclasses.replace(self, **kw)

    @classmethod
    def create(cls, stiffness=5000.0, damping=50.0, friction=1.0,
               slip_vel=0.1, device=None):
        """Stable for bodies of at least ~0.15 kg at dt = 5 ms (explicit
        penalty + semi-implicit Euler: damping/m dt < 2 and
        sqrt(stiffness/m) dt < 2 for the lightest contacting body)."""
        dev = resolve_device(device)

        def f(x):
            return torch.as_tensor(x, dtype=torch.float32, device=dev)

        return cls(stiffness=f(stiffness), damping=f(damping),
                   friction=f(friction), slip_vel=f(slip_vel))


def _flat_value_and_grad(xy: torch.Tensor):
    return xy.new_zeros(xy.shape[:-1]), torch.zeros_like(xy)


def flat_terrain(xy: torch.Tensor) -> torch.Tensor:
    """Height 0 everywhere (plane). Signature: (..., 2) -> (...)."""
    return xy.new_zeros(xy.shape[:-1])


flat_terrain.value_and_grad = _flat_value_and_grad


def contact_forces(params: ContactParams, pos: torch.Tensor,
                   vel: torch.Tensor, radius: torch.Tensor,
                   terrain_fn: Callable = flat_terrain) -> torch.Tensor:
    """World-frame forces (..., nc, 3) on contact spheres at pos/vel
    (..., nc, 3) with radii (nc,)."""
    vag = getattr(terrain_fn, "value_and_grad", None)
    if vag is None:
        raise NotImplementedError(
            "the port has flat terrain only: the height function needs a "
            "value_and_grad")
    h, g = vag(pos[..., :2])
    n = torch.cat([-g, torch.ones_like(h)[..., None]], dim=-1)
    n = n / torch.linalg.vector_norm(n, dim=-1, keepdim=True)

    depth = (h + radius) - pos[..., 2]
    in_contact = depth > 0.0

    v_n = torch.sum(vel * n, dim=-1)
    fn_mag = params.stiffness * torch.clamp(depth, min=0.0) \
        - params.damping * v_n
    fn_mag = torch.where(in_contact, torch.clamp(fn_mag, min=0.0), 0.0)

    v_t = vel - v_n[..., None] * n
    vt_norm = torch.linalg.vector_norm(v_t, dim=-1, keepdim=True)
    ft = -params.friction * fn_mag[..., None] * v_t / (
        vt_norm + params.slip_vel)
    return fn_mag[..., None] * n + ft
