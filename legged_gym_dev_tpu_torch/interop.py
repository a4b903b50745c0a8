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
