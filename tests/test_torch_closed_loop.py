"""The port's receding-horizon closed loop (fast_tube.closed_loop_tube_mpc_fast)
against the JAX package's, vmapped over the same numpy-drawn gap batch:
B=3, N=20, a 3-tick loop with the DoubleInt2D plant of bench.py, an 8x6
first solve and 4x6 re-solves. This file runs the l1 tube;
tests/test_torch_closed_loop_nn.py runs NN_oneshot (refresh 3) through the
same check.

Bar: every trace (z, v, w, the plant's projection, the re-solve
violations) within 2e-3 and the adoption flags equal.
"""
import numpy as np

import jax

from legged_gym_dev_tpu.core import make_rom as jax_make_rom
from legged_gym_dev_tpu.solver import ALConfig as JaxConfig
from legged_gym_dev_tpu.solver.fast_tube import (
    closed_loop_tube_mpc_fast as jax_closed_loop,
)
from legged_gym_dev_tpu_torch.core import make_rom
from legged_gym_dev_tpu_torch.solver import (
    ALConfig,
    closed_loop_tube_mpc_fast,
)
from tests.torch_port_cases import PLANT_ARGS, gap_case, jax_params, torch_params
from tests.torch_port_cases import one_torch_thread  # noqa: F401

N, H_REV, B, H = 20, 10, 3, 3
NAMES = ("z", "v", "w", "pz_x", "viol")


def check_closed_loop(tube):
    case = gap_case(B, N, H_REV, tube, seed=1)
    refresh = dict(nn_basis_refresh=3) if tube == "NN_oneshot" else {}
    first = dict(outer_iters=8, inner_iters=6, **refresh)
    loop = dict(outer_iters=4, inner_iters=6, **refresh)
    kw = dict(tube_kind=tube, scaling=0.5, H=H, N=N, H_rev=H_REV,
              warm_start="interpolate", tube_ws="evaluate")
    plant_j = jax_make_rom("DoubleInt2D", *PLANT_ARGS)
    out_j = jax.jit(jax.vmap(lambda pp: jax_closed_loop(
        pp, plant_j, cfg_first=JaxConfig(**first),
        cfg_loop=JaxConfig(**loop), **kw)))(jax_params(case))
    out_t = closed_loop_tube_mpc_fast(
        torch_params(case), make_rom("DoubleInt2D", *PLANT_ARGS, device="cpu"),
        cfg_first=ALConfig(**first), cfg_loop=ALConfig(**loop), device="cpu",
        **kw)
    for name, t, r in zip(NAMES, out_t[:5], out_j[:5]):
        assert tuple(t.shape) == r.shape, (name, tuple(t.shape), r.shape)
        err = np.abs(t.numpy() - np.asarray(r)).max()
        assert err < 2e-3, (tube, name, err)
    np.testing.assert_array_equal(out_t[5].numpy(), np.asarray(out_j[5]))


def test_closed_loop_matches_jax():
    check_closed_loop("l1")
