"""The port's trajectory generator against the JAX package from a
carried-over state: the JAX generator is reset and run for a few ticks
with its own random draws, its state is handed to the port as numpy
(``interop.traj_gen_state_from_numpy``), and both then take the same
deterministic steps (``step_rom``, ``step``, ``get_trajectory``). Envs
whose input mode expires draw new random parameters, which the
two RNGs cannot match, so those envs are left out of the comparison.

Tolerance: atol 1e-6 (a few float32 operations on O(1) values).
The random parts are held to their distributions (bounds, simplex).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from legged_gym_dev_tpu.core import make_rom as jax_make_rom
from legged_gym_dev_tpu.trajgen import TrajectoryGenerator as JaxGen
from legged_gym_dev_tpu.trajgen import UniformSampleHoldDT as JaxHold
from legged_gym_dev_tpu.trajgen import UniformWeightSampler as JaxWeights
from legged_gym_dev_tpu_torch.core import make_rom
from legged_gym_dev_tpu_torch.interop import traj_gen_state_from_numpy
from legged_gym_dev_tpu_torch.trajgen import (
    TrajectoryGenerator,
    UniformSampleHoldDT,
    UniformWeightSampler,
)
from tests.torch_port_cases import one_torch_thread  # noqa: F401

ATOL = 1e-6
B = 64
ROMS = {
    "SingleInt2D": (0.1, [-1e9] * 2, [1e9] * 2, [-0.35] * 2, [0.35] * 2),
    "DoubleInt2D": (0.1, [-1e9, -1e9, -0.3, -0.3], [1e9, 1e9, 0.3, 0.3],
                    [-0.5, -0.5], [0.5, 0.5]),
}


def generators(rom_name, dN):
    kw = dict(dt_loop=0.02, N=10, dN=dN, prob_stationary=0.2)
    jg = JaxGen.create(jax_make_rom(rom_name, *ROMS[rom_name]),
                       JaxHold.create(1.0, 2.0), JaxWeights(), **kw)
    tg = TrajectoryGenerator.create(
        make_rom(rom_name, *ROMS[rom_name], device="cpu"),
        UniformSampleHoldDT.create(1.0, 2.0), UniformWeightSampler(), **kw)
    return jg, tg


def carried_state(jg, ticks=7, seed=0):
    """A JAX state after a reset around random ROM states and a few
    ticks, as numpy."""
    rng = np.random.default_rng(seed)
    z0 = rng.normal(0, 0.2, (B, jg.rom.n)).astype(np.float32)
    st = jg.init_state(jax.random.PRNGKey(seed), B)
    st = jg.reset(st, jnp.ones(B, bool), jnp.asarray(z0))
    for _ in range(ticks):
        st = jg.step(st)
    return jax.tree.map(np.asarray, st)


def close(a, b, keep, name):
    np.testing.assert_allclose(a.numpy()[keep], np.asarray(b)[keep],
                               atol=ATOL, err_msg=name)


FIELDS = ("trajectory", "v_trajectory", "v", "k", "t")


@pytest.mark.parametrize("rom_name", sorted(ROMS))
@pytest.mark.parametrize("dN", [1, 2])
def test_step_and_window_match_jax(rom_name, dN):
    jg, tg = generators(rom_name, dN)
    js = carried_state(jg, seed=dN)
    ts = traj_gen_state_from_numpy(js, torch.Generator().manual_seed(0))
    keep = np.ones(B, bool)
    for _ in range(12):
        # an expired mode is resampled in this step (due or not)
        keep &= ~(js.t > js.t_final)
        js_new = jg.step(js)
        ts = tg.step(ts)
        for f in FIELDS:
            close(getattr(ts, f), getattr(js_new, f), keep, f)
        close(tg.get_trajectory(ts), jg.get_trajectory(js_new), keep,
              "window")
        js = jax.tree.map(np.asarray, js_new)
    assert keep.sum() >= B // 4
    # stationary envs hold their velocity states at zero
    assert js.stationary.any()


@pytest.mark.parametrize("rom_name", sorted(ROMS))
def test_step_rom_masked_matches_jax(rom_name):
    """One masked ROM tick with the time increment (the reset's inner
    step) on envs whose mode does not expire."""
    jg, tg = generators(rom_name, 1)
    js = carried_state(jg, ticks=3, seed=5)
    ts = traj_gen_state_from_numpy(js, torch.Generator().manual_seed(1))
    mask = np.random.default_rng(5).uniform(size=B) > 0.3
    keep = ~(js.t > js.t_final)
    jn = jg.step_rom(js, jnp.asarray(mask), increment_rom_time=True,
                     allow_resample_mask=jnp.asarray(mask))
    tn = tg.step_rom(ts, torch.as_tensor(mask), increment_rom_time=True,
                     allow_resample_mask=torch.as_tensor(mask))
    for f in FIELDS:
        close(getattr(tn, f), getattr(jn, f), keep, f)
    assert keep.sum() >= B // 2


@pytest.mark.parametrize("rom_name", sorted(ROMS))
def test_reset_and_resample_distributions(rom_name):
    """The port's own draws: inputs within the ROM's bounds, weights on
    the simplex, hold times within the sampler's range, the window built
    from z (its last ROM state one tick ahead of z)."""
    _, tg = generators(rom_name, 1)
    rom = tg.rom
    gen = torch.Generator().manual_seed(3)
    z0 = torch.as_tensor(np.random.default_rng(3).normal(
        0, 0.05, (B, rom.n)).astype(np.float32))
    st = tg.init_state(gen, B)
    st = tg.reset(st, torch.ones(B, dtype=torch.bool), z0)
    assert torch.allclose(st.weights.sum(-1), torch.ones(B))
    hold = st.t_final - st.ramp_t_start
    assert bool(((hold >= 1.0) & (hold <= 2.0)).all())
    for name in ("sample_hold_input", "extreme_input", "ramp_v_end"):
        x = getattr(st, name)
        assert bool(((x >= rom.v_min) & (x <= rom.v_max)).all()), name
    assert torch.allclose(st.k, torch.zeros(B))   # N*dN ticks from -N*dN
    win = tg.get_trajectory(st)
    assert win.shape == (B, 10, rom.n) and bool(torch.isfinite(win).all())
