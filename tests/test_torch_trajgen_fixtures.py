"""The port's scripted trajectory fixtures and weight samplers against the
JAX package's (``trajgen/generator.py``, ``trajgen/samplers.py``).

- Zero, Square and Circle on SingleInt2D and DoubleInt2D: their resample
  and reset are deterministic, so both packages reset from the same ROM
  states and step on; ``get_input_t`` is compared at times across every
  breakpoint of Square's schedule, from a JAX state carried to the port.
  Bar: atol 1e-6 (float32 arithmetic on O(1) values).
- The weight samplers' masks and ``SAMPLER_REGISTRY``'s keys equal JAX's;
  the TurnBiased sampler's mean weight share matches JAX's (16384 draws
  each, atol 0.015: about 5 standard errors of the difference).
- Square and Circle raise ``ValueError`` on a Unicycle, as JAX does.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from legged_gym_dev_tpu.core import make_rom as jax_make_rom
from legged_gym_dev_tpu.trajgen import generator as jgen
from legged_gym_dev_tpu.trajgen import samplers as jsam
from legged_gym_dev_tpu_torch.core import make_rom
from legged_gym_dev_tpu_torch.interop import traj_gen_state_from_numpy
from legged_gym_dev_tpu_torch.trajgen import (
    TRAJ_GEN_REGISTRY,
    CircleTrajectoryGenerator,
    SquareTrajectoryGenerator,
    ZeroTrajectoryGenerator,
)
from legged_gym_dev_tpu_torch.trajgen import samplers as tsam
from tests.torch_port_cases import one_torch_thread  # noqa: F401

ATOL = 1e-6
B = 16
ROMS = {
    "SingleInt2D": (0.1, [-10.0] * 2, [10.0] * 2, [-0.35, -0.3],
                    [0.3, 0.35]),
    "DoubleInt2D": (0.1, [-10.0, -10.0, -0.3, -0.4], [10.0, 10.0, 0.4, 0.3],
                    [-0.5, -0.6], [0.6, 0.5]),
}
FIXTURES = ("ZeroTrajectoryGenerator", "SquareTrajectoryGenerator",
            "CircleTrajectoryGenerator")
FIELDS = ("t", "k", "t_final", "trajectory", "v_trajectory", "v",
          "stationary", "center")


def generators(name, rom_name):
    kw = dict(dt_loop=0.02, N=6, dN=1)
    jg = jgen.TRAJ_GEN_REGISTRY[name].create(
        jax_make_rom(rom_name, *ROMS[rom_name]),
        jsam.UniformSampleHoldDT.create(1.0, 2.0),
        jsam.UniformWeightSampler(), **kw)
    tg = TRAJ_GEN_REGISTRY[name].create(
        make_rom(rom_name, *ROMS[rom_name], device="cpu"),
        tsam.UniformSampleHoldDT.create(1.0, 2.0),
        tsam.UniformWeightSampler(), **kw)
    return jg, tg


def start_states(rom_name, seed=0):
    n = 2 if rom_name == "SingleInt2D" else 4
    return np.random.default_rng(seed).normal(0, 0.2, (B, n)).astype(
        np.float32)


def assert_fields(ts, js, fields=FIELDS):
    for f in fields:
        np.testing.assert_allclose(getattr(ts, f).numpy(),
                                   np.asarray(getattr(js, f)), atol=ATOL,
                                   err_msg=f)


def test_registry_holds_the_fixture_classes():
    assert sorted(TRAJ_GEN_REGISTRY) == sorted(jgen.TRAJ_GEN_REGISTRY)
    assert TRAJ_GEN_REGISTRY["SquareTrajectoryGenerator"] \
        is SquareTrajectoryGenerator


@pytest.mark.parametrize("rom_name", sorted(ROMS))
@pytest.mark.parametrize("name", FIXTURES)
def test_reset_and_steps_match_jax(name, rom_name):
    """A masked reset (deterministic for the fixtures) from the same ROM
    states, then 30 env ticks, the window compared after each."""
    jg, tg = generators(name, rom_name)
    z0 = start_states(rom_name)
    mask = np.arange(B) % 4 != 3
    js = jg.init_state(jax.random.PRNGKey(0), B)
    js = jg.reset(js, jnp.asarray(mask), jnp.asarray(z0))
    ts = tg.init_state(torch.Generator().manual_seed(0), B)
    assert isinstance(tg.reset(ts, torch.ones(B, dtype=torch.bool),
                               torch.as_tensor(z0)).center, torch.Tensor)
    ts = tg.reset(ts, torch.as_tensor(mask), torch.as_tensor(z0))
    assert_fields(ts, js)
    step = jax.jit(jg.step)
    for _ in range(30):
        js, ts = step(js), tg.step(ts)
        assert_fields(ts, js)
        np.testing.assert_allclose(tg.get_trajectory(ts).numpy(),
                                   np.asarray(jg.get_trajectory(js)),
                                   atol=ATOL)
    if name == "ZeroTrajectoryGenerator":
        assert bool(ts.stationary[torch.as_tensor(mask)].all())
        assert float(ts.v.abs().max()) == 0.0


def square_times(rom_name):
    """Times on both sides of every breakpoint of Square's schedule."""
    if rom_name == "SingleInt2D":
        _, _, _, vmin, vmax = ROMS[rom_name]
        c1 = 2 / vmax[1]
        c2 = c1 + 1 / vmax[0]
        c3 = c2 + 2 / abs(vmin[1])
        cs = [0.0, c1, c2, c3, c3 + 1 / abs(vmin[0])]
    else:
        cs = list(np.linspace(0.0, 30.0, 16))
    ts = [c + d for c in cs for d in (-0.013, 0.0, 0.011)]
    return np.resize(np.asarray(ts, np.float32), B)


@pytest.mark.parametrize("rom_name", sorted(ROMS))
@pytest.mark.parametrize("name", FIXTURES)
def test_get_input_t_matches_jax(name, rom_name):
    """``get_input_t`` from a carried state at times across Square's
    breakpoints (and, on DoubleInt2D, a sweep over its 15 of them)."""
    jg, tg = generators(name, rom_name)
    z0 = start_states(rom_name, seed=1)
    js = jg.reset(jg.init_state(jax.random.PRNGKey(1), B),
                  jnp.ones(B, bool), jnp.asarray(z0))
    for t in (square_times(rom_name), np.linspace(-1.0, 40.0, B)):
        jt = js.replace(t=jnp.asarray(t, jnp.float32))
        ts = traj_gen_state_from_numpy(jax.tree.map(np.asarray, jt),
                                       torch.Generator().manual_seed(1))
        z = np.random.default_rng(2).normal(0, 0.3, z0.shape).astype(
            np.float32)
        jst, jv = jg.get_input_t(jt, jnp.asarray(z))
        tst, tv = tg.get_input_t(ts, torch.as_tensor(z))
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=ATOL)
        assert_fields(tst, jst)
        if name == "SquareTrajectoryGenerator":
            assert float(tv.abs().max()) > 0.0


@pytest.mark.parametrize("rom_name", sorted(ROMS))
def test_resample_matches_jax(rom_name):
    """Zero marks the masked envs stationary, Circle centers them 0.5 to
    the side of z, Square leaves the state as it is."""
    z = start_states(rom_name, seed=3)
    mask = np.arange(B) % 3 == 0
    for name in FIXTURES:
        jg, tg = generators(name, rom_name)
        js = jg.init_state(jax.random.PRNGKey(2), B)
        ts = tg.init_state(torch.Generator().manual_seed(2), B)
        assert_fields(tg.resample(ts, torch.as_tensor(mask),
                                  torch.as_tensor(z)),
                      jg.resample(js, jnp.asarray(mask), jnp.asarray(z)))


def test_samplers_and_registry_match_jax():
    assert list(tsam.SAMPLER_REGISTRY) == list(jsam.SAMPLER_REGISTRY)
    for name in ("UniformWeightSampler", "UniformWeightSamplerNoExtreme",
                 "UniformWeightSamplerNoRamp", "WeightSamplerSampleAndHold",
                 "UniformWeightSamplerTurnBiased"):
        tm = tsam.SAMPLER_REGISTRY[name]().mask
        assert all(isinstance(x, float) for x in tm)
        np.testing.assert_array_equal(
            np.asarray(tm, np.float32),
            np.asarray(jsam.SAMPLER_REGISTRY[name]().mask, np.float32))
    np.testing.assert_array_equal(
        np.asarray(tsam.UniformWeightSamplerTurnBiased(5.0).mask),
        np.asarray(jsam.UniformWeightSamplerTurnBiased(5.0).mask))
    hold = tsam.UniformSampleHoldDT.create(1.5, 4.0)
    t = hold.sample(torch.Generator().manual_seed(0), 4096, "cpu")
    assert t.shape == (4096,) and t.dtype == torch.float32
    assert float(t.min()) >= 1.5 and float(t.max()) < 4.0
    assert abs(float(t.mean()) - 2.75) < 0.05


def test_turn_biased_share_matches_jax():
    n = 16384
    jw = np.asarray(jsam.UniformWeightSamplerTurnBiased().sample(
        jax.random.PRNGKey(0), n))
    tw = tsam.UniformWeightSamplerTurnBiased().sample(
        torch.Generator().manual_seed(0), n, "cpu").numpy()
    np.testing.assert_allclose(tw.sum(axis=-1), 1.0, atol=1e-5)
    assert np.all(tw[:, 1] == 0.0)
    np.testing.assert_allclose(tw.mean(axis=0), jw.mean(axis=0), atol=0.015)
    assert tw.mean(axis=0)[3] > 0.55


@pytest.mark.parametrize("cls", [SquareTrajectoryGenerator,
                                 CircleTrajectoryGenerator])
def test_fixtures_raise_on_other_roms(cls):
    rom = make_rom("Unicycle", 0.1, [-10.0] * 3, [10.0] * 3, [-0.5, -1.0],
                   [0.5, 1.0], device="cpu")
    tg = cls.create(rom, tsam.UniformSampleHoldDT.create(1.0, 2.0),
                    tsam.UniformWeightSampler())
    st = tg.init_state(torch.Generator().manual_seed(0), 2)
    with pytest.raises(ValueError, match="SingleInt2D/DoubleInt2D"):
        tg.get_input_t(st, torch.zeros(2, 3))
    assert isinstance(ZeroTrajectoryGenerator.create(
        rom, tg.t_sampler, tg.weight_sampler), ZeroTrajectoryGenerator)
