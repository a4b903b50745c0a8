"""The JAX package's kernel-route switches in the port, and the public
class members it shares with the JAX package.

1. ``RobotSim.use_pallas_substep`` and ``LGDT_PALLAS_SUBSTEP``: what
   ``create`` makes of the variable (0, 1, unset, beaten by an explicit
   argument), held against JAX's ``RobotSim.create``; the route each value
   takes (``False``: ``substep_plain``, also shard by shard under a mesh;
   ``None`` and ``True``: the kernel's wrapper); ``replace`` and ``shard``
   keep the field. The plain route's step against JAX's XLA substep at
   rtol = atol = 2e-5 (test_pallas_substep.py's bar).
2. ``LGDT_PALLAS_MULTIRHS`` (``staged_scalar._PALLAS_MULTIRHS``): with it
   off and ``linsolve="pallas"``, the multi-RHS Woodbury solves go to
   ``factor_solve_entries`` and the single right-hand side solves still to
   the kernel's wrapper; the NN_oneshot solve (B=2, N=8, a 2x2 schedule)
   against JAX's with its constant off too (its Pallas kernel in interpret
   mode), plans z and w within 2e-3 (tests/test_torch_fast_tube.py's bar),
   for the per-step solve of ``[gf, U]`` and for the refreshed basis.
3. ``clip_v`` on every ROM against JAX's, shared and per scenario
   (``jax.vmap`` over a stacked ROM), exactly; ``MLP.replace(out_scale=)``
   against JAX's ``model.replace(out_scale=...)`` within 1e-6; ``replace``
   on every class that flax.struct gives one.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from legged_gym_dev_tpu_torch.ops import block_tridiag_kernels as btk
from legged_gym_dev_tpu_torch.ops import substep_kernels as sk
from legged_gym_dev_tpu_torch.parallel import mesh as pm
from legged_gym_dev_tpu_torch.sim.robot_sim import RobotSim
from legged_gym_dev_tpu_torch.solver import ALConfig, solve_tube_fast_batched
from legged_gym_dev_tpu_torch.solver import staged_scalar as tss
from tests.torch_port_cases import (
    gap_case,
    jax_call,
    jax_params,
    jax_robot_sim,
    jax_robot_state,
    mlp_weights,
    torch_params,
)
from tests.torch_port_cases import one_torch_thread  # noqa: F401
from tests.torch_robot_cases import substep_inputs, torch_sim, torch_state

FIELDS = ("base_pos", "base_quat", "q", "v")
CPU = torch.device("cpu")


# ---------------------------------------------------------------------------
# 1. the physics route
# ---------------------------------------------------------------------------

def _models():
    from legged_gym_dev_tpu.sim.dynamics import RobotModel as JaxModel
    from legged_gym_dev_tpu.sim.urdf import parse_urdf as jax_parse
    from legged_gym_dev_tpu_torch.sim.dynamics import RobotModel
    from legged_gym_dev_tpu_torch.sim.urdf import parse_urdf
    from tests.torch_robot_cases import HOPPER4_URDF

    return (RobotModel.from_spec(parse_urdf(HOPPER4_URDF)),
            JaxModel.from_spec(jax_parse(HOPPER4_URDF)))


@pytest.mark.parametrize("env,kw", [
    (None, {}), ("0", {}), ("1", {}), ("", {}), ("yes", {}),
    ("0", {"use_pallas_substep": True}), ("1", {"use_pallas_substep": False}),
    (None, {"use_pallas_substep": False})])
def test_create_reads_the_variable_as_jax_does(monkeypatch, env, kw):
    """``LGDT_PALLAS_SUBSTEP=0/1`` sets the field, any other value leaves
    it None, and an explicit argument beats the variable: the field JAX's
    ``RobotSim.create`` makes in the same environment."""
    from legged_gym_dev_tpu.sim.robot_sim import RobotSim as JaxSim

    if env is None:
        monkeypatch.delenv("LGDT_PALLAS_SUBSTEP", raising=False)
    else:
        monkeypatch.setenv("LGDT_PALLAS_SUBSTEP", env)
    model, jax_model = _models()
    ours = RobotSim.create(model, device="cpu", **kw).use_pallas_substep
    theirs = JaxSim.create(jax_model, **kw).use_pallas_substep
    assert ours is theirs
    expect = kw.get("use_pallas_substep",
                    {"0": False, "1": True}.get(env))
    assert ours is expect


class _Spy:
    """Counts the calls of the functions of ``substep_kernels`` it wraps
    (``RobotSim.substep`` looks them up at each call)."""

    def __init__(self, monkeypatch, names):
        self.calls = dict.fromkeys(names, 0)
        for name in names:
            fn = getattr(sk, name)

            def wrapped(*a, _fn=fn, _name=name, **k):
                self.calls[_name] += 1
                return _fn(*a, **k)
            monkeypatch.setattr(sk, name, wrapped)


SPIED = ("substep", "substep_shard", "substep_sharded", "substep_plain")


@pytest.fixture(scope="module")
def hopper_step():
    """The hopper at B=8 with per-env DR rows: the inputs, the port's sim
    and JAX's XLA substep on them."""
    inp = substep_inputs("hopper", 8, seed=5, dr=True)
    ref = jax_robot_sim("hopper", inp).substep(*jax_robot_state(inp))
    return inp, torch_sim("hopper", "cpu", inp), ref


def _close(got, ref):
    for f in FIELDS:
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(ref, f)), rtol=2e-5,
                                   atol=2e-5, err_msg=f)


@pytest.mark.parametrize("route", [None, True, False])
def test_substep_takes_the_chosen_route(monkeypatch, hopper_step, route):
    """``False`` calls ``substep_plain`` and never the kernel's wrapper;
    ``None`` and ``True`` call the wrapper (whose CPU version is
    ``substep_plain``). Every route steps as JAX's XLA substep."""
    inp, sim, ref = hopper_step
    sim = sim.replace(use_pallas_substep=route)
    st, tau = torch_state(inp)
    spy = _Spy(monkeypatch, SPIED)
    sk.reset_launches()
    _close(sim.substep(st, tau), ref)
    if route is False:
        assert spy.calls == {"substep": 0, "substep_shard": 0,
                             "substep_sharded": 0, "substep_plain": 1}
    else:
        assert spy.calls["substep"] == 1 and spy.calls["substep_plain"] == 1
    assert sum(sk.launches().values()) == 0


@pytest.mark.parametrize("route", [None, False])
def test_mesh_route_goes_shard_by_shard(monkeypatch, hopper_step, route):
    """With ``shard_mesh`` set, ``False`` runs ``substep_plain`` on each
    shard's sim (its device, its DR rows) and never the shard kernel's
    wrapper; ``None`` takes ``substep_shard`` on each. Both step as JAX's
    XLA substep on the whole batch."""
    inp, sim, ref = hopper_step
    mesh = pm.make_mesh(2, devices=[CPU, CPU])
    sim = sim.replace(use_pallas_substep=route, shard_mesh=(mesh, "dp"))
    st, tau = torch_state(inp)
    spy = _Spy(monkeypatch, SPIED)
    _close(sim.substep(st, tau), ref)
    assert spy.calls["substep_sharded"] == 1 and spy.calls["substep"] == 0
    if route is False:
        assert spy.calls["substep_shard"] == 0
        assert spy.calls["substep_plain"] == 2
    else:
        assert spy.calls["substep_shard"] == 2
    assert all(s.use_pallas_substep is route for s in sim.shard(mesh))


def test_replace_and_shard_keep_the_field(hopper_step):
    """``replace(use_pallas_substep=...)`` round-trips and leaves the
    other fields shared; ``shard`` cuts sims that inherit the field."""
    _, sim, _ = hopper_step
    off = sim.replace(use_pallas_substep=False)
    assert off.use_pallas_substep is False and sim.use_pallas_substep is None
    assert off.model is sim.model and off.contact is sim.contact
    assert off.replace(use_pallas_substep=None) == sim
    mesh = pm.make_mesh(4, devices=[CPU] * 4)
    shards = off.shard(mesh)
    assert all(s.is_shard and s.use_pallas_substep is False for s in shards)
    assert all(s.use_pallas_substep is None for s in sim.shard(mesh))


# ---------------------------------------------------------------------------
# 2. the multi-RHS route
# ---------------------------------------------------------------------------

N_SOLVE, H_REV, B_SOLVE = 8, 4, 2
SCHEDULE = dict(outer_iters=2, inner_iters=2, linsolve="pallas")
KW = dict(scaling=0.5, warm_start="interpolate", tube_ws="evaluate")


@pytest.fixture(scope="module", params=["inner", 2],
                ids=["per_step", "refreshed_basis"])
def multirhs_off(request):
    """The NN_oneshot solve with the multi-RHS kernel route off in both
    packages, ``nn_basis_refresh`` "inner" (each step solves [gf, U]) or 2
    (a basis every 2 steps, the gradient solved alone)."""
    from legged_gym_dev_tpu.solver import ALConfig as JaxConfig
    from legged_gym_dev_tpu.solver import staged_scalar as jss
    from legged_gym_dev_tpu.solver.fast_tube import (
        solve_tube_fast_batched as jax_solve_batched,
    )

    cfg = dict(SCHEDULE, nn_basis_refresh=request.param)
    case = gap_case(B_SOLVE, N_SOLVE, H_REV, "NN_oneshot", seed=2)
    mp = pytest.MonkeyPatch()
    mp.setattr(jss, "_PALLAS_MULTIRHS", False)
    try:
        out_j = jax_call(lambda pb: jax_solve_batched(
            pb, N_SOLVE, H_REV, tube_kind="NN_oneshot",
            cfg=JaxConfig(**cfg), **KW), jax_params(case))
    finally:
        mp.undo()
    return request.param, case, cfg, out_j


def _port_solve(case, cfg):
    return solve_tube_fast_batched(torch_params(case), N_SOLVE, H_REV,
                                   tube_kind="NN_oneshot",
                                   cfg=ALConfig(**cfg), device="cpu", **KW)


def test_multirhs_off_routes_and_matches_jax(monkeypatch, multirhs_off):
    refresh, case, cfg, out_j = multirhs_off
    calls = dict(multi=0, single=0, factor=0)

    def spy(module, name, key):
        fn = getattr(module, name)

        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        monkeypatch.setattr(module, name, wrapped)

    spy(tss, "block_tridiag_multirhs_entries", "multi")
    spy(tss, "block_tridiag_solve_entries", "single")
    spy(tss, "factor_solve_entries", "factor")
    monkeypatch.setattr(tss, "_PALLAS_MULTIRHS", False)
    btk.reset_launches()
    out_t = _port_solve(case, cfg)
    assert calls["multi"] == 0 and calls["factor"] > 0
    # the refreshed basis solves the gradient alone, on the kernel's route
    assert (calls["single"] > 0) == (refresh != "inner")
    assert sum(btk.launches().values()) == 0          # CPU tensors
    for f in ("z", "w"):
        d = np.abs(getattr(out_t, f).numpy()
                   - np.asarray(getattr(out_j, f))).max()
        assert d < 2e-3, (f, d)
    # the kernel's route solves the same systems
    monkeypatch.setattr(tss, "_PALLAS_MULTIRHS", True)
    calls.update(multi=0, factor=0)
    out_k = _port_solve(case, cfg)
    assert calls["multi"] > 0 and calls["factor"] == 0
    assert np.abs(out_k.z.numpy() - out_t.z.numpy()).max() < 2e-3


def test_multirhs_constant_reads_the_variable():
    """The port reads ``LGDT_PALLAS_MULTIRHS`` at import as JAX does:
    "1" or unset keeps the kernel route, anything else turns it off (one
    process, the module imported again under each value)."""
    import os
    import subprocess
    import sys

    code = "\n".join([
        "import importlib, os",
        "import legged_gym_dev_tpu_torch.solver.staged_scalar as s",
        "for v in ('0', '1', None, 'no'):",
        "    os.environ.pop('LGDT_PALLAS_MULTIRHS', None)",
        "    if v is not None:",
        "        os.environ['LGDT_PALLAS_MULTIRHS'] = v",
        "    print(importlib.reload(s)._PALLAS_MULTIRHS)"])
    env = {k: v for k, v in os.environ.items()
           if k != "LGDT_PALLAS_MULTIRHS"}
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, check=True)
    assert out.stdout.split() == ["False", "True", "True", "False"]


# ---------------------------------------------------------------------------
# 3. clip_v, MLP.replace and replace
# ---------------------------------------------------------------------------

ROMS = ("SingleInt2D", "DoubleInt2D", "Unicycle", "LateralUnicycle",
        "ExtendedUnicycle", "ExtendedLateralUnicycle")


def _rom_args(name, rng):
    from legged_gym_dev_tpu_torch.core import rom as trom

    cls = getattr(trom, name)
    n, m = cls.n, cls.m
    z = rng.uniform(1.0, 2.0, n).astype(np.float32)
    v = rng.uniform(0.2, 1.0, m).astype(np.float32)
    return 0.1, -z, z, -v, v


@pytest.mark.parametrize("name", ROMS)
def test_clip_v_matches_jax(name):
    from legged_gym_dev_tpu.core import make_rom as jax_make_rom
    from legged_gym_dev_tpu_torch.core import make_rom

    B = 5
    rng = np.random.default_rng(7)
    args = [_rom_args(name, rng) for _ in range(B)]
    m = len(args[0][3])
    v = rng.normal(0.0, 1.5, (B, 3, m)).astype(np.float32)
    # shared bounds: scenario 0's
    ours = make_rom(name, *args[0], device="cpu").clip_v(torch.as_tensor(v))
    theirs = jax_make_rom(name, *args[0]).clip_v(jnp.asarray(v))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))
    # per-scenario (B, m) bounds
    from legged_gym_dev_tpu_torch.core import rom as trom

    stacked = getattr(trom, name).stack(
        [make_rom(name, *a, device="cpu") for a in args], device="cpu")
    assert stacked.v_min.shape == (B, m)
    jroms = [jax_make_rom(name, *a) for a in args]
    jstack = jax.tree.map(lambda *x: jnp.stack(x), *jroms)
    theirs = jax.vmap(lambda r, x: r.clip_v(x))(jstack, jnp.asarray(v))
    ours = stacked.clip_v(torch.as_tensor(v))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))
    assert (ours != torch.as_tensor(v)).any()     # some inputs were clipped


def test_mlp_replace_out_scale_matches_jax():
    """``replace(out_scale=s)`` gives the calibrated net of JAX's recipe
    (``model.replace(out_scale=jnp.asarray(s))``), compounding a scale on
    one that has one; the weights are shared, the source unchanged."""
    from legged_gym_dev_tpu.tube.models import MLP as JaxMLP
    from legged_gym_dev_tpu_torch.interop import mlp_from_numpy

    ws, bs = mlp_weights(6, 1, 8, seed=4)
    jm = JaxMLP(weights=tuple(map(jnp.asarray, ws)),
                biases=tuple(map(jnp.asarray, bs)),
                final_activation="softplus")
    tm = mlp_from_numpy(ws, bs, final_activation="softplus", device="cpu")
    x = np.random.default_rng(0).normal(size=(4, 6)).astype(np.float32)
    s1, s2 = 1.37, 0.81
    j1 = jm.replace(out_scale=jnp.asarray(s1))
    t1 = tm.replace(out_scale=s1)
    j2 = j1.replace(out_scale=jnp.asarray(s1 * s2))
    t2 = t1.replace(out_scale=torch.tensor(s1 * s2))
    for t, j in ((tm, jm), (t1, j1), (t2, j2)):
        np.testing.assert_allclose(t(torch.as_tensor(x)).detach().numpy(),
                                   np.asarray(j(jnp.asarray(x))), rtol=1e-6,
                                   atol=1e-7)
    assert tm.out_scale is None and t1.out_scale.dtype == torch.float32
    assert t1.weights[0].data_ptr() == tm.weights[0].data_ptr()
    assert t1.activation == tm.activation
    assert t1.final_activation == tm.final_activation == "softplus"
    with pytest.raises(TypeError, match="no fields"):
        tm.replace(scale=1.0)


def _instances():
    """One small instance of each class that flax.struct gives a
    ``replace`` in the JAX package, and a field to swap."""
    from legged_gym_dev_tpu_torch.controllers import (
        DoubleSingleTracking,
        RaibertHeuristic,
    )
    from legged_gym_dev_tpu_torch.core import make_rom
    from legged_gym_dev_tpu_torch.envs.hopper_trajectory import HopperDR
    from legged_gym_dev_tpu_torch.rl.ppo import PPOConfig
    from legged_gym_dev_tpu_torch.sim.actuator_net import ActuatorNetLSTM
    from legged_gym_dev_tpu_torch.sim.robot_sim import JointSprings
    from legged_gym_dev_tpu_torch.solver.mpc import MPCConfig
    from legged_gym_dev_tpu_torch.trajgen import generator as tg
    from legged_gym_dev_tpu_torch.trajgen.samplers import (
        UniformSampleHoldDT,
        UniformWeightSampler,
    )

    rom = make_rom("SingleInt2D", 0.1, [-1, -1], [1, 1], [-0.5, -0.5],
                   [0.5, 0.5], device="cpu")
    ts = UniformSampleHoldDT(t_low=0.1, t_high=0.5)
    wsamp = UniformWeightSampler()
    model, _ = _models()
    z = torch.zeros(2)
    out = {
        "RaibertHeuristic": (RaibertHeuristic.create(1, 1, 1, 1, 1, 1), "Kp",
                             2.0),
        "DoubleSingleTracking": (DoubleSingleTracking.create(
            1, 1, rom.clip_v_z), "Kd", 3.0),
        "HopperDR": (HopperDR.ones(2, CPU), "torque", torch.zeros(2)),
        "PPOConfig": (PPOConfig(), "gamma", 0.9),
        "ActuatorNetLSTM": (ActuatorNetLSTM(
            (z,), (z,), (z,), (z,), z, z, z, z), "out_scale", torch.ones(())),
        "RobotModel": (model, "body_names", ("a",)),
        "JointSprings": (JointSprings.zero(2, device="cpu"), "damping",
                         torch.ones(2)),
        "ALConfig": (ALConfig(), "outer_iters", 3),
        "MPCConfig": (MPCConfig(H=2, N=4, H_rev=2), "H", 3),
        "UniformSampleHoldDT": (ts, "t_high", 0.7),
        "UniformWeightSampler": (wsamp, "mask", (1.0, 0.0, 1.0, 1.0)),
    }
    from legged_gym_dev_tpu_torch.core import rom as trom

    for name in ROMS:
        r = getattr(trom, name).create(*_rom_args(
            name, np.random.default_rng(0)), device="cpu")
        out[name] = (r, "dt", 0.05)
    for cls in (tg.TrajectoryGenerator, tg.ZeroTrajectoryGenerator,
                tg.SquareTrajectoryGenerator, tg.CircleTrajectoryGenerator):
        out[cls.__name__] = (cls.create(rom, ts, wsamp), "N", 6)
    return out


INSTANCE_NAMES = sorted(["RaibertHeuristic", "DoubleSingleTracking",
                         "HopperDR", "PPOConfig", "ActuatorNetLSTM",
                         "RobotModel", "JointSprings", "ALConfig",
                         "MPCConfig", "UniformSampleHoldDT",
                         "UniformWeightSampler", "TrajectoryGenerator",
                         "ZeroTrajectoryGenerator",
                         "SquareTrajectoryGenerator",
                         "CircleTrajectoryGenerator", *ROMS])


@pytest.mark.parametrize("name", INSTANCE_NAMES)
def test_replace_swaps_one_field(name):
    """flax.struct's ``replace``: a new object of the same class with the
    named field swapped and every other field the same object."""
    obj, field, value = _instances()[name]
    new = obj.replace(**{field: value})
    assert type(new) is type(obj) and new is not obj
    assert getattr(new, field) is value
    for f in dataclasses.fields(obj):
        if f.name != field:
            assert getattr(new, f.name) is getattr(obj, f.name), f.name
    with pytest.raises(TypeError):
        obj.replace(no_such_field=1)
