"""Shared inputs for the port's parity tests (tests/test_torch_*.py).

One numpy-drawn scenario batch on the ``gap`` problem, handed to the JAX
package (broadcast pytree, as bench.py builds it) and to the port
(``interop.trajopt_params_from_numpy`` on the CPU), so both compute the
same problem.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from legged_gym_dev_tpu.core import make_rom as jax_make_rom
from legged_gym_dev_tpu.solver import PROBLEM_DICT
from legged_gym_dev_tpu.solver import TrajOptParams as JaxParams
from legged_gym_dev_tpu.tube.models import MLP as JaxMLP
from legged_gym_dev_tpu_torch.interop import (
    mlp_from_numpy,
    trajopt_params_from_numpy,
)

PROB = PROBLEM_DICT["gap"]
ROM_ARGS = ("SingleInt2D", PROB["dt"], [-PROB["pos_max"]] * 2,
            [PROB["pos_max"]] * 2, [-PROB["vel_max"]] * 2,
            [PROB["vel_max"]] * 2)
PLANT_ARGS = (PROB["dt"], [-np.inf, -np.inf, -0.3, -0.3],
              [np.inf, np.inf, 0.3, 0.3], [-0.5, -0.5], [0.5, 0.5])


def jax_call(fn, *args):
    """``fn(*args)`` of a JAX reference, compiled by XLA without backend
    (LLVM) optimization: large autodiff graphs compile faster, and the
    values are those of the same operations in fp32."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})(*args)


def mlp_weights(n_in, n_out, units, seed, layers=2):
    """Kaiming-uniform weights as (in, out) arrays, last layer x0.5 and
    bias -2 (tube widths near softplus(-2) ~ 0.13)."""
    rng = np.random.default_rng(seed)
    sizes = [n_in] + [units] * layers + [n_out]
    ws, bs = [], []
    for fan_in, fan_out in zip(sizes[:-1], sizes[1:]):
        bd = 1.0 / np.sqrt(fan_in)
        ws.append(rng.uniform(-bd, bd, (fan_in, fan_out)).astype(np.float32))
        bs.append(rng.uniform(-bd, bd, (fan_out,)).astype(np.float32))
    ws[-1] = ws[-1] * 0.5
    bs[-1] = bs[-1] * 0.0 - 2.0
    return ws, bs


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for a test module that imports this fixture: the
    port's solvers launch thousands of small ops, which run faster on one
    thread than on eight, and six parallel test workers then do not
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def gap_case(B, N, H_rev, tube, seed=0, bench_draws=True):
    """Numpy inputs of a gap batch: bench.py's randomised starts, goals and
    obstacles, or (``bench_draws=False``) only the start spread over
    +-0.1, as tests/test_fast_tube.py batches it."""
    rng = np.random.default_rng(seed)
    case = dict(N=N, H_rev=H_rev, tube=tube,
                Qw=0.1 if tube == "NN_oneshot" else 0.0, mlp=None)
    if bench_draws:
        case.update(
            z0=PROB["start"] + rng.uniform(-0.15, 0.15, (B, 2)),
            zf=PROB["goal"] + rng.uniform(-0.15, 0.15, (B, 2)),
            obs_c=PROB["obs"]["c"] + rng.uniform(-0.05, 0.05, (B, 2, 2)),
            obs_r=PROB["obs"]["r"] * rng.uniform(0.85, 1.0, (B, 2)))
    else:
        case.update(
            z0=PROB["start"] + np.linspace(-0.1, 0.1, B)[:, None],
            zf=np.broadcast_to(PROB["goal"], (B, 2)),
            obs_c=np.broadcast_to(PROB["obs"]["c"], (B, 2, 2)),
            obs_r=np.broadcast_to(PROB["obs"]["r"], (B, 2)))
    for k in ("z0", "zf", "obs_c", "obs_r"):
        case[k] = case[k].astype(np.float32)
    if tube == "NN_oneshot":
        case["mlp"] = mlp_weights(H_rev + (H_rev + N) * 2, N, 32, seed + 7)
    return case


def jax_params(case):
    N, H_rev = case["N"], case["H_rev"]
    nn = None
    if case["mlp"] is not None:
        ws, bs = case["mlp"]
        nn = JaxMLP(weights=tuple(jnp.asarray(w) for w in ws),
                    biases=tuple(jnp.asarray(b) for b in bs),
                    final_activation="softplus")
    p = JaxParams.create(
        jax_make_rom(*ROM_ARGS), N, H_rev, 10 * np.eye(2), 10 * np.eye(2),
        PROB["start"], PROB["goal"], PROB["obs"]["c"], PROB["obs"]["r"],
        Qw=case["Qw"], w_max=1.0, tube_params=nn)
    B = case["z0"].shape[0]
    pb = jax.tree.map(lambda x: jnp.broadcast_to(x, (B,) + x.shape), p)
    return pb.replace(z0=jnp.asarray(case["z0"]), zf=jnp.asarray(case["zf"]),
                      obs_c=jnp.asarray(case["obs_c"]),
                      obs_r=jnp.asarray(case["obs_r"]))


def torch_params(case):
    nn = None
    if case["mlp"] is not None:
        ws, bs = case["mlp"]
        nn = mlp_from_numpy(ws, bs, final_activation="softplus",
                            device="cpu")
    return trajopt_params_from_numpy(
        *ROM_ARGS, case["N"], case["H_rev"], 10 * np.eye(2), 10 * np.eye(2),
        case["z0"], case["zf"], case["obs_c"], case["obs_r"], Qw=case["Qw"],
        w_max=1.0, tube_params=nn, device="cpu")


def jax_robot_sim(robot, inputs=None):
    """The JAX package's ``RobotSim`` of a test robot
    (``tests/torch_robot_cases.py``), on its XLA substep path, with DR
    ``inputs`` applied as ``torch_robot_cases.torch_sim`` applies them."""
    from legged_gym_dev_tpu.sim.contact import ContactParams
    from legged_gym_dev_tpu.sim.dynamics import RobotModel
    from legged_gym_dev_tpu.sim.robot_sim import JointSprings, RobotSim
    from legged_gym_dev_tpu.sim.urdf import parse_urdf
    from tests.torch_robot_cases import robot_config

    cfg = robot_config(robot)
    model = RobotModel.from_spec(parse_urdf(cfg["urdf"]))
    springs = None
    if cfg["springs"] is not None:
        springs = JointSprings(**{k: jnp.asarray(v, jnp.float32)
                                  for k, v in cfg["springs"].items()})
    c = ContactParams.create(**cfg["contact"])
    sim = RobotSim.create(model, contact=c, springs=springs, dt=cfg["dt"],
                          decimation=cfg["decimation"],
                          use_pallas_substep=False)
    if inputs is not None and "friction" in inputs:
        sim = sim.replace(
            contact=c.replace(
                friction=jnp.asarray(inputs["friction"]),
                stiffness=c.stiffness * jnp.asarray(inputs["stiff_mult"]),
                damping=c.damping * jnp.asarray(inputs["damp_mult"])),
            base_mass_delta=jnp.asarray(inputs["base_mass"]))
    return sim


def jax_robot_state(inputs):
    """(RobotState, tau) of ``torch_robot_cases.substep_inputs`` in JAX."""
    from legged_gym_dev_tpu.sim.dynamics import RobotState

    return (RobotState(*(jnp.asarray(inputs[k]) for k in
                         ("base_pos", "base_quat", "q", "v"))),
            jnp.asarray(inputs["tau"]))
