"""The port's LSTM actuator net (``sim/actuator_net.py``) against the JAX
package's, with weights drawn in numpy
(``torch_robot_cases.actuator_net_weights``): one step, and
``RobotSim.step_with_carry`` with the net's torque function on a robot
in the air (no contact), to 1e-6; ``from_torchscript`` on a TorchScript
module the test writes, against JAX's reader and the module's own
forward.
"""
import numpy as np
import torch

import jax
import jax.numpy as jnp

from legged_gym_dev_tpu.sim.actuator_net import ActuatorNetLSTM as JaxNet
from legged_gym_dev_tpu_torch.interop import actuator_net_from_numpy
from legged_gym_dev_tpu_torch.sim.actuator_net import ActuatorNetLSTM
from tests.torch_port_cases import jax_robot_sim, jax_robot_state
from tests.torch_robot_cases import (
    actuator_net_weights,
    substep_inputs,
    torch_sim,
    torch_state,
    write_actuator_net,
)
from tests.torch_port_cases import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-6, atol=1e-6)


def jax_net(seed):
    w = actuator_net_weights(seed)

    def j(k):
        return jnp.asarray(w[k])

    return JaxNet(
        w_ih=tuple(j(f"lstm.weight_ih_l{i}") for i in range(2)),
        w_hh=tuple(j(f"lstm.weight_hh_l{i}") for i in range(2)),
        b_ih=tuple(j(f"lstm.bias_ih_l{i}") for i in range(2)),
        b_hh=tuple(j(f"lstm.bias_hh_l{i}") for i in range(2)),
        out_w=j("linear.weight"), out_b=j("linear.bias"),
        out_scale=j("out_scale").reshape(()), in_scale=j("in_scale"))


def test_one_step_matches_jax():
    jnet = jax_net(0)
    tnet = actuator_net_from_numpy(jax.tree.map(np.asarray, jnet),
                                   device="cpu")
    rng = np.random.default_rng(1)
    N = 48
    x = rng.normal(0, [0.3, 3.0], (N, 2)).astype(np.float32)
    h = rng.normal(0, 0.5, (2, N, 8)).astype(np.float32)
    c = rng.normal(0, 0.5, (2, N, 8)).astype(np.float32)
    ref = jnet(jnp.asarray(x), jnp.asarray(h), jnp.asarray(c))
    out = tnet(torch.as_tensor(x), torch.as_tensor(h), torch.as_tensor(c))
    assert out[0].shape == (N,) and out[1].shape == (2, N, 8)
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    assert float(np.abs(np.asarray(ref[0])).max()) > 1.0


def test_step_with_carry_matches_jax():
    """Four substeps of the 4-joint robot 2 m above the ground, torques
    from the net every substep (position error to a fixed target, joint
    velocity), its hidden and cell state carried: the states and the
    carry match JAX's."""
    inp = substep_inputs("hopper4", 6, seed=2)
    inp["base_pos"][:, 2] += 2.0
    jnet = jax_net(4)
    tnet = actuator_net_from_numpy(jax.tree.map(np.asarray, jnet),
                                   device="cpu")
    target = np.random.default_rng(3).normal(0, 0.1, 4).astype(np.float32)

    def torque_fn(net, stack, zeros, target):
        def fn(carry, rs):
            h, c = carry
            x = stack([(target - rs.q).reshape(-1),
                       rs.v[:, 6:].reshape(-1)], -1)
            tau, h, c = net(x, h, c)
            return (h, c), tau.reshape(rs.q.shape)
        return fn, (zeros((2, 6 * 4, 8)), zeros((2, 6 * 4, 8)))

    fj, cj = torque_fn(jnet, jnp.stack, jnp.zeros, jnp.asarray(target))
    ft, ct = torque_fn(tnet, torch.stack, torch.zeros,
                       torch.as_tensor(target))
    js, jc = jax_robot_sim("hopper4").step_with_carry(
        jax_robot_state(inp)[0], cj, fj)
    ts, tc = torch_sim("hopper4").step_with_carry(torch_state(inp)[0], ct,
                                                  ft)
    for f in ("base_pos", "base_quat", "q", "v"):
        np.testing.assert_allclose(getattr(ts, f).numpy(),
                                   np.asarray(getattr(js, f)), err_msg=f,
                                   **TOL)
    for a, b in zip(tc, jc):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    assert float(np.abs(np.asarray(js.v)[:, 6:] - inp["v"][:, 6:]).max()) \
        > 1e-3


def test_from_torchscript_matches_jax_and_the_module(tmp_path):
    path = write_actuator_net(tmp_path / "net.pt", seed=5)
    jnet = JaxNet.from_torchscript(str(path))
    tnet = ActuatorNetLSTM.from_torchscript(str(path), device="cpu")
    for f in ("w_ih", "w_hh", "b_ih", "b_hh"):
        for a, b in zip(getattr(tnet, f), getattr(jnet, f)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for f in ("out_w", "out_b", "out_scale", "in_scale"):
        np.testing.assert_array_equal(getattr(tnet, f).numpy(),
                                      np.asarray(getattr(jnet, f)))
    # three steps of the net against the module's LSTM over the sequence
    rng = np.random.default_rng(6)
    xs = rng.normal(0, [0.3, 3.0], (3, 10, 2)).astype(np.float32)
    h = c = torch.zeros((2, 10, 8))
    taus = []
    for x in xs:
        tau, h, c = tnet(torch.as_tensor(x), h, c)
        taus.append(tau)
    with torch.no_grad():
        ref = torch.jit.load(str(path))(torch.as_tensor(xs))
    np.testing.assert_allclose(torch.stack(taus).numpy(), ref.numpy(),
                               rtol=1e-5, atol=1e-5)
