"""The port's policy exports against the JAX package's
(``utils/export.py``), given the same weights (flax parameters initialized
by JAX, carried to the port by ``interop.actor_critic_from_numpy``).

- TorchScript: the port's export and JAX's ``export_policy_torchscript``
  give the same actions on a numpy batch (atol 1e-6).
- The stateful LSTM module: both exports over 10 calls, ``reset_memory``
  in the middle (atol 1e-6), and the port's against the recurrent
  inference policy.
- The ``.pt2`` program (``torch.export``) round trip, at another batch
  than it was traced at.
- ONNX returns None without the ``onnx`` package.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from legged_gym_dev_tpu.rl import networks as jnet
from legged_gym_dev_tpu.utils import export as jexport
from legged_gym_dev_tpu_torch.interop import actor_critic_from_numpy
from legged_gym_dev_tpu_torch.utils import export
from tests.torch_port_cases import one_torch_thread  # noqa: F401

O, A = 20, 4
ATOL = 1e-6


def params(model, recurrent=False):
    args = (jnp.zeros((1, O)),)
    if recurrent:
        args += (model.initial_carry(1),)
    return jax.tree.map(np.asarray,
                        model.init(jax.random.PRNGKey(3), *args))


def obs(n, seed=0):
    return np.random.default_rng(seed).normal(size=(n, O)).astype(
        np.float32)


@pytest.fixture(scope="module")
def feed_forward():
    p = params(jnet.ActorCritic(num_actions=A, actor_hidden_dims=(32, 16),
                                critic_hidden_dims=(32, 16)))
    return p, actor_critic_from_numpy(p, device="cpu")


def test_torchscript_matches_jax_export(feed_forward, tmp_path):
    p, model = feed_forward
    jm = torch.jit.load(jexport.export_policy_torchscript(
        p, str(tmp_path / "jax.pt")))
    tm = torch.jit.load(export.export_policy_torchscript(
        model, str(tmp_path / "port" / "policy.pt")))
    x = torch.as_tensor(obs(64))
    with torch.no_grad():
        np.testing.assert_allclose(tm(x).numpy(), jm(x).numpy(), atol=ATOL)
        np.testing.assert_allclose(tm(x).numpy(), model(x)[0].numpy(),
                                   atol=ATOL)


def test_exported_program_round_trip(feed_forward, tmp_path):
    _, model = feed_forward
    path = export.export_policy_exported(model, O, str(tmp_path / "p.pt2"))
    f = export.load_policy_exported(path)
    with torch.no_grad():
        for n in (1, 7, 300):
            x = torch.as_tensor(obs(n, seed=n))
            np.testing.assert_allclose(f(x).numpy(), model(x)[0].numpy(),
                                       atol=ATOL)
    fixed = export.load_policy_exported(export.export_policy_exported(
        model, O, str(tmp_path / "b3.pt2"), batch=3))
    x = torch.as_tensor(obs(3))
    with torch.no_grad():
        np.testing.assert_allclose(fixed(x).numpy(), model(x)[0].numpy(),
                                   atol=ATOL)


def test_onnx_needs_the_onnx_package(feed_forward, tmp_path):
    try:
        import onnx  # noqa: F401
        present = True
    except ImportError:
        present = False
    out = export.export_policy_onnx(feed_forward[1], O,
                                    str(tmp_path / "p.onnx"))
    assert (out is not None) == present
    assert (out is None) == (jexport.export_policy_onnx(
        feed_forward[0], O, str(tmp_path / "j.onnx")) is None)


def test_lstm_export_matches_jax_and_the_policy(tmp_path):
    p = params(jnet.ActorCriticRecurrent(
        num_actions=A, rnn_hidden_size=16, actor_hidden_dims=(32,),
        critic_hidden_dims=(32,)), recurrent=True)
    model = actor_critic_from_numpy(p, device="cpu")
    jm = torch.jit.load(jexport.export_policy_lstm_torchscript(
        p, str(tmp_path / "jax_lstm.pt")))
    tm = torch.jit.load(export.export_policy_lstm_torchscript(
        model, str(tmp_path / "lstm.pt")))
    xs = torch.as_tensor(obs(10, seed=4))
    carry = model.initial_carry(1)
    with torch.no_grad():
        for i in range(10):
            if i == 5:
                jm.reset_memory()
                tm.reset_memory()
                carry = model.initial_carry(1)
            a_t, a_j = tm(xs[i:i + 1]), jm(xs[i:i + 1])
            mean, _, _, carry = model(xs[i:i + 1], carry)
            np.testing.assert_allclose(a_t.numpy(), a_j.numpy(), atol=ATOL)
            np.testing.assert_allclose(a_t.numpy(), mean.numpy(), atol=ATOL)
            np.testing.assert_allclose(tm.hidden_state.numpy(),
                                       carry[1].numpy(), atol=ATOL)
    assert float(tm.cell.bias_ih.abs().max()) == 0.0
