"""Port of the tube MLP (tube/models.py) against the JAX MLP, weights
carried by interop.mlp_from_numpy: forward, analytic Jacobian and VJP.
Tolerance: atol 1e-5 (fp32, O(1) outputs; the two sides sum the
products in different orders)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from legged_gym_dev_tpu.tube.models import MLP as JaxMLP
from legged_gym_dev_tpu_torch.interop import mlp_from_numpy
from legged_gym_dev_tpu_torch.utils.runtime import fp32_matmul
from tests.torch_port_cases import mlp_weights
from tests.torch_port_cases import one_torch_thread  # noqa: F401

ATOL = 1e-5
CONFIGS = [  # (activation, final activation, out_scale)
    ("softplus_b5", "softplus", None),
    ("softplus_b5", "none", 1.7),
    ("tanh", "softplus", None),
    ("elu", "none", None),
    ("relu", "softplus", 0.8),
]


def pair(act, final, scale, n_in=30, n_out=12, units=16, seed=0):
    ws, bs = mlp_weights(n_in, n_out, units, seed)
    jm = JaxMLP(weights=tuple(jnp.asarray(w) for w in ws),
                biases=tuple(jnp.asarray(b) for b in bs), activation=act,
                final_activation=final,
                out_scale=None if scale is None else jnp.float32(scale))
    tm = mlp_from_numpy(ws, bs, activation=act, final_activation=final,
                        out_scale=scale, device="cpu")
    return jm, tm


def inputs(shape, seed=1):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("act,final,scale", CONFIGS)
def test_forward_matches_jax(act, final, scale):
    jm, tm = pair(act, final, scale)
    x = inputs((3, 5, 30))            # extra leading axes, as the solver
    np.testing.assert_allclose(tm(torch.as_tensor(x)).numpy(),
                               np.asarray(jm(jnp.asarray(x))), atol=ATOL)


@pytest.mark.parametrize("act,final,scale", CONFIGS)
def test_value_and_jacobian_matches_jax(act, final, scale):
    jm, tm = pair(act, final, scale)
    x = inputs((6, 30))
    out_j, J_j = jm.value_and_jacobian(jnp.asarray(x))
    with fp32_matmul():
        out_t, J_t = tm.value_and_jacobian(torch.as_tensor(x))
    assert tuple(J_t.shape) == (6, 12, 30)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=ATOL)
    np.testing.assert_allclose(J_t.numpy(), np.asarray(J_j), atol=ATOL)


@pytest.mark.parametrize("act,final,scale", CONFIGS)
def test_value_and_vjp_matches_jax(act, final, scale):
    jm, tm = pair(act, final, scale)
    x, ct = inputs((6, 30)), inputs((6, 12), seed=2)
    out_j, g_j = jm.value_and_vjp(jnp.asarray(x), jnp.asarray(ct))
    out_t, g_t = tm.value_and_vjp(torch.as_tensor(x), torch.as_tensor(ct))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=ATOL)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), atol=ATOL)


def test_jacobian_matches_autograd():
    """The explicit product chain equals torch autograd's Jacobian."""
    _, tm = pair("softplus_b5", "softplus", None)
    x = torch.as_tensor(inputs((30,)))
    J = torch.autograd.functional.jacobian(tm, x)
    _, J_chain = tm.value_and_jacobian(x[None])
    torch.testing.assert_close(J_chain[0], J, atol=ATOL, rtol=1e-5)
