"""Learn, then plan: the port's tube-learning path into its NN_oneshot solve,
held against the JAX package's solve of the same learned network on the
CPU (the path tests/test_full_pipeline.py::test_learned_tube_in_mpc_solve
holds on a hopper URDF the repository does not have; here on the URDF-free
``rom_tracking`` task).

The port collects ``rom_tracking`` data (B=256, 8 s), trains the one-shot
net of that test (H_rev 5, H_fwd 20, 2x64 softplus_b5) with the vector
loss, and carries the weights into JAX through numpy. Both packages then
solve NN_oneshot on the gap problem with bench.py's randomised draws at
B=4, N=20, an 8x6 schedule, linsolve="pallas" (JAX's Pallas kernels in
interpret mode, the port's kernel wrappers on their plain versions), on a
draw away from a kink of the tube. Bars: plans z and w within 2e-3, each
scenario's violation no worse than JAX's by more than 1e-4 (both bars of
tests/test_torch_fast_tube.py; the 8x6 schedule leaves some scenarios
above 1e-3 in JAX as well), widths in [0, w_max] and not all zero; and the
port's full 20x10 schedule brings every scenario below 1e-3.

Also the CLI's ``collect --cpu`` / ``train-tube --cpu`` at a tiny size, the
port's model file round trip (bit for bit), and JAX's pickled tube model
carried into the port.
"""
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from legged_gym_dev_tpu.core import make_rom as jax_make_rom
from legged_gym_dev_tpu.solver import ALConfig as JaxConfig
from legged_gym_dev_tpu.solver import TrajOptParams as JaxParams
from legged_gym_dev_tpu.solver.fast_tube import (
    solve_tube_fast_batched as jax_solve_batched,
)
from legged_gym_dev_tpu.tube.models import MLP as JaxMLP
from legged_gym_dev_tpu_torch import cli
from legged_gym_dev_tpu_torch.controllers import DoubleSingleTracking
from legged_gym_dev_tpu_torch.envs.presets import make_rom_tracking_env
from legged_gym_dev_tpu_torch.interop import (
    trajopt_params_from_numpy,
    tube_mlp_from_numpy,
)
from legged_gym_dev_tpu_torch.solver import ALConfig, solve_tube_fast_batched
from legged_gym_dev_tpu_torch.tube.collect import collect_epochs
from legged_gym_dev_tpu_torch.tube.datasets import (
    scalar_horizon_tube_dataset,
)
from legged_gym_dev_tpu_torch.tube.losses import vector_tube_loss
from legged_gym_dev_tpu_torch.tube.models import MLP, load_mlp, save_mlp
from legged_gym_dev_tpu_torch.tube.train import (
    TrainConfig,
    conformal_width_scale,
    train_tube,
)
from tests.torch_port_cases import PROB, ROM_ARGS, gap_case
from tests.torch_port_cases import one_torch_thread  # noqa: F401

H_FWD, H_REV, B = 20, 5, 4
# A draw whose scenarios sit away from a kink of the learned tube.
SEED = 2
KW = dict(scaling=0.5, warm_start="interpolate", tube_ws="evaluate")
CFG = dict(outer_iters=8, inner_iters=6, linsolve="pallas",
           nn_basis_refresh=3)


@pytest.fixture(scope="module")
def learned():
    """Port-collected rollouts and the one-shot net trained on them."""
    sim = make_rom_tracking_env(num_envs=256, device="cpu").sim
    policy = DoubleSingleTracking.create(4.0, 4.0, sim.model.clip_v_z)
    data = collect_epochs(sim, policy, torch.Generator().manual_seed(0),
                          episode_length_s=8.0, epochs=1)
    ds = scalar_horizon_tube_dataset(data, H_fwd=H_FWD, H_rev=H_REV)
    model = MLP.create(torch.Generator().manual_seed(1), ds.input_dim,
                       ds.output_dim, num_units=64, num_layers=2,
                       activation="softplus_b5")
    res = train_tube(
        ds, model, lambda fw, w, d: vector_tube_loss(fw, w, d, alpha=0.9),
        TrainConfig(epochs=40, batch_size=256, eval_every=10),
        device="cpu")
    return data, ds, res


def test_training_learns_a_quantile(learned):
    data, ds, res = learned
    assert data.z.shape == (256, 81, 2)
    hist = res.history
    assert hist[-1]["loss"] < 0.5 * hist[0]["loss"], hist
    final = [h for h in hist if "coverage" in h][-1]
    assert final["coverage"] > 0.5, final
    s = conformal_width_scale(res.best_model, ds, alpha=0.9)
    assert 0.5 < s < 5.0, s


def _jax_params(case, mlp):
    nn = JaxMLP(weights=tuple(jnp.asarray(w.numpy()) for w in mlp.weights),
                biases=tuple(jnp.asarray(b.numpy()) for b in mlp.biases),
                activation=mlp.activation,
                final_activation=mlp.final_activation)
    p = JaxParams.create(
        jax_make_rom(*ROM_ARGS), H_FWD, H_REV, 10 * np.eye(2),
        10 * np.eye(2), PROB["start"], PROB["goal"], PROB["obs"]["c"],
        PROB["obs"]["r"], Qw=case["Qw"], w_max=1.0, tube_params=nn)
    pb = jax.tree.map(lambda x: jnp.broadcast_to(x, (B,) + x.shape), p)
    return pb.replace(z0=jnp.asarray(case["z0"]), zf=jnp.asarray(case["zf"]),
                      obs_c=jnp.asarray(case["obs_c"]),
                      obs_r=jnp.asarray(case["obs_r"]))


def test_learned_tube_plan_matches_jax(learned):
    _, _, res = learned
    mlp = res.best_model
    case = gap_case(B, H_FWD, H_REV, "NN_oneshot", seed=SEED)
    out_j = jax.jit(lambda pb: jax_solve_batched(
        pb, H_FWD, H_REV, tube_kind="NN_oneshot", cfg=JaxConfig(**CFG),
        **KW))(_jax_params(case, mlp))
    p = trajopt_params_from_numpy(
        *ROM_ARGS, H_FWD, H_REV, 10 * np.eye(2), 10 * np.eye(2),
        case["z0"], case["zf"], case["obs_c"], case["obs_r"], Qw=case["Qw"],
        w_max=1.0, tube_params=mlp, device="cpu")
    out_t = solve_tube_fast_batched(p, H_FWD, H_REV, tube_kind="NN_oneshot",
                                    cfg=ALConfig(**CFG), device="cpu", **KW)
    dz = np.abs(out_t.z.numpy() - np.asarray(out_j.z)).max()
    dw = np.abs(out_t.w.numpy() - np.asarray(out_j.w)).max()
    assert dz < 2e-3 and dw < 2e-3, (dz, dw)
    viol_t, viol_j = out_t.sol.viol.numpy(), np.asarray(out_j.sol.viol)
    assert (viol_t <= viol_j + 1e-4).all(), (viol_t, viol_j)
    full = solve_tube_fast_batched(
        p, H_FWD, H_REV, tube_kind="NN_oneshot",
        cfg=ALConfig(linsolve="pallas", nn_basis_refresh=3), device="cpu",
        **KW)
    assert (full.sol.viol.numpy() < 1e-3).all(), full.sol.viol
    for w in (out_t.w.numpy(), full.w.numpy()):
        assert w.min() >= -1e-6 and w.max() <= 1.0 + 1e-6, (w.min(),
                                                             w.max())
        assert w[:, 1:].mean() > 0.01, w.mean()


def test_cli_collect_and_train_tube_on_cpu(tmp_path):
    npz, shards = tmp_path / "r.npz", tmp_path / "shards"
    cli.main(["collect", "--cpu", "--num-envs", "8", "--epochs", "2",
              "--episode-length-s", "4.0", "--out", str(npz)])
    raw = np.load(npz)
    assert raw["z"].shape == (16, 41, 2) and raw["done"].shape == (16, 40)
    cli.main(["collect", "--cpu", "--num-envs", "8", "--epochs", "1",
              "--episode-length-s", "2.0", "--shards", "--out",
              str(shards)])
    assert sorted(p.name for p in shards.iterdir()) == ["epoch_0.tdl"]
    model = tmp_path / "tube.pt"
    cli.main(["train-tube", "--cpu", "--oneshot", "--H-fwd", "10",
              "--H-rev", "5", "--epochs", "2", "--data", str(npz),
              "--out", str(model)])
    m = load_mlp(model, device="cpu")
    assert m.weights[0].shape == (5 + 15 * 2, 128)
    assert m.weights[-1].shape == (128, 10)
    cli.main(["train-tube", "--cpu", "--epochs", "1", "--window", "2",
              "--data", str(shards)])
    # the config path: the one-shot config's dataset, loss and widths
    args = cli.build_parser().parse_args([
        "train-tube", "--cpu", "--config",
        "configs/tube_learning/tube_learning_oneshot.yaml", "--data",
        str(npz), "--epochs", "1"])
    ds, mlp, _, cfg, _, spec = cli.make_tube_training(args)
    assert (spec["H_rev"], spec["H_fwd"], spec["loss"]) == (25, 50,
                                                            "vector")
    assert (cfg.epochs, cfg.batch_size, cfg.learning_rate) == (1, 2048,
                                                               1e-3)
    assert ds.input_dim == 175 and mlp.activation == "softplus_b5"


def test_model_file_round_trip(tmp_path):
    gen = torch.Generator().manual_seed(5)
    m = MLP.create(gen, 12, 3, num_units=16, num_layers=2,
                   activation="tanh", final_activation="softplus")
    m.out_scale = torch.tensor(1.75)
    path = tmp_path / "m.pt"
    save_mlp(m, path)
    r = load_mlp(path, device="cpu")
    for a, b in zip(list(m.weights) + list(m.biases),
                    list(r.weights) + list(r.biases)):
        assert torch.equal(a, b)
    assert (r.activation, r.final_activation) == ("tanh", "softplus")
    assert torch.equal(r.out_scale, m.out_scale)
    x = torch.randn(7, 12, generator=gen)
    assert torch.equal(r(x), m(x))


def test_jax_pickled_model_carries_over():
    jm = JaxMLP.create(jax.random.PRNGKey(3), 9, 4, num_units=16,
                       num_layers=2, activation="elu",
                       final_activation="softplus")
    jm = jm.replace(out_scale=jnp.asarray(1.3, jnp.float32))
    tree = pickle.loads(pickle.dumps(jax.tree.map(np.asarray, jm)))
    tm = tube_mlp_from_numpy(tree, device="cpu")
    assert (tm.activation, tm.final_activation) == ("elu", "softplus")
    x = np.random.default_rng(0).normal(size=(5, 9)).astype(np.float32)
    np.testing.assert_allclose(tm(torch.as_tensor(x)).numpy(),
                               np.asarray(jm(jnp.asarray(x))), rtol=1e-6,
                               atol=1e-6)
