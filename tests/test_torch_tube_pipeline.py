"""The port's tube-learning pipeline against the JAX package's on the same
numpy inputs: datasets, the ROM-tracking collector, losses, training,
calibration, ``tube_spec`` and the tube parts of ``evaluation.py``
(tests/test_tube_pipeline.py and tests/test_evaluation.py, as
JAX-against-port tests).

Tolerances, stated per check:
- datasets, batches, splits and ``tube_spec``: equal;
- the collector: shapes, T and steps a tick equal; one ROM tick from a
  carried JAX state (no mode expiring in it) at 1e-6;
- each loss's value and gradient: 1e-6, on a batch with exact-zero
  residuals (``torch.abs`` has derivative 0 at 0 where ``jnp.abs`` has +1);
- Adam against ``optax.adam``: equal after 30 steps; with
  ``clip_by_global_norm``, rtol 1e-6 (the global norm's sum is reduced in
  another order, which moves it by an ulp);
- ``train_tube``, 20 optimizer steps from JAX's initial weights with one
  seed (the same batches): weights at rtol 1e-5, atol 1e-6; the history's
  losses at 1e-5;
- ``conformal_width_scale``, ``evaluate_rollout_recursive`` and the
  evaluation functions: 1e-5 (matrix products round differently).
"""
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from legged_gym_dev_tpu import evaluation as jev
from legged_gym_dev_tpu.controllers import (
    DoubleSingleTracking as JaxDoubleSingleTracking,
)
from legged_gym_dev_tpu.envs.presets import (
    make_rom_tracking_env as jax_make_rom_tracking_env,
)
from legged_gym_dev_tpu.tube import collect as jcol
from legged_gym_dev_tpu.tube import datasets as jds
from legged_gym_dev_tpu.tube import losses as jlo
from legged_gym_dev_tpu.tube import train as jtr
from legged_gym_dev_tpu.tube.models import MLP as JaxMLP
from legged_gym_dev_tpu.utils.config import tube_spec as jax_tube_spec
from legged_gym_dev_tpu_torch import evaluation as tev
from legged_gym_dev_tpu_torch.controllers import DoubleSingleTracking
from legged_gym_dev_tpu_torch.envs.presets import make_rom_tracking_env
from legged_gym_dev_tpu_torch.interop import (
    rom_sim_state_from_numpy,
    tube_mlp_from_numpy,
)
from legged_gym_dev_tpu_torch.tube import collect as tcol
from legged_gym_dev_tpu_torch.tube import datasets as tds
from legged_gym_dev_tpu_torch.tube import losses as tlo
from legged_gym_dev_tpu_torch.tube import train as ttr
from legged_gym_dev_tpu_torch.utils.config import load_config, tube_spec
from tests.torch_port_cases import one_torch_thread  # noqa: F401

B = 16


def rollouts(E=12, T=40, n=2, m=2, seed=0, p_done=0.03):
    """Random rollout arrays (float32) with a few mid-episode dones."""
    rng = np.random.default_rng(seed)
    return dict(
        z=rng.normal(size=(E, T + 1, n)).astype(np.float32),
        v=rng.normal(size=(E, T, m)).astype(np.float32),
        pz_x=rng.normal(size=(E, T + 1, n)).astype(np.float32),
        done=rng.uniform(size=(E, T)) < p_done)


def both(**kw):
    d = rollouts(**kw)
    return jds.RolloutData(**d), tds.RolloutData(**d)


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ---------------------------------------------------------------------------
# datasets
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 4])
def test_dataset_constructors_equal_jax(n):
    jr, tr = both(n=n)
    _eq(tr.done, jr.done)
    assert tr.done[:, -1].all()
    for N, dN in ((1, 1), (3, 1), (3, 2)):
        _eq(tds.sliding_window(tr.v, N, dN, 2),
            jds.sliding_window(jr.v, N, dN, 2))
        for name in ("scalar_tube_dataset", "vector_tube_dataset",
                     "error_dynamics_dataset"):
            a = getattr(tds, name)(tr, N=N, dN=dN)
            b = getattr(jds, name)(jr, N=N, dN=dN)
            _eq(a.data, b.data)
            _eq(a.target, b.target)
        a = tds.scalar_tube_dataset(tr, N=N, dN=dN, recursive=True)
        b = jds.scalar_tube_dataset(jr, N=N, dN=dN, recursive=True)
        _eq(a.data, b.data)
        for name in ("alpha_scalar_tube_dataset",
                     "alpha_vector_tube_dataset"):
            a = getattr(tds, name)(tr, N=N, dN=dN,
                                   rng=np.random.default_rng(1))
            b = getattr(jds, name)(jr, N=N, dN=dN,
                                   rng=np.random.default_rng(1))
            _eq(a.data, b.data)
            _eq(a.target, b.target)
            a.update(np.random.default_rng(2))
            b.update(np.random.default_rng(2))
            _eq(a.data, b.data)
    a, b = tds.scalar_tube_dataset(tr, N=2), jds.scalar_tube_dataset(jr, N=2)
    for (x, y) in zip(a.random_split(0.8, np.random.default_rng(3)),
                      b.random_split(0.8, np.random.default_rng(3))):
        _eq(x.data, y.data)
        _eq(x.target, y.target)


@pytest.mark.parametrize("H_fwd,H_rev,p_done", [
    (10, 5, 0.03), (20, 5, 0.0), (30, 25, 0.0), (10, 3, 0.2), (45, 5, 0.03)])
def test_horizon_dataset_and_batches_equal_jax(H_fwd, H_rev, p_done):
    """The clean-window filter (vectorised here, a loop in JAX), the padded
    series, the split and ``sample_batch`` for the same numpy seed."""
    jr, tr = both(n=4, p_done=p_done)
    a = tds.scalar_horizon_tube_dataset(tr, H_fwd=H_fwd, H_rev=H_rev)
    b = jds.scalar_horizon_tube_dataset(jr, H_fwd=H_fwd, H_rev=H_rev)
    for f in ("w", "z_rest", "v"):
        _eq(getattr(a, f), getattr(b, f))
    assert (a.valid is None) == (b.valid is None)
    if b.valid is not None:
        assert a.valid.dtype == b.valid.dtype
        _eq(a.valid, b.valid)
    assert (a.input_dim, a.output_dim) == (b.input_dim, b.output_dim)
    for ds_a, ds_b in ((a, b), (tds.scalar_horizon_tube_dataset(
            tr, H_fwd=H_fwd, H_rev=H_rev, drop_done_episodes=False),
            jds.scalar_horizon_tube_dataset(
                jr, H_fwd=H_fwd, H_rev=H_rev, drop_done_episodes=False))):
        if ds_b.w.shape[1] - H_fwd - 1 <= H_rev and ds_b.valid is None:
            continue
        xa, ya = ds_a.sample_batch(np.random.default_rng(4), 257)
        xb, yb = ds_b.sample_batch(np.random.default_rng(4), 257)
        assert xa.dtype == xb.dtype == np.float32
        _eq(xa, xb)
        _eq(ya, yb)
        for sa, sb in zip(ds_a.random_split(0.75, np.random.default_rng(5)),
                          ds_b.random_split(0.75, np.random.default_rng(5))):
            for f in ("w", "z_rest", "v"):
                _eq(getattr(sa, f), getattr(sb, f))
            assert (sa.valid is None) == (sb.valid is None)
            if sb.valid is not None:
                _eq(sa.valid, sb.valid)


# ---------------------------------------------------------------------------
# collection
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def rom_envs():
    return (jax_make_rom_tracking_env(num_envs=B),
            make_rom_tracking_env(num_envs=B, device="cpu"))


def test_collect_rom_tracking_shapes(rom_envs):
    jenv, tenv = rom_envs
    jsim, tsim = jenv.sim, tenv.sim
    jp = JaxDoubleSingleTracking.create(4.0, 4.0, jsim.model.clip_v_z)
    tp = DoubleSingleTracking.create(4.0, 4.0, tsim.model.clip_v_z)
    jd = jcol.collect_epochs(jsim, jp, jax.random.PRNGKey(0), 2.0, 2)
    td = tcol.collect_epochs(tsim, tp, torch.Generator().manual_seed(0),
                             2.0, 2)
    for f in ("z", "v", "pz_x", "done"):
        assert getattr(td, f).shape == getattr(jd, f).shape, f
        assert getattr(td, f).dtype == getattr(jd, f).dtype, f
    assert td.z.shape == (2 * B, 21, 2)
    assert tcol._ticks(2.0, tsim.rom.dt, tsim.traj_gen.dt_loop) == (20, 2)
    _eq(td.done, jd.done)
    err = np.linalg.norm(td.pz_x - td.z, axis=-1)
    # the PD tracker keeps the robot near the plan (as JAX's test holds it)
    assert err[:, 5:].mean() < 0.5


def test_rom_tick_matches_jax(rom_envs):
    """One ROM tick (2 sim steps under the PD law) from a carried JAX
    state, every mode held past the tick: records and state at 1e-6."""
    jenv, tenv = rom_envs
    jsim, tsim = jenv.sim, tenv.sim
    js = jax.jit(jsim.reset)(jax.random.PRNGKey(1))
    jp = JaxDoubleSingleTracking.create(4.0, 4.0, jsim.model.clip_v_z)
    for _ in range(3):
        js = jsim.step(js, jp(jsim.get_observations(js)))
    js = js.replace(traj_gen=js.traj_gen.replace(
        t_final=js.traj_gen.t_final + 100.0))
    ts = rom_sim_state_from_numpy(jax.tree.map(np.asarray, js), tsim)
    tp = DoubleSingleTracking.create(4.0, 4.0, tsim.model.clip_v_z)
    for _ in range(2):
        js = jsim.step(js, jp(jsim.get_observations(js)))
    j_rec = (jsim.traj_gen.get_trajectory(js.traj_gen)[:, 0],
             jsim.rom.proj_z(js.root_states), js.traj_gen.v)
    ts2, t_rec = tcol.rom_tick(tsim, tp, ts, 2)
    for a, b in zip(t_rec[:3], j_rec):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)
    assert not t_rec[3].any()
    np.testing.assert_allclose(ts2.root_states.numpy(),
                               np.asarray(js.root_states), rtol=1e-6,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

LOSSES = ["scalar_tube_loss", "scalar_horizon_tube_loss", "vector_tube_loss",
          "alpha_scalar_tube_loss", "alpha_vector_tube_loss", "error_loss"]


@pytest.mark.parametrize("name", LOSSES)
def test_loss_value_and_grad_match_jax(name):
    rng = np.random.default_rng(6)
    w = rng.uniform(0, 0.5, (64, 5)).astype(np.float32)
    fw = (w + rng.normal(0, 0.3, w.shape)).astype(np.float32)
    fw[::3] = w[::3]                     # exact-zero residuals
    fw[1, :] = w[1, :] + 3.0             # beyond the Huber knee
    data = rng.uniform(0, 1, (64, 7)).astype(np.float32)
    if name.startswith("scalar") or name.startswith("alpha_scalar"):
        w, fw = w[:, :1], fw[:, :1]
    jf, tf = getattr(jlo, name), getattr(tlo, name)
    jv, jg = jax.value_and_grad(jf)(jnp.asarray(fw), jnp.asarray(w),
                                    jnp.asarray(data))
    x = torch.tensor(fw, requires_grad=True)
    tv = tf(x, torch.as_tensor(w), torch.as_tensor(data))
    (tg,) = torch.autograd.grad(tv, x)
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6,
                               atol=1e-7)
    assert list(tlo.LOSS_REGISTRY) == list(jlo.LOSS_REGISTRY)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("clip", [0.0, 0.5])
def test_adam_matches_optax(clip):
    rng = np.random.default_rng(7)
    ps = [rng.normal(size=(5, 3)).astype(np.float32),
          rng.normal(size=3).astype(np.float32)]
    tx = optax.adam(1e-3)
    if clip > 0:
        tx = optax.chain(optax.clip_by_global_norm(clip), tx)
    jp = [jnp.asarray(p) for p in ps]
    js = tx.init(jp)
    tp = [torch.tensor(p) for p in ps]
    opt = ttr.Adam(1e-3, clip)
    ts = opt.init(tp)
    for k in range(30):
        gs = [(rng.normal(size=p.shape) * (0.1 if k % 2 else 3.0))
              .astype(np.float32) for p in ps]
        gs[0][0, 0] = 0.0
        u, js = tx.update([jnp.asarray(g) for g in gs], js, jp)
        jp = optax.apply_updates(jp, u)
        ts = opt.update_(tp, [torch.tensor(g) for g in gs], ts)
    for a, b in zip(tp, jp):
        if clip > 0:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=0)
        else:
            _eq(a.numpy(), b)
    assert int(ts.count) == 30


def _jax_mlp(n_in, n_out, seed=0, units=32, final="none"):
    return JaxMLP.create(jax.random.PRNGKey(seed), n_in, n_out,
                         num_units=units, num_layers=2,
                         activation="softplus_b5", final_activation=final)


def _train_case(kind):
    jr, tr = both(E=20, T=40, n=2, seed=8)
    if kind == "oneshot":
        mk = dict(H_fwd=10, H_rev=5)
        jd, td = (jds.scalar_horizon_tube_dataset(jr, **mk),
                  tds.scalar_horizon_tube_dataset(tr, **mk))
        cfg = dict(epochs=2, batch_size=12, eval_every=1, seed=3)
        jl = lambda fw, w, d: jlo.vector_tube_loss(fw, w, d, alpha=0.9)
        tl = lambda fw, w, d: tlo.vector_tube_loss(fw, w, d, alpha=0.9)
    else:
        jd, td = jds.scalar_tube_dataset(jr, N=3), tds.scalar_tube_dataset(
            tr, N=3)
        cfg = dict(epochs=2, batch_size=61, eval_every=1, seed=3,
                   grad_clip=1.0)
        jl = lambda fw, w, d: jlo.scalar_tube_loss(fw, w, d, alpha=0.9)
        tl = lambda fw, w, d: tlo.scalar_tube_loss(fw, w, d, alpha=0.9)
    return jd, td, cfg, jl, tl


@pytest.mark.parametrize("kind", ["oneshot", "scalar"])
def test_train_tube_matches_jax(kind):
    """20 optimizer steps (2 epochs of 10) with evaluation each epoch,
    from JAX's initial weights carried across, on the same seed."""
    jd, td, cfg, jl, tl = _train_case(kind)
    jm = _jax_mlp(jd.input_dim, jd.output_dim)
    tm = tube_mlp_from_numpy(jax.tree.map(np.asarray, jm), device="cpu")
    jres = jtr.train_tube(jd, jm, jl, jtr.TrainConfig(**cfg))
    tres = ttr.train_tube(td, tm, tl, ttr.TrainConfig(**cfg), device="cpu")
    assert [h["steps"] for h in tres.history] == [10, 10]
    for hj, ht in zip(jres.history, tres.history):
        for k in ("loss", "grad_norm", "coverage", "eval_mean_err"):
            np.testing.assert_allclose(ht[k], hj[k], rtol=1e-5, atol=1e-6,
                                       err_msg=k)
    for m_t, m_j in ((tres.model, jres.model),
                     (tres.best_model, jres.best_model)):
        for a, b in zip(list(m_t.weights) + list(m_t.biases),
                        list(m_j.weights) + list(m_j.biases)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-6)
    # the trained weights are frozen copies, and training moved them
    assert not any(p.requires_grad for p in tres.model.parameters())
    assert not torch.equal(tres.model.weights[0], tm.weights[0])


def test_conformal_scale_and_recursive_rollout_match_jax():
    jd, td, _, _, _ = _train_case("oneshot")
    jm = _jax_mlp(jd.input_dim, jd.output_dim, seed=4, final="softplus")
    tm = tube_mlp_from_numpy(jax.tree.map(np.asarray, jm), device="cpu")
    for per_step in (True, False):
        s_j = jtr.conformal_width_scale(jm, jd, alpha=0.9, batch=512,
                                        per_step=per_step,
                                        rng=np.random.default_rng(9))
        s_t = ttr.conformal_width_scale(tm, td, alpha=0.9, batch=512,
                                        per_step=per_step,
                                        rng=np.random.default_rng(9))
        np.testing.assert_allclose(s_t, s_j, rtol=1e-5)
    jr, tr = both(E=4, T=30, n=4, seed=10)
    js = jds.scalar_tube_dataset(jr, N=1)
    jm = _jax_mlp(js.input_dim, 1, seed=5, final="softplus")
    tm = tube_mlp_from_numpy(jax.tree.map(np.asarray, jm), device="cpu")
    z_rest, v = jr.z[0, :-1, 2:], jr.v[0]
    w_j = jtr.evaluate_rollout_recursive(jm, 0.1, jnp.asarray(z_rest),
                                         jnp.asarray(v), 0)
    w_t = ttr.evaluate_rollout_recursive(tm, 0.1, z_rest, v, 0)
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), rtol=1e-5,
                               atol=1e-6)
    assert ttr.coverage(np.ones((3, 2)), np.zeros((3, 2))) == 1.0


# ---------------------------------------------------------------------------
# config and evaluation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", [
    "default", "tube_learning", "tube_learning_oneshot", "alpha_tube_learning",
    "error_dynamics", "error_dynamics_simple", "tube_learning_simple",
    "tube_learning_simple_one_shot"])
def test_tube_spec_matches_jax(name):
    from legged_gym_dev_tpu.utils.config import load_config as jax_load

    path = f"configs/tube_learning/{name}.yaml"
    assert load_config(path) == jax_load(path)
    assert tube_spec(load_config(path).get("tube")) == jax_tube_spec(
        jax_load(path).get("tube"))
    for bad in ({"dataset": "nope"}, {"loss": "nope"}, {"typo": 1}):
        with pytest.raises(ValueError):
            tube_spec(bad)


def _close(a, b, rtol=1e-5, atol=1e-6, name=""):
    if isinstance(b, dict):
        assert set(a) == set(b), name
        for k in b:
            _close(a[k], b[k], rtol, atol, f"{name}/{k}")
    else:
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=name)


def test_tube_evaluations_match_jax():
    jr, tr = both(E=6, T=30, n=2, seed=11, p_done=0.0)
    models = {}
    specs = {
        "standard": {"kind": "scalar", "N": 1, "dN": 1, "recursive": False},
        "input_history": {"kind": "scalar", "N": 3, "dN": 1,
                          "recursive": False},
        "recursive": {"kind": "scalar", "N": 3, "dN": 1, "recursive": True},
        "oneshot": {"kind": "oneshot", "H_fwd": 5, "H_rev": 3},
    }
    for i, (name, spec) in enumerate(specs.items()):
        if spec["kind"] == "oneshot":
            ds = jds.scalar_horizon_tube_dataset(jr, H_fwd=5, H_rev=3)
            n_in, n_out = ds.input_dim, ds.output_dim
        else:
            ds = jds.scalar_tube_dataset(jr, N=spec["N"],
                                         recursive=spec["recursive"])
            n_in, n_out = ds.input_dim, 1
        jm = _jax_mlp(n_in, n_out, seed=i, units=16, final="softplus")
        models[name] = (jm, spec)
    tmodels = {k: (tube_mlp_from_numpy(jax.tree.map(np.asarray, m),
                                       device="cpu"), s)
               for k, (m, s) in models.items()}
    _close(tev.compare_tube_models(tmodels, tr, batch=64),
           jev.compare_tube_models(models, jr, batch=64))
    ds = jds.scalar_tube_dataset(jr, N=3)
    _close(tev.evaluate_tube_one_step(tmodels["input_history"][0], ds.data,
                                      ds.target),
           jev.evaluate_tube_one_step(models["input_history"][0], ds.data,
                                      ds.target))
    _close(tev.evaluate_tube_recursive(tmodels["input_history"][0], tr, 3),
           jev.evaluate_tube_recursive(models["input_history"][0], jr, 3))
    ed = jds.error_dynamics_dataset(jr, N=1)
    jm = _jax_mlp(ed.input_dim, 2, seed=12, units=16)
    tm = tube_mlp_from_numpy(jax.tree.map(np.asarray, jm), device="cpu")
    _close(tev.evaluate_error_dynamics(tm, tr, horizon=10),
           jev.evaluate_error_dynamics(jm, jr, horizon=10))


def test_trace_evaluations_match_jax():
    rng = np.random.default_rng(13)
    n = 500
    w = rng.uniform(0.05, 0.3, n).astype(np.float32)
    w[:20] = 0.0
    err = w * rng.uniform(0.3, 1.5, n).astype(np.float32)
    trace = types.SimpleNamespace(
        z=np.zeros((n, 2), np.float32),
        w=w, pz_x=np.stack([err, np.zeros(n, np.float32)], -1),
        viol=rng.uniform(0, 1e-4, n), converged=rng.uniform(size=n) > 0.1)
    _close(tev.evaluate_tube_on_mpc_trace(trace),
           jev.evaluate_tube_on_mpc_trace(trace), rtol=0, atol=0)
    for alpha in (0.5, 0.9):
        assert (tev.trace_conformal_scale(trace, alpha)
                == jev.trace_conformal_scale(trace, alpha))


def test_velocity_tracking_evaluation_on_the_quadruped():
    """``evaluate_velocity_tracking`` on the quadruped's velocity task
    (a zero-action policy, 6 steps): finite statistics inside their
    ranges. (The JAX evaluation rolls its own random draws, so the two
    are not compared value for value.)"""
    from legged_gym_dev_tpu_torch.envs.presets import (
        _anymal_c_kwargs,
        make_velocity_env,
    )
    from tests.torch_robot_cases import QUADRUPED_URDF

    env = make_velocity_env(QUADRUPED_URDF, **_anymal_c_kwargs({}),
                            num_envs=4, add_noise=False, device="cpu")
    out = tev.evaluate_velocity_tracking(
        env, lambda obs: torch.zeros(4, 12),
        torch.Generator().manual_seed(0), steps=6, settle=2)
    assert set(out) == {"track_err_m_s", "single_stance_frac",
                        "single_stance_moving", "done_rate_per_step"}
    assert np.isfinite(out["track_err_m_s"]) and out["track_err_m_s"] >= 0
    for k in ("single_stance_frac", "single_stance_moving",
              "done_rate_per_step"):
        assert 0.0 <= out[k] <= 1.0, (k, out[k])
