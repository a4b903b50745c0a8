"""Data-parallel training and solving over a device mesh of CPU shards
(``legged_gym_dev_tpu_torch/parallel/mesh.py``), the port's counterpart of
tests/test_parallel.py and test_pallas_substep.py's sharded parity:

1. ``substep_sharded`` (K3's sharded route; its plain version on CPU
   shards) on 8 shards, the hopper at B=32 with per-env DR rows drawn by
   numpy, against the JAX package's unsharded XLA substep
   (``use_pallas_substep=False``) at rtol = atol = 2e-5, JAX's bar
   (test_pallas_substep.py's sharded test holds its shard_map kernel to
   that same XLA path);
2. the sharded l1 solve (N=10, B=16, 5x5; also on a (2, 4) host mesh),
   its verdicts (N=4) and the closed loop (N=8, H=3) against the port's
   unsharded calls within 1e-5, and a 4-step ROM-sim collect step, equal
   on the envs that drew nothing;
3. the command curriculum's reduction over the shards;
4. a sharded PPO iteration on ``rom_tracking`` (64 envs, 8 shards);
5. ``OnPolicyRunner(mesh=)`` with a checkpoint that resumes unsharded;
6. a 1-shard mesh bit for bit the unsharded runner;
7. ``cli train --cpu --dp-devices 2``;
8. the recurrent runner with its carry sharded.
"""
import json

import numpy as np
import pytest
import torch

from legged_gym_dev_tpu_torch import cli
from legged_gym_dev_tpu_torch.controllers import DoubleSingleTracking
from legged_gym_dev_tpu_torch.core import make_rom
from legged_gym_dev_tpu_torch.envs import ShardedEnv, presets, registry
from legged_gym_dev_tpu_torch.envs.base import shard_env_state
from legged_gym_dev_tpu_torch.ops import substep_kernels as sk
from legged_gym_dev_tpu_torch.parallel import mesh as pm
from legged_gym_dev_tpu_torch.rl import ActorCritic, ActorCriticRecurrent
from legged_gym_dev_tpu_torch.rl.ppo import (
    PPOConfig,
    init_train_state,
    make_learn_iteration_sharded,
    ppo_update,
    rollout_sharded,
)
from legged_gym_dev_tpu_torch.rl.runner import OnPolicyRunner
from legged_gym_dev_tpu_torch.solver import (
    ALConfig,
    StagedProblem,
    certify_staged_batched,
    closed_loop_tube_mpc_fast,
    solve_tube_fast_batched,
    staged_bounds,
)
from tests.torch_port_cases import (
    PLANT_ARGS,
    gap_case,
    jax_robot_sim,
    jax_robot_state,
    torch_params,
)
from tests.torch_port_cases import one_torch_thread  # noqa: F401
from tests.torch_robot_cases import (
    CASSIE_URDF,
    substep_inputs,
    torch_sim,
    torch_state,
)

CPU = torch.device("cpu")
FIELDS = ("base_pos", "base_quat", "q", "v")


def cpu_mesh(k):
    return pm.make_mesh(k, devices=[CPU] * k)


# ---------------------------------------------------------------------------
# 1. K3's sharded route
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("route", ["substep_sharded", "sim"])
def test_substep_sharded_matches_jax(route):
    """8 shards of 4 envs, each with its rows of the base payload mass
    (B,), friction (B, 1, 1) and the contact stiffness and damping
    multipliers (B, 1), against JAX's unsharded XLA substep."""
    B, mesh = 32, cpu_mesh(8)
    inp = substep_inputs("hopper", B, seed=2, dr=True)
    sim = torch_sim("hopper", "cpu", inp)
    st, tau = torch_state(inp)
    sk.reset_launches()
    if route == "substep_sharded":
        out = sk.substep_sharded(sim, pm.shard_batch(st, mesh, batch_size=B),
                                 tau, mesh, "dp")
        assert isinstance(out, pm.Sharded) and len(out) == 8
        assert all(s.base_pos.shape == (4, 3) for s in out)
        got = pm.gather(out)
    else:   # the sim's route: a whole batch in, a whole batch out
        got = sim.replace(shard_mesh=(mesh, "dp")).substep(st, tau)
        assert isinstance(got, type(st))
    ref = jax_robot_sim("hopper", inp).substep(*jax_robot_state(inp))
    for f in FIELDS:
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(ref, f)), rtol=2e-5,
                                   atol=2e-5, err_msg=f)
    # each shard's sim holds its own DR rows, cut once and kept, and is an
    # ordinary sim of its shard (no mesh of its own)
    shards = sim.shard(mesh)
    assert shards is sim.shard(mesh)
    for i, s in enumerate(shards):
        assert s.shard_mesh is None and s.device == CPU
        assert s.contact.friction.shape == (4, 1, 1)
        assert torch.equal(s.base_mass_delta,
                           sim.base_mass_delta[4 * i:4 * i + 4])
        assert torch.equal(s.contact.stiffness,
                           sim.contact.stiffness[4 * i:4 * i + 4])
    assert sum(sk.launches().values()) == 0    # CPU shards launch nothing


def test_substep_sharded_needs_a_divisible_batch():
    inp = substep_inputs("hopper", 6, seed=2)
    st, tau = torch_state(inp)
    with pytest.raises(ValueError, match="not divisible"):
        sk.substep_sharded(torch_sim("hopper", "cpu", inp), st, tau,
                           cpu_mesh(4), "dp")


# ---------------------------------------------------------------------------
# 2. solver, closed loop and collection on a mesh
# ---------------------------------------------------------------------------

N, H_REV = 10, 5


@pytest.fixture(scope="module")
def solve_case():
    case = gap_case(16, N, H_REV, "l1", bench_draws=False)
    cfg = ALConfig(outer_iters=5, inner_iters=5)

    def solve(p):
        return solve_tube_fast_batched(p, N, H_REV, tube_kind="l1",
                                       scaling=0.5, cfg=cfg,
                                       warm_start="interpolate", tube_ws=0.0,
                                       device=p.z0.device)

    p = torch_params(case)
    return p, solve, solve(p)


@pytest.mark.parametrize("mesh_kind", ["dp8", "host2x4"])
def test_sharded_solve_matches_unsharded(solve_case, mesh_kind):
    p, solve, ref = solve_case
    if mesh_kind == "dp8":
        mesh, axis = cpu_mesh(8), "dp"
    else:
        mesh = pm.make_host_mesh(2, 4, devices=[CPU] * 8)
        axis = ("dcn", "ici")
    sh = pm.shard_batch(p, mesh, axis=axis, batch_size=16)
    assert sh[0].z0.shape == (2, 2) and sh[0].rom is p.rom
    out = pm.gather(pm.map_shards(solve, sh))
    np.testing.assert_allclose(out.z.numpy(), ref.z.numpy(), atol=1e-5)
    np.testing.assert_allclose(out.sol.viol.numpy(), ref.sol.viol.numpy(),
                               atol=1e-5)


def test_sharded_verdicts_match_unsharded():
    """``certify_staged_batched`` shard by shard (2 shards, N=4, B=4:
    its restorations and polish steps dominate, whatever the size)
    equals the unsharded verdicts and restored iterates."""
    n_, h_ = 4, 2
    p = torch_params(gap_case(4, n_, h_, "l1"))
    cfg = ALConfig(outer_iters=5, inner_iters=5)
    sp = StagedProblem(n=2, m=2, N=n_, K=2, tube_kind="l1", scaling=0.5,
                       track_ref=False)

    def solve_and_certify(pp):
        o = solve_tube_fast_batched(pp, n_, h_, tube_kind="l1", scaling=0.5,
                                    cfg=cfg, warm_start="interpolate",
                                    tube_ws=0.0, device=pp.z0.device)
        lb, ub = staged_bounds(pp, 2, 2, n_)
        return certify_staged_batched(
            sp, pp, o.sol.x.reshape(pp.batch_size, n_ + 1, -1), o.sol.viol,
            lb, ub, device=pp.z0.device)

    ref = solve_and_certify(p)
    out = pm.gather(pm.map_shards(solve_and_certify,
                                  pm.shard_batch(p, cpu_mesh(2),
                                                 batch_size=4)))
    assert torch.equal(out.verdict, ref.verdict)
    np.testing.assert_allclose(out.u_restored.numpy(),
                               ref.u_restored.numpy(), atol=1e-5)


def test_sharded_closed_loop_matches_unsharded():
    case = gap_case(16, 8, 4, "l1", bench_draws=False)
    p = torch_params(case)
    robot = make_rom("DoubleInt2D", *PLANT_ARGS, device="cpu")

    def run(pp):
        return closed_loop_tube_mpc_fast(
            pp, robot, tube_kind="l1", scaling=0.5, H=3, N=8, H_rev=4,
            cfg_first=ALConfig(outer_iters=3, inner_iters=3, ls_iters=4),
            cfg_loop=ALConfig(outer_iters=1, inner_iters=2, ls_iters=4),
            warm_start="interpolate", tube_ws=0.0, device=pp.z0.device)

    ref = run(p)
    out = pm.gather(pm.map_shards(run, pm.shard_batch(p, cpu_mesh(8),
                                                      batch_size=16)))
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                                   atol=1e-5)


def test_sharded_collect_step_matches_on_envs_that_drew_nothing():
    """4 steps of the ROM sim under its PD tracker, sharded over 8 shards
    (each with its own generator) and unsharded from the same state: equal
    on every env whose trajectory generator resampled nothing in the
    window (its mode expiry ``t_final`` unchanged)."""
    B, mesh = 64, cpu_mesh(8)
    sim = presets.make_rom_tracking_env(num_envs=B, device="cpu").sim
    policy = DoubleSingleTracking.create(4.0, 4.0, sim.model.clip_v_z)
    state = sim.reset(torch.Generator().manual_seed(0))
    shards = shard_env_state(state, mesh, B,
                             pm.shard_generators(mesh, 1))
    sims = sim.shard(mesh)
    assert all(s.num_envs == 8 for s in sims)

    def collect(sim, s):
        for _ in range(4):
            s = sim.step(s, policy(sim.get_observations(s)))
        return s, sim.rom.proj_z(s.root_states)

    ref, proj = collect(sim, state)
    out = pm.gather(pm.map_shards(collect, pm.Sharded(sims, mesh), shards),
                    batch_size=B)
    quiet = ref.traj_gen.t_final == state.traj_gen.t_final
    assert 0 < int(quiet.sum()) < B
    assert torch.isfinite(out[1]).all()
    np.testing.assert_allclose(out[1][quiet].numpy(), proj[quiet].numpy(),
                               atol=1e-5)
    np.testing.assert_allclose(out[0].root_states[quiet].numpy(),
                               ref.root_states[quiet].numpy(), atol=1e-5)


# ---------------------------------------------------------------------------
# 3. the command curriculum's batch reduction
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["widen", "hold"])
def test_command_curriculum_reduces_over_shards(case):
    """Cassie (the curriculum on), 8 envs on 2 shards, some envs timed out
    with tracking sums set so that the whole batch's decision differs from
    one shard's alone: ``widen`` (shard 0's 3 good resets outweigh shard
    1's bad one; shard 1 alone would hold) and ``hold`` (shard 0's one good
    reset against shard 1's two bad ones; shard 0 alone would widen). The
    sharded step's ranges equal the unsharded step's on every shard."""
    env = presets.make_cassie_env(urdf_path=CASSIE_URDF, num_envs=8,
                                  add_noise=False, device="cpu")
    assert env.command_curriculum and env.reduces_batch
    mesh = cpu_mesh(2)
    state, _ = env.reset(torch.Generator().manual_seed(0))
    L = env.max_episode_length
    good = 1.2 * dict(env.reward_scales)["tracking_lin_vel"] * env.dt * L
    done_envs, good_envs = {"widen": ([0, 1, 2, 4], [0, 1, 2]),
                            "hold": ([0, 4, 5], [0])}[case]
    step = state.episode_step.clone()
    step[done_envs] = L - 1
    track = torch.zeros(8)
    track[good_envs] = good
    state = state.replace(episode_step=step, episode_sums=dict(
        state.episode_sums, tracking_lin_vel=track))
    actions = torch.zeros(8, env.num_actions)

    ref, tr = env.step(state, actions)
    assert sorted(torch.nonzero(tr.done).flatten().tolist()) == done_envs
    widened = not torch.equal(ref.command_ranges, state.command_ranges)
    assert widened == (case == "widen")
    senv = ShardedEnv(env, mesh)
    shards = senv.shard_state(state, pm.shard_generators(mesh, 0))
    out, trs = senv.step(shards, pm.shard_batch(actions, mesh))
    for s in out:
        assert torch.equal(s.command_ranges, ref.command_ranges)
    assert torch.equal(torch.cat([t.done for t in trs]), tr.done)


# ---------------------------------------------------------------------------
# 4-8. training over a mesh
# ---------------------------------------------------------------------------

CFG = PPOConfig(num_steps=8, num_mini_batches=2, num_learning_epochs=2)


def rom_env(B):
    return registry.make_env("rom_tracking", num_envs=B, device="cpu")


def policy(env, seed=0, recurrent=False):
    if recurrent:
        return ActorCriticRecurrent(env.num_obs, env.num_actions,
                                    rnn_hidden_size=8,
                                    actor_hidden_dims=(16,),
                                    critic_hidden_dims=(16,),
                                    generator=torch.Generator()
                                    .manual_seed(seed))
    return ActorCritic(env.num_obs, env.num_actions, (32,), (32,),
                       generator=torch.Generator().manual_seed(seed))


def _params_equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a.parameters(),
                                                 b.parameters()))


def test_sharded_ppo_iteration():
    """64 envs on 8 shards: finite metrics, replicas equal after the
    update, and the update equal to ``ppo_update`` on the gathered batch
    of the same rollout (a second, identical setup rolled out by hand)."""
    env, mesh = rom_env(64), cpu_mesh(8)

    def setup():
        senv = ShardedEnv(env, mesh)
        model = policy(env)
        gens = pm.shard_generators(mesh, 1)
        states, _ = senv.reset(gens)
        return (senv, model, pm.replicate(model, mesh), gens, states,
                init_train_state(model, CFG, gens[0]))

    senv, model, models, gens, states, ts = setup()
    learn = make_learn_iteration_sharded(senv, models, CFG, gens)
    _, states2, metrics = learn(ts, states)
    for k in ("mean_reward", "loss", "kl", "lr"):
        assert torch.isfinite(metrics[k]), k
    assert isinstance(states2, pm.Sharded) and len(states2) == 8
    for m in models[1:]:
        assert _params_equal(m, model)

    senv, check, replicas, gens, states, ts = setup()
    first = torch.cat([e._obs(s) for e, s in zip(senv.envs, states)])
    _, batch, roll = rollout_sharded(senv, replicas, states, CFG, gens)
    assert batch.obs.shape == (8, 64, env.num_obs)
    assert torch.equal(batch.obs[0], first)        # envs in shard order
    assert torch.equal(roll["mean_reward"], metrics["mean_reward"])
    _, up = ppo_update(check, ts, batch, CFG)
    assert _params_equal(check, model)
    assert torch.equal(up["loss"], metrics["loss"])


def _runner(tmp_path, mesh, recurrent=False, seed=3, B=16):
    env = rom_env(B)
    return OnPolicyRunner(env, model=policy(env, recurrent=recurrent),
                          cfg=PPOConfig(num_steps=4, num_mini_batches=2,
                                        num_learning_epochs=1),
                          log_dir=None if tmp_path is None
                          else str(tmp_path), seed=seed, mesh=mesh)


def test_runner_with_mesh_resumes_unsharded(tmp_path):
    runner = _runner(tmp_path / "run", cpu_mesh(4))
    hist = runner.learn(2, save_interval=100)
    assert len(hist) == 2
    assert all(np.isfinite(h["loss"]) and np.isfinite(h["mean_reward"])
               for h in hist)
    assert isinstance(runner.env_state, pm.Sharded)
    assert len(runner.env_state) == 4
    for m in runner.models[1:]:
        assert _params_equal(m, runner.model)
    # the checkpoint holds one copy of the parameters: an unsharded
    # runner resumes it, and a sharded one resumes it into every replica
    sd = torch.load(tmp_path / "run" / "latest.pt", weights_only=True)
    plain = _runner(None, None, seed=9)
    plain.load_state_dict(sd)
    assert _params_equal(plain.model, runner.model)
    sharded = _runner(None, cpu_mesh(2), seed=9)
    sharded.load_state_dict(sd)
    for m in sharded.models:
        assert _params_equal(m, runner.model)
    obs = torch.randn(5, runner.env.num_obs)
    assert torch.equal(plain.get_inference_policy()(obs),
                       runner.get_inference_policy()(obs))


@pytest.mark.parametrize("recurrent", [False, True],
                         ids=["feedforward", "recurrent"])
def test_one_shard_mesh_is_the_unsharded_runner(recurrent):
    ref = _runner(None, None, recurrent=recurrent)
    one = _runner(None, cpu_mesh(1), recurrent=recurrent)
    h0, h1 = ref.learn(2), one.learn(2)
    for a, b in zip(h0, h1):
        for k in ("loss", "mean_reward", "kl", "lr", "value_loss"):
            assert a[k] == b[k], k
    assert _params_equal(ref.model, one.model)


def test_recurrent_runner_shards_its_carry():
    runner = _runner(None, cpu_mesh(4), recurrent=True)
    assert isinstance(runner.carry, pm.Sharded)
    assert [c[0].shape for c in runner.carry] == [(4, 8)] * 4
    hist = runner.learn(2)
    assert all(np.isfinite(h["loss"]) for h in hist)
    assert [c[1].shape for c in runner.carry] == [(4, 8)] * 4
    for m in runner.models[1:]:
        assert _params_equal(m, runner.model)


def test_cli_train_dp_devices_on_cpu_shards(tmp_path, capsys):
    cli.main(["train", "--task", "rom_tracking", "--cpu", "--dp-devices",
              "2", "--num-envs", "16", "--max-iterations", "1",
              "--log-root", str(tmp_path / "logs")])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert np.isfinite(out["final"]["loss"])
    args = cli.build_parser().parse_args(
        ["train", "--task", "rom_tracking", "--cpu", "--dp-devices", "2",
         "--num-envs", "16", "--log-root", str(tmp_path / "logs")])
    runner, _ = cli.make_runner(args)
    assert runner.mesh.size == 2 and len(runner.env_state) == 2
    # on the card: N CUDA devices, raising with fewer present
    args.cpu = False
    with pytest.raises((RuntimeError, ValueError)):
        cli.make_runner(args)
