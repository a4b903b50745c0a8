"""The port's training runner, checkpoints, config reader and ``cli
train`` on the hopper of tests/torch_robot_cases.py, on the CPU.

- ``CheckpointManager``: ``model_{it}`` / ``latest`` / ``best{stage}``
  aliases, best reset on a stage change (as tests/test_rl.py holds the JAX
  package's); the stage map of ``make_curriculum_stage_fn``.
- ``save_model_arch`` / ``load_model_arch`` rebuild both networks.
- ``OnPolicyRunner.learn`` on ``hopper_trajectory`` at B=16 for 2
  iterations (24 steps each): finite metrics, ``lr`` within its bounds;
  ``latest`` loaded into a fresh runner gives the inference policy's
  output bit for bit.
- ``load_config`` reads ``configs/rl/*.yaml`` as the JAX package's does;
  ``cli train --cpu`` on a temporary config, then ``--resume``.
"""
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from legged_gym_dev_tpu.utils import config as jconfig
from legged_gym_dev_tpu_torch import cli
from legged_gym_dev_tpu_torch.envs import registry
from legged_gym_dev_tpu_torch.rl import ActorCritic, ActorCriticRecurrent
from legged_gym_dev_tpu_torch.rl.ppo import PPOConfig
from legged_gym_dev_tpu_torch.rl.runner import (
    CheckpointManager,
    OnPolicyRunner,
    load_model_arch,
    make_curriculum_stage_fn,
    save_model_arch,
)
from legged_gym_dev_tpu_torch.utils import config as tconfig
from tests.torch_robot_cases import HOPPER_URDF
from tests.torch_port_cases import one_torch_thread  # noqa: F401

CONFIGS = Path(__file__).resolve().parent.parent / "configs" / "rl"


def hopper_env(B=16):
    return registry.make_env("hopper_trajectory", urdf_path=HOPPER_URDF,
                             num_envs=B, curriculum="single_int",
                             device="cpu")


def small_policy(env, seed=0):
    return ActorCritic(env.num_obs, env.num_actions, (32, 16), (32, 16),
                       generator=torch.Generator().manual_seed(seed))


def test_checkpoint_aliases_and_best_stage_reset(tmp_path):
    mgr = CheckpointManager(str(tmp_path))

    def sd(v):
        return {"w": torch.tensor([v])}

    mgr.save(sd(1.0), it=0, metric=5.0, stage=0)
    mgr.save(sd(2.0), it=1, metric=3.0, stage=0)    # worse: best0 keeps 1
    # stage change: best resets, a much worse metric still wins
    mgr.save(sd(3.0), it=2, metric=-10.0, stage=1)
    mgr.save(sd(4.0), it=3, metric=-20.0, stage=1)  # worse: best1 keeps 3
    assert mgr.best_stages() == [0, 1]
    for name, v in (("best0", 1.0), ("best1", 3.0), ("latest", 4.0),
                    ("model_1", 2.0)):
        assert float(mgr.load(name)["w"]) == v, name

    class Cur:
        steps = (24, 48)

    fn = make_curriculum_stage_fn(Cur(), steps_per_iter=24)
    assert [fn(i) for i in range(4)] == [1, 2, 2, 2]
    fn2 = make_curriculum_stage_fn(Cur(), steps_per_iter=8)
    assert [fn2(i) for i in range(8)] == [0, 0, 1, 1, 1, 2, 2, 2]


@pytest.mark.parametrize("recurrent", [False, True])
def test_model_arch_round_trip(tmp_path, recurrent):
    gen = torch.Generator().manual_seed(0)
    model = (ActorCriticRecurrent(38, 4, 16, (32,), (8,), init_noise_std=0.5,
                                  generator=gen) if recurrent
             else ActorCritic(38, 4, (32, 16), (8,), activation="tanh",
                              generator=gen))
    save_model_arch(model, str(tmp_path))
    again = load_model_arch(str(tmp_path))
    assert type(again) is type(model)
    assert ({k: v.shape for k, v in again.state_dict().items()}
            == {k: v.shape for k, v in model.state_dict().items()})
    for f in ("num_obs", "num_actions", "actor_hidden_dims",
              "critic_hidden_dims", "activation", "init_noise_std"):
        assert getattr(again, f) == getattr(model, f), f
    assert load_model_arch(str(tmp_path / "none")) is None


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    log_dir = str(tmp_path_factory.mktemp("run"))
    env = hopper_env()
    runner = OnPolicyRunner(env, model=small_policy(env), cfg=PPOConfig(),
                            log_dir=log_dir, seed=0)
    hist = runner.learn(2)
    return env, runner, hist, log_dir


def test_learn_gives_finite_metrics(trained):
    env, runner, hist, log_dir = trained
    cfg = runner.cfg
    assert [h["it"] for h in hist] == [0, 1]
    for h in hist:
        for k in ("mean_reward", "loss", "policy_loss", "value_loss", "kl",
                  "lr"):
            assert np.isfinite(h[k]), (k, h[k])
        # (float32 bounds: lr is a float32 tensor)
        assert np.float32(cfg.min_lr) <= h["lr"] <= np.float32(cfg.max_lr)
        assert all(np.isfinite(v) for v in h["mean_episode_info"].values())
        assert h["steps_per_s"] > 0
    assert runner.env_state.common_step == 2 * cfg.num_steps
    assert int(runner.train_state.opt_state.count) == (
        2 * cfg.num_learning_epochs * cfg.num_mini_batches)
    lines = open(os.path.join(log_dir, "metrics.jsonl")).read().splitlines()
    assert [json.loads(x)["it"] for x in lines] == [0, 1]
    assert sorted(os.listdir(log_dir)) == sorted(
        ["arch.json", "best0.pt", "latest.pt", "metrics.jsonl",
         "model_0.pt", "model_1.pt"])


def test_inference_policy_after_load(trained):
    env, runner, _, log_dir = trained
    obs = torch.randn(3, env.num_obs, generator=torch.Generator()
                      .manual_seed(1))
    want = runner.get_inference_policy()(obs)
    fresh = OnPolicyRunner(env, model=load_model_arch(log_dir),
                           log_dir=log_dir, seed=5)
    assert not torch.equal(fresh.get_inference_policy()(obs), want)
    fresh.load("latest")
    assert torch.equal(fresh.get_inference_policy()(obs), want)


def test_recurrent_runner_and_policy_reset():
    env = hopper_env(8)
    model = ActorCriticRecurrent(env.num_obs, 4, 16, (16,), (16,),
                                 generator=torch.Generator().manual_seed(0))
    runner = OnPolicyRunner(env, model=model, cfg=PPOConfig(num_steps=6),
                            seed=0)
    (h,) = runner.learn(1)
    assert all(np.isfinite(h[k]) for k in ("loss", "kl", "lr",
                                           "mean_reward"))
    policy = runner.get_inference_policy()
    obs = torch.randn(2, env.num_obs)
    a1, a2 = policy(obs), policy(obs)      # the carry moves on
    assert not torch.equal(a1, a2)
    policy.reset()
    assert torch.equal(policy(obs), a1)


@pytest.mark.parametrize("name", sorted(p.name for p in
                                        CONFIGS.glob("*.yaml")))
def test_load_config_matches_jax(name):
    assert tconfig.load_config(str(CONFIGS / name)) == \
        jconfig.load_config(str(CONFIGS / name))


def test_cli_train_cpu_and_resume(tmp_path, capsys):
    urdf = tmp_path / "hopper.urdf"
    urdf.write_text(HOPPER_URDF)
    cfg = tmp_path / "hopper.yaml"
    cfg.write_text(f"""
defaults:
  - {CONFIGS / 'hopper_single_int'}
  - _self_
env:
  num_envs: 8
  urdf_path: {urdf}
policy:
  actor_hidden_dims: [16]
  critic_hidden_dims: [16]
train:
  num_steps: 4
run:
  max_iterations: 1
""")
    root = tmp_path / "logs"
    common = ["train", "--cpu", "--config", str(cfg), "--log-root",
              str(root)]
    assert cli.main(common) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert np.isfinite(out["final"]["loss"])
    first = out["log_dir"]
    assert os.path.exists(os.path.join(first, "latest.pt"))
    with open(os.path.join(first, "arch.json")) as f:
        assert json.load(f)["actor_hidden_dims"] == [16]
    assert cli.main(common + ["--resume", "--max-iterations", "2",
                              "--run-name", "again"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["final"]["it"] == 1 and out["log_dir"].endswith("_again")
    assert len(os.listdir(root / "hopper_trajectory")) == 2
