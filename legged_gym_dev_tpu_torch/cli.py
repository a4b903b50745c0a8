"""Command-line entry point of the port: ``train``.

Counterpart of ``legged_gym_dev_tpu/cli.py``'s ``train`` subcommand (the
others are not ported yet):

    python -m legged_gym_dev_tpu_torch.cli train \\
        --config configs/rl/hopper_single_int.yaml

trains a task of the registry through ``make_alg_runner`` and
``OnPolicyRunner.learn`` on the CUDA card (``--cpu`` for the CPU). The
YAML's ``env`` section holds the preset's arguments, ``env.urdf_path``
among them; CLI flags override the YAML.
"""
from __future__ import annotations

import argparse
import json
import sys


def make_runner(args):
    """The ``train`` subcommand's env, policy and runner, from its parsed
    arguments: (runner, iterations to learn)."""
    import torch

    from .envs import task_registry
    from .utils.config import (
        apply_train_overrides,
        build_policy,
        env_kwargs,
        load_config,
    )

    env_kw = {}
    task = args.task or "hopper_trajectory"
    max_iterations, seed = 1500, args.seed
    policy_cfg, train_cfg = None, None
    if args.config:
        cfg = load_config(args.config)
        # an explicit --task overrides the YAML's
        task = args.task or cfg.get("task") or "hopper_trajectory"
        env_kw.update(env_kwargs(cfg.get("env")))
        policy_cfg = cfg.get("policy")
        run = cfg.get("run", {})
        max_iterations = run.get("max_iterations", max_iterations)
        seed = cfg.get("seed", run.get("seed", seed))
        if cfg.get("train"):
            train_cfg = apply_train_overrides(
                task_registry.get(task).train_cfg, cfg["train"])
    if args.num_envs is not None:
        env_kw["num_envs"] = args.num_envs
    if args.max_iterations is not None:
        max_iterations = args.max_iterations
    env_kw.setdefault("num_envs", 4096)
    env_kw["device"] = "cpu" if args.cpu else None

    env = task_registry.make_env(task, **env_kw)
    # the hopper's policy dims by default
    model = build_policy(
        policy_cfg or {"actor_hidden_dims": [128, 64, 32],
                       "critic_hidden_dims": [128, 64, 32]},
        num_actions=env.num_actions, num_obs=env.num_obs,
        generator=torch.Generator().manual_seed(seed))
    runner = task_registry.make_alg_runner(
        env, task, log_root=args.log_root, run_name=args.run_name,
        seed=seed, resume=args.resume, load_run=args.load, model=model,
        train_cfg=train_cfg)
    return runner, max_iterations


def cmd_train(args):
    runner, iterations = make_runner(args)
    hist = runner.learn(iterations)
    print(json.dumps({"final": hist[-1], "log_dir": runner.log_dir}))


def build_parser():
    ap = argparse.ArgumentParser(prog="legged_gym_dev_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    t = sub.add_parser("train")
    t.add_argument("--cpu", action="store_true",
                   help="run on the CPU (default: the CUDA card)")
    t.add_argument("--seed", type=int, default=0)
    t.add_argument("--config", default="",
                   help="YAML config (configs/rl/*; sections task/env/"
                        "policy/train/run)")
    t.add_argument("--task", default=None,
                   help="task name (overrides the config's task)")
    t.add_argument("--num-envs", type=int, default=None,
                   help="override the config/default env count")
    t.add_argument("--max-iterations", type=int, default=None,
                   help="override the config's run.max_iterations "
                        "(default 1500)")
    t.add_argument("--log-root", default="logs")
    t.add_argument("--run-name", default="")
    t.add_argument("--resume", action="store_true")
    t.add_argument("--load", default="latest")
    t.set_defaults(fn=cmd_train)
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.fn(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
