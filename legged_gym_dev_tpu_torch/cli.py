"""Command-line entry point of the port: ``train``, ``collect`` and
``train-tube``.

Counterpart of those subcommands of ``legged_gym_dev_tpu/cli.py`` (``play``,
``plan`` and ``mpc`` are not ported yet):

    python -m legged_gym_dev_tpu_torch.cli train \\
        --config configs/rl/hopper_single_int.yaml
    python -m legged_gym_dev_tpu_torch.cli collect \\
        --config configs/data_generation/default_custom.yaml \\
        --seed 42 --out data/rollouts.npz
    python -m legged_gym_dev_tpu_torch.cli train-tube \\
        --config configs/tube_learning/tube_learning_oneshot.yaml \\
        --data data/rollouts.npz --out data/tube.pt

``train`` trains a task of the registry through ``make_alg_runner`` and
``OnPolicyRunner.learn``; the YAML's ``env`` section holds the preset's
arguments, ``env.urdf_path`` among them. ``collect`` records ROM-tracking
rollouts (the physics-free ``rom_tracking`` task with its PD tracker, or a
rigid-body trajectory task with the Raibert heuristic or a trained
policy) into an ``.npz`` file or ``.tdl`` shards. ``train-tube`` trains a
tube network on them and writes the port's model file
(``tube.models.save_mlp``). Everything runs on the CUDA card (``--cpu``
for the CPU); CLI flags override the YAML.
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


def collect_rollouts(args):
    """The ``collect`` subcommand's rollouts (host ``RolloutData``), from
    its parsed arguments; a ``--config`` file's ``collect`` section sets
    task, num_envs, epochs, episode_length_s and raibert."""
    import torch

    from .tube.datasets import RolloutData

    if args.config:
        from .utils.config import load_config

        col = load_config(args.config).get("collect", {})
        for key in ("task", "num_envs", "epochs", "episode_length_s",
                    "raibert"):
            if key in col:
                setattr(args, key, col[key])
    device = "cpu" if args.cpu else None
    if args.task == "rom_tracking":
        from .controllers import DoubleSingleTracking
        from .envs.presets import make_rom_tracking_env
        from .tube.collect import collect_epochs

        sim = make_rom_tracking_env(num_envs=args.num_envs,
                                    device=device).sim
        gen = torch.Generator(device=sim.device).manual_seed(args.seed)
        policy = DoubleSingleTracking.create(4.0, 4.0, sim.model.clip_v_z)
        return collect_epochs(sim, policy, gen,
                              episode_length_s=args.episode_length_s,
                              epochs=args.epochs)
    # a rigid-body trajectory task with a trained policy, or the hopper's
    # Raibert heuristic
    from .envs import task_registry
    from .tube.collect import collect_tracking

    env = task_registry.make_env(args.task, num_envs=args.num_envs,
                                 add_noise=False, device=device)
    if args.raibert:
        policy = env.raibert            # the hopper tasks carry it
    else:
        runner = task_registry.make_alg_runner(
            env, args.task, log_root=args.log_root, seed=args.seed,
            resume=True, load_run=args.checkpoint, load_dir=args.load)
        policy = runner.get_inference_policy()
    gen = torch.Generator(device=env.device).manual_seed(args.seed)
    return RolloutData.concatenate([
        collect_tracking(env, policy, gen,
                         episode_length_s=args.episode_length_s,
                         raibert_obs=bool(args.raibert))
        for _ in range(args.epochs)])


def save_rollouts(args, data) -> str:
    """Write ``data`` where ``collect --out`` says: an ``.npz`` file, or
    ``.tdl`` shards under that directory with ``--shards``."""
    import os

    import numpy as np

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    shape = f"{data.z.shape[0]} episodes x {data.v.shape[1]} steps"
    if args.shards:
        from .tube.shards import write_rollout_shards

        paths = write_rollout_shards(args.out, [data], variant=args.variant)
        return f"saved {shape} -> {len(paths)} shard(s) under {args.out}"
    np.savez(args.out, z=data.z, v=data.v, pz_x=data.pz_x, done=data.done)
    return f"saved {shape} -> {args.out}"


def cmd_collect(args):
    print(save_rollouts(args, collect_rollouts(args)))


def _tube_spec(args):
    """The tube dataset, loss and model spec from ``--config`` (its
    ``tube`` section) or the flags; ``--epochs`` overrides either."""
    from .utils.config import load_config, tube_spec

    if args.config:
        spec = tube_spec(load_config(args.config).get("tube"))
    else:
        # the one-shot configs train with the vector loss (per-step
        # pinball summed over H_fwd, then Huber); the scalar dataset
        # with the scalar loss
        spec = tube_spec({
            "dataset": "oneshot" if args.oneshot else "scalar",
            "loss": "vector" if args.oneshot else "scalar",
            "alpha": args.alpha, "window": args.window,
            "H_fwd": args.H_fwd, "H_rev": args.H_rev})
    if args.epochs is not None:
        spec["epochs"] = args.epochs
    return spec


def _tube_dataset(spec, data):
    from .tube import datasets as D

    name, N = spec["dataset"], spec["window"]
    if name == "oneshot":
        return D.scalar_horizon_tube_dataset(data, H_fwd=spec["H_fwd"],
                                             H_rev=spec["H_rev"])
    return {
        "scalar": D.scalar_tube_dataset,
        "vector": D.vector_tube_dataset,
        "alpha_scalar": D.alpha_scalar_tube_dataset,
        "alpha_vector": D.alpha_vector_tube_dataset,
        "error": D.error_dynamics_dataset,
    }[name](data, N=N, dN=1)


def _tube_loss(spec):
    from .tube import losses as L

    a = spec["alpha"]
    return {
        "scalar": lambda fw, w, d: L.scalar_tube_loss(fw, w, d, alpha=a),
        "vector": lambda fw, w, d: L.vector_tube_loss(fw, w, d, alpha=a),
        "alpha_scalar": L.alpha_scalar_tube_loss,
        "alpha_vector": L.alpha_vector_tube_loss,
        "error": L.error_loss,
    }[spec["loss"]]


def make_tube_training(args):
    """The ``train-tube`` subcommand's parts, from its parsed arguments:
    ``(data, model, loss_fn, TrainConfig, device, spec)``. ``data`` is a
    shard loader (``tube.shards.make_loader``) when ``--data`` is a
    directory of ``.tdl`` shards, else the dataset built from the
    ``.npz`` rollouts; the model's initial weights come from ``--seed``."""
    import glob
    import os

    import numpy as np
    import torch

    from .tube.datasets import RolloutData
    from .tube.losses import scalar_tube_loss
    from .tube.models import MLP
    from .tube.train import TrainConfig
    from .utils.runtime import resolve_device

    dev = resolve_device("cpu" if args.cpu else None)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    if os.path.isdir(args.data):
        from .tube.shards import make_loader

        paths = sorted(glob.glob(os.path.join(args.data, "*.tdl")))
        if not paths:
            raise SystemExit(f"no .tdl shards under {args.data}")
        loader = make_loader(paths, N=args.window, dN=1)
        model = MLP.create(gen, loader.input_dim, loader.target_dim,
                           num_units=128, num_layers=2)
        epochs = 100 if args.epochs is None else args.epochs
        return (loader, model,
                lambda fw, w, d: scalar_tube_loss(fw, w, d,
                                                  alpha=args.alpha),
                TrainConfig(epochs=epochs, batch_size=1024), dev, None)
    raw = np.load(args.data)
    data = RolloutData(z=raw["z"], v=raw["v"], pz_x=raw["pz_x"],
                       done=raw["done"])
    spec = _tube_spec(args)
    ds = _tube_dataset(spec, data)
    model = MLP.create(gen, ds.input_dim, ds.output_dim,
                       num_units=spec["num_units"],
                       num_layers=spec["num_layers"],
                       activation=spec["activation"])
    return (ds, model, _tube_loss(spec),
            TrainConfig(epochs=spec["epochs"], batch_size=spec["batch_size"],
                        learning_rate=spec["lr"]), dev, spec)


def cmd_train_tube(args):
    from .tube.models import save_mlp
    from .tube.train import train_tube, train_tube_streaming

    data, model, loss_fn, cfg, dev, spec = make_tube_training(args)
    streaming = spec is None
    train = train_tube_streaming if streaming else train_tube
    res = train(data, model, loss_fn, cfg, device=dev)
    final = [h for h in res.history if "coverage" in h][-1]
    out = {"final": final}
    if streaming:
        out.update(streaming=True, loader=type(data).__name__)
    print(json.dumps(out))
    if args.out:
        save_mlp(res.best_model, args.out)
        print(f"saved tube model -> {args.out}")


def build_parser():
    ap = argparse.ArgumentParser(prog="legged_gym_dev_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def common(p):
        p.add_argument("--cpu", action="store_true",
                       help="run on the CPU (default: the CUDA card)")
        p.add_argument("--seed", type=int, default=0)

    t = sub.add_parser("train")
    common(t)
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

    c = sub.add_parser("collect")
    common(c)
    c.add_argument("--config", default="",
                   help="data-generation YAML (configs/data_generation/*)")
    c.add_argument("--task", default="rom_tracking",
                   help="rom_tracking (ROM-only sim) or a registered "
                        "trajectory task (hopper_trajectory, "
                        "anymal_c_trajectory, ...)")
    c.add_argument("--raibert", action="store_true",
                   help="the Raibert heuristic instead of a trained policy "
                        "(hopper tasks)")
    c.add_argument("--load", default="",
                   help="run dir of the trained policy (default: the most "
                        "recent run under <log-root>/<task>)")
    c.add_argument("--checkpoint", default="latest")
    c.add_argument("--log-root", default="logs")
    c.add_argument("--num-envs", type=int, default=1024)
    c.add_argument("--epochs", type=int, default=4)
    c.add_argument("--episode-length-s", type=float, default=8.0)
    c.add_argument("--out", default="data/rollouts.npz")
    c.add_argument("--shards", action="store_true",
                   help="write binary .tdl shards (native loader) instead "
                        "of .npz; --out is then a directory")
    c.add_argument("--variant", default="scalar",
                   choices=["scalar", "scalar_recursive", "vector", "error"])
    c.set_defaults(fn=cmd_collect)

    tt = sub.add_parser("train-tube")
    common(tt)
    tt.add_argument("--config", default="",
                    help="tube-learning YAML (configs/tube_learning/*)")
    tt.add_argument("--data", default="data/rollouts.npz",
                    help=".npz rollouts, or a directory of .tdl shards "
                         "(streamed through the native loader)")
    tt.add_argument("--epochs", type=int, default=None,
                    help="override the config's epochs (default 100)")
    tt.add_argument("--alpha", type=float, default=0.9)
    tt.add_argument("--window", type=int, default=3)
    tt.add_argument("--oneshot", action="store_true")
    tt.add_argument("--H-fwd", type=int, default=50)
    tt.add_argument("--H-rev", type=int, default=10)
    tt.add_argument("--out", default="",
                    help="the port's tube-model file (torch.save)")
    tt.set_defaults(fn=cmd_train_tube)
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.fn(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
