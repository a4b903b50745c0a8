"""Command-line entry point of the port: ``train``, ``play``,
``collect``, ``train-tube``, ``plan`` and ``mpc``.

Counterpart of those subcommands of ``legged_gym_dev_tpu/cli.py``:

    python -m legged_gym_dev_tpu_torch.cli train \\
        --config configs/rl/hopper_single_int.yaml
    python -m legged_gym_dev_tpu_torch.cli play --task hopper_trajectory \\
        --num-envs 1 --steps 1000 --export exported --mat play.mat
    python -m legged_gym_dev_tpu_torch.cli collect \\
        --config configs/data_generation/default_custom.yaml \\
        --seed 42 --out data/rollouts.npz
    python -m legged_gym_dev_tpu_torch.cli train-tube \\
        --config configs/tube_learning/tube_learning_oneshot.yaml \\
        --data data/rollouts.npz --out data/tube.pt
    python -m legged_gym_dev_tpu_torch.cli plan --problem gap --out plan.mat
    python -m legged_gym_dev_tpu_torch.cli mpc --tube-dyn NN_oneshot \
        --H-rev 25 --tube-model data/tube.pt

``train`` trains a task of the registry through ``make_alg_runner`` and
``OnPolicyRunner.learn``; the YAML's ``env`` section holds the preset's
arguments, ``env.urdf_path`` among them; ``--dp-devices N`` trains
data-parallel over N CUDA cards (N CPU shards with ``--cpu``). ``play`` resumes a trained run
(the most recent under ``<log-root>/<task>``, or ``--load``), rolls its
deterministic policy without observation noise, logs env 0's signals
(``--mat``, ``--plot``) and exports the policy (``--export``: TorchScript
and a ``torch.export`` program, ONNX where ``onnx`` is installed; the
stateful LSTM TorchScript module for a recurrent run); ``--video FILE``
renders env 0's logged rollout with MuJoCo (``--video-steps`` frames) and
``--live [PORT]`` serves the browser viewer during it; both need the
``mujoco`` package and say so where it is missing. ``collect``
records ROM-tracking rollouts (the physics-free ``rom_tracking`` task with
its PD tracker, or a rigid-body trajectory task with the Raibert heuristic
or a trained policy) into an ``.npz`` file or ``.tdl`` shards. ``train-tube`` trains a
tube network on them and writes the port's model file
(``tube.models.save_mlp``). ``plan`` solves one tube-MPC plan of a
``PROBLEM_DICT`` problem and ``mpc`` runs the closed loop on it: by default
through the staged solver (the block-tridiagonal kernels on the card) with
a restoration verdict, with ``--generic`` (and always for the rolling
tubes) through the dense generic solver. Everything runs on the CUDA card
(``--cpu`` for the CPU); CLI flags override the YAML. ``plan`` and ``mpc``
print one JSON line with the JAX package's keys.
"""
from __future__ import annotations

import argparse
import json
import os
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
    mesh = None
    if args.dp_devices:
        from .parallel.mesh import make_mesh

        # --cpu: N CPU shards (JAX's virtual CPU mesh); else N CUDA cards,
        # raising with fewer present
        mesh = make_mesh(args.dp_devices, devices=(
            [torch.device("cpu")] * args.dp_devices if args.cpu else None))
    runner = task_registry.make_alg_runner(
        env, task, log_root=args.log_root, run_name=args.run_name,
        seed=seed, resume=args.resume, load_run=args.load, model=model,
        train_cfg=train_cfg, mesh=mesh)
    return runner, max_iterations


def cmd_train(args):
    runner, iterations = make_runner(args)
    hist = runner.learn(iterations)
    print(json.dumps({"final": hist[-1], "log_dir": runner.log_dir}))


def _play_signals(env, state, tr):
    """Env 0's dashboard signals for the Logger's 9 panels: dof
    position, velocity and torque, base velocities against the commands,
    the feet's contact force z and the tracking error, as 0-d or 1-d
    tensors. The contact force is computed on env 0's rows alone, from
    ``contact_points`` (``contact_kinematics`` without the Jacobian it
    does not use)."""
    import torch

    from .core.maths import quat_rotate_inverse
    from .sim.dynamics import RobotState

    sig = {"reward": tr.reward[0]}
    r = getattr(state, "robot", None)
    if r is None:
        # physics-free ROM envs: only obs-derived signals exist
        if env.num_obs > 5:
            sig["base_vel_x"] = tr.obs[0, 5]
        return sig
    lin_b = quat_rotate_inverse(r.base_quat[0:1], r.v[0:1, :3])[0]
    sig.update({
        "dof_pos": r.q[0],
        "dof_vel": r.v[0, 6:],
        "base_vel_x": lin_b[0],
        "base_vel_y": lin_b[1],
        "base_vel_z": lin_b[2],
        "base_vel_yaw": r.v[0, 5],
    })
    if getattr(state, "torques", None) is not None:
        sig["dof_torque"] = state.torques[0]
    if getattr(state, "actions", None) is not None:
        act_scale = getattr(env, "action_scale", 1.0)
        dd = getattr(env, "default_dof_pos", None)
        if dd is not None and state.actions.shape[1] == r.q.shape[1]:
            sig["dof_pos_target"] = act_scale * state.actions[0] + dd
    cmds = getattr(state, "commands", None)
    if cmds is not None:
        sig["command_x"] = cmds[0, 0]
        sig["command_y"] = cmds[0, 1]
        sig["command_yaw"] = cmds[0, 2]
    if getattr(state, "prev_error", None) is not None:
        sig["tracking_error"] = torch.sqrt(torch.sum(state.prev_error[0]))
    try:
        from .sim.contact import contact_forces
        from .sim.kinematics import contact_points

        sim = env.sim
        r0 = RobotState(base_pos=r.base_pos[:1], base_quat=r.base_quat[:1],
                        q=r.q[:1], v=r.v[:1])
        pos, vel = contact_points(sim.model, r0)
        f = contact_forces(sim.contact, pos, vel,
                           sim.model.tensor("contact_radius", r.q.device),
                           sim.terrain_fn)
        feet = getattr(env, "feet_spheres", None)
        if not feet:
            fs = getattr(env, "foot_sphere", None)
            feet = (fs,) if fs is not None else None
        sig["contact_forces_z"] = (f[0, list(feet), 2] if feet
                                   else f[0, :, 2].max())
    except (AttributeError, TypeError):
        pass
    return sig


_EXPORT_LABELS = {"torchscript": "TorchScript",
                  "exported": "torch.export program", "onnx": "ONNX",
                  "lstm_torchscript": "LSTM TorchScript"}


def play(env, runner, steps, export="", plot="", mat="", record=False,
         viewer=None):
    """Roll ``runner``'s deterministic policy on ``env`` for ``steps``
    env steps from a reset (generator seeded 0), logging env 0's signals
    with one host transfer a step; export the policy into the directory
    ``export`` first, save the dashboard to ``plot`` and the log to
    ``mat`` (.mat) when given. ``record`` keeps env 0's ``(base_pos,
    base_quat, q)`` trace of a rigid-body env (in the same transfer);
    ``viewer`` (a ``utils.live_viewer.LiveViewer``) gets that state every
    step, pauses the loop while paused and ends it on "quit". Returns
    {"exports": {kind: path}, "rollout_s": wall seconds of the steps,
    "logger": the Logger, "trace": the recorded trace, a list}."""
    import time

    import numpy as np
    import torch

    from .utils import export as ex
    from .utils.logger import Logger

    policy = runner.get_inference_policy()
    exports = {}
    if export:
        model = runner.model
        if runner.recurrent:
            exports["lstm_torchscript"] = ex.export_policy_lstm_torchscript(
                model, os.path.join(export, "policy_lstm.pt"))
        else:
            exports["torchscript"] = ex.export_policy_torchscript(
                model, os.path.join(export, "policy.pt"))
            exports["exported"] = ex.export_policy_exported(
                model, env.num_obs, os.path.join(export, "policy.pt2"))
            exports["onnx"] = ex.export_policy_onnx(
                model, env.num_obs, os.path.join(export, "policy.onnx"))
        for kind, path in exports.items():
            print(f"exported {_EXPORT_LABELS[kind]}: {path}")

    if runner.recurrent:
        policy.reset()
    logger = Logger(dt=env.dt)
    gen = torch.Generator(device=env.device)
    gen.manual_seed(0)
    trace = []
    with torch.no_grad():
        state, obs = env.reset(gen)
        t0 = time.perf_counter()
        i = 0
        while i < steps:
            if viewer is not None and viewer.paused:
                time.sleep(0.05)
                if "quit" in viewer.pop_events():
                    break
                continue
            state, tr = env.step(state, policy(obs))
            obs = tr.obs
            sig = _play_signals(env, state, tr)
            r = getattr(state, "robot", None)
            keep = r is not None and (record or viewer is not None)
            vals = list(sig.values())
            if keep:
                vals += [r.base_pos[0], r.base_quat[0], r.q[0]]
            flat = torch.cat([v.reshape(-1).float() for v in vals])
            host = np.split(flat.cpu().numpy(), np.cumsum(
                [v.numel() for v in vals])[:-1])
            logger.log_states({k: h.reshape(v.shape)
                               for (k, v), h in zip(sig.items(), host)})
            if keep:
                trace.append(tuple(host[len(sig):]))
                if viewer is not None:
                    viewer.push_state(*trace[-1])
            if viewer is not None and "quit" in viewer.pop_events():
                break
            i += 1
        rollout_s = time.perf_counter() - t0
    if plot:
        logger.plot_states(plot)
        print(f"dashboard saved: {plot}")
    if mat:
        logger.save_mat(mat)
        print(f"state log saved: {mat}")
    return {"exports": exports, "rollout_s": rollout_s, "logger": logger,
            "trace": trace}


def _require_mujoco(flag: str) -> None:
    """``flag`` renders through MuJoCo: raise, naming it, when the
    ``mujoco`` package is not installed (the card's machine has none)."""
    import importlib.util

    if importlib.util.find_spec("mujoco") is None:
        raise SystemExit(f"cli play {flag} renders with MuJoCo, and the "
                         "'mujoco' package is not installed here")


def cmd_play(args):
    import numpy as np

    from .envs import task_registry

    video, live = args.video, args.live
    for flag, on in (("--video", bool(video)), ("--live", live is not None)):
        if on:
            _require_mujoco(flag)
    env = task_registry.make_env(args.task, num_envs=args.num_envs,
                                 add_noise=False,
                                 device="cpu" if args.cpu else None)
    # play always resumes a trained policy: --load names the run dir, else
    # the most recent run under <log_root>/<task>
    runner = task_registry.make_alg_runner(
        env, args.task, log_root=args.log_root, seed=0, resume=True,
        load_run=args.checkpoint, load_dir=args.load)
    viewer = None
    if live is not None:
        # the browser viewer (the reference's Isaac Gym viewer role, ref
        # base_task.py:86-148 / play.py:96-110): frames over HTTP, keys
        # back (ESC quit, V sync, SPACE pause, arrows/+-/F camera)
        from .utils.live_viewer import LiveViewer

        if not hasattr(env, "sim") or not hasattr(env.sim, "model"):
            raise SystemExit(f"{args.task} has no rigid-body state to view")
        viewer = LiveViewer(env.sim.model, port=live)
    try:
        out = play(env, runner, args.steps, export=args.export,
                   plot=args.plot, mat=args.mat, record=bool(video),
                   viewer=viewer)
    finally:
        if viewer is not None:
            viewer.close()
    result = {"steps": args.steps, "num_envs": env.num_envs,
              "rollout_s": out["rollout_s"], "exports": out["exports"]}
    if video:
        # render the rollout that was just logged: env 0's recorded trace
        from .utils.video import render_state_trace

        trace = out["trace"]
        if not trace:
            raise SystemExit(f"{args.task} has no rigid-body state to "
                             "render (physics-free ROM env)")
        n_vid = min(len(trace), args.video_steps or min(args.steps, 250))
        pos, quat, qs = (np.stack([t[k] for t in trace[:n_vid]])
                         for k in range(3))
        result["video"] = render_state_trace(env.sim.model, pos, quat, qs,
                                             video, fps=1.0 / env.dt)
        print(f"rollout video saved: {result['video']}")
    print(json.dumps(result))


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


def _device(args):
    from .utils.runtime import resolve_device

    return resolve_device("cpu" if args.cpu else None)


def _load_tube_model(args, device):
    """The one-shot tube net of ``--tube-model`` (the port's model file,
    ``tube.models.save_mlp``), with its horizon checked against --N and
    --H-rev: its output is the width horizon, its input
    ``[e (H_rev), vec_F([v_prev; v]) ((H_rev + N) x 2)]`` (SingleInt2D has
    no z0[2:])."""
    from .tube.models import load_mlp

    if not args.tube_model:
        raise SystemExit("--tube-dyn NN_oneshot requires --tube-model "
                         "(train one with `train-tube --oneshot --out ...`)")
    model = load_mlp(args.tube_model, device=device)
    out_dim = model.weights[-1].shape[1]
    if out_dim != args.N:
        raise SystemExit(
            f"tube model predicts H_fwd={out_dim} widths but --N={args.N}; "
            "the one-shot horizon must equal the planning horizon")
    in_dim = model.weights[0].shape[0]
    expect = args.H_rev + (args.H_rev + args.N) * 2
    if in_dim != expect:
        raise SystemExit(
            f"tube model input dim {in_dim} != {expect} expected for "
            f"H_rev={args.H_rev}, N={args.N} (was it trained with "
            "--oneshot and matching --H-rev/--H-fwd?)")
    return model


def _make_problem(args, device, tube_params=None):
    import numpy as np

    from .interop import trajopt_params_from_numpy
    from .solver import PROBLEM_DICT

    prob = PROBLEM_DICT[args.problem]
    p = trajopt_params_from_numpy(
        "SingleInt2D", prob["dt"], [-prob["pos_max"]] * 2,
        [prob["pos_max"]] * 2, [-prob["vel_max"]] * 2,
        [prob["vel_max"]] * 2, args.N, args.H_rev, 10 * np.eye(2),
        10 * np.eye(2), prob["start"], prob["goal"], prob["obs"]["c"],
        prob["obs"]["r"], Qw=0.0, w_max=1.0, tube_params=tube_params,
        device=device)
    return prob, p


def _staged_cfg(args, device, loop: bool = False):
    """The staged solver's config: the chunked Woodbury refresh for the NN
    tube, the 4x6 warm re-solve schedule in the loop, and the hand-written
    kernels on the card (their plain versions are slower on the CPU than
    the block-Thomas, as the JAX package's interpreted Pallas is)."""
    from .solver import ALConfig

    kw = {}
    if args.tube_dyn == "NN_oneshot":
        kw["nn_basis_refresh"] = 3
    if loop:
        kw.update(outer_iters=4, inner_iters=6)
    if device.type == "cuda":
        kw["linsolve"] = "pallas"
    return ALConfig(**kw)


def _staged_problem(args, p):
    from .solver import StagedProblem

    return StagedProblem(
        n=p.rom.n, m=p.rom.m, N=args.N, K=p.obs_r.shape[-1],
        tube_kind=("nn" if args.tube_dyn == "NN_oneshot" else args.tube_dyn),
        scaling=0.5, track_ref=False)


def _verdict(args, p, sol):
    """The restoration verdict of a staged solve of one scenario."""
    from .solver import VERDICT_NAMES, certify_staged, staged_bounds

    sp = _staged_problem(args, p)
    lb_u, ub_u = staged_bounds(p, sp.n, sp.m, args.N)
    cert = certify_staged(sp, p, sol.x.reshape(1, args.N + 1, -1), sol.viol,
                          lb_u, ub_u)
    return VERDICT_NAMES[int(cert.verdict[0])], float(cert.viol_restored[0])


def _generic(args) -> bool:
    # the rolling tubes have no staged form
    return args.generic or args.tube_dyn.endswith("_rolling")


def cmd_plan(args):
    from .solver import get_tube_dynamics, solve_nominal, solve_tube
    from .solver.fast_tube import solve_tube_fast

    dev = _device(args)
    tube_params = (_load_tube_model(args, dev)
                   if args.tube_dyn == "NN_oneshot" and not args.nominal
                   else None)
    prob, p = _make_problem(args, dev, tube_params)
    verdict_info = {}
    if args.nominal:
        z, v, sol = solve_nominal(p, args.N, warm_start="interpolate",
                                  device=dev)
        w = None
    elif _generic(args):
        tube_fn = get_tube_dynamics(args.tube_dyn, args.N, scaling=0.5)
        out = solve_tube(p, tube_fn, args.N, args.H_rev,
                         warm_start="nominal", tube_ws="evaluate",
                         device=dev)
        z, v, w, sol = out.z, out.v, out.w, out.sol
    else:
        out = solve_tube_fast(p, args.N, args.H_rev,
                              tube_kind=args.tube_dyn, scaling=0.5,
                              cfg=_staged_cfg(args, dev),
                              warm_start="interpolate", tube_ws="evaluate")
        z, v, w, sol = out.z, out.v, out.w, out.sol
        verdict, viol_restored = _verdict(args, p, sol)
        verdict_info = {"verdict": verdict, "viol_restored": viol_restored}
    print(json.dumps({
        "viol": float(sol.viol[0]), "obj": float(sol.obj[0]),
        "converged": bool(sol.converged[0]), **verdict_info,
    }))
    if args.out:
        payload = {"z": z[0].cpu().numpy(), "v": v[0].cpu().numpy(),
                   "z0": prob["start"], "zf": prob["goal"],
                   "obs_c": prob["obs"]["c"], "obs_r": prob["obs"]["r"]}
        if w is not None:
            payload["w"] = w[0].cpu().numpy()
        _save_mat_or_npz(args.out, payload)
        print(f"saved plan -> {args.out}")


def cmd_mpc(args):
    import numpy as np

    from .core import make_rom

    dev = _device(args)
    tube_params = (_load_tube_model(args, dev)
                   if args.tube_dyn == "NN_oneshot" else None)
    prob, p = _make_problem(args, dev, tube_params)
    robot = make_rom("DoubleInt2D", prob["dt"], [-np.inf, -np.inf, -0.3, -0.3],
                     [np.inf, np.inf, 0.3, 0.3], [-0.5, -0.5], [0.5, 0.5],
                     device=dev)
    if _generic(args):
        from .solver import get_tube_dynamics
        from .solver.mpc import MPCConfig, closed_loop_tube_mpc

        tube_fn = get_tube_dynamics(args.tube_dyn, args.N, scaling=0.5)
        trace = closed_loop_tube_mpc(
            p, tube_fn, robot, MPCConfig(H=args.H, N=args.N,
                                         H_rev=args.H_rev), device=dev)
        z = trace.z[0].cpu().numpy()
        pzx_t = trace.pz_x[0].cpu().numpy()
        result = {
            "goal_dist": float(np.linalg.norm(z[-1] - prob["goal"])),
            "max_resolve_viol": float(trace.viol.max()),
            "tracking_err_max": float(np.abs(z - pzx_t).max()),
        }
        payload_extra = {k: getattr(trace, k)[0].cpu().numpy()
                         for k in ("z_sol", "v_sol", "w_sol")}
        v_t, w_t = trace.v[0].cpu().numpy(), trace.w[0].cpu().numpy()
        adopted = None
    else:
        from .solver.fast_tube import (
            closed_loop_tube_mpc_fast,
            solve_tube_fast,
        )

        cfg_first = _staged_cfg(args, dev)
        cfg_loop = _staged_cfg(args, dev, loop=True)
        out0 = solve_tube_fast(p, args.N, args.H_rev,
                               tube_kind=args.tube_dyn, scaling=0.5,
                               cfg=cfg_first, warm_start="interpolate",
                               tube_ws="evaluate")
        verdict, _ = _verdict(args, p, out0.sol)
        z_t, v_t, w_t, pzx_t, viols, adopts = closed_loop_tube_mpc_fast(
            p, robot, tube_kind=args.tube_dyn, scaling=0.5, H=args.H,
            N=args.N, H_rev=args.H_rev, cfg_first=cfg_first,
            cfg_loop=cfg_loop, device=dev)
        z = z_t[0].cpu().numpy()
        pzx_t = pzx_t[0].cpu().numpy()
        adopted = adopts[0].cpu().numpy()
        result = {
            "goal_dist": float(np.linalg.norm(z[-1] - prob["goal"])),
            "max_resolve_viol": float(viols.max()),
            "tracking_err_max": float(np.abs(z - pzx_t).max()),
            "plan_verdict": verdict,
            "verdicts": {verdict: 1},
            "adopted_frac": float(adopted.mean()),
        }
        payload_extra = {}
        v_t, w_t = v_t[0].cpu().numpy(), w_t[0].cpu().numpy()
    print(json.dumps(result))
    if args.out:
        # .mat export, as the reference's closed-loop script
        payload = {
            "z": z, "v": v_t, "w": w_t, "pz_x": pzx_t,
            "z0": prob["start"], "zf": prob["goal"],
            "obs_x": prob["obs"]["c"][:, 0], "obs_y": prob["obs"]["c"][:, 1],
            "obs_r": prob["obs"]["r"], **payload_extra,
        }
        if adopted is not None:
            payload["adopted"] = adopted
        _save_mat_or_npz(args.out, payload)
        print(f"saved closed-loop trace -> {args.out}")


def _save_mat_or_npz(path, payload):
    import numpy as np

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if path.endswith(".mat"):
        from scipy.io import savemat

        savemat(path, payload)
    else:
        np.savez(path, **payload)


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
    t.add_argument("--dp-devices", type=int, default=0,
                   help="data-parallel training over an N-device mesh "
                        "(envs sharded, params replicated)")
    t.set_defaults(fn=cmd_train)

    pl = sub.add_parser("play")
    common(pl)
    pl.add_argument("--task", default="hopper_trajectory")
    pl.add_argument("--num-envs", type=int, default=1)
    pl.add_argument("--steps", type=int, default=1000)
    pl.add_argument("--load", default="",
                    help="run dir to resume (default: the most recent run "
                         "under <log-root>/<task>)")
    pl.add_argument("--checkpoint", default="latest")
    pl.add_argument("--log-root", default="logs")
    pl.add_argument("--export", default="",
                    help="directory for the exported policy")
    pl.add_argument("--plot", default="", help="dashboard .png")
    pl.add_argument("--mat", default="", help=".mat state-log export")
    pl.add_argument("--video", default="",
                    help="render env 0's rollout to .mp4/.gif with "
                         "mujoco.Renderer (needs the mujoco package)")
    pl.add_argument("--live", type=int, nargs="?", const=0, default=None,
                    metavar="PORT",
                    help="serve an interactive live viewer over HTTP "
                         "(0/omitted port = auto; browser keys: ESC quit, "
                         "V sync, SPACE pause, arrows/+-/F camera; needs "
                         "the mujoco package)")
    pl.add_argument("--video-steps", type=int, default=0,
                    help="frames to record (default: min(steps, 250))")
    pl.set_defaults(fn=cmd_play)

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

    for name, fn in (("plan", cmd_plan), ("mpc", cmd_mpc)):
        s = sub.add_parser(name)
        common(s)
        s.add_argument("--problem", default="gap",
                       choices=["gap", "right", "right_wide"])
        s.add_argument("--tube-dyn", default="l1",
                       choices=["l1", "l2", "l1_rolling", "l2_rolling",
                                "NN_oneshot"])
        s.add_argument("--tube-model", default="",
                       help="the port's tube-model file from `train-tube "
                            "--oneshot --out` (required for --tube-dyn "
                            "NN_oneshot; its H_fwd must equal --N and "
                            "H_rev --H-rev)")
        s.add_argument("--N", type=int, default=50)
        s.add_argument("--H-rev", type=int, default=10)
        s.add_argument("--out", default="",
                       help=".mat (scipy.io.savemat) or .npz output")
        s.add_argument("--generic", action="store_true",
                       help="the dense generic AL solver instead of the "
                            "staged block-tridiagonal path (also taken by "
                            "the rolling tubes, which have no staged form)")
        if name == "plan":
            s.add_argument("--nominal", action="store_true")
        else:
            s.add_argument("--H", type=int, default=75)
        s.set_defaults(fn=fn)
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.fn(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
