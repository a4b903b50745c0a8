"""Rules of the PyTorch/CUDA port that hold for every file of it.

- No file under ``legged_gym_dev_tpu_torch/``, nor ``chip_smoke.py`` nor
  the files it loads by path (the card tests
  ``tests/test_torch_kernels_cuda.py``, the test robots, the goldens'
  runner ``tests/test_torch_goldens.py``), imports ``jax``, ``flax`` or
  the JAX package (an AST scan of every ``import`` and ``from ...
  import``, relative imports resolved).
- Entry points called without ``device`` mean the CUDA card: on a machine
  without one they raise instead of running on the CPU.
- Every name a JAX ``__init__.py`` binds (read with ``ast``, never
  imported) can be imported from the port's counterpart, but for the TPU
  runtime helpers ``utils.force_cpu`` / ``setup_tpu_runtime``.
"""
import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from legged_gym_dev_tpu_torch.interop import (
    mlp_from_numpy,
    trajopt_params_from_numpy,
)
from legged_gym_dev_tpu_torch.solver import (
    ALConfig,
    StagedProblem,
    certify_staged_batched,
    closed_loop_tube_mpc_fast,
    solve_tube_fast_batched,
    staged_bounds,
)
from legged_gym_dev_tpu_torch.utils.runtime import resolve_device
from tests.torch_port_cases import ROM_ARGS, gap_case, torch_params

ROOT = Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "legged_gym_dev_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "legged_gym_dev_tpu")


def _port_files():
    """The package, the port's scripts, chip_smoke.py and the card tests,
    which run on a machine without JAX."""
    return sorted(PACKAGE.rglob("*.py")) + sorted(
        (ROOT / "scripts").glob("torch_*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "tests" / "test_torch_kernels_cuda.py",
        ROOT / "tests" / "torch_robot_cases.py",
        ROOT / "tests" / "test_torch_goldens.py"]


def _imported_modules(path):
    """Absolute names of every module a file imports."""
    tree = ast.parse(path.read_text(), filename=str(path))
    rel = path.relative_to(ROOT).with_suffix("").parts
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = list(rel[:len(rel) - node.level])
                names.append(".".join(base + ([node.module]
                                              if node.module else [])))
            else:
                names.append(node.module)
    return names


def test_scan_sees_the_whole_port():
    files = {p.relative_to(ROOT).as_posix() for p in _port_files()}
    for needed in ("chip_smoke.py",
                   "legged_gym_dev_tpu_torch/solver/staged_scalar.py",
                   "legged_gym_dev_tpu_torch/ops/block_tridiag_kernels.py",
                   "legged_gym_dev_tpu_torch/ops/substep_kernels.py",
                   "legged_gym_dev_tpu_torch/sim/urdf.py",
                   "tests/torch_robot_cases.py"):
        assert needed in files
    # the resolver turns a relative import into its absolute module
    assert ("legged_gym_dev_tpu_torch.ops.block_tridiag_kernels"
            in _imported_modules(PACKAGE / "solver" / "staged_scalar.py"))


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_port_imports_no_jax(path):
    bad = [name for name in _imported_modules(path)
           if name.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


def _no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_resolve_device_raises_without_card(monkeypatch):
    _no_card(monkeypatch)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    assert resolve_device("cpu") == torch.device("cpu")


def test_entry_points_raise_without_card(monkeypatch):
    """Each entry point called without ``device`` raises on a machine with
    no card (and so does building inputs for it without ``device``)."""
    _no_card(monkeypatch)
    case = gap_case(2, 10, 4, "l1")
    p = torch_params(case)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        solve_tube_fast_batched(p, 10, 4, cfg=ALConfig(outer_iters=1,
                                                       inner_iters=1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        closed_loop_tube_mpc_fast(p, p.rom, H=1, N=10, H_rev=4)
    sp = StagedProblem(n=2, m=2, N=10, K=2, tube_kind="l1", scaling=0.5,
                       track_ref=False)
    lb, ub = staged_bounds(p, 2, 2, 10)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        certify_staged_batched(sp, p, torch.zeros(2, 11, 5),
                               torch.zeros(2), lb, ub)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trajopt_params_from_numpy(*ROM_ARGS, 10, 4, np.eye(2), np.eye(2),
                                  case["z0"], case["zf"], case["obs_c"],
                                  case["obs_r"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mlp_from_numpy([np.eye(2, dtype=np.float32)],
                       [np.zeros(2, np.float32)])


def test_rl_entry_points_raise_without_card(monkeypatch):
    """The RL slice's entry points, called without ``device``, raise on a
    machine with no card."""
    from legged_gym_dev_tpu_torch.envs.presets import make_trajectory_env
    from legged_gym_dev_tpu_torch.sim.contact import ContactParams
    from legged_gym_dev_tpu_torch.sim.dynamics import RobotModel
    from legged_gym_dev_tpu_torch.sim.robot_sim import RobotSim
    from legged_gym_dev_tpu_torch.sim.urdf import parse_urdf
    from tests.torch_robot_cases import HOPPER4_URDF, QUADRUPED_URDF

    _no_card(monkeypatch)
    model = RobotModel.from_spec(parse_urdf(HOPPER4_URDF))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RobotSim.create(model)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_trajectory_env(QUADRUPED_URDF, num_envs=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ContactParams.create()
    assert RobotSim.create(model, device="cpu").device.type == "cpu"


def test_training_entry_points_raise_without_card(monkeypatch, tmp_path):
    """The training slice's entry points (the hopper presets, the
    registry, ``cli train`` without ``--cpu``) raise on a machine with no
    card; ``--cpu`` and ``device="cpu"`` are the CPU's way in."""
    from legged_gym_dev_tpu_torch import cli
    from legged_gym_dev_tpu_torch.envs import registry
    from legged_gym_dev_tpu_torch.envs.presets import (
        make_hopper_trajectory_env,
        make_hopper_velocity_env,
    )
    from tests.torch_robot_cases import HOPPER_URDF

    _no_card(monkeypatch)
    for make in (make_hopper_trajectory_env, make_hopper_velocity_env):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make(urdf_path=HOPPER_URDF, num_envs=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        registry.make_env("hopper_trajectory", urdf_path=HOPPER_URDF,
                          num_envs=2)
    urdf = tmp_path / "hopper.urdf"
    urdf.write_text(HOPPER_URDF)
    cfg = tmp_path / "c.yaml"
    cfg.write_text(f"env:\n  num_envs: 2\n  urdf_path: {urdf}\n")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["train", "--config", str(cfg), "--log-root",
                  str(tmp_path / "logs"), "--max-iterations", "1"])
    env = make_hopper_trajectory_env(urdf_path=HOPPER_URDF, num_envs=2,
                                     device="cpu")
    assert env.device.type == "cpu"


def test_scan_sees_the_tube_slice():
    files = {p.relative_to(ROOT).as_posix() for p in _port_files()}
    for needed in ("legged_gym_dev_tpu_torch/tube/datasets.py",
                   "legged_gym_dev_tpu_torch/tube/shards.py",
                   "legged_gym_dev_tpu_torch/tube/train.py",
                   "legged_gym_dev_tpu_torch/native/__init__.py",
                   "legged_gym_dev_tpu_torch/evaluation.py",
                   "legged_gym_dev_tpu_torch/sim/rom_sim.py",
                   "legged_gym_dev_tpu_torch/envs/rom_tracking.py"):
        assert needed in files
    assert ("legged_gym_dev_tpu_torch.native"
            in _imported_modules(PACKAGE / "tube" / "shards.py"))


def test_tube_entry_points_raise_without_card(monkeypatch, tmp_path):
    """The tube-learning slice's entry points (the ``rom_tracking`` preset,
    the trainers, the model file's loader, ``cli collect`` and ``cli
    train-tube`` without ``--cpu``) raise on a machine with no card."""
    from legged_gym_dev_tpu_torch import cli
    from legged_gym_dev_tpu_torch.envs import registry
    from legged_gym_dev_tpu_torch.envs.presets import make_rom_tracking_env
    from legged_gym_dev_tpu_torch.tube.datasets import TubeDataset
    from legged_gym_dev_tpu_torch.tube.losses import scalar_tube_loss
    from legged_gym_dev_tpu_torch.tube.models import MLP, load_mlp, save_mlp
    from legged_gym_dev_tpu_torch.tube.shards import NumpyTubeLoader
    from legged_gym_dev_tpu_torch.tube.train import (
        TrainConfig,
        train_tube,
        train_tube_streaming,
    )

    _no_card(monkeypatch)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_rom_tracking_env(num_envs=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        registry.make_env("rom_tracking", num_envs=2)
    assert make_rom_tracking_env(num_envs=2, device="cpu").device.type \
        == "cpu"
    model = MLP.create(torch.Generator().manual_seed(0), 3, 1, num_units=4)
    ds = TubeDataset(np.zeros((40, 3), np.float32),
                     np.zeros((40, 1), np.float32))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_tube(ds, model, scalar_tube_loss, TrainConfig(epochs=1))
    npz = tmp_path / "r.npz"
    cli.main(["collect", "--cpu", "--num-envs", "2", "--epochs", "1",
              "--episode-length-s", "1.0", "--shards", "--out",
              str(tmp_path / "shards")])
    loader = NumpyTubeLoader(sorted(map(str, (tmp_path / "shards").iterdir())))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_tube_streaming(loader, MLP.create(
            torch.Generator(), loader.input_dim, 1, num_units=4),
            scalar_tube_loss, TrainConfig(epochs=1))
    save_mlp(model, tmp_path / "m.pt")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_mlp(tmp_path / "m.pt")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["collect", "--num-envs", "2", "--epochs", "1",
                  "--out", str(npz)])
    cli.main(["collect", "--cpu", "--num-envs", "2", "--epochs", "1",
              "--episode-length-s", "1.0", "--out", str(npz)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["train-tube", "--data", str(npz), "--epochs", "1"])


def test_scan_sees_the_planning_slice():
    files = {p.relative_to(ROOT).as_posix() for p in _port_files()}
    for needed in ("legged_gym_dev_tpu_torch/solver/al_solver.py",
                   "legged_gym_dev_tpu_torch/solver/mpc.py",
                   "legged_gym_dev_tpu_torch/solver/bucketed.py",
                   "legged_gym_dev_tpu_torch/solver/debug.py",
                   "legged_gym_dev_tpu_torch/solver/tube_dynamics.py",
                   "legged_gym_dev_tpu_torch/cli.py",
                   "tests/test_torch_goldens.py"):
        assert needed in files
    assert ("legged_gym_dev_tpu_torch.solver.al_solver"
            in _imported_modules(PACKAGE / "solver" / "mpc.py"))


def test_planning_entry_points_raise_without_card(monkeypatch, tmp_path):
    """The planning slice's entry points (the generic solver, its solves,
    the closed loop, the bucketed solve, ``cli plan`` / ``cli mpc``
    without ``--cpu``) called without ``device`` raise on a machine with
    no card."""
    from legged_gym_dev_tpu_torch import cli
    from legged_gym_dev_tpu_torch.solver import (
        build_nlp_fns,
        get_tube_dynamics,
        make_bounds,
        pack_x,
        solve_al,
        solve_nominal,
        solve_tube,
        solve_tube_batched,
    )
    from legged_gym_dev_tpu_torch.solver.bucketed import (
        solve_tube_fast_bucketed,
    )
    from legged_gym_dev_tpu_torch.solver.mpc import (
        MPCConfig,
        closed_loop_tube_mpc,
    )

    _no_card(monkeypatch)
    N = 6
    p = torch_params(gap_case(2, N, 4, "l1"))
    tube = get_tube_dynamics("l1", N)
    one = ALConfig(outer_iters=1, inner_iters=1)
    x0 = pack_x(p.z0[:, None].expand(2, N + 1, 2), torch.zeros(2, N, 2),
                torch.zeros(2, N + 1))
    calls = [
        lambda: solve_al(*build_nlp_fns(2, 2, N, True, tube), x0, p,
                         *make_bounds(p, N, True), one),
        lambda: solve_nominal(p, N, one),
        lambda: solve_tube(p, tube, N, 4, one),
        lambda: solve_tube_batched(p, tube, N, 4, one),
        lambda: closed_loop_tube_mpc(p, tube, p.rom,
                                     MPCConfig(H=1, N=N, H_rev=4),
                                     al_first=one, al_loop=one),
        lambda: solve_tube_fast_bucketed(p, N, 4, cfg=ALConfig(
            outer_iters=2, inner_iters=1), phase1_outers=1),
        lambda: cli.main(["plan", "--N", str(N), "--H-rev", "4"]),
        lambda: cli.main(["mpc", "--N", str(N), "--H-rev", "4", "--H", "1"]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    out = solve_tube(p, tube, N, 4, one, device="cpu")
    assert out.z.device.type == "cpu"


def test_scan_sees_the_play_and_reference_slice():
    files = {p.relative_to(ROOT).as_posix() for p in _port_files()}
    for needed in ("legged_gym_dev_tpu_torch/utils/logger.py",
                   "legged_gym_dev_tpu_torch/utils/export.py",
                   "legged_gym_dev_tpu_torch/utils/profiling.py",
                   "legged_gym_dev_tpu_torch/utils/grids.py",
                   "legged_gym_dev_tpu_torch/solver/block_tridiag.py",
                   "legged_gym_dev_tpu_torch/trajgen/generator.py",
                   "legged_gym_dev_tpu_torch/sim/dynamics.py"):
        assert needed in files
    assert ("legged_gym_dev_tpu_torch.solver.block_tridiag"
            in _imported_modules(PACKAGE / "solver" / "fast_tube.py"))


def test_play_entry_points_raise_without_card(monkeypatch, tmp_path):
    """``cli play`` without ``--cpu`` raises on a machine with no card;
    so does the hopper preset with a named weight sampler."""
    from legged_gym_dev_tpu_torch import cli
    from legged_gym_dev_tpu_torch.envs.presets import (
        make_hopper_trajectory_env,
    )
    from tests.torch_robot_cases import HOPPER_URDF

    _no_card(monkeypatch)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["play", "--task", "rom_tracking", "--num-envs", "2",
                  "--steps", "1", "--log-root", str(tmp_path / "logs")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_hopper_trajectory_env(
            urdf_path=HOPPER_URDF, num_envs=2,
            weight_sampler="UniformWeightSamplerTurnBiased")


def test_scan_sees_the_mesh_slice():
    files = {p.relative_to(ROOT).as_posix() for p in _port_files()}
    for needed in ("legged_gym_dev_tpu_torch/parallel/__init__.py",
                   "legged_gym_dev_tpu_torch/parallel/mesh.py"):
        assert needed in files
    assert ("legged_gym_dev_tpu_torch.parallel.mesh"
            in _imported_modules(PACKAGE / "ops" / "substep_kernels.py"))


def test_mesh_entry_points_raise_without_card(monkeypatch, tmp_path):
    """A mesh asked of the card (``make_mesh``, ``make_host_mesh`` without
    devices, ``cli train --dp-devices`` without ``--cpu``) raises on a
    machine with no card instead of landing on the CPU."""
    from legged_gym_dev_tpu_torch import cli
    from legged_gym_dev_tpu_torch.parallel import make_host_mesh, make_mesh

    _no_card(monkeypatch)
    for call in (lambda: make_mesh(), lambda: make_mesh(1),
                 lambda: make_host_mesh(1, 1)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["train", "--task", "rom_tracking", "--dp-devices", "2",
                  "--num-envs", "4", "--max-iterations", "1",
                  "--log-root", str(tmp_path / "logs")])
    assert make_mesh(2, devices=["cpu", "cpu"]).size == 2


# the JAX package's TPU runtime set-up, which the port's resolve_device,
# fp32_matmul and --cpu stand in for
NOT_PORTED = {"utils": {"force_cpu", "setup_tpu_runtime"}}


def _bound_names(path):
    """Public names an ``__init__.py`` binds at module level: relative
    imports, definitions, assignments, ``__all__`` and ``__version__``."""
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.ImportFrom) and node.level:
            names |= {a.asname or a.name for a in node.names}
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    names.add(t.id)
                    if t.id == "__all__":
                        names |= set(ast.literal_eval(node.value))
    return {n for n in names if not n.startswith("_")
            or n == "__version__"}


JAX_INITS = sorted((ROOT / "legged_gym_dev_tpu").rglob("__init__.py"))


@pytest.mark.parametrize(
    "jax_init", JAX_INITS,
    ids=lambda p: p.relative_to(ROOT / "legged_gym_dev_tpu").as_posix())
def test_port_exports_every_jax_package_name(jax_init):
    """Each name the JAX ``__init__.py`` binds is bound by the port's
    counterpart and can be imported from it."""
    import importlib

    rel = jax_init.relative_to(ROOT / "legged_gym_dev_tpu")
    sub = ".".join(rel.parent.parts)
    ours = PACKAGE / rel
    assert ours.exists(), f"no port counterpart of {rel}"
    need = _bound_names(jax_init) - NOT_PORTED.get(sub, set())
    missing = sorted(need - _bound_names(ours))
    assert not missing, f"{ours.relative_to(ROOT)} lacks {missing}"
    module = "legged_gym_dev_tpu_torch" + (f".{sub}" if sub else "")
    mod = importlib.import_module(module)
    assert not [n for n in sorted(need) if not hasattr(mod, n)]


def test_exports_rule_reads_the_jax_names():
    """The rule sees what it must: the names this port once lacked, and
    only the two runtime helpers are left out."""
    by_sub = {p.parent.name: _bound_names(p) for p in JAX_INITS}
    assert {"CheckpointManager", "OnPolicyRunner"} <= by_sub["rl"]
    assert {"RomTrackingEnv", "RomTrackingEnvState",
            "HopperTrajectoryEnv"} <= by_sub["envs"]
    assert {"RomSim", "RomSimState"} <= by_sub["sim"]
    assert {"MLP", "softplus_beta"} <= by_sub["tube"]
    assert "maths" in by_sub["core"]
    assert by_sub["utils"] == NOT_PORTED["utils"]


def test_flagship_entry_points_raise_without_card(monkeypatch):
    """Both flagship pipelines, called without ``device``, raise on a
    machine with no card (before any work), as their scripts do without
    ``E2E_CPU`` / ``--cpu``."""
    import importlib.util

    _no_card(monkeypatch)
    for name, fn in (("torch_flagship_e2e", "run_flagship"),
                     ("torch_flagship_rl_e2e", "run_rl_flagship")):
        path = ROOT / "scripts" / f"{name}.py"
        spec = importlib.util.spec_from_file_location(f"{name}_rule", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            getattr(module, fn)()
        monkeypatch.delenv("E2E_CPU", raising=False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            module.main([])


def test_scan_sees_the_mujoco_slice():
    files = {p.relative_to(ROOT).as_posix() for p in _port_files()}
    for needed in ("legged_gym_dev_tpu_torch/sim/mjcf.py",
                   "legged_gym_dev_tpu_torch/utils/video.py",
                   "legged_gym_dev_tpu_torch/utils/live_viewer.py"):
        assert needed in files
        bad = [m for m in _imported_modules(ROOT / needed)
               if m.split(".")[0] in FORBIDDEN]
        assert not bad, (needed, bad)
    assert ("legged_gym_dev_tpu_torch.sim.mjcf"
            in _imported_modules(PACKAGE / "utils" / "video.py"))


def test_mujoco_and_scenario_entry_points_raise_without_card(monkeypatch,
                                                             tmp_path):
    """The sim2sim evaluations, ``record_rollout_video`` and the builders
    of per-scenario ROMs, networks and ``TrajOptParams``, called without
    ``device``, raise on a machine with no card."""
    from legged_gym_dev_tpu_torch.core.rom import SingleInt2D, make_rom
    from legged_gym_dev_tpu_torch.envs.presets import make_rom_tracking_env
    from legged_gym_dev_tpu_torch.evaluation import (
        evaluate_sim2sim_hopper,
        evaluate_sim2sim_hopper_reference,
    )
    from legged_gym_dev_tpu_torch.tube.models import MLP
    from legged_gym_dev_tpu_torch.utils.video import record_rollout_video
    from tests.torch_robot_cases import HOPPER_URDF

    env = make_rom_tracking_env(num_envs=2, device="cpu")
    rom = make_rom(*ROM_ARGS, device="cpu")
    net = mlp_from_numpy([np.ones((3, 2), np.float32)],
                         [np.zeros(2, np.float32)], device="cpu")
    B = 3
    case = gap_case(B, 4, 2, "l1")
    _no_card(monkeypatch)
    calls = [
        lambda: evaluate_sim2sim_hopper(steps=2, urdf_path=HOPPER_URDF),
        lambda: evaluate_sim2sim_hopper_reference(
            steps=2, urdf_path=HOPPER_URDF, xml_path=str(tmp_path / "x")),
        lambda: record_rollout_video(env, lambda o: o[:, :2],
                                     torch.Generator(), 1,
                                     str(tmp_path / "v.gif")),
        lambda: make_rom("SingleInt2D", np.full(B, 0.1), [-1, -1], [1, 1],
                         np.full((B, 2), -0.2), np.full((B, 2), 0.2)),
        lambda: SingleInt2D.stack([rom] * B),
        lambda: MLP.stack([net] * B),
        lambda: mlp_from_numpy([np.ones((B, 3, 2), np.float32)],
                               [np.zeros((B, 2), np.float32)]),
        lambda: trajopt_params_from_numpy(
            "SingleInt2D", np.full(B, 0.1, np.float32), *ROM_ARGS[2:], 4, 2,
            np.eye(2), np.eye(2), case["z0"], case["zf"], case["obs_c"],
            case["obs_r"]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert SingleInt2D.stack([rom] * B, device="cpu").per_scenario


# JAX modules whose port counterpart carries another name: the Pallas
# kernels' wrappers and their CUDA kernels (ROADMAP.md §2).
RENAMED = {"ops/pallas_block_tridiag.py": "ops/block_tridiag_kernels.py",
           "ops/pallas_substep.py": "ops/substep_kernels.py"}


def test_every_jax_module_has_a_counterpart():
    """Each module of the JAX package has its file in the port (under its
    own path, or the kernel wrappers' names above); ROADMAP.md lists no
    whole module as not to be ported."""
    jax_pkg = ROOT / "legged_gym_dev_tpu"
    missing = []
    for path in sorted(jax_pkg.rglob("*.py")):
        rel = path.relative_to(jax_pkg).as_posix()
        if not (PACKAGE / RENAMED.get(rel, rel)).exists():
            missing.append(rel)
    assert not missing, missing
    assert all((PACKAGE / v).exists() for v in RENAMED.values())


# Public members of the JAX package's classes that the port's counterparts
# do not carry, each with the reason. Everything else a JAX class offers
# (methods, properties, dataclass fields) its counterpart offers too.
_KEY = ("the PRNG key a JAX state carries; the port's state draws from its "
        "torch.Generator (``gen``)")
_FLAX = ("flax.linen.Module's own machinery; the port's torch.nn.Module "
         "holds its parameters itself")
_FLAX_NAMES = ("apply", "bind", "clone", "copy", "get_variable", "has_rng",
               "has_variable", "init", "init_with_output", "is_initializing",
               "is_mutable_collection", "lazy_init", "make_rng",
               "module_paths", "name", "param", "parent", "path", "perturb",
               "put_variable", "scope", "setup", "sow", "tabulate", "unbind",
               "variable", "variables")
MEMBERS_NOT_PORTED = {
    "envs/hopper_trajectory.py:HopperEnvState": {"key": _KEY},
    "envs/hopper_velocity.py:HopperVelEnvState": {"key": _KEY},
    "envs/legged_robot_velocity.py:VelocityEnvState": {"key": _KEY},
    "envs/legged_robot_trajectory.py:TrajectoryEnvState": {"key": _KEY},
    "envs/rom_tracking.py:RomTrackingEnvState": {"key": _KEY},
    "sim/rom_sim.py:RomSimState": {"key": _KEY},
    "trajgen/generator.py:TrajGenState": {"key": _KEY},
    "rl/ppo.py:TrainState": {"key": _KEY},
    "envs/hopper_velocity.py:HopperVelocityEnv": {
        "curriculum": "a dummy field, always None (the flat velocity task "
                      "has no curriculum)"},
    "envs/legged_robot_velocity.py:LeggedRobotVelocityEnv": {
        "obs_scales": "a dummy field: the observation scales are applied "
                      "inline, block by block"},
    "envs/legged_robot_trajectory.py:LeggedRobotTrajectoryEnv": {
        "obs_scales": "the velocity env's dummy field, inherited"},
    "rl/networks.py:ActorCritic": dict.fromkeys(_FLAX_NAMES, _FLAX),
    "rl/networks.py:ActorCriticRecurrent": dict.fromkeys(_FLAX_NAMES, _FLAX),
}
# JAX classes with no counterpart class, and why.
CLASSES_NOT_PORTED = {
    "rl/networks.py:MLPBody": "a flax module of the actor's and critic's "
                              "layers; the port builds torch.nn.Sequential "
                              "stacks (``rl/networks.mlp``)",
}


def _instance_members(name):
    """The attributes of a small instance, for port classes that set
    their fields in ``__init__`` (torch modules) rather than as dataclass
    fields; None for the others."""
    from legged_gym_dev_tpu_torch.rl.networks import (
        ActorCritic,
        ActorCriticRecurrent,
    )
    from legged_gym_dev_tpu_torch.tube.models import MLP

    make = {
        "rl/networks.py:ActorCritic": lambda: ActorCritic(3, 2, (4,), (4,)),
        "rl/networks.py:ActorCriticRecurrent": lambda: ActorCriticRecurrent(
            3, 2, rnn_hidden_size=4, actor_hidden_dims=(4,),
            critic_hidden_dims=(4,)),
        "tube/models.py:MLP": lambda: MLP.create(
            torch.Generator().manual_seed(0), 3, 1, num_units=4),
    }.get(name)
    return None if make is None else set(dir(make()))


def _public_members(cls):
    import dataclasses

    names = {n for n in dir(cls) if not n.startswith("_")}
    if dataclasses.is_dataclass(cls):
        names |= {f.name for f in dataclasses.fields(cls)}
    return names


JAX_MODULES = sorted(
    p.relative_to(ROOT / "legged_gym_dev_tpu").as_posix()
    for p in (ROOT / "legged_gym_dev_tpu").rglob("*.py"))


@pytest.mark.parametrize("rel", JAX_MODULES)
def test_port_classes_carry_every_jax_member(rel):
    """Each class a JAX module defines has its counterpart class in the
    port's module, with every public method, property and dataclass field
    of the JAX class, or the attribute on a small instance where the port
    class sets it in ``__init__``; ``MEMBERS_NOT_PORTED`` and
    ``CLASSES_NOT_PORTED`` name the exceptions."""
    import dataclasses
    import importlib
    import inspect

    def module(pkg, path):
        return importlib.import_module(
            pkg + "." + path[:-3].replace("/", ".").removesuffix(
                ".__init__"))

    jax_mod = module("legged_gym_dev_tpu", rel)
    port_mod = module("legged_gym_dev_tpu_torch", RENAMED.get(rel, rel))
    gaps = []
    for cname, cls in sorted(vars(jax_mod).items()):
        if not inspect.isclass(cls) or cls.__module__ != jax_mod.__name__:
            continue
        key = f"{rel}:{cname}"
        ours = getattr(port_mod, cname, None)
        if key in CLASSES_NOT_PORTED:
            continue
        if not inspect.isclass(ours):
            gaps.append(f"{cname}: no class")
            continue
        have = _public_members(ours)
        fields = (dataclasses.is_dataclass(cls)
                  and not dataclasses.is_dataclass(ours))
        inst = _instance_members(key)
        if fields and inst is None:
            gaps.append(f"{cname}: no instance to read its fields from")
        have |= inst or set()
        missing = (_public_members(cls) - have
                   - set(MEMBERS_NOT_PORTED.get(key, ())))
        if missing:
            gaps.append(f"{cname}: {sorted(missing)}")
    assert not gaps, f"{rel}: {gaps}"


def test_member_allow_list_names_jax_members():
    """Each exception names a class of the JAX package and, for members,
    public members of it, with a reason; a class named as not ported has
    no counterpart."""
    import importlib

    for key, members in {**MEMBERS_NOT_PORTED,
                         **{k: {} for k in CLASSES_NOT_PORTED}}.items():
        rel, cname = key.split(":")
        mod = importlib.import_module(
            "legged_gym_dev_tpu." + rel[:-3].replace("/", "."))
        cls = getattr(mod, cname)
        assert set(members) <= _public_members(cls), key
        assert all(isinstance(r, str) and r for r in members.values())
        if key in CLASSES_NOT_PORTED:
            port = importlib.import_module(
                "legged_gym_dev_tpu_torch." + rel[:-3].replace("/", "."))
            assert not hasattr(port, cname) and CLASSES_NOT_PORTED[key]
