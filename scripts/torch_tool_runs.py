"""The port's profiling and schedule tools (``scripts/torch_profile_*.py``,
``torch_measure_imbalance.py``, ``torch_sweep_schedule.py``,
``torch_tune_loop_schedule.py``, ``torch_compile_time_quadruped.py``) on
the card, each in a process of its own.

A run is one tool's ``main`` with the environment knobs and arguments of
``RUNS``: the JAX files' defaults but for the cuts named there (only timed
reps are cut). A tool that makes a robot gets a test robot of
``tests/torch_robot_cases.py``, written under ``build/tool_runs/<run>/``
and named through ``OVERRIDES`` (the presets' URDFs lie outside this
repository). Each run's record (the tool's returned numbers, its knobs
and cuts, the card's name and power limit, the process wall) is printed
as ``[tool run] {json}`` and written to ``<out>/<run>.json``; the tool's
own output goes to ``<out>/<run>.log`` and is echoed.

    python3 scripts/torch_tool_runs.py all --out chiprun_out/tool_runs
    python3 scripts/torch_tool_runs.py profile_sim profile_rough

Needs the card.
"""
import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

from torch_train_runs import card, load_by_path  # noqa: E402

# run -> (tool script, test robot constant or None, knobs, arguments: the
# cuts of timed reps)
RUNS = {
    "profile_solver": ("torch_profile_solver", None, {}, []),
    "profile_staged": ("torch_profile_staged", None, {}, ["--reps", "2"]),
    "profile_nn_tube": ("torch_profile_nn_tube", None,
                        {"PROF_JAC_AD": "1", "PROF_CHOL_XLA": "1"},
                        ["--reps", "2"]),
    "profile_tick": ("torch_profile_tick", None, {}, ["--reps", "1"]),
    "profile_sim": ("torch_profile_sim", "HOPPER_URDF", {}, []),
    "profile_quadruped": ("torch_profile_quadruped", "QUADRUPED_URDF", {},
                          []),
    "profile_rough": ("torch_profile_rough", "QUADRUPED_URDF", {},
                      ["--reps", "2"]),
    "measure_imbalance": ("torch_measure_imbalance", None, {}, []),
    "sweep_schedule": ("torch_sweep_schedule", None, {}, []),
    "tune_loop_schedule": ("torch_tune_loop_schedule", None, {},
                           ["--reps", "1"]),
    **{f"compile_time_{t}": ("torch_compile_time_quadruped",
                             "QUADRUPED_URDF", {"TARGET": t}, [])
       for t in ("substep", "envstep", "ppo")},
}


def child(run, out_dir):
    """One run in this process; returns its record."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device")
    script, const, knobs, argv = RUNS[run]
    os.environ.update(knobs)
    if const:
        work = ROOT / "build" / "tool_runs" / run
        work.mkdir(parents=True, exist_ok=True)
        rc = load_by_path("torch_robot_cases",
                          ROOT / "tests" / "torch_robot_cases.py")
        urdf = work / f"{const.lower()}.urdf"
        urdf.write_text(getattr(rc, const))
        os.environ["OVERRIDES"] = json.dumps({"urdf_path": str(urdf)})
    tool = load_by_path(script, ROOT / "scripts" / f"{script}.py")
    t0 = time.perf_counter()
    out = tool.main(list(argv))
    torch.cuda.synchronize()
    rec = dict(run=run, script=f"scripts/{script}.py", robot=const,
               knobs=knobs, cuts=argv, card=card(),
               device=torch.cuda.get_device_name(0),
               process_wall_s=time.perf_counter() - t0, out=out)
    (out_dir / f"{run}.json").write_text(json.dumps(rec, indent=1))
    print("[tool run] " + json.dumps(rec), flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("runs", nargs="+", help=f"{sorted(RUNS)} or all")
    ap.add_argument("--out", default=str(ROOT / "build" / "tool_runs"),
                    help="directory of the records and logs")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    runs = list(RUNS) if args.runs == ["all"] else args.runs
    unknown = sorted(set(runs) - set(RUNS))
    if unknown:
        ap.error(f"unknown runs {unknown}")
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    if args.child:
        child(runs[0], out_dir)
        return 0
    print(card(), flush=True)
    failed = []
    for run in runs:
        t0 = time.perf_counter()
        log = out_dir / f"{run}.log"
        with open(log, "w") as f:
            rc = subprocess.run(
                [sys.executable, __file__, run, "--child", "--out",
                 str(out_dir)], stdout=f, stderr=subprocess.STDOUT,
                cwd=ROOT).returncode
        lines = log.read_text().splitlines()
        print(f"[{run}] rc {rc} in {time.perf_counter() - t0:.1f} s",
              flush=True)
        for line in lines:
            if not line.startswith("[tool run] "):
                print(f"  {line}", flush=True)
        if rc != 0 or not any(line.startswith("[tool run] ")
                              for line in lines):
            failed.append(run)
    print(json.dumps({"ok": not failed, "failed": failed}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
