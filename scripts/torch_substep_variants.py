#!/usr/bin/env python3
"""Where the physics-substep kernel's (K3) time goes, on one CUDA card.

Builds variants (one ``nvcc`` each, all at once, into
``build/substep_variants/``) and times each on the 12-joint test quadruped
at B=4096 with per-env DR (``tests/torch_robot_cases.py``, the inputs of
``chip_smoke.py``'s substep phase): CUDA events over 50 launches of the
kernel alone, and the device time of 20 launches from ``torch.profiler``.

Variants:
  one_thread_b32/64/128   the first port's one-thread-per-env kernel
                          (``--one-thread FILE``: ``csrc/substep.cu`` as of
                          commit 75c82da) at blocks of 32, 64 and 128
                          threads: what occupancy alone gives; left out
                          without the file
  team4/8/16              ``legged_gym_dev_tpu_torch/csrc/substep.cu`` with
                          4, 8 or 16 lanes an env (blocks of 128 threads)
  team<T>_fk              ... returns after forward kinematics
  team<T>_mass            ... returns after the mass matrix and bias
  team<T>_chol            ... returns after the Cholesky factor (before
                          the substitutions)
  team8_load              ... returns after copying the model, schedules
                          and inputs to shared memory
  team8_chol_rolled       team8 with the Cholesky's column loop not unrolled
  team8_teamsync,         team8 and nj4_team8 with each whole-warp
  nj4_team8_teamsync      __syncwarp() replaced by one over the team's lanes
  team8_mass_<x>          team8 cut after the mass matrix and bias, with one
                          change to that phase: no_cols (no Jacobian
                          columns), no_entries (no entries of M), no_sync (no
                          __syncwarp between a body's columns and its
                          entries; wrong results)
  nj4_team2/4/8/16        the team design at nj=4 with 2 to 16 lanes an
                          env, timed on the 4-joint test robot (beside the
                          one-thread kernel on the same robot), and
  nj4_team4/8_<cut>       cut after load, fk or mass as above
A phase's time is the difference between two cuts.

Usage: ``python3 scripts/torch_substep_variants.py [--only a,b]
[--one-thread FILE]`` (needs nvcc and a card; ``--only`` keeps the variants
whose names start with one of the given prefixes). Write the one-thread
kernel's file beforehand, from a checkout with its history:
``git show 75c82da:legged_gym_dev_tpu_torch/csrc/substep.cu >
build/substep_one_thread.cu``.
"""
import argparse
import concurrent.futures
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from legged_gym_dev_tpu_torch.ops import _build  # noqa: E402
from legged_gym_dev_tpu_torch.ops import substep_kernels as sk  # noqa: E402

OUT = ROOT / "build" / "substep_variants"
B = 4096
TEAM_LINE = "__host__ __device__ constexpr int team_of() { return 8; }"
CUTS = {"load": "  // ---- torques: effort clip + springs + soft joint",
        "fk": "  // ---- per body and per contact sphere",
        "mass": "  // ---- right-hand side: -bias + flat-plane contact",
        "chol": "    // the substitutions on lane 0"}


def variants(one_thread=None):
    team_src = (_build.CSRC / sk.SOURCE).read_text()

    def replace(src, a, b):
        if a not in src:
            raise RuntimeError(f"anchor not in the source: {a!r}")
        return src.replace(a, b)

    out = {}
    if one_thread is not None:
        old_src = Path(one_thread).read_text()
        for threads in (32, 64, 128):
            out[f"one_thread_b{threads}"] = replace(
                old_src, "constexpr int kThreads = 128;",
                f"constexpr int kThreads = {threads};")
    for team in (4, 8, 16):
        src = replace(team_src, TEAM_LINE, TEAM_LINE.replace(
            "return 8;", f"return NJ >= 8 ? {team} : 8;"))
        out[f"team{team}"] = src
        for cut, anchor in CUTS.items():
            if cut != "load" or team == 8:
                out[f"team{team}_{cut}"] = replace(
                    src, anchor, "  if (B > 0) return;\n" + anchor)
    mass = out["team8_mass"]
    for x, (a, b) in {
            "no_cols": ("for (int ai = lane; ai < La; ai += T) {",
                        "for (int ai = lane; ai < 0; ai += T) {"),
            "no_entries": ("const int ne = topo.elen[n];",
                           "const int ne = 0;"),
            "no_sync": ("    __syncwarp();\n    // M += m_n Jp^T Jp",
                        "    // M += m_n Jp^T Jp")}.items():
        out[f"team8_mass_{x}"] = replace(mass, a, b)
    out["team8_teamsync"] = replace(
        team_src, "__syncwarp()",
        "__syncwarp(((1u << T) - 1u) << ((threadIdx.x & 31) & ~(T - 1)))")
    out["nj4_team8_teamsync"] = out["team8_teamsync"]
    out["team8_chol_rolled"] = replace(
        team_src, "#pragma unroll\n    for (int j = 0; j < NV; ++j) {",
        "#pragma unroll 1\n    for (int j = 0; j < NV; ++j) {")
    for team in (2, 4, 8, 16):
        src = replace(team_src, TEAM_LINE, TEAM_LINE.replace(
            "return 8;", f"return NJ >= 8 ? 8 : {team};"))
        out[f"nj4_team{team}"] = src
        for cut, anchor in CUTS.items():
            # nj=4 factors in registers on one lane: no Cholesky cut
            if team in (4, 8) and cut != "chol":
                out[f"nj4_team{team}_{cut}"] = replace(
                    src, anchor, "  if (B > 0) return;\n" + anchor)
    return out


def build(item):
    name, text = item
    src, lib = OUT / f"{name}.cu", OUT / f"{name}.so"
    src.write_text(text)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                           str(src)], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"{name}: {proc.stderr}")
    regs = {}
    nj = "ILi4E" if name.startswith("nj4_") else "ILi12E"
    for mangled, info in cs.ptxas_summary(proc.stdout + proc.stderr).items():
        if "substep_kernel" in mangled and nj in mangled:
            regs = info
    return name, (ctypes.CDLL(str(lib)), regs)


def device_ms(call):
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            call()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA
          and "substep_kernel" in e.name]
    return 1e-3 * sum(us) / max(1, len(us))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", default="")
    ap.add_argument("--one-thread", default=None)
    opts = ap.parse_args()
    only = [x for x in opts.only.split(",") if x]
    if not torch.cuda.is_available():
        print("torch_substep_variants: no CUDA device", file=sys.stderr)
        return 2
    OUT.mkdir(parents=True, exist_ok=True)
    todo = {k: v for k, v in variants(opts.one_thread).items()
            if not only or any(k.startswith(x) for x in only)}
    with concurrent.futures.ThreadPoolExecutor() as pool:
        libs = dict(pool.map(build, todo.items()))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card)
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    rc = cs.robot_cases()
    rec = {}
    for robot in ("quadruped", "hopper4"):
        inp = rc.substep_inputs(robot, B, seed=7, dr=True)
        sim = rc.torch_sim(robot, dev, inp)
        st, tau = rc.torch_state(inp, dev)
        nj, nv = sim.model.nj, sim.model.nv
        nc = len(sim.model.contact_body)
        params = torch.as_tensor(sk.pack_model(sim), device=dev)
        # the first port's layout: (rows, B) inputs and outputs
        xs = torch.cat([st.base_pos, st.base_quat, st.q, st.v, tau],
                       1).t().contiguous()
        dr = sk.dr_rows(sim, B, dev)
        o = torch.empty((7 + nj + nv, B), device=dev)
        outs = [torch.empty((B, n), device=dev) for n in (3, 4, nj, nv)]
        args, views = sk.substep_args(sim, st, tau, outs)
        for name, (lib, regs) in libs.items():
            if (robot == "hopper4") != (name.startswith("nj4_")
                                        or name.startswith("one_thread")):
                continue
            fn = lib.substep
            if name.startswith("one_thread"):
                fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
                    ctypes.c_void_p]

                def call():
                    fn(params.data_ptr(), xs.data_ptr(), dr.data_ptr(),
                       o.data_ptr(), nj, nc, B, 1, stream)
            else:
                fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
                    ctypes.c_void_p]
                lib.substep_team.restype = ctypes.c_int
                topo = torch.as_tensor(
                    sk.pack_topology(sim.model, lib.substep_team(nj)),
                    device=dev)

                def call():
                    fn(params.data_ptr(), topo.data_ptr(),
                       ctypes.addressof(args), nj, nc, B, stream)
            call()
            torch.cuda.synchronize()
            ms = cs.time_ms(call, 50, warmup=3)
            rec.setdefault(robot, {})[name] = dict(
                ms=ms, device_ms=device_ms(call), ptxas=regs)
            print(f"{robot:9s} {name:16s} {ms:.4f} ms (device "
                  f"{rec[robot][name]['device_ms']:.4f}) "
                  + json.dumps({k: regs.get(k) for k in
                                ("registers", "spill_stores")}), flush=True)
    print(json.dumps({"card": card, "B": B, "variants": rec}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
