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
  baseline, nj4_baseline  with ``--baseline FILE``: another version of
                          ``csrc/substep.cu`` (an earlier commit's, written
                          beforehand with ``git show``) at nj 12 and 4,
                          timed in turns with team8 / nj4_team8 (baseline,
                          base, base, baseline)
A phase's time is the difference between two cuts.

``--shard``: the shard kernel (K3s, ``substep_shard_kernel``) instead, at
B=1024 (one shard of the 4-shard mesh), on the same robots:
  shard32                 the source as it is: a warp an env, 4 envs a block
  shard16                 16 lanes an env (8 envs a block)
  shard32_e2, shard32_e8  2 or 8 envs a block
  shard32_<cut>           returns after the copies (load), forward
                          kinematics (fk), the Jacobian columns (cols), the
                          mass matrix and bias (mass) or the Cholesky
                          factor (chol)
  shard32_subst0          both substitutions on lane 0 after the factor,
                          as K3 does them (instead of the forward one in
                          every lane beside the factor)
  shard32_colfwd          the forward substitution after the factor, a
                          column at a time (y_j by shuffle, lane i > j
                          subtracts L_ij y_j), the backward sweep on lane 0
  shard32_global          the schedules read from global memory instead of
                          a copy in shared memory
  shard32_libpivot        the Cholesky's pivots from the library's sqrtf
                          and division instead of pivot_fast
  shard32_unroll1         the item walk not unrolled
  shard32_empty           returns at once (the launch's own time)
  team8, team8_<cut>      K3 from the same source and its cuts, at B=1024
  nj4_...                 shard32, shard16, the cuts up to mass, and K3
                          (nj4_team8) on the 4-joint robot
then K3 and the shard kernel of the source in turns (K3, shard, shard,
K3) at B=1024 and 4096, both across batches, and shard32_subst0 at B=2048
and 4096.

``--nj10``: K3 at nj=10, on the Adam stand-in (``biped10``, two legs of
five joints): the library's two forms of it, ``substep_kernel<10>`` (the
8-lane team, what ``substep`` launches) and the shard kernel, in turns
(team, shard, shard, team) at B=1024, 2048 and 4096, held to each other
bit for bit, with the shard kernel's launch shape and waves; then at
B=4096 the team kernel (nj10) and its cuts after the copies, FK, the mass
matrix and the factor (nj10_<cut>), and what each phase costs.
``--racecheck``: ``compute-sanitizer --tool racecheck`` and ``--tool
synccheck`` on one K3 launch at B=64 on the 4-joint hopper and the
quadruped, with ``--baseline FILE``'s source and with the source (one
process each; the output's summaries under ``build/substep_variants/``).

Each time is the device time a launch of 20 launches queued behind a
sleep (``chip_smoke.device_ms``); each variant's outputs are checked
against K3's (bit for bit, cuts excepted). It first holds ``pivot_fast``
against the library's ``sqrtf(max(a, 1e-12))`` and ``1.0f / d`` on all
2^32 floats; with ``--baseline FILE`` it also compiles ``substep_kernel``
and ``substep_shard_kernel`` at every joint count 1-24 from FILE and from
the source (``nvcc -cubin``) and says whether each instance has the same
SASS.

Usage: ``python3 scripts/torch_substep_variants.py [--only a,b]
[--one-thread FILE] [--baseline FILE] [--shard | --nj10 | --racecheck]``
(needs nvcc and a card; ``--only`` keeps the variants whose names start
with one of the given prefixes). Write the one-thread kernel's file
beforehand, from a checkout with its history: ``git show 75c82da:
legged_gym_dev_tpu_torch/csrc/substep.cu > build/substep_one_thread.cu``;
the baseline likewise from the commit to compare with.
"""
import argparse
import concurrent.futures
import ctypes
import json
import re
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


def variants(one_thread=None, baseline=None):
    team_src = (_build.CSRC / sk.SOURCE).read_text()

    def replace(src, a, b):
        if a not in src:
            raise RuntimeError(f"anchor not in the source: {a!r}")
        return src.replace(a, b)

    out = {}
    if baseline is not None:
        out["baseline"] = out["nj4_baseline"] = Path(baseline).read_text()
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
    nj = 4 if name.startswith("nj4_") else 10 if name.startswith(
        "nj10") else 12
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS,
                           f"-DSUBSTEP_NJ={nj}", "-o", str(lib), str(src)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"{name}: {proc.stderr}")
    regs = {}
    kernel = "substep_shard_kernel" if "shard" in name else "substep_kernel"
    for mangled, info in cs.ptxas_summary(proc.stdout + proc.stderr).items():
        if f"{kernel}ILi{nj}E" in mangled:
            regs = info
    return name, (ctypes.CDLL(str(lib)), regs)


# --shard: the shard kernel's variants, anchored on its phase comments
SHARD_TEAM = "constexpr int shard_team_of() { return 32; }"
SHARD_THREADS = "constexpr int kShardThreads = 128;"
SHARD_CUTS = {
    "load": "  // ---- shard: torques; M and bias set",
    "fk": "  // ---- shard: per body and per contact sphere",
    "cols": "  // ---- shard: mass matrix and bias, each lane's",
    "mass": "  // ---- shard: right-hand side",
    "chol": "    // ---- shard: the backward substitution on lane 0"}
SHARD_FORWARD = (
    """    float t[NV], y[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i) t[i] = s.rhs[i];
""", """      if (j > 0) {
#pragma unroll
        for (int i = j; i < NV; ++i)
          t[i] = t[i] - s.M[lo(i, j - 1)] * y[j - 1];
      }
      y[j] = t[j] / d;
""")
SHARD_BACKWARD_START = "    // ---- shard: the backward substitution on lane 0"
SHARD_BACKWARD_END = "  __syncwarp();\n\n  // ---- shard: velocity clamp"
LANE0_SUBST = """    // both substitutions on lane 0, as K3 does them
    if (lane == 0) {
      float y[NV];
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        float t = s.rhs[i];
#pragma unroll
        for (int k = 0; k < i; ++k) t = t - s.M[lo(i, k)] * y[k];
        y[i] = t / s.dg[i];
      }
#pragma unroll
      for (int i = NV - 1; i >= 0; --i) {
        float t = y[i];
#pragma unroll
        for (int k = i + 1; k < NV; ++k) t = t - s.M[lo(k, i)] * y[k];
        y[i] = t / s.dg[i];
      }
#pragma unroll
      for (int i = 0; i < NV; ++i) s.qdd[i] = y[i];
    }
  }
"""
COLUMN_FORWARD = """    // the forward substitution a column at a time: lane i holds row i's
    // running t_i; y_j = t_j / d_j comes from lane j by shuffle
    constexpr int R = (NV + T - 1) / T;
    float t[R], y[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = lane + r * T;
      t[r] = i < NV ? s.rhs[i] : 0.0f;
      y[r] = 0.0f;
    }
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const float q = t[j / T] / s.dg[j];
      const float yj = __shfl_sync(0xffffffffu, q, j % T, T);
      if (lane == j % T) y[j / T] = q;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int i = lane + r * T;
        if (i > j && i < NV) t[r] = t[r] - s.M[lo(i, j)] * yj;
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (lane + r * T < NV) s.qdd[lane + r * T] = y[r];
    __syncwarp();
    // the backward sweep on lane 0
    if (lane == 0) {
      float x[NV];
#pragma unroll
      for (int i = 0; i < NV; ++i) x[i] = s.qdd[i];
#pragma unroll
      for (int i = NV - 1; i >= 0; --i) {
        float u = x[i];
#pragma unroll
        for (int k = i + 1; k < NV; ++k) u = u - s.M[lo(k, i)] * x[k];
        x[i] = u / s.dg[i];
      }
#pragma unroll
      for (int i = 0; i < NV; ++i) s.qdd[i] = x[i];
    }"""
SHARD_TOPO_SMEM = (
    "  const ShardTopo<NJ>& topo = *reinterpret_cast<const ShardTopo<NJ>*>"
    "(smem);")
SHARD_TOPO_COPY = """  for (int i = threadIdx.x; i < TI; i += blockDim.x)
    cp_async4(smem + i, topo_g + i);
"""
SHARD_PIVOT = "      pivot_fast(acc, d, inv);"
SHARD_WALK = "#pragma unroll 2\n    for (int st = 0; st < nsteps; ++st) {"
SHARD_START = "  // ---- shard: the model, the schedules used"
PIVOT_CHECK = r"""
#define SUBSTEP_NJ 1
#include "{source}"
// pivot_fast against the library's values it stands for, on every float
__global__ void pivot_check(unsigned long long* bad, unsigned* first) {{
  const unsigned long long step = (unsigned long long)gridDim.x * blockDim.x;
  for (unsigned long long i = blockIdx.x * (unsigned long long)blockDim.x +
                              threadIdx.x;
       i < (1ull << 32); i += step) {{
    const float a = __uint_as_float((unsigned)i);
    const float wd = sqrtf(max_c(a, 1e-12f)), wi = 1.0f / wd;
    float d, inv;
    pivot_fast(a, d, inv);
    const bool same_d = __float_as_uint(d) == __float_as_uint(wd) ||
                        (d != d && wd != wd);
    const bool same_i = __float_as_uint(inv) == __float_as_uint(wi) ||
                        (inv != inv && wi != wi);
    if (!same_d || !same_i) {{
      atomicAdd(bad, 1ull);
      atomicMin(first, (unsigned)i);
    }}
  }}
}}
extern "C" int pivot_check_run(unsigned long long* bad, unsigned* first) {{
  pivot_check<<<1056, 256>>>(bad, first);
  return (int)cudaDeviceSynchronize();
}}
"""


def pivot_check():
    """pivot_fast of the source against sqrtf(max(a, 1e-12)) and 1.0f / d
    on all 2^32 floats: (mismatches, the first one's bits). NaN matches
    NaN."""
    src, lib = OUT / "pivot_check.cu", OUT / "pivot_check.so"
    src.write_text(PIVOT_CHECK.format(source=_build.CSRC / sk.SOURCE))
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                    str(src)], capture_output=True, text=True, check=True)
    fn = ctypes.CDLL(str(lib)).pivot_check_run
    fn.argtypes = [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    bad = torch.zeros(1, dtype=torch.int64, device="cuda")
    first = torch.full((1,), -1, dtype=torch.int32, device="cuda")
    err = fn(bad.data_ptr(), first.data_ptr())
    if err:
        raise RuntimeError(f"pivot_check failed: CUDA error {err}")
    return int(bad.item()), int(first.item()) & 0xffffffff


def shard_variants():
    src = (_build.CSRC / sk.SOURCE).read_text()

    def replace(text, a, b):
        if a not in text:
            raise RuntimeError(f"anchor not in the source: {a!r}")
        return text.replace(a, b)

    def cut(text, anchor):
        return replace(text, anchor, "  if (B > 0) return;\n" + anchor)

    out = {"shard32": src,
           "shard16": replace(src, SHARD_TEAM,
                              SHARD_TEAM.replace("32", "16")),
           "shard32_e2": replace(src, SHARD_THREADS,
                                 SHARD_THREADS.replace("128", "64")),
           "shard32_e8": replace(src, SHARD_THREADS,
                                 SHARD_THREADS.replace("128", "256"))}
    for name, anchor in SHARD_CUTS.items():
        out[f"shard32_{name}"] = cut(src, anchor)
    # the forward substitution after the factor instead of beside it
    after = replace(replace(src, SHARD_FORWARD[0], ""), SHARD_FORWARD[1], "")
    start = after.index(SHARD_BACKWARD_START)
    end = after.index(SHARD_BACKWARD_END)
    out["shard32_subst0"] = after[:start] + LANE0_SUBST + after[end:]
    out["shard32_colfwd"] = after[:start] + COLUMN_FORWARD + "\n  }\n" + \
        after[end:]
    out["shard32_global"] = replace(
        replace(src, SHARD_TOPO_COPY, ""), SHARD_TOPO_SMEM,
        SHARD_TOPO_SMEM.replace("(smem)", "(topo_g)"))
    out["shard32_libpivot"] = replace(
        src, SHARD_PIVOT, "      d = sqrtf(max_c(acc, 1e-12f));\n"
        "      inv = 1.0f / d;")
    out["shard32_unroll1"] = replace(src, SHARD_WALK,
                                     SHARD_WALK.replace("2", "1", 1))
    out["shard32_empty"] = cut(src, SHARD_START)
    out["team8"] = src
    for name, anchor in CUTS.items():
        out[f"team8_{name}"] = cut(src, anchor)
    for name in ("shard32", "shard16", "shard32_load", "shard32_fk",
                 "shard32_cols", "shard32_mass", "team8", "team8_fk",
                 "team8_mass"):
        out[f"nj4_{name}"] = out[name]
    return out


def sass_of(path, kernel):
    """{instance (``<kernel>ILi<nj>E``): SASS lines without addresses and
    encodings} of ``kernel`` in a cubin (the names' internal prefix carries
    a hash of the file, so it is dropped)."""
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(path)],
                          capture_output=True, text=True, check=True).stdout
    out = {}
    for part in text.split("Function : ")[1:]:
        m = re.search(rf"\d({kernel}ILi\d+E)", part.splitlines()[0])
        if m:
            lines = (re.sub(r"/\*[^*]*\*/", "", line).strip()
                     for line in part.splitlines()[1:])
            out[m.group(1)] = [line for line in lines if line]
    return out


def sass_check(baseline):
    """``substep_kernel`` and ``substep_shard_kernel`` at every joint count
    from ``baseline`` and from the source (one ``nvcc -cubin`` each, all at
    once): {kernel: {nj: same SASS}}."""
    texts = {"baseline": Path(baseline).read_text(),
             "base": (_build.CSRC / sk.SOURCE).read_text()}
    for name, text in texts.items():
        (OUT / f"sass_{name}.cu").write_text(text)
    flags = [f for f in _build.NVCC_FLAGS
             if f not in ("-shared", "-Xcompiler", "-fPIC")]

    def cubin(job):
        name, nj = job
        path = OUT / f"sass_{name}_nj{nj}.cubin"
        subprocess.run([_build._nvcc(), *flags, "-cubin",
                        f"-DSUBSTEP_NJ={nj}", "-o", str(path),
                        str(OUT / f"sass_{name}.cu")], check=True,
                       capture_output=True)
        return job, {k: sass_of(path, k) for k in ("substep_kernel",
                                                   "substep_shard_kernel")}

    jobs = [(name, nj) for nj in range(1, sk.MAX_NJ + 1) for name in texts]
    with concurrent.futures.ThreadPoolExecutor() as pool:
        got = dict(pool.map(cubin, jobs))
    return {k: {nj: bool(got["base", nj][k])
                and got["base", nj][k] == got["baseline", nj][k]
                for nj in range(1, sk.MAX_NJ + 1)}
            for k in ("substep_kernel", "substep_shard_kernel")}


class ShardCase:
    """A robot's single-step inputs at batch B and the raw launches of K3
    and of the shard kernel of a library on them."""

    def __init__(self, robot, B, dev):
        rc = cs.robot_cases()
        inp = rc.substep_inputs(robot, B, seed=7, dr=True)
        self.sim = rc.torch_sim(robot, dev, inp)
        self.st, self.tau = rc.torch_state(inp, dev)
        self.B, self.dev = B, dev
        m = self.sim.model
        self.nj, self.nv, self.nc = m.nj, m.nv, len(m.contact_body)
        self.params = torch.as_tensor(sk.pack_model(self.sim), device=dev)
        self.stream = torch.cuda.current_stream(dev).cuda_stream

    def call(self, lib, shard):
        """(launch function, its outputs) of K3 or the shard kernel."""
        nj = self.nj
        outs = [torch.empty((self.B, n), device=self.dev)
                for n in (3, 4, nj, self.nv)]
        args, views = sk.substep_args(self.sim, self.st, self.tau, outs)
        if shard:
            lib.substep_shard_team.restype = ctypes.c_int
            topo, ncol, nsteps = sk.pack_shard_topology(
                self.sim.model, lib.substep_shard_team(nj))
            fn, extra = lib.substep_shard, (ncol, nsteps)
        else:
            lib.substep_team.restype = ctypes.c_int
            topo = sk.pack_topology(self.sim.model, lib.substep_team(nj))
            fn, extra = lib.substep, ()
        topo = torch.as_tensor(topo, device=self.dev)
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * (
            3 + len(extra)) + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        raw = (self.params.data_ptr(), topo.data_ptr(),
               ctypes.addressof(args), nj, self.nc, self.B, *extra,
               self.stream)

        def launch(keep=(args, views, topo)):
            if fn(*raw):
                raise RuntimeError("launch failed")
        return launch, outs


def dev_time(call):
    ms, *q = cs.device_ms(call)
    return ms if ms is not None else cs.time_ms(call, 50, warmup=3)


def shard_main(opts, only, card):
    rec = {"card": card}
    bad, first = pivot_check()
    rec["pivot_check"] = dict(mismatches=bad, first=first)
    print(f"pivot_fast against sqrtf / division on all 2^32 floats: {bad} "
          f"mismatches" + (f" (first 0x{first:08x})" if bad else ""),
          flush=True)
    if opts.baseline is not None:
        same = sass_check(opts.baseline)
        rec["same_sass"] = same
        print("SASS of substep_kernel<nj>, source against baseline: "
              + json.dumps(same), flush=True)
    todo = {k: v for k, v in shard_variants().items()
            if not only or any(k.startswith(x) for x in only)}
    with concurrent.futures.ThreadPoolExecutor() as pool:
        libs = dict(pool.map(build, todo.items()))
    dev = torch.device("cuda")
    B = 1024
    for robot, prefix in (("quadruped", ""), ("hopper4", "nj4_")):
        case = ShardCase(robot, B, dev)
        base = libs.get(prefix + "shard32", libs.get("shard32"))
        if base is None:
            continue
        k3_call, k3_out = case.call(base[0], shard=False)
        k3_call()
        res = rec.setdefault(robot, {})
        for name, (lib, regs) in libs.items():
            if name.startswith("nj4_") != (prefix == "nj4_"):
                continue
            shard = "shard" in name
            call, outs = case.call(lib, shard)
            call()
            torch.cuda.synchronize()
            whole = not any(name.endswith(f"_{c}")
                            for c in (*SHARD_CUTS, *CUTS, "empty"))
            same = all(torch.equal(a, b) for a, b in zip(outs, k3_out))
            if whole and not same:
                raise RuntimeError(f"{name}: outputs differ from K3's")
            res[name] = dict(ms=dev_time(call), ptxas=regs,
                             equal_to_k3=same if whole else None)
            print(f"{robot:9s} B={B} {name:20s} {res[name]['ms']:.4f} ms "
                  + json.dumps({k: regs.get(k) for k in
                                ("registers", "spill_stores")}), flush=True)
        # what each phase costs: the difference between two cuts
        for kernel, cuts in (("shard32", ("load", "fk", "cols", "mass",
                                          "chol")),
                             ("team8", ("load", "fk", "mass", "chol"))):
            names = [f"{prefix}{kernel}_{c}" for c in cuts] + [
                prefix + kernel]
            have = [n for n in names if n in res]
            steps, last = {}, 0.0
            for n in have:
                steps[n.removeprefix(prefix)] = res[n]["ms"] - last
                last = res[n]["ms"]
            res[f"{kernel}_phases"] = steps
            print(f"{robot:9s} {kernel} phases (ms): " + ", ".join(
                f"{k} {v:.4f}" for k, v in steps.items()), flush=True)
        # K3 and the shard kernel of the source in turns, and by batch
        for Bt in (1024, 4096):
            c = ShardCase(robot, Bt, dev)
            k3, _ = c.call(base[0], shard=False)
            sh, _ = c.call(base[0], shard=True)
            turns = [[n, dev_time(f)] for n, f in (("K3", k3), ("shard", sh),
                                                  ("shard", sh), ("K3", k3))]
            res[f"turns_B{Bt}"] = turns
            print(f"{robot:9s} B={Bt} in turns: " + ", ".join(
                f"{n} {ms:.4f}" for n, ms in turns), flush=True)
        for name in ("shard32_subst0",):
            if prefix or name not in libs:
                continue
            for Bt in (2048, 4096):
                c = ShardCase(robot, Bt, dev)
                res[name][f"ms_B{Bt}"] = dev_time(
                    c.call(libs[name][0], shard=True)[0])
            print(f"{robot:9s} {name} at B=2048 / 4096: "
                  f"{res[name]['ms_B2048']:.4f} / "
                  f"{res[name]['ms_B4096']:.4f} ms", flush=True)
        sweep = {}
        for Bs in (256, 512, 2048, 8192):
            c = ShardCase(robot, Bs, dev)
            sweep[Bs] = {n: dev_time(c.call(base[0], shard=n == "shard")[0])
                         for n in ("K3", "shard")}
        res["by_batch"] = sweep
        print(f"{robot:9s} by batch (K3 / shard ms): " + ", ".join(
            f"B={b} {v['K3']:.4f} / {v['shard']:.4f}"
            for b, v in sweep.items()), flush=True)
    print(json.dumps({"card": card, "B": B, "shard": rec}))
    return 0


# --nj10: K3 at nj=10, the team kernel's phase cuts
def nj10_variants():
    src = (_build.CSRC / sk.SOURCE).read_text()
    out = {"nj10": src}
    for name, anchor in CUTS.items():
        if anchor not in src:
            raise RuntimeError(f"anchor not in the source: {anchor!r}")
        out[f"nj10_{name}"] = src.replace(anchor,
                                          "  if (B > 0) return;\n" + anchor)
    return out


def shard_shape(lib, nj, ncol, nsteps):
    """The shard kernel's launch shape from a library's
    ``substep_shard_shape``."""
    fn = lib.substep_shard_shape
    ref = ctypes.POINTER(ctypes.c_int)
    fn.argtypes = [ctypes.c_int] * 3 + [ref] * 7
    fn.restype = ctypes.c_int
    out = [ctypes.c_int(0) for _ in range(7)]
    if fn(nj, ncol, nsteps, *(ctypes.byref(x) for x in out)):
        raise RuntimeError("substep_shard_shape failed")
    return dict(zip(("team", "envs", "threads", "smem_bytes",
                     "blocks_per_sm", "registers", "local_bytes"),
                    (x.value for x in out)), columns=ncol, steps=nsteps)


def nj10_main(only, card):
    """K3 at nj=10: the library's two forms in turns, then the team
    kernel's phase cuts."""
    rec = {"card": card}
    todo = {k: v for k, v in nj10_variants().items()
            if k == "nj10" or not only or any(k.startswith(x) for x in only)}
    with concurrent.futures.ThreadPoolExecutor() as pool:
        libs = dict(pool.map(build, todo.items()))
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    robot, base = "biped10", libs["nj10"][0]
    base.substep_shard_team.restype = ctypes.c_int
    for Bt in (1024, 2048, 4096):
        c = ShardCase(robot, Bt, dev)
        calls = {f: c.call(base, f == "shard") for f in ("team", "shard")}
        for call, _ in calls.values():
            call()
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(calls["team"][1],
                                                     calls["shard"][1])):
            raise RuntimeError(f"B={Bt}: the shard kernel differs from K3")
        turns = [[f, dev_time(calls[f][0])]
                 for f in ("team", "shard", "shard", "team")]
        _, ncol, nsteps = sk.pack_shard_topology(c.sim.model,
                                                 base.substep_shard_team(10))
        shape = shard_shape(base, 10, ncol, nsteps)
        shape["waves"] = -(-Bt // shape["envs"]) / (shape["blocks_per_sm"]
                                                     * sms)
        rec[f"B{Bt}"] = dict(turns=turns, shard_shape=shape)
        print(f"biped10 B={Bt} in turns: " + ", ".join(
            f"{n} {ms:.4f}" for n, ms in turns) + "; shard shape "
            + json.dumps(shape), flush=True)
    c = ShardCase(robot, 4096, dev)
    team_call, team_out = c.call(base, False)
    team_call()
    res = rec.setdefault("variants", {})
    for name, (lib, regs) in libs.items():
        call, outs = c.call(lib, False)
        call()
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(outs, team_out))
        if name == "nj10" and not same:
            raise RuntimeError(f"{name}: outputs differ from K3's")
        res[name] = dict(ms=dev_time(call), ptxas=regs,
                         equal_to_k3=same if name == "nj10" else None)
        print(f"biped10 B=4096 {name:12s} {res[name]['ms']:.4f} ms "
              + json.dumps({k: regs.get(k) for k in
                            ("registers", "spill_stores", "smem_bytes")}),
              flush=True)
    # what each phase costs: the difference between two cuts
    steps, last = {}, 0.0
    for n in [f"nj10_{k}" for k in CUTS] + ["nj10"]:
        if n in res:
            steps[n] = res[n]["ms"] - last
            last = res[n]["ms"]
    rec["nj10_phases"] = steps
    print("biped10 nj10 phases (ms): " + ", ".join(
        f"{k} {v:.4f}" for k, v in steps.items()), flush=True)
    print(json.dumps({"card": card, "nj10": rec}))
    return 0


RACE_ROBOTS = {4: "hopper4", 12: "quadruped"}


def launch_once(path, nj):
    """One K3 launch of the library at ``path`` (built for nj joints) at
    B=64 on that joint count's test robot, synchronised (the process
    compute-sanitizer watches)."""
    lib = ctypes.CDLL(str(path))
    c = ShardCase(RACE_ROBOTS[nj], 64, torch.device("cuda"))
    call, outs = c.call(lib, False)
    call()
    torch.cuda.synchronize()
    print("launched", path, nj, bool(torch.isfinite(outs[3]).all()))
    return 0


def racecheck(baseline, card):
    """compute-sanitizer's racecheck and synccheck on one K3 launch at nj=4
    and 12, the baseline's source and the source: each tool's summary."""
    texts = {"baseline": Path(baseline).read_text(),
             "base": (_build.CSRC / sk.SOURCE).read_text()}
    jobs = [(f"race_{name}_nj{nj}", text, nj)
            for name, text in texts.items() for nj in RACE_ROBOTS]

    def compile_(job):
        name, text, nj = job
        src, lib = OUT / f"{name}.cu", OUT / f"{name}.so"
        src.write_text(text)
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS,
                        f"-DSUBSTEP_NJ={nj}", "-o", str(lib), str(src)],
                       check=True, capture_output=True)
        return lib

    with concurrent.futures.ThreadPoolExecutor() as pool:
        built = list(pool.map(compile_, jobs))
    sanitizer = Path(_build._nvcc()).with_name("compute-sanitizer")
    rec = {"card": card}
    for (name, _, nj), lib in zip(jobs, built):
        for tool in ("racecheck", "synccheck"):
            cmd = [str(sanitizer), "--tool", tool, sys.executable,
                   str(Path(__file__).resolve()), "--launch-once", str(lib),
                   "--nj", str(nj)]
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True,
                                      timeout=150)
                text, rc = proc.stdout + proc.stderr, proc.returncode
            except (OSError, subprocess.TimeoutExpired) as err:
                text, rc = repr(err), None
            log = OUT / f"{name}_{tool}.log"
            log.write_text(text)
            summary = [line for line in text.splitlines()
                       if "SUMMARY" in line or "hazard" in line.lower()
                       or "launched" in line or "rror" in line][-6:]
            rec[f"{name}_{tool}"] = dict(rc=rc, summary=summary)
            print(f"{name} {tool}: rc {rc}; " + " | ".join(summary),
                  flush=True)
    print(json.dumps({"racecheck": rec}))
    return 0


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
    ap.add_argument("--baseline", default=None)
    ap.add_argument("--shard", action="store_true")
    ap.add_argument("--nj10", action="store_true")
    ap.add_argument("--racecheck", action="store_true")
    ap.add_argument("--launch-once", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--nj", type=int, default=12, help=argparse.SUPPRESS)
    opts = ap.parse_args()
    only = [x for x in opts.only.split(",") if x]
    if not torch.cuda.is_available():
        print("torch_substep_variants: no CUDA device", file=sys.stderr)
        return 2
    if opts.launch_once:
        return launch_once(opts.launch_once, opts.nj)
    OUT.mkdir(parents=True, exist_ok=True)
    if opts.shard or opts.nj10 or opts.racecheck:
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True).stdout.strip()
        print(card, flush=True)
        if opts.racecheck:
            if opts.baseline is None:
                ap.error("--racecheck needs --baseline FILE")
            return racecheck(opts.baseline, card)
        if opts.nj10:
            return nj10_main(only, card)
        return shard_main(opts, only, card)
    if opts.baseline is not None:
        same = sass_check(opts.baseline)
        print("SASS, source against baseline: " + json.dumps(same),
              flush=True)
    todo = {k: v for k, v in variants(opts.one_thread, opts.baseline).items()
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
        calls = {}
        for name, (lib, regs) in libs.items():
            if (robot == "hopper4") != (name.startswith("nj4_")
                                        or name.startswith("one_thread")):
                continue
            fn = lib.substep
            if name.startswith("one_thread"):
                fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
                    ctypes.c_void_p]

                def call(fn=fn):
                    fn(params.data_ptr(), xs.data_ptr(), dr.data_ptr(),
                       o.data_ptr(), nj, nc, B, 1, stream)
            else:
                fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
                    ctypes.c_void_p]
                lib.substep_team.restype = ctypes.c_int
                topo = torch.as_tensor(
                    sk.pack_topology(sim.model, lib.substep_team(nj)),
                    device=dev)

                def call(fn=fn, topo=topo):
                    fn(params.data_ptr(), topo.data_ptr(),
                       ctypes.addressof(args), nj, nc, B, stream)
            calls[name] = call
            call()
            torch.cuda.synchronize()
            ms = cs.time_ms(call, 50, warmup=3)
            rec.setdefault(robot, {})[name] = dict(
                ms=ms, device_ms=device_ms(call), ptxas=regs)
            print(f"{robot:9s} {name:16s} {ms:.4f} ms (device "
                  f"{rec[robot][name]['device_ms']:.4f}) "
                  + json.dumps({k: regs.get(k) for k in
                                ("registers", "spill_stores")}), flush=True)
        # the baseline and base in turns: baseline, base, base, baseline
        pair = (("nj4_baseline", "nj4_team8") if robot == "hopper4"
                else ("baseline", "team8"))
        if all(n in calls for n in pair):
            turns = [[n, cs.time_ms(calls[n], 50, warmup=3)]
                     for n in (pair[0], pair[1], pair[1], pair[0])]
            rec[robot]["turns"] = turns
            print(f"{robot:9s} in turns: " + ", ".join(
                f"{n} {ms:.4f}" for n, ms in turns), flush=True)
    print(json.dumps({"card": card, "B": B, "variants": rec}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
