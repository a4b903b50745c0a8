#!/usr/bin/env python3
"""Where the block-tridiagonal kernels' time goes, on one CUDA card.

Builds variants of ``legged_gym_dev_tpu_torch/csrc/block_tridiag.cu``
(one ``nvcc`` each, all at once, into ``build/bt_variants/``), each cut
after one phase of a kernel or with one constant changed, at one block
size (``--b``, 5 or 10), and times ``bt_solve`` at B=2048, ``bt_factor`` at
B=1024 and ``bt_msolve`` at B=1024, R=50 (S=51, the main path's shapes)
with each: CUDA events over 50 launches, and the device time of
20 launches queued behind a sleep kernel (``chip_smoke.device_ms``). A
phase's time is the difference between two cuts. Then ``bt_solve`` and
``bt_factor`` as they are at B = 256 to 8192. Inputs are
``chip_smoke.spd_systems``. Every variant's registers and spills per
kernel come from nvcc's ``-Xptxas -v`` report.

Variants at b=5 (the team kernels):
  solve_empty        bt_solve returns at once (launch cost)
  solve_load_only    bt_solve returns after copying its rows to shared memory
  solve_fwd_only     bt_solve returns after the forward sweep
  factor_empty       bt_factor returns at once (launch cost)
  factor_copy_only   bt_factor returns after copying its rows to shared memory
  factor_sweep_only  bt_factor's Schur sweep without its record stores (they
                     sit behind a guard that is false at run time)
  ms_empty           bt_msolve returns at once
  ms_fill_only       bt_msolve returns after filling its stage records
  ms_fwd_only        bt_msolve returns after the forward sweep
  ms_ahead1/2/8      bt_msolve with its loads 1, 2 or 8 stages ahead
  ms_no_min_blocks   bt_msolve's __launch_bounds__ without its minimum of one
                     block a multiprocessor (ptxas then picks fewer registers)
  fast_recip         both kernels multiply by an uncorrected reciprocal, and
                     bt_solve's factor takes rsqrtf (what rounding as the
                     plain version's division and square root costs)
Variants at b=10 (the streamed kernels, 16 lanes a scenario):
  loads_only         both kernels stream every stage through the ring but
                     skip each step's arithmetic (a guard false at run time)
  solve_fwd_only     bt_solve returns after the forward sweep (its scratch
                     records written, no backward sweep)
  chunk2, chunk8     a ring of 2 x 2 or 2 x 8 stage slots a team (loads 2 to
                     4 or 8 to 16 stages ahead) instead of 2 x 4
  buf3, buf4         a ring of 3 x 4 or 4 x 4 stage slots a team (loads 8 to
                     12 or 12 to 16 stages ahead)
  carve50/60/100     the streamed kernels launched with a preferred shared
                     memory carveout of 50, 60 or 100% of the SM's (the rest
                     is L1; the copies go through L1, where a 128-byte line
                     holds 32 stages of a row)
  teams4             four scenarios (two warps) a block instead of two
  ms_fwd_only        bt_msolve_kernel_wide returns after the forward sweep
  ms_loads_only      bt_msolve_kernel_wide streams its records and loads
                     and stores x but skips each stage's arithmetic (a
                     guard false at run time)
  ms_chunk2/8        its chunks of copies of 2 or 8 stages instead of 4
  ms_buf3            rings of 3 chunks (copies two chunks ahead) instead
                     of 2
  ms_blocks1/3       __launch_bounds__ asking for 1 or 3 blocks an SM
                     instead of 2 (255 or 85 registers a thread)
  ms_csm             the triangular solves reading the factor from the
                     ring slot instead of registers
  ms_csm_chunk2_blocks3  ms_csm with chunks of 2 stages and 3 blocks an SM
  ms_resident3/4     at most 3 or 4 scenarios a block and one block an SM
                     (no register cap): 396 or 528 scenarios in flight, so
                     their forward values may stay in L2 for the backward
                     sweep
  ms_teams1/3/4/8    at most 1, 3, 4 or 8 scenarios a block instead of 2
                     (8: 5 at R=50)
At b=10 the script first holds the source's ``pivot_inv`` against
``__frcp_rn(sqrtf(max(a, 1e-12)))`` bit for bit on all 2^32 floats (NaN
matching NaN) and stops on a mismatch.
and at both:
  base               the source as it is, every block size instantiated
  baseline           with ``--baseline FILE``: another version of
                     ``block_tridiag.cu`` (for example ``git show
                     <commit>:legged_gym_dev_tpu_torch/csrc/block_tridiag.cu``),
                     every block size instantiated. At b=5 only its
                     ``bt_solve`` is timed; at b=10 its ``bt_solve`` and
                     ``bt_factor`` at S=51 and S=201, in turns with base's
                     (baseline, base, base, baseline), and base's outputs
                     are held against its bit for bit; at b=10 also its
                     ``bt_msolve`` (``bt_msolve_kernel<10>``) at B=1024,
                     R=50, S=51, in turns with base's
                     (``bt_msolve_kernel_wide<10>``), outputs bit for bit
                     on the same records. The script says whether every
                     ``bt_solve_kernel``, ``bt_factor_kernel`` and
                     ``bt_msolve_kernel`` instance up to b=8 and the b=10
                     ``bt_solve_kernel_wide`` and ``bt_factor_kernel_wide``
                     compile to the same SASS in both.

Usage: ``python3 scripts/torch_bt_variants.py [--b 10] [--baseline FILE]``
(needs nvcc and a card). The interface of ``bt_solve``'s argument struct
only grew at its end, so a baseline from before the scratch field reads
the same struct.
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

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from legged_gym_dev_tpu_torch.ops import _build  # noqa: E402
from legged_gym_dev_tpu_torch.ops import block_tridiag_kernels as btk  # noqa: E402

S = 51
OUT = ROOT / "build" / "bt_variants"
SASS_KERNELS = ([f"{k}ILi{b}E" for k in ("bt_solve_kernel",
                                          "bt_factor_kernel",
                                          "bt_msolve_kernel")
                 for b in btk.SUPPORTED_B if b <= btk.TEAM]
                + [f"{k}ILi{b}E" for k in ("bt_solve_kernel_wide",
                                           "bt_factor_kernel_wide")
                   for b in btk.SUPPORTED_B if b > btk.TEAM])


def only_b(src, b):
    one = re.search(r"#define LGDT_FOR_EACH_B\(X\)[^\n]*", src)
    if one is None:
        raise RuntimeError("LGDT_FOR_EACH_B not found")
    return src.replace(one.group(0), f"#define LGDT_FOR_EACH_B(X) X({b})")


def replace(src, a, b_):
    if a not in src:
        raise RuntimeError(f"anchor not in the source: {a!r}")
    return src.replace(a, b_)


def cut(src, anchor, code="  if (S > 0) return;\n"):
    return replace(src, anchor, code + anchor)


def fast_recip(base):
    for a, b_ in (
            ("  return fmaf(fmaf(-q, c, a), rp, q);", "  return q;"),
            ("__frcp_rn(sqrtf(acc[j] < 1e-12f ? 1e-12f : acc[j]));",
             "rsqrtf(acc[j] < 1e-12f ? 1e-12f : acc[j]);"),
            ("    rp[j] = __frcp_rn(c[lo(j, j)]);", "    rp[j] = inv;")):
        base = replace(base, a, b_)
    return base


def variants_b5(src):
    base = only_b(src, 5)

    def ahead(n):
        return replace(base, "constexpr int kAhead = 4;",
                       f"constexpr int kAhead = {n};")

    return {
        "solve_empty": cut(base, "  load_rows<b>(a, NE, smem"),
        "solve_load_only": cut(base, "  // 2. the chain, per team"),
        "solve_fwd_only": cut(base, "  // x_k = y_k - S_k^{-1} L_k^T x_{k+1}"),
        "factor_empty": cut(base, "  load_rows<b>(a, NF, smem"),
        "factor_copy_only": cut(base, "  // 2. the Schur chain, per team"),
        "factor_sweep_only": replace(
            base, "  const bool writes = s0 + team < B;",
            "  const bool writes = s0 + team < B && S < 0;"),
        "ms_empty": cut(base, "  // 1. the block's scenarios' records"),
        "ms_fill_only": cut(base, "  // 2. one column per thread"),
        "ms_fwd_only": cut(base, "  // backward; y holds x_{k+1}"),
        "ms_ahead1": ahead(1),
        "ms_ahead2": ahead(2),
        "ms_ahead8": ahead(8),
        "ms_no_min_blocks": replace(base,
                                    "__launch_bounds__(kMsolveThreads, 1)",
                                    "__launch_bounds__(kMsolveThreads)"),
        "fast_recip": fast_recip(base),
    }


def carveout(src, pct):
    """The streamed kernels launched with a preferred shared memory
    carveout of pct percent of the SM's (the rest is L1)."""
    for kernel in ("bt_solve_kernel_wide<b>", "bt_factor_kernel_wide<b>"):
        src = replace(src, f"    {kernel}\n        <<<",
                      f"    cudaFuncSetAttribute({kernel}, "
                      f"cudaFuncAttributePreferredSharedMemoryCarveout, "
                      f"{pct});\n    {kernel}\n        <<<")
    return src


def ms_loads_only(base):
    """bt_msolve_kernel_wide without each stage's arithmetic: the L
    products and the two triangular solves behind a guard false at run
    time (the forward values still go through x)."""
    start = base.index("bt_msolve_kernel_wide(const float*")
    head, body = base[:start], base[start:]
    body = replace(body, "      if (k > 0) {  // L_{k-1} y_{k-1}",
                   "      if (k > 0 && S < 0) {  // L_{k-1} y_{k-1}")
    body = replace(body, "#pragma unroll\n      for (int q = 0; q < BBp / 4; ++q) {",
                   "#pragma unroll\n      for (int q = 0; q < (S < 0 ? BBp / 4 : 0); ++q) {")
    body = replace(body, "      cho_solve_rp<b>(c, rp, r);",
                   "      if (S < 0) cho_solve_rp<b>(c, rp, r);")
    return head + body


def ms_factor_in_smem(base):
    """bt_msolve_kernel_wide's triangular solves reading each stage's
    factor from its ring slot (shared memory) instead of a copy in
    registers: the same expressions on the same values."""
    return replace(base, """      float c[NLp], rp[Bp];
      lds4<NLp>(st, c);
      lds4<Bp>(st + NLp + BBp, rp);
      cho_solve_rp<b>(c, rp, r);""", """      float rp[Bp];
      lds4<Bp>(st + NLp + BBp, rp);
      cho_solve_rp<b>(*reinterpret_cast<const float(*)[NLp]>(st), rp, r);""")


def ms_resident(base, teams):
    """bt_msolve_kernel_wide with at most ``teams`` scenarios a block and
    one block an SM (its shared memory padded to 116 KB, no register cap):
    fewer scenarios in flight, so that the forward values they write to x
    may stay in the 50 MB L2 until the backward sweep reads them back."""
    text = replace(replace(base, "constexpr int kMsTeams = 2;",
                           f"constexpr int kMsTeams = {teams};"),
                   "constexpr int kMsBlocks = 2;",
                   "constexpr int kMsBlocks = 1;")
    line = ("    *bytes = ((size_t)*teams * (ring + (48 - ring % 32) % 32) "
            "+ values) * 4;\n")
    return replace(text, line,
                   line + "    if (*bytes < 116 * 1024) *bytes = 116 * 1024;\n")


def variants_b10(src):
    base = only_b(src, 10)
    return {
        "loads_only": replace(base, "    {  // step k's arithmetic",
                              "    if (S < 0) {  // step k's arithmetic"),
        "solve_fwd_only": cut(base, "  // 2. x_{S-1} = y_{S-1}"),
        "chunk2": replace(base, "constexpr int kChunk = 4;",
                          "constexpr int kChunk = 2;"),
        "chunk8": replace(base, "constexpr int kChunk = 4;",
                          "constexpr int kChunk = 8;"),
        "teams4": replace(base, "constexpr int kWideTeams = 2;",
                          "constexpr int kWideTeams = 4;"),
        "buf3": replace(base, "constexpr int kBuf = 2;",
                        "constexpr int kBuf = 3;"),
        "buf4": replace(base, "constexpr int kBuf = 2;",
                        "constexpr int kBuf = 4;"),
        **{f"carve{c}": carveout(base, c) for c in (50, 60, 100)},
        "fast_recip": fast_recip(base),
        "ms_fwd_only": cut(base, "  // 2. backward: x_k = y_k - S_k^{-1}"),
        "ms_loads_only": ms_loads_only(base),
        "ms_chunk2": replace(base, "constexpr int kMsChunk = 4;",
                             "constexpr int kMsChunk = 2;"),
        "ms_chunk8": replace(base, "constexpr int kMsChunk = 4;",
                             "constexpr int kMsChunk = 8;"),
        "ms_buf3": replace(base, "constexpr int kMsBuf = 2;",
                           "constexpr int kMsBuf = 3;"),
        **{f"ms_blocks{n}": replace(
            base, "constexpr int kMsBlocks = 2;",
            f"constexpr int kMsBlocks = {n};") for n in (1, 3)},
        "ms_csm": ms_factor_in_smem(base),
        "ms_csm_chunk2_blocks3": ms_factor_in_smem(replace(
            replace(base, "constexpr int kMsChunk = 4;",
                    "constexpr int kMsChunk = 2;"),
            "constexpr int kMsBlocks = 2;", "constexpr int kMsBlocks = 3;")),
        **{f"ms_resident{t}": ms_resident(base, t) for t in (3, 4)},
        **{f"ms_teams{t}": replace(base, "constexpr int kMsTeams = 2;",
                                   f"constexpr int kMsTeams = {t};")
           for t in (1, 3, 4, 8)},
    }


def variants(b, baseline=None):
    src = (_build.CSRC / btk.SOURCE).read_text()
    extra = {} if baseline is None else {
        "baseline": Path(baseline).read_text()}
    cuts = variants_b5(src) if b == 5 else variants_b10(src)
    return {**extra, "base": src, **cuts}


def build(item):
    name, text = item
    src, lib = OUT / f"{name}.cu", OUT / f"{name}.so"
    src.write_text(text)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                           str(src)], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"{name}: {proc.stderr}")
    regs = {}
    for mangled, info in cs.ptxas_summary(proc.stdout + proc.stderr).items():
        m = re.search(r"\d(bt_[a-z_]+?_kernel(?:_wide)?)ILi(\d+)E", mangled)
        if m:
            regs[f"{m.group(1)}<{m.group(2)}>"] = info
    return name, (ctypes.CDLL(str(lib)), regs)


def sass(name):
    """{kernel instance: its SASS without addresses and encodings} of a
    variant's library, for the instances in SASS_KERNELS."""
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(OUT / f"{name}.so")],
                          capture_output=True, text=True, check=True).stdout
    out = {}
    for part in text.split("Function : ")[1:]:
        head = part.splitlines()[0]
        for key in SASS_KERNELS:
            if key in head:
                lines = (re.sub(r"/\*[^*]*\*/", "", line).strip()
                         for line in part.splitlines()[1:])
                out[key] = [line for line in lines if line]
    return out


def sass_lines(name):
    """Instructions of each b=10 kernel in a variant's library."""
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(OUT / f"{name}.so")],
                          capture_output=True, text=True, check=True).stdout
    out = {}
    for part in text.split("Function : ")[1:]:
        m = re.search(r"\d(bt_[a-z_]+?_kernel(?:_wide)?)ILi10E",
                      part.splitlines()[0])
        if m:
            out[m.group(1)] = sum(1 for line in part.splitlines()
                                  if re.match(r"\s+/\*[0-9a-f]{4,}\*/", line))
    return out


PIVOT_CHECK = r"""
#include "{source}"
// pivot_inv against the library functions it stands for, on every float
__global__ void pivot_check(unsigned long long* bad, unsigned* first) {{
  const unsigned long long step = (unsigned long long)gridDim.x * blockDim.x;
  for (unsigned long long i = blockIdx.x * (unsigned long long)blockDim.x +
                              threadIdx.x;
       i < (1ull << 32); i += step) {{
    const float a = __uint_as_float((unsigned)i);
    const float want = __frcp_rn(sqrtf(a < 1e-12f ? 1e-12f : a));
    const float got = pivot_inv(a);
    if (__float_as_uint(got) != __float_as_uint(want) &&
        !(got != got && want != want)) {{
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
    """Runs pivot_inv of the source against __frcp_rn(sqrtf(max(a, 1e-12)))
    on all 2^32 floats: (mismatches, the first one's bits). NaN matches
    NaN."""
    src, lib = OUT / "pivot_check.cu", OUT / "pivot_check.so"
    src.write_text(PIVOT_CHECK.format(source=_build.CSRC / btk.SOURCE))
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


def entries(D, L):
    b = D.shape[-1]
    return ([[D[:, :, i, j].contiguous() for j in range(b)]
             for i in range(b)],
            [[L[:, :, i, j].contiguous() for j in range(b)]
             for i in range(b)])


def bind(lib):
    for fn in (lib.bt_solve, lib.bt_factor):
        fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.bt_msolve.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    lib.bt_msolve.restype = ctypes.c_int
    return lib


class Problem:
    """bt_solve's (B) and bt_factor + bt_msolve's (Bf, R) launch arguments
    at block size b and S stages, with the plain versions' outputs."""

    def __init__(self, b, S_, B, Bf, R, dev):
        self.b, self.S, self.B, self.Bf, self.R = b, S_, B, Bf, R
        D, L, rhs = cs.spd_systems(B, S_, b, 1, seed=B + b, dev=dev)
        Df, Lf = entries(D, L)
        r = [rhs[:, :, i, 0].contiguous() for i in range(b)]
        self.args, self.x = btk.prepare_solve_entries(Df, Lf, r, b)
        self.x_plain = torch.stack(
            btk.block_tridiag_solve_entries_plain(Df, Lf, r, b))
        solve_inputs = (Df, Lf, r)
        D, L, rhs = cs.spd_systems(Bf, S_, b, R, seed=Bf + b + 1, dev=dev)
        Df, Lf = entries(D, L)
        cols = [rhs[:, :, i, :].contiguous() for i in range(b)]
        self.fargs, self.rec, self.rargs, self.xo = \
            btk.prepare_multirhs_entries(Df, Lf, cols, b)
        self.rec_plain = btk.factor_records_plain(Df, Lf, b, Bf, S_)
        self.xo_plain = torch.stack(
            btk.block_tridiag_multirhs_entries_plain(Df, Lf, cols, b))
        # the tables hold raw pointers: the inputs live as long as they do
        self.inputs = (solve_inputs, (Df, Lf, cols))

    def calls(self, lib, stream):
        b, S_ = self.b, self.S
        return {
            "bt_solve": lambda: lib.bt_solve(ctypes.addressof(self.args), S_,
                                             self.B, b, stream),
            "bt_factor": lambda: lib.bt_factor(ctypes.addressof(self.fargs),
                                               S_, self.Bf, b, stream),
            "bt_msolve": lambda: lib.bt_msolve(
                self.rec.data_ptr(), ctypes.addressof(self.rargs),
                self.xo.data_ptr(), S_, self.Bf, self.R, b, stream)}

    def outputs(self, lib, stream):
        """(x, records, multi-RHS x) of one bt_solve, one bt_factor and one
        bt_msolve launch of lib."""
        calls = self.calls(lib, stream)
        for k in ("bt_solve", "bt_factor", "bt_msolve"):
            err = calls[k]()
            if err:
                raise RuntimeError(f"{k} failed: CUDA error {err}")
        torch.cuda.synchronize()
        return self.x.clone(), self.rec.clone(), self.xo.clone()


def timed(call):
    ms = cs.time_ms(call, 50, warmup=3)
    dev_ms, *_ = cs.device_ms(call)
    return dict(ms=ms, device_ms=dev_ms)


def fmt(r):
    d = "not measured" if r["device_ms"] is None else f"{r['device_ms']:.4f}"
    return f"{r['ms']:.4f} ms (device {d})"


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--b", type=int, default=5, choices=(5, 10))
    ap.add_argument("--baseline", default=None)
    opts = ap.parse_args()
    b, baseline = opts.b, opts.baseline
    if not torch.cuda.is_available():
        print("torch_bt_variants: no CUDA device", file=sys.stderr)
        return 2
    OUT.mkdir(parents=True, exist_ok=True)
    with concurrent.futures.ThreadPoolExecutor() as pool:
        libs = dict(pool.map(build, variants(b, baseline).items()))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card)
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    for name, (lib, regs) in libs.items():
        bind(lib)
        print(f"[ptxas] {name}: " + json.dumps(
            {k: (v["registers"], v["spill_stores"]) for k, v in regs.items()
             if f"<{b}>" in k}), flush=True)
    rec = {name: {"ptxas": regs} for name, (_, regs) in libs.items()}
    if b == 10:
        for name in libs:
            rec[name]["sass_lines"] = sass_lines(name)
            print(f"[sass] {name}: {json.dumps(rec[name]['sass_lines'])}",
                  flush=True)
    if b == 10:
        bad, first = pivot_check()
        rec["pivot_check"] = dict(mismatches=bad, first=first)
        print(f"pivot_inv against __frcp_rn(sqrtf(max(a, 1e-12))) on all "
              f"2^32 floats: {bad} mismatches"
              + (f" (first {first:#010x})" if bad else ""), flush=True)
        if bad:
            raise RuntimeError("pivot_inv is not the library's rounding")
    prob = Problem(b, S, 2048, 1024, 50, dev)
    base = libs["base"][0]
    err = rel_errs(prob, prob.outputs(base, stream))
    print(f"base against the plain versions at S={S}: rel err "
          f"{json.dumps(err)}", flush=True)
    if not max(err.values()) <= 1e-4:
        raise RuntimeError(f"base disagrees with the plain versions: {err}")
    rec["base"]["rel_err"] = err

    for name, (lib, _) in libs.items():
        if name != "baseline":
            rec[name]["rel_err"] = rel_errs(prob,
                                            prob.outputs(lib, stream))
        calls = prob.calls(lib, stream)
        if name == "baseline" and b == 5:
            calls = {"bt_solve": calls["bt_solve"]}
        for kernel, call in calls.items():
            rec[name][kernel] = timed(call)
        print(f"{name:16s} " + "   ".join(
            f"{k} {fmt(rec[name][k])}" for k in calls)
            + ("" if name == "baseline" else "   rel err " + " / ".join(
                f"{v:.1e}" for v in rec[name]["rel_err"].values())),
            flush=True)

    if baseline is not None:
        got, ref = sass("base"), sass("baseline")
        same = {k: k in got and got[k] == ref.get(k) for k in SASS_KERNELS}
        rec["baseline"]["same_sass"] = same
        print("SASS, base against baseline: " + json.dumps(same), flush=True)
        if b == 10:
            rec["in_turns"] = in_turns(libs, dev, stream)

    sweep = {"bt_solve": {}, "bt_factor": {}}
    for B in (256, 1024, 2048, 4096, 8192):
        p = Problem(b, S, B, B, 1, dev)
        calls = p.calls(base, stream)
        for kernel in sweep:
            sweep[kernel][B] = cs.time_ms(calls[kernel], 50, warmup=3)
            print(f"base {kernel} B={B}: {sweep[kernel][B]:.4f} ms",
                  flush=True)
    print(json.dumps({"card": card, "b": b, "variants": rec, "by_B": sweep}))
    return 0


def rel_errs(prob, outs):
    """Each kernel's max relative error against its plain version."""
    return {k: float((got - ref).abs().max() / ref.abs().max())
            for k, got, ref in zip(("bt_solve", "bt_factor", "bt_msolve"),
                                   outs, (prob.x_plain, prob.rec_plain,
                                          prob.xo_plain))}


def in_turns(libs, dev, stream):
    """b=10: baseline and base at S=51 (bt_msolve at R=50) and S=201
    (R=7), timed in turns (baseline, base, base, baseline), base's outputs
    against baseline's bit for bit (bt_msolve on the same records)."""
    out = {}
    for S_, R in ((S, 50), (201, 7)):
        prob = Problem(10, S_, 2048, 1024, R, dev)
        got = prob.outputs(libs["base"][0], stream)
        ref = prob.outputs(libs["baseline"][0], stream)
        same = [bool(torch.equal(g, r)) for g, r in zip(got[:2], ref[:2])]
        # both bt_msolve kernels on the same records (baseline's factor's)
        xs = []
        for name in ("base", "baseline"):
            if prob.calls(libs[name][0], stream)["bt_msolve"]():
                raise RuntimeError(f"{name} bt_msolve failed")
            torch.cuda.synchronize()
            xs.append(prob.xo.clone())
        same.append(bool(torch.equal(xs[0], xs[1])))
        err = rel_errs(prob, got)
        runs = []
        for name in ("baseline", "base", "base", "baseline"):
            calls = prob.calls(libs[name][0], stream)
            runs.append((name, {k: timed(calls[k]) for k in calls}))
        out[S_] = dict(same_x=same[0], same_records=same[1],
                       same_msolve=same[2], rel_err=err, runs=runs)
        print(f"in turns at S={S_} (bt_solve B=2048, bt_factor and "
              f"bt_msolve B=1024, R={R}): "
              + "; ".join(f"{n} solve {fmt(t['bt_solve'])}, factor "
                          f"{fmt(t['bt_factor'])}, msolve "
                          f"{fmt(t['bt_msolve'])}" for n, t in runs)
              + f"; base equals baseline bit for bit: x {same[0]}, records "
              f"{same[1]}, msolve {same[2]}; base rel err "
              f"{json.dumps(err)}", flush=True)
    return out


if __name__ == "__main__":
    sys.exit(main())
