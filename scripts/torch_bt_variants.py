#!/usr/bin/env python3
"""Where the block-tridiagonal kernels' time goes, on one CUDA card.

Builds variants of ``legged_gym_dev_tpu_torch/csrc/block_tridiag.cu``
(b=5 only, one ``nvcc`` each, all at once, into ``build/bt_variants/``),
each cut after one phase of a kernel or with one constant changed, and
times ``bt_solve`` at B=2048, ``bt_factor`` at B=1024 and ``bt_msolve`` at
B=1024, R=50 (S=51, the main path's shapes) with each: CUDA events over 50
launches, and the device time of 20 launches from ``torch.profiler``. A
phase's time is the difference between two cuts. Then ``bt_solve`` and
``bt_factor`` as they are at B = 256 to 8192. Inputs are
``chip_smoke.spd_systems``.

Variants:
  base               the source as it is
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
  baseline           with ``--baseline FILE``: another version of
                     ``block_tridiag.cu`` (for example ``git show
                     <commit>:legged_gym_dev_tpu_torch/csrc/block_tridiag.cu``),
                     of which only ``bt_solve`` is timed (its interface is
                     unchanged); the script also says whether its
                     ``bt_solve_kernel<5>`` compiles to the same SASS as base's

Usage: ``python3 scripts/torch_bt_variants.py [--baseline FILE]`` (needs
nvcc and a card).
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
from legged_gym_dev_tpu_torch.ops import block_tridiag_kernels as btk  # noqa: E402

S, b = 51, 5
OUT = ROOT / "build" / "bt_variants"


def only_b5(src):
    one = re.search(r"#define LGDT_FOR_EACH_B\(X\)[^\n]*", src)
    if one is None:
        raise RuntimeError("LGDT_FOR_EACH_B not found")
    return src.replace(one.group(0), "#define LGDT_FOR_EACH_B(X) X(5)")


def variants(baseline=None):
    base = only_b5((_build.CSRC / btk.SOURCE).read_text())

    def cut(src, anchor, code="  if (S > 0) return;\n"):
        if anchor not in src:
            raise RuntimeError(f"anchor not in the source: {anchor!r}")
        return src.replace(anchor, code + anchor)

    def replace(src, a, b_):
        if a not in src:
            raise RuntimeError(f"anchor not in the source: {a!r}")
        return src.replace(a, b_)

    def ahead(n):
        return base.replace("constexpr int kAhead = 4;",
                            f"constexpr int kAhead = {n};")

    def no_min_blocks():
        src = base.replace("__launch_bounds__(kMsolveThreads, 1)",
                           "__launch_bounds__(kMsolveThreads)")
        if src == base:
            raise RuntimeError("bt_msolve's __launch_bounds__ not found")
        return src

    def fast_recip():
        src = base
        for a, b_ in (
                ("  return fmaf(fmaf(-q, c, a), rp, q);", "  return q;"),
                ("__frcp_rn(sqrtf(acc[j] < 1e-12f ? 1e-12f : acc[j]));",
                 "rsqrtf(acc[j] < 1e-12f ? 1e-12f : acc[j]);"),
                ("    rp[j] = __frcp_rn(c[lo(j, j)]);", "    rp[j] = inv;")):
            if a not in src:
                raise RuntimeError(f"anchor not in the source: {a!r}")
            src = src.replace(a, b_)
        return src

    extra = {} if baseline is None else {
        "baseline": only_b5(Path(baseline).read_text())}
    return {
        **extra,
        "base": base,
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
        "ms_no_min_blocks": no_min_blocks(),
        "fast_recip": fast_recip(),
    }


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
        for kernel in ("bt_solve_kernel", "bt_factor_kernel",
                       "bt_msolve_kernel"):
            if kernel in mangled:
                regs[kernel] = info
    return name, (ctypes.CDLL(str(lib)), regs)


def solve_sass(name):
    """The SASS of bt_solve_kernel<5> in a variant's library, without
    addresses and encodings."""
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(OUT / f"{name}.so")],
                          capture_output=True, text=True, check=True).stdout
    for part in text.split("Function : ")[1:]:
        if "bt_solve_kernelILi5E" in part.splitlines()[0]:
            lines = (re.sub(r"/\*[^*]*\*/", "", line).strip()
                     for line in part.splitlines()[1:])
            return [line for line in lines if line]
    return None


def entries(D, L):
    return ([[D[:, :, i, j].contiguous() for j in range(b)]
             for i in range(b)],
            [[L[:, :, i, j].contiguous() for j in range(b)]
             for i in range(b)])


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", default=None)
    baseline = ap.parse_args().baseline
    if not torch.cuda.is_available():
        print("torch_bt_variants: no CUDA device", file=sys.stderr)
        return 2
    OUT.mkdir(parents=True, exist_ok=True)
    with concurrent.futures.ThreadPoolExecutor() as pool:
        libs = dict(pool.map(build, variants(baseline).items()))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card)
    dev = torch.device("cuda")
    D, L, rhs = cs.spd_systems(2048, S, b, 1, seed=1, dev=dev)
    Df, Lf = entries(D, L)
    args, _ = btk.prepare_solve_entries(
        Df, Lf, [rhs[:, :, i, 0].contiguous() for i in range(b)], b)
    D, L, rhs = cs.spd_systems(1024, S, b, 50, seed=2, dev=dev)
    Df, Lf = entries(D, L)
    fargs, frec, rargs, xo = btk.prepare_multirhs_entries(
        Df, Lf, [rhs[:, :, i, :].contiguous() for i in range(b)], b)
    btk._launch_factor(fargs, S, 1024, b, dev)
    stream = torch.cuda.current_stream().cuda_stream
    rec = {}
    for name, (lib, regs) in libs.items():
        solve, factor, msolve = lib.bt_solve, lib.bt_factor, lib.bt_msolve
        for fn in (solve, factor):
            fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 3 + [
                ctypes.c_void_p]
        msolve.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        calls = {
            "bt_solve": lambda: solve(ctypes.addressof(args), S, 2048, b,
                                      stream),
            "bt_factor": lambda: factor(ctypes.addressof(fargs), S, 1024, b,
                                        stream),
            "bt_msolve": lambda: msolve(frec.data_ptr(),
                                        ctypes.addressof(rargs),
                                        xo.data_ptr(), S, 1024, 50, b,
                                        stream)}
        if name == "baseline":
            calls = {"bt_solve": calls["bt_solve"]}
        rec[name] = {"ptxas": regs}
        for kernel, call in calls.items():
            ms = cs.time_ms(call, 50, warmup=3)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(20):
                    call()
                torch.cuda.synchronize()
            us = [e.time_range.elapsed_us() for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and f"{kernel}_kernel" in e.name]
            rec[name][kernel] = dict(ms=ms, device_ms=1e-3 * sum(us)
                                     / max(1, len(us)))
        print(f"{name:16s} " + "   ".join(
            f"{k} {rec[name][k]['ms']:.4f} ms (device "
            f"{rec[name][k]['device_ms']:.4f})" for k in calls) + "   "
            + json.dumps({k[:-7]: (v["registers"], v["spill_stores"])
                          for k, v in regs.items()}), flush=True)
    if baseline is not None:
        sass = solve_sass("baseline")
        same = sass is not None and sass == solve_sass("base")
        rec["baseline"]["same_bt_solve_sass"] = same
        print(f"bt_solve_kernel<5>: baseline and base SASS "
              f"{'identical' if same else 'differ'}", flush=True)
    sweep = {"bt_solve": {}, "bt_factor": {}}
    base = libs["base"][0]
    for B in (256, 1024, 2048, 4096, 8192):
        D, L, rhs = cs.spd_systems(B, S, b, 1, seed=B, dev=dev)
        Df, Lf = entries(D, L)
        r = [rhs[:, :, i, 0].contiguous() for i in range(b)]
        args_b, _ = btk.prepare_solve_entries(Df, Lf, r, b)
        fargs_b, frec_b, _, _ = btk.prepare_multirhs_entries(
            Df, Lf, [x[..., None] for x in r], b)
        for kernel, a in (("bt_solve", args_b), ("bt_factor", fargs_b)):
            fn = getattr(base, kernel)
            sweep[kernel][B] = cs.time_ms(
                lambda: fn(ctypes.addressof(a), S, B, b, stream), 50,
                warmup=3)
            print(f"base {kernel} B={B}: {sweep[kernel][B]:.4f} ms",
                  flush=True)
    print(json.dumps({"card": card, "variants": rec, "by_B": sweep}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
