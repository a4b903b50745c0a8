"""Component-level timing of the structured tube solve's inner step, on the
PyTorch/CUDA port.

The counterpart of ``scripts/profile_solver.py`` on
``legged_gym_dev_tpu_torch``. Times, at bench shapes (B=1024, N=50,
SingleInt2D ``gap`` problem, z0 moved by ``default_rng(0)``):
  - the full solve (reference point): ``solve_tube_fast_batched``, l1, the
    20x10 schedule, on the kernel route (``linsolve="pallas"``: the CUDA
    kernel ``bt_solve`` on the card, the port's main path; the JAX file's
    ``ALConfig()`` takes the block-Thomas scan);
  - ``fast_tube._assemble`` (array form: grad, D, L), once an inner step;
  - the plain factor + solve of ``solver/block_tridiag.py``, likewise;
  - ``fast_tube._merit`` (its sequential evaluation), likewise;
  - the rest of the full solve that these three leave unaccounted.
Each repeated piece runs outer x inner = 200 times in a Python loop that
carries the JAX file's dependence (``c + 1e-12 * g``).

Run on the card:  python scripts/torch_profile_solver.py
On the CPU:       python scripts/torch_profile_solver.py --cpu  (or E2E_CPU=1)
``--reps`` cuts the timed reps (3, the least taken). ``main`` prints the
JAX file's lines and returns their numbers as a dict.
"""
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_tool_common import (  # noqa: E402
    H_REV,
    N,
    best_of,
    gap_params,
    parse,
    print_launches,
    reset_launches,
)

from legged_gym_dev_tpu_torch.solver import ALConfig  # noqa: E402

CFG = ALConfig(linsolve="pallas")
REPS = 3


def profile_solver(B: int = 1024, N: int = N, H_rev: int = H_REV,
                   cfg: ALConfig = CFG, reps: int = REPS, device=None):
    """The timings (ms) of the full solve and its pieces at batch B;
    ``cfg`` fixes the schedule, hence the inner-step count."""
    from legged_gym_dev_tpu_torch.solver import fast_tube as ft
    from legged_gym_dev_tpu_torch.solver.block_tridiag import (
        block_tridiag_factor,
        block_tridiag_solve,
    )
    from legged_gym_dev_tpu_torch.solver.trajopt import get_warm_start
    from legged_gym_dev_tpu_torch.utils.runtime import (
        fp32_matmul,
        resolve_device,
    )

    dev = resolve_device(device)
    p = gap_params(B, 0, ("z0",), dev, N=N, H_rev=H_rev)
    n, m = p.rom.n, p.rom.m
    S = N + 1
    sp = ft.StagedProblem(n=n, m=m, N=N, K=p.obs_r.shape[-1],
                          tube_kind="l1", scaling=0.5, track_ref=False)
    n_inner = cfg.outer_iters * cfg.inner_iters

    with fp32_matmul():
        # representative iterates: the interpolated warm start
        z0s, v0s = get_warm_start("interpolate", p, N, cfg)
        w0s = torch.cat([torch.zeros(B, 1, device=dev),
                         0.5 * torch.sum(torch.abs(v0s), dim=-1)], dim=1)
        u0 = ft.pack_staged(z0s, w0s, v0s, n, m, N)
        lam = torch.zeros(B, N * n + 2 + N, device=dev)
        mu = torch.zeros(B, S * sp.K, device=dev)
        rho = torch.full((B, 1), 100.0, device=dev)

        def full():
            return ft.solve_tube_fast_batched(
                p, N, H_rev, tube_kind="l1", scaling=0.5, cfg=cfg,
                warm_start="interpolate", tube_ws="evaluate",
                device=dev).z

        def assemble_rep():
            c = u0
            for _ in range(n_inner):
                g, D, L, _ = ft._assemble(sp, c, p, lam, mu, rho)
                c = c + 1e-12 * g
            return c

        g0, D0, L0, _ = ft._assemble(sp, u0, p, lam, mu, rho)

        def factor_rep():
            c = g0
            for _ in range(n_inner):
                d = block_tridiag_solve(block_tridiag_factor(D0, L0), c)
                c = c + 1e-12 * d
            return c

        def merit_rep():
            c = u0
            for _ in range(n_inner):
                mval = ft._merit(sp, u0, p, lam, mu, rho)
                c = c + 1e-12 * mval[:, None, None]
            return c

        reset_launches()
        t_full, _ = best_of(full, reps, dev)
        t_asm, _ = best_of(assemble_rep, reps, dev)
        t_fac, _ = best_of(factor_rep, reps, dev)
        t_merit, _ = best_of(merit_rep, reps, dev)
    return dict(batch=B, inner_steps=n_inner, full_solve_ms=t_full * 1e3,
                solves_per_s=B / t_full, assemble_ms=t_asm * 1e3,
                factor_solve_ms=t_fac * 1e3, merit_ms=t_merit * 1e3,
                unaccounted_ms=(t_full - t_asm - t_fac - t_merit) * 1e3)


def report(r: dict) -> None:
    """The JAX file's lines."""
    k = r["inner_steps"]
    print(f"full solve          : {r['full_solve_ms']:8.1f} ms   "
          f"({r['solves_per_s']:7.1f} solves/s)")
    print(f"assemble x{k:3d}       : {r['assemble_ms']:8.1f} ms")
    print(f"factor+solve x{k:3d}   : {r['factor_solve_ms']:8.1f} ms")
    print(f"merit(seq-dep) x{k:3d} : {r['merit_ms']:8.1f} ms  (1 per inner; "
          f"ls adds a parallel 10-wide)")
    print(f"unaccounted         : {r['unaccounted_ms']:8.1f} ms", flush=True)


def main(argv=None):
    args = parse(argv, __doc__)
    r = profile_solver(reps=args.reps or REPS, device=args.device)
    report(r)
    r["launches"] = print_launches()
    return r


if __name__ == "__main__":
    main()
