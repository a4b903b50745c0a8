"""Component-level timing of the scalar-entry staged tube solver, on the
PyTorch/CUDA port.

The counterpart of ``scripts/profile_staged.py`` on
``legged_gym_dev_tpu_torch``. Times at bench shapes (B from BENCH_BATCH,
4096 by default; N=50; the ``gap`` problem, z0 moved by
``default_rng(0)``; each scenario started on the line from z0 to zf, w
0.1, v 0):
  - the full solve (reference point): ``staged_scalar.solve_staged_scalar``
    on the kernel route (``linsolve="pallas"``: ``bt_solve`` on the card,
    the port's main path; the JAX file's ``ALConfig()`` takes the
    block-Thomas scan);
  - the solver's inner step alone, rebuilt from ``staged_scalar``'s
    pieces as the JAX file rebuilds it (merit, assembly, bound mask,
    masked banded solve, parallel line search), iterated outer x inner =
    200 times: on ``factor_solve_entries`` (the JAX file's), then on the
    kernel ``bt_solve``;
  - ``_assemble_e`` alone, x200;
  - the banded factor + solve alone, x200: the plain
    ``factor_solve_entries``, then the kernel route the solver takes for
    one right-hand side (``bt_solve``);
  - the merit alone (one evaluation and one of the 10 line-search
    candidates), x200.
The loops carry the JAX file's dependence (``u + 1e-12 * ...``).

Run on the card:  python scripts/torch_profile_staged.py
On the CPU:       E2E_CPU=1 BENCH_BATCH=8 \\
                  python scripts/torch_profile_staged.py
``--reps`` cuts the timed reps (5, the least taken). ``main`` prints the
JAX file's lines (the kernel-route lines after their plain ones) and
returns their numbers as a dict.
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
REPS = 5


def staged_problem(p, N):
    from legged_gym_dev_tpu_torch.solver import fast_tube as ft

    return ft.StagedProblem(n=p.rom.n, m=p.rom.m, N=N, K=p.obs_r.shape[-1],
                            tube_kind="l1", scaling=0.5, track_ref=False)


def make_u0(p, N):
    """The JAX file's start: z on the line from z0 to zf, w 0.1, v 0;
    with the staged bounds."""
    from legged_gym_dev_tpu_torch.solver import fast_tube as ft

    n, m, S = p.rom.n, p.rom.m, N + 1
    t = torch.linspace(0, 1, S, device=p.device)
    z_ws = p.z0[:, None] + (p.zf - p.z0)[:, None] * t[None, :, None]
    u0 = ft.pack_staged(z_ws, torch.full((p.batch_size, S), 0.1,
                                         device=p.device),
                        torch.zeros(p.batch_size, N, m, device=p.device),
                        n, m, N)
    lb, ub = ft.staged_bounds(p, n, m, N)
    return u0, lb, ub


def lam_mu(sp, B, cfg, dev):
    """Zero multipliers and the initial penalty, (B, 1)."""
    S = sp.N + 1
    return (torch.zeros(B, sp.N * sp.n + 2 + sp.N, device=dev),
            torch.zeros(B, S * sp.K, device=dev),
            torch.full((B, 1), cfg.rho0, device=dev))


def entries(x):
    return tuple(x[:, :, i] for i in range(x.shape[-1]))


def inner_step(sp, p, cfg, lb_e, ub_e, lam, mu, rho, solve):
    """The solver's inner step as the JAX file rebuilds it from
    ``staged_scalar``'s private pieces, with the banded solve ``solve``
    (``factor_solve_entries`` or the kernel route): a function of the
    entry tuple."""
    from legged_gym_dev_tpu_torch.solver.staged_scalar import (
        _add,
        _assemble_e,
        _is0,
        _merit_e,
        _mul,
        _sum,
    )

    b = len(lb_e)
    B, S = lb_e[0].shape
    dev = lb_e[0].device
    eps_e = tuple(1e-9 + 1e-6 * (ub_e[i] - lb_e[i]) for i in range(b))
    alphas = cfg.ls_backtrack ** torch.arange(cfg.ls_iters,
                                              dtype=torch.float32,
                                              device=dev)[:, None, None]

    def step(u_e):
        merit = _merit_e(sp, u_e, p, lam, mu, rho)
        grad_e, D_e, L_e, _ = _assemble_e(sp, u_e, p, lam, mu, rho)
        fm = []
        for i in range(b):
            at_lb = (u_e[i] <= lb_e[i] + eps_e[i]) & (grad_e[i] > 0.0)
            at_ub = (u_e[i] >= ub_e[i] - eps_e[i]) & (grad_e[i] < 0.0)
            fm.append((~(at_lb | at_ub)).float())
        reg = cfg.reg + 1e-6 * rho
        Dm = [[0.0] * b for _ in range(b)]
        for i in range(b):
            for j in range(i + 1):
                if _is0(D_e[i][j]) and i != j:
                    Dm[i][j] = torch.zeros(B, S, device=dev)
                    continue
                v = _mul(D_e[i][j], fm[i] * fm[j])
                if i == j:
                    v = _add(v, (1.0 - fm[i]) + reg)
                Dm[i][j] = v if not _is0(v) else torch.zeros(B, S,
                                                             device=dev)
        Lm = [[_mul(L_e[i][j], fm[i][:, 1:] * fm[j][:, :-1])
               for j in range(b)] for i in range(b)]
        gf = [grad_e[i] * fm[i] for i in range(b)]
        d_e = solve(Dm, Lm, [-g for g in gf], b)
        d_e = [torch.where(fm[i] > 0.0, d_e[i], 0.0) for i in range(b)]
        dir_deriv = 0.0
        for i in range(b):
            dir_deriv = dir_deriv + _sum(grad_e[i] * d_e[i])
        u_try = tuple(torch.clamp(u_e[i][None] + alphas * d_e[i][None],
                                  lb_e[i], ub_e[i]) for i in range(b))
        m_trys = _merit_e(sp, u_try, p, lam, mu, rho)     # (ls, B, 1)
        ok = m_trys <= merit + cfg.armijo * alphas * dir_deriv
        idx = torch.argmax(ok.int(), dim=0, keepdim=True)
        any_ok = torch.any(ok, dim=0)
        return tuple(
            torch.where(any_ok,
                        torch.gather(u_try[i], 0, idx.expand(1, B, S))[0],
                        u_e[i]) for i in range(b))

    return step


def profile_staged(B: int = 4096, N: int = N, H_rev: int = H_REV,
                   cfg: ALConfig = CFG, reps: int = REPS, device=None):
    """The timings (ms) of the full solve and its pieces at batch B;
    ``cfg`` fixes the schedule, hence the inner-step count."""
    from legged_gym_dev_tpu_torch.ops.block_tridiag_kernels import (
        block_tridiag_solve_entries,
    )
    from legged_gym_dev_tpu_torch.solver.staged_scalar import (
        _add,
        _assemble_e,
        _is0,
        _merit_e,
        factor_solve_entries,
        solve_staged_scalar,
    )
    from legged_gym_dev_tpu_torch.utils.runtime import (
        fp32_matmul,
        resolve_device,
    )

    dev = resolve_device(device)
    p = gap_params(B, 0, ("z0",), dev, N=N, H_rev=H_rev)
    sp = staged_problem(p, N)
    b, S = sp.n + 1 + sp.m, N + 1
    n_inner = cfg.outer_iters * cfg.inner_iters
    u0, lb, ub = make_u0(p, N)
    u_e, lb_e, ub_e = entries(u0), entries(lb), entries(ub)
    lam, mu, rho = lam_mu(sp, B, cfg, dev)
    alphas = cfg.ls_backtrack ** torch.arange(cfg.ls_iters,
                                              dtype=torch.float32,
                                              device=dev)[:, None, None]

    def full_solve():
        return solve_staged_scalar(sp, p, u0, lb, ub, cfg).x

    def inner_only(solve):
        def run():
            step = inner_step(sp, p, cfg, lb_e, ub_e, lam, mu, rho, solve)
            u = u_e
            for _ in range(n_inner):
                u = step(u)
            return u[0]
        return run

    def assemble_only():
        u = u_e
        for _ in range(n_inner):
            g_e, D_e, _, _ = _assemble_e(sp, u, p, lam, mu, rho)
            bump = sum(D_e[i][i] for i in range(b))
            u = tuple(u[i] + 1e-12 * (g_e[i] + bump) for i in range(b))
        return u[0]

    def factor_only(solve):
        g_e, D_e, L_e, _ = _assemble_e(sp, u_e, p, lam, mu, rho)
        Dm = [[0.0] * b for _ in range(b)]
        for i in range(b):
            for j in range(i + 1):
                v = _add(D_e[i][j], cfg.reg) if i == j else D_e[i][j]
                Dm[i][j] = (torch.zeros(B, S, device=dev) if _is0(v)
                            else torch.broadcast_to(torch.as_tensor(
                                v, dtype=torch.float32, device=dev), (B, S)))
        rhs0 = tuple(-(g_e[i] + 0.0 * u_e[i]) for i in range(b))

        def run():
            r = rhs0
            for _ in range(n_inner):
                d = solve(Dm, L_e, list(r), b)
                r = tuple(ri + 1e-12 * di for ri, di in zip(r, d))
            return r[0]
        return run

    def merit_only():
        u = u_e
        for _ in range(n_inner):
            m0 = _merit_e(sp, u, p, lam, mu, rho)
            u_try = tuple(u[i][None] * (1.0 + 0.0 * alphas)
                          for i in range(b))
            mt = _merit_e(sp, u_try, p, lam, mu, rho)
            u = tuple(u[i] + 1e-12 * (m0 + mt[0]) for i in range(b))
        return u[0]

    out = dict(batch=B, N=N, inner_steps=n_inner)
    reset_launches()
    with fp32_matmul():
        for key, fn in (
                ("full_solve_ms", full_solve),
                ("inner_ms", inner_only(factor_solve_entries)),
                ("inner_bt_solve_ms", inner_only(block_tridiag_solve_entries)),
                ("assemble_ms", assemble_only),
                ("factor_ms", factor_only(factor_solve_entries)),
                ("factor_bt_solve_ms",
                 factor_only(block_tridiag_solve_entries)),
                ("merit_ms", merit_only)):
            out[key] = best_of(fn, reps, dev)[0] * 1e3
    out["solves_per_s"] = B / out["full_solve_ms"] * 1e3
    return out


def report(r: dict) -> None:
    """The JAX file's lines, each kernel-route line after its plain one."""
    k = r["inner_steps"]
    print(f"B={r['batch']} N={r['N']} inner-steps/solve={k}")
    print(f"full solve:      {r['full_solve_ms']:8.1f} ms   "
          f"({r['solves_per_s']:8.0f} solves/s)")
    print(f"inner   x{k}:   {r['inner_ms']:8.1f} ms")
    print(f"inner   x{k} (bt_solve):   {r['inner_bt_solve_ms']:8.1f} ms")
    print(f"assemble x{k}:  {r['assemble_ms']:8.1f} ms")
    print(f"factor  x{k}:   {r['factor_ms']:8.1f} ms")
    print(f"factor  x{k} (bt_solve):   {r['factor_bt_solve_ms']:8.1f} ms")
    print(f"merit   x{k}:   {r['merit_ms']:8.1f} ms", flush=True)


def main(argv=None):
    args = parse(argv, __doc__)
    B = int(os.environ.get("BENCH_BATCH", "4096"))
    r = profile_staged(B=B, reps=args.reps or REPS, device=args.device)
    report(r)
    r["launches"] = print_launches()
    return r


if __name__ == "__main__":
    main()
