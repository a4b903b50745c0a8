"""Component profile of the NN-oneshot scalar-entry solve at bench shapes,
on the PyTorch/CUDA port.

The counterpart of ``scripts/profile_nn_tube.py`` on
``legged_gym_dev_tpu_torch``. Times each candidate hot spot alone at its
per-solve call count (200 inner iterations, a Python loop carrying the
JAX file's ``once(x + 1e-6 i) + 0 * c``) so the full-solve wall can be
attributed:
  - the tube MLP's Jacobian: the analytic product chain the solver uses
    (``MLP.value_and_jacobian``), and with PROF_JAC_AD set
    ``torch.func.jacfwd`` / ``jacrev`` in fp32 and ``jacrev`` with TF32 on
    (the JAX file's "default" matmul precision);
  - the MLP forward over 11 candidates (10 line-search points and the
    assembly);
  - the (B, 50, 50) capacitance factor and solve: the blocked Cholesky of
    ``ops/blocked_chol.py``, and with PROF_CHOL_XLA set
    ``torch.linalg.cholesky`` + ``cholesky_solve``;
  - the capacitance assembly, 3 x U^T R;
  - the banded block-Thomas of ``staged_scalar.factor_solve_entries`` with
    one right-hand side and with 51, each followed by the kernel route the
    port's solver takes for the same system on the card: ``bt_solve`` for
    one, ``bt_factor`` + ``bt_msolve`` for 51.
Everything runs in full fp32 (TF32 off) but the one TF32 variant. The MLP
(2x128, softplus head) and the random inputs come from seeded
``torch.Generator`` draws where the JAX file uses PRNGKey(0); the banded
systems from its ``np.random.default_rng(0)``.

Run on the card:  python scripts/torch_profile_nn_tube.py
On the CPU:       E2E_CPU=1 B=8 python scripts/torch_profile_nn_tube.py
Environment knobs (the JAX file's): B (1024), PROF_JAC_AD, PROF_CHOL_XLA.
``--reps`` cuts the timed reps (5, the least taken). ``main`` prints the
JAX file's lines and returns their numbers (ms) as a dict.
"""
import contextlib
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_tool_common import (  # noqa: E402
    H_REV,
    N,
    best_of,
    parse,
    print_launches,
    reset_launches,
)

ITERS = 200     # inner iterations per solve (20 outer x 10 inner)
REPS = 5


@contextlib.contextmanager
def tf32():
    """TF32 matmuls inside the block (the JAX file's default precision);
    the previous flag restored after."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def repeated(once, x0, iters):
    """The JAX file's ``fori_loop(0, iters, lambda i, c: once(x0 + 1e-6 i)
    + 0 * c, once(x0))`` over a tensor or a list of tensors."""
    def shift(x, i):
        if isinstance(x, list):
            return [t + 1e-6 * i for t in x]
        return x + 1e-6 * i

    def carry(a, c):
        if isinstance(a, list):
            return [u + 0.0 * v for u, v in zip(a, c)]
        return a + 0.0 * c

    def run():
        c = once(x0)
        for i in range(iters):
            c = carry(once(shift(x0, i)), c)
        return c
    return run


def banded_system(B, S, b, seed=0):
    """The JAX file's SPD banded system from ``default_rng(seed)``: D (B,
    S, b, b) = X Y^T + 10 b I, L (B, S-1, b, b), one right-hand side and
    51, as numpy."""
    rng = np.random.default_rng(seed)
    D = np.einsum("bsij,bskj->bsik",
                  rng.normal(size=(B, S, b, b)).astype(np.float32),
                  rng.normal(size=(B, S, b, b)).astype(np.float32))
    D += 10 * b * np.eye(b, dtype=np.float32)
    L = 0.3 * rng.normal(size=(B, S - 1, b, b)).astype(np.float32)
    r1 = [rng.normal(size=(B, S)).astype(np.float32) for _ in range(b)]
    rM = [rng.normal(size=(B, S, 51)).astype(np.float32) for _ in range(b)]
    return D, L, r1, rM


def profile_nn_tube(B: int = 1024, N: int = N, H_rev: int = H_REV,
                    iters: int = ITERS, reps: int = REPS,
                    jac_ad: bool = False, chol_xla: bool = False,
                    device=None) -> dict:
    """The timings (ms) of each piece, ``iters`` calls each, at batch B;
    prints each as the JAX file does."""
    from legged_gym_dev_tpu_torch.ops.block_tridiag_kernels import (
        block_tridiag_multirhs_entries,
        block_tridiag_solve_entries,
    )
    from legged_gym_dev_tpu_torch.ops.blocked_chol import (
        blocked_cho_solve,
        blocked_cholesky,
    )
    from legged_gym_dev_tpu_torch.solver.staged_scalar import (
        factor_solve_entries,
    )
    from legged_gym_dev_tpu_torch.tube.models import MLP
    from legged_gym_dev_tpu_torch.utils.runtime import (
        fp32_matmul,
        resolve_device,
    )

    dev = resolve_device(device)
    m, S, b = 2, N + 1, 5
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    nn = MLP.create(gen, H_rev + (H_rev + N) * m, N, num_units=128,
                    num_layers=2, final_activation="softplus")
    zv = torch.randn(B, N * m, generator=gen, device=dev) * 0.1
    e_hist = torch.zeros(B, H_rev, device=dev)
    vprev = torch.zeros(B, H_rev, m, device=dev)
    out = {}

    def timed(tag, key, fn):
        t = best_of(fn, reps, dev)[0]
        print(f"{tag}: {t * 1000:.1f} ms", flush=True)
        out[key] = t * 1e3

    def net_input(z, e, vp):
        """(..., N m) plan, (..., H_rev) errors, (..., H_rev, m) inputs ->
        (..., n_in), the JAX file's ``fw_of`` layout."""
        vs = z.reshape(z.shape[:-1] + (m, N))
        return torch.cat([e, vp[..., 0], vs[..., 0, :], vp[..., 1],
                          vs[..., 1, :]], dim=-1)

    def fw_of(z, e, vp):
        return nn(net_input(z, e, vp))

    def jac(transform):
        def once(z):
            return torch.func.vmap(transform(fw_of))(z, e_hist, vprev)
        return once

    reset_launches()
    with fp32_matmul():
        # --- MLP Jacobian variants (x iters) ---
        if jac_ad:
            timed(f"jacfwd highest x{iters}", "jacfwd_highest",
                  repeated(jac(torch.func.jacfwd), zv, iters))
            timed(f"jacrev highest x{iters}", "jacrev_highest",
                  repeated(jac(torch.func.jacrev), zv, iters))
            with tf32():
                timed(f"jacrev default x{iters}", "jacrev_default",
                      repeated(jac(torch.func.jacrev), zv, iters))

        # the analytic matmul-chain Jacobian the solver uses
        timed(f"value_and_jacobian x{iters}", "value_and_jacobian",
              repeated(lambda z: nn.value_and_jacobian(
                  net_input(z, e_hist, vprev))[1], zv, iters))

        # --- MLP forward (merit) 11x per inner ---
        def fwd_11(z):
            zb = z[:, None].expand(B, 11, N * m)
            return fw_of(zb, e_hist[:, None].expand(B, 11, H_rev),
                         vprev[:, None].expand(B, 11, H_rev, m))
        timed(f"mlp fwd 11-cand x{iters}", "mlp_fwd_11", repeated(
            fwd_11, zv, iters))

        # --- capacitance solve (B, N, N) x iters ---
        A = torch.randn(B, N, N, generator=gen, device=dev) * 0.1
        C = torch.eye(N, device=dev) + A @ A.transpose(-1, -2)
        rhs = torch.randn(B, N, generator=gen, device=dev)
        if chol_xla:
            timed(f"cho_factor+solve (B,{N},{N}) x{iters}", "cho_library",
                  repeated(lambda c: torch.cholesky_solve(
                      rhs[..., None], torch.linalg.cholesky(c))[..., 0],
                      C, iters))
        timed(f"blocked chol+solve (B,{N},{N}) x{iters}", "blocked_chol",
              repeated(lambda c: blocked_cho_solve(
                  blocked_cholesky(c, p=10), rhs, p=10), C, iters))

        # capacitance assembly: 3x batched (N, S) @ (S, N) matmuls
        Um3 = torch.randn(3, B, S, N, generator=gen, device=dev) * 0.1
        Ru3 = torch.randn(3, B, S, N, generator=gen, device=dev) * 0.1

        def cap(u):
            c = torch.eye(N, device=dev)
            for i in range(3):
                c = c + u[i].transpose(-1, -2) @ Ru3[i]
            return c
        timed(f"capacitance 3x UtRu x{iters}", "capacitance",
              repeated(cap, Um3, iters))

        # --- banded Thomas: single vs multi RHS x iters, then the kernels
        D, L, r1, rM = banded_system(B, S, b)
        Dt, Lt = torch.as_tensor(D, device=dev), torch.as_tensor(L, device=dev)
        D_e = [[Dt[:, :, i, j] for j in range(i + 1)] for i in range(b)]
        L_e = [[Lt[:, :, i, j] for j in range(b)] for i in range(b)]
        r1 = [torch.as_tensor(r, device=dev) for r in r1]
        rM = [torch.as_tensor(r, device=dev) for r in rM]
        for tag, key, solve, r in (
                ("thomas single-rhs", "thomas_1", factor_solve_entries, r1),
                ("bt_solve single-rhs", "bt_solve_1",
                 block_tridiag_solve_entries, r1),
                ("thomas 51-rhs", "thomas_51", factor_solve_entries, rM),
                ("bt_factor+bt_msolve 51-rhs", "bt_msolve_51",
                 block_tridiag_multirhs_entries, rM)):
            timed(f"{tag} x{iters}", key, repeated(
                lambda rr, s=solve: s(D_e, L_e, rr, b), r, iters))
    return out


def main(argv=None):
    args = parse(argv, __doc__)
    B = int(os.environ.get("B", "1024"))
    out = profile_nn_tube(B=B, reps=args.reps or REPS,
                          jac_ad=bool(os.environ.get("PROF_JAC_AD")),
                          chol_xla=bool(os.environ.get("PROF_CHOL_XLA")),
                          device=args.device)
    out["batch"] = B
    out["launches"] = print_launches()
    return out


if __name__ == "__main__":
    main()
