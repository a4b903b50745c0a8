"""The port's generic solver against the certified goldens
(tests/goldens/*.npz: f64 solutions of the five BASELINE.json configs by
two scipy families, with a KKT certificate), at tests/test_goldens.py's
tolerances, through the port alone (no JAX in this file):

1. SingleInt2D nominal plan (``solve_nominal``): plan within 1e-3, viol
   < 1e-4;
2. DoubleInt2D with a fixed tube width (``solve_nominal`` on inflated
   obstacles): the same bars;
3. Unicycle with the golden's NN one-shot tube (``solve_tube``): plan
   within 1e-3, viol < 1e-3, solved to tol_feas 1e-6 in at most 30 outer
   iterations (below);
4. the closed loop (``closed_loop_tube_mpc``, l2 tube, N=20, H=15): the
   executed z and v within 5e-3;
5. a batch of 4 (``solve_tube_batched``, l2 tube): plans within 1e-3
   without the null-space coordinate w[0] (Qw=0 and no constraint touches
   it), viol < 1e-3.

Config 3's solve is held to a tighter feasibility tolerance than the
default ALConfig's 1e-5. At this KKT point the plan moves by about 140x
the violation (the NN tube's rows are flat in v), so a solve that stops
as the default allows, anywhere below 1e-5, lands up to 1.4e-3 from the
golden, and which fp32 rounding it gets decides the side of the 1e-3 bar:
the JAX package's own ``solve_tube`` at the default passes at the
golden's start (1.6e-5, its last outer happened to jump to viol 7e-7) and
misses at a start moved by 1e-7 (1.30e-3 and 1.34e-3, viol 8.4e-6 to
9.5e-6); the port misses on 1-4 CPU threads and on the card. Near the
optimum the AL merit's changes fall below its fp32 rounding (3e-5 at a
merit of 196), so the line search can stall for a few outer iterations.
Solved to 1e-6 in at most 30 outer iterations the port lands within
1.5e-4 on 1, 2, 4 and 8 CPU threads (the JAX package within 1.6e-4 at
the golden's start and at two of three starts moved by 1e-7; at the third
it stalls at viol 1.2e-5 for its last 13 outer iterations).

``run_config(k, device)`` is also ``chip_smoke.py``'s ``[plan goldens]``
(it loads this file by path): it returns each config's deviation, its
bar and the solve's violation.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

from legged_gym_dev_tpu_torch.core import make_rom
from legged_gym_dev_tpu_torch.interop import (
    mlp_from_numpy,
    trajopt_params_from_numpy,
)
from legged_gym_dev_tpu_torch.solver import (
    PROBLEM_DICT,
    ALConfig,
    get_tube_dynamics,
    solve_nominal,
    solve_tube,
    solve_tube_batched,
)
from legged_gym_dev_tpu_torch.solver.mpc import (
    MPCConfig,
    closed_loop_tube_mpc,
)

GOLD = Path(__file__).resolve().parent / "goldens"
PROB = PROBLEM_DICT["gap"]
NAMES = {1: "config1_nominal_singleint", 2: "config2_tube_doubleint",
         3: "config3_tube_nn_unicycle", 4: "config4_closed_loop",
         5: "config5_batched"}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for this module: the generic solver launches
    thousands of small ops, which run faster on one thread than on eight,
    and six parallel test workers then do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def load(k):
    g = dict(np.load(GOLD / f"{NAMES[k]}.npz"))
    # the stored certificate numbers
    if "kkt_scaled" in g:
        assert float(g["kkt_scaled"]) < 1e-6
    if "feas" in g:
        assert float(g["feas"]) < 1e-6
    return g


def _gap_params(N, H_rev, device, **kw):
    return trajopt_params_from_numpy(
        "SingleInt2D", PROB["dt"], [-PROB["pos_max"]] * 2,
        [PROB["pos_max"]] * 2, [-PROB["vel_max"]] * 2,
        [PROB["vel_max"]] * 2, N, H_rev, 10 * np.eye(2), 10 * np.eye(2),
        kw.pop("z0", PROB["start"]), PROB["goal"], PROB["obs"]["c"],
        kw.pop("obs_r", PROB["obs"]["r"]), device=device, **kw)


def _flat(*parts):
    B = parts[0].shape[0]
    return torch.cat([t.reshape(B, -1) for t in parts], dim=1).cpu().numpy()


def _config1(g, device):
    N = int(g["N"])
    p = _gap_params(N, 10, device)
    z, v, sol = solve_nominal(p, N, ALConfig(), warm_start="interpolate",
                              device=device)
    return np.abs(_flat(z, v)[0] - g["x"]).max(), sol.viol


def _config2(g, device):
    N, w_fixed = int(g["N"]), float(g["w_fixed"])
    p = trajopt_params_from_numpy(
        "DoubleInt2D", PROB["dt"], [-10, -10, -1, -1], [10, 10, 1, 1],
        [-1, -1], [1, 1], N, 10, np.diag([10.0, 10.0, 1.0, 1.0]), np.eye(2),
        [0.3, 0.3, 0.0, 0.0], [1.5, 1.5, 0.0, 0.0], PROB["obs"]["c"],
        np.asarray(PROB["obs"]["r"]) + w_fixed, device=device)
    z, v, sol = solve_nominal(p, N, ALConfig(), warm_start="interpolate",
                              device=device)
    return np.abs(_flat(z, v)[0] - g["x"]).max(), sol.viol


def _config3(g, device):
    N, H_rev = int(g["N"]), int(g["H_rev"])
    layers = len([k for k in g if k.startswith("w")])
    nn = mlp_from_numpy([g[f"w{i}"] for i in range(layers)],
                        [g[f"b{i}"] for i in range(layers)],
                        activation="softplus_b5",
                        final_activation="softplus", device=device)
    p = trajopt_params_from_numpy(
        "Unicycle", PROB["dt"], [-10, -10, -np.pi * 4], [10, 10, np.pi * 4],
        [-1, -2], [1, 2], N, H_rev, np.diag([10.0, 10.0, 0.1]), np.eye(2),
        [0.3, 0.3, np.pi / 4], [1.5, 1.5, np.pi / 4], PROB["obs"]["c"],
        PROB["obs"]["r"], Qw=0.1, tube_params=nn, device=device)
    out = solve_tube(p, get_tube_dynamics("NN_oneshot", N), N, H_rev,
                     ALConfig(tol_feas=1e-6, outer_iters=30),
                     warm_start="interpolate", tube_ws="evaluate",
                     device=device)
    return np.abs(_flat(out.z, out.v, out.w)[0] - g["x"]).max(), out.sol.viol


def _config4(g, device):
    N, H, H_rev = int(g["N"]), int(g["H"]), int(g["H_rev"])
    p = _gap_params(N, H_rev, device, Qw=0.0)
    robot = make_rom("DoubleInt2D", PROB["dt"], [-np.inf, -np.inf, -0.3, -0.3],
                     [np.inf, np.inf, 0.3, 0.3], [-0.5, -0.5], [0.5, 0.5],
                     device=device)
    trace = closed_loop_tube_mpc(
        p, get_tube_dynamics("l2", N, scaling=0.5), robot,
        MPCConfig(H=H, N=N, H_rev=H_rev), al_first=ALConfig(),
        al_loop=ALConfig(outer_iters=8, inner_iters=8),
        warm_start="interpolate", device=device)
    dz = np.abs(trace.z[0].cpu().numpy() - g["z"]).max()
    dv = np.abs(trace.v[0].cpu().numpy() - g["v"]).max()
    return max(dz, dv), trace.viol.amax(dim=1)


def _config5(g, device):
    N, B = int(g["N"]), int(g["B"])
    p = _gap_params(N, 10, device, Qw=0.0, z0=g["starts"], obs_r=g["radii"],
                    batch=B)
    out = solve_tube_batched(p, get_tube_dynamics("l2", N, scaling=0.5), N,
                             10, ALConfig(), warm_start="interpolate",
                             tube_ws="evaluate", device=device)
    x = _flat(out.z, out.v, out.w)
    # w[0] is a null-space coordinate with Qw=0: any value in [0, w_max]
    # is optimal, so solvers legitimately disagree there.
    w0 = (N + 1) * 2 + N * 2
    err = np.abs(np.delete(x, w0, axis=1) - np.delete(g["x"], w0, axis=1))
    return err.max(), out.sol.viol


# config: (runner, plan bar, violation bar or None)
CONFIGS = {1: (_config1, 1e-3, 1e-4), 2: (_config2, 1e-3, 1e-4),
           3: (_config3, 1e-3, 1e-3), 4: (_config4, 5e-3, None),
           5: (_config5, 1e-3, 1e-3)}


def run_config(k, device):
    """Config k on ``device``: dict(dev=max deviation from the golden,
    bar, viol=max violation of the solves, viol_bar, ok)."""
    run, bar, viol_bar = CONFIGS[k]
    dev, viol = run(load(k), device)
    viol = float(torch.as_tensor(viol).max())
    ok = bool(dev < bar and (viol_bar is None or viol < viol_bar))
    return dict(config=NAMES[k], dev=float(dev), bar=bar, viol=viol,
                viol_bar=viol_bar, ok=ok)


@pytest.mark.parametrize("k", sorted(CONFIGS), ids=lambda k: NAMES[k])
def test_port_meets_golden(k):
    res = run_config(k, "cpu")
    assert res["dev"] < res["bar"], res
    if res["viol_bar"] is not None:
        assert res["viol"] < res["viol_bar"], res
