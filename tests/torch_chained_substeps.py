"""How far the physics paths drift apart over one decimated env step of
the quadruped of tests/torch_robot_cases.py, its four substeps chained
through the contacts: JAX's Pallas substep kernel (interpret mode)
against JAX's plain ``RobotSim.substep``, and the port's plain substep
against JAX's plain one.

The inputs are ``chip_smoke.py``'s ``[routes]`` physics at a small batch:
``substep_inputs("quadruped", B, seed=17, dr=True)`` (per-env DR rows),
the PD law ``20 (q0 - q) - 0.5 qdot`` a substep, and ``WARM`` plain JAX
steps from the random draw before the compared step. For each pair it
prints the largest relative difference (max |a - b| / max |b|, as
``chip_smoke.errs``) of each state field: each substep taken by both from
the same state, and the whole step with each path chained on its own.

Not a test (no bar): chained traces diverge through contact. It answers
whether JAX's own two paths drift over a step as far as the card's kernel
and plain routes do.

    JAX_PLATFORMS=cpu python -m tests.torch_chained_substeps [B]

The interpret-mode kernel takes about a minute a substep on the CPU.
"""
import json
import sys

import numpy as np
import torch

import jax.numpy as jnp

from legged_gym_dev_tpu.ops.pallas_substep import pallas_substep
from legged_gym_dev_tpu_torch.sim.dynamics import RobotState
from tests.torch_port_cases import jax_robot_sim, jax_robot_state
from tests.torch_robot_cases import (
    robot_config,
    substep_inputs,
    torch_sim,
)

FIELDS = ("base_pos", "base_quat", "q", "v")
WARM = 3


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def field_errs(a, b):
    return {f: rel(getattr(a, f), getattr(b, f)) for f in FIELDS}


def worst(acc, new):
    return {f: max(acc.get(f, 0.0), new[f]) for f in FIELDS}


def to_torch(js):
    return RobotState(*(torch.as_tensor(np.array(getattr(js, f)))
                        for f in FIELDS))


def main(B=16):
    robot = "quadruped"
    inp = substep_inputs(robot, B, seed=17, dr=True)
    jsim = jax_robot_sim(robot, inp)
    tsim = torch_sim(robot, "cpu", inp)
    q0 = np.asarray(robot_config(robot)["q0"], np.float32)
    jq0, tq0 = jnp.asarray(q0), torch.as_tensor(q0)

    def jpd(s):
        return 20.0 * (jq0 - s.q) - 0.5 * s.v[:, 6:]

    def tpd(s):
        return 20.0 * (tq0 - s.q) - 0.5 * s.v[:, 6:]

    def kernel(s, tau):
        return pallas_substep(jsim, s, tau, block=B, interpret=True)

    state, _ = jax_robot_state(inp)
    for _ in range(WARM * jsim.decimation):
        state = jsim.substep(state, jpd(state))
    out = {"robot": robot, "batch": B, "decimation": jsim.decimation,
           "warm_steps": WARM}
    # JAX: the kernel's chain, and the plain substep from each of its states
    plain, kern, each = state, state, {}
    for _ in range(jsim.decimation):
        nxt = kernel(kern, jpd(kern))
        each = worst(each, field_errs(nxt, jsim.substep(kern, jpd(kern))))
        plain = jsim.substep(plain, jpd(plain))
        kern = nxt
    out["jax_kernel_vs_plain"] = dict(substep=each,
                                      step=field_errs(kern, plain))
    # the port's plain substep against JAX's plain substep
    tplain, jplain, each = to_torch(state), state, {}
    for _ in range(jsim.decimation):
        ts = to_torch(jplain)
        each = worst(each, field_errs(tsim.substep(ts, tpd(ts)),
                                      jsim.substep(jplain, jpd(jplain))))
        tplain = tsim.substep(tplain, tpd(tplain))
        jplain = jsim.substep(jplain, jpd(jplain))
    out["port_plain_vs_jax_plain"] = dict(substep=each,
                                          step=field_errs(tplain, jplain))
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:]))
