"""Attribute the rough-terrain slowdown, on the PyTorch/CUDA port.

The counterpart of ``scripts/profile_rough.py`` on
``legged_gym_dev_tpu_torch``. Times K = 50 policy steps a call
(``env.step`` in a Python loop; the carried state keeps every step live,
the call ends in a scalar) for:
  - flat ``anymal_c_velocity`` on the kernel route (the CUDA kernel
    ``substep`` on the card);
  - the same on the plain substep (``use_pallas_substep=False``): the
    kernel-against-plain gap the rough path pays, since the reference
    sends non-flat terrain to its plain substep;
  - ``anymal_c_rough`` with the height scan off (the measured points
    removed and the flat task's noise vector): terrain in contact alone;
  - ``anymal_c_rough`` in full, its 187-point height scan included.
Each: one untimed call, then 5 timed calls, the least kept. Then the
three-way attribution: scan, terrain in contact, kernel against plain.

Run on the card:  OVERRIDES='{"urdf_path": "anymal_c.urdf"}' \\
                  python scripts/torch_profile_rough.py
On the CPU:       ENVS=8 ... --cpu  (or E2E_CPU=1)

Environment knobs: ENVS (2048), the JAX file's; ``OVERRIDES``, JSON
keywords for both tasks' env factories (``urdf_path``: the robots' URDFs
lie outside this repository). ``--reps`` cuts the timed calls. ``main``
prints the JAX file's lines and returns their numbers (ms a step) as a
dict.
"""
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_tool_common import (  # noqa: E402
    best_of,
    env_overrides,
    parse,
    print_launches,
    reset_launches,
)

K = 50      # policy steps a timed call
REPS = 5


def attribution(t_f, t_fn, t_n, t_r) -> dict:
    """The JAX file's split of the rough step (any unit): the height scan,
    terrain in contact, and the kernel against the plain substep."""
    return {"scan": t_r - t_n, "terrain_in_contact": t_n - t_fn,
            "kernel_vs_fallback": t_fn - t_f}


def timed_scan(env, es, act, reps, dev, k=K):
    """Least seconds a step of ``k``-step calls from ``es``."""
    def run():
        s = es
        for _ in range(k):
            s, _ = env.step(s, act)
        return torch.sum(s.robot.base_pos[:, 2])
    return best_of(run, reps, dev)[0] / k


def profile_rough(B: int = 2048, k: int = K, reps: int = REPS,
                  overrides=None, device=None) -> dict:
    from legged_gym_dev_tpu_torch.envs import task_registry
    from legged_gym_dev_tpu_torch.utils.runtime import resolve_device

    dev = resolve_device(device)
    kw = dict(num_envs=B, device=dev, **(overrides or {}))
    env = task_registry.make_env("anymal_c_rough", **kw)
    envf = task_registry.make_env("anymal_c_velocity", **kw)
    env_noscan = env.replace(measured_points_x=None, measured_points_y=None,
                             noise_vec=envf.noise_vec)
    envf_noker = envf.replace(sim=envf.sim.replace(use_pallas_substep=False))
    act = torch.zeros(B, envf.num_actions, device=dev)
    nc = env.sim.model.contact_radius.shape[0]

    def reset(e):
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        return e.reset(gen)[0]

    es, esf, esn = reset(env), reset(envf), reset(env_noscan)
    reset_launches()
    t_f = timed_scan(envf, esf, act, reps, dev, k)
    print(f"flat (pallas substep): {t_f * 1e3:.2f} ms/step "
          f"({B / t_f:.0f} steps/s)", flush=True)
    t_fn = timed_scan(envf_noker, esf, act, reps, dev, k)
    print(f"flat (XLA fallback):   {t_fn * 1e3:.2f} ms/step "
          f"({B / t_fn:.0f} steps/s)", flush=True)
    t_n = timed_scan(env_noscan, esn, act, reps, dev, k)
    print(f"rough, no height scan: {t_n * 1e3:.2f} ms/step "
          f"({B / t_n:.0f} steps/s)", flush=True)
    t_r = timed_scan(env, es, act, reps, dev, k)
    print(f"rough (full):          {t_r * 1e3:.2f} ms/step "
          f"({B / t_r:.0f} steps/s)  [nc={nc}]", flush=True)
    split = attribution(t_f, t_fn, t_n, t_r)
    print(f"attribution: scan {1e3 * split['scan']:.2f} ms, "
          f"terrain-in-contact {1e3 * split['terrain_in_contact']:.2f} ms, "
          f"kernel-vs-fallback {1e3 * split['kernel_vs_fallback']:.2f} ms",
          flush=True)
    return dict(batch=B, steps_a_call=k, nc=nc,
                decimation=envf.sim.decimation,
                flat_kernel_ms=t_f * 1e3, flat_plain_ms=t_fn * 1e3,
                rough_no_scan_ms=t_n * 1e3, rough_ms=t_r * 1e3,
                attribution_ms={key: v * 1e3 for key, v in split.items()})


def main(argv=None):
    args = parse(argv, __doc__)
    B = int(os.environ.get("ENVS", "2048"))
    out = profile_rough(B=B, reps=args.reps or REPS,
                        overrides=env_overrides(), device=args.device)
    out["launches"] = print_launches()
    return out


if __name__ == "__main__":
    main()
