#!/usr/bin/env python3
"""What a torch.profiler session leaves behind, on one CUDA card.

Times the host's cost of small launches (``reps`` in-place adds on a
4096-float tensor, then one synchronise; host clock) three times before
one short ``torch.profiler`` session (CUDA activity, 20 such adds) and
three times after it, in one process. A host-bound program that runs
after a profiler session pays the difference on every launch, so
``chip_smoke.py`` takes no profile before its main path.

Usage: ``python3 scripts/torch_profiler_overhead.py`` (needs a card).
"""
import json
import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile


def launches_us(x, reps):
    """Host microseconds a launch over ``reps`` launches."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        x.add_(1.0)
    torch.cuda.synchronize()
    return 1e6 * (time.perf_counter() - t0) / reps


def main(reps=20000):
    if not torch.cuda.is_available():
        print("torch_profiler_overhead: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card)
    x = torch.zeros(4096, device="cuda")
    launches_us(x, 1000)                          # warm
    before = [launches_us(x, reps) for _ in range(3)]
    with profile(activities=[ProfilerActivity.CUDA]):
        for _ in range(20):
            x.add_(1.0)
        torch.cuda.synchronize()
    after = [launches_us(x, reps) for _ in range(3)]
    print(json.dumps({"card": card, "reps": reps,
                      "us_per_launch_before": before,
                      "us_per_launch_after": after}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
