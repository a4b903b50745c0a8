"""Profiling and timing utilities.

Counterpart of ``legged_gym_dev_tpu/utils/profiling.py``: a
``torch.profiler`` trace context that writes a Chrome trace, named
wall-clock spans with FLOP-based roofline accounting, and the tube
solve's rough FLOP model.

Usage:
    with trace("plots/trace"):            # open in Perfetto / chrome://tracing
        out = solve(batch)

    t = Timing()
    with t.span("solve"):
        solve(batch)
    print(t.report(work={"solve": n_flops}))
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """A ``torch.profiler`` session over the block (host, and the card's
    kernels where CUDA is available), written to
    ``<log_dir>/trace.json`` as a Chrome trace."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=acts)
    prof.__enter__()
    try:
        yield prof
    finally:
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class Timing:
    """Named wall-clock spans with optional FLOP-based roofline
    accounting. A span is closed by ``torch.cuda.synchronize`` when CUDA
    is in use, so it holds the card's work queued inside it."""

    def __init__(self):
        self.spans: Dict[str, list] = defaultdict(list)

    @contextlib.contextmanager
    def span(self, name: str):
        _sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            _sync()
            self.spans[name].append(time.perf_counter() - t0)

    def best(self, name: str) -> float:
        return min(self.spans[name])

    def report(self, work: Optional[Dict[str, float]] = None,
               peak_flops: float = 67e12) -> str:
        """Per-span best wall time; with ``work`` (FLOPs per call), the
        achieved FLOP/s and its share of ``peak_flops`` (default: the
        H100 SXM's fp32 rate outside the tensor cores, 67 TFLOP/s)."""
        lines = []
        for name, ts in self.spans.items():
            best = min(ts)
            line = f"{name}: {best * 1e3:.2f} ms (n={len(ts)})"
            if work and name in work:
                rate = work[name] / best
                line += (f", {rate / 1e12:.2f} TFLOP/s"
                         f" ({100 * rate / peak_flops:.1f}% of peak)")
            lines.append(line)
        return "\n".join(lines)


def flops_tube_solve(B: int, N: int, n: int, m: int, outer: int,
                     inner: int) -> float:
    """Rough FLOP model of the structured tube solve: per inner
    iteration the banded factor and solve dominate at about
    S * (b^3 + 6 b^2) with b = n + 1 + m, plus the assembly's S * b^2
    terms."""
    b = n + 1 + m
    S = N + 1
    per_iter = S * (b ** 3 + 8 * b * b) * 4
    return float(B * outer * inner * per_iter)
