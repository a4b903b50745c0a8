"""Device resolution and the fp32 precision policy.

Counterpart of ``legged_gym_dev_tpu/utils/runtime.py``, which configures the
TPU runtime; here the two knobs that matter are where tensors live and that
fp32 products stay fp32.
"""
from __future__ import annotations

import contextlib

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card. Raises when CUDA is asked for and there
    is no card: the port never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    return dev


@contextlib.contextmanager
def fp32_matmul():
    """Full-fp32 matrix products inside the block: TF32 off for matmuls
    (``torch.backends.cuda.matmul.allow_tf32 = False``) and for cuDNN
    (``torch.backends.cudnn.allow_tf32 = False``).

    The port's counterpart of ``jax.default_matmul_precision("highest")``
    around the JAX solver (staged_scalar.py:1004, fast_tube.py:373): the NN
    tube's Woodbury products lose the solver's feasibility in reduced
    precision. The previous flags are restored on exit.
    """
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
