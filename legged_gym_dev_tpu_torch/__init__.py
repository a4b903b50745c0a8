"""PyTorch/CUDA port of ``legged_gym_dev_tpu``.

The JAX package beside this one is the reference; every module here mirrors
the module of the same path there. Plain tensor code is PyTorch; the TPU's
Pallas kernels become CUDA C++ kernels for Hopper (``csrc/``), each with a
plain PyTorch version beside its wrapper (``ops/``).

Device rule: entry points take ``device=None``, which means the CUDA card;
without one they raise instead of running on the CPU. Pass ``device="cpu"``
to run on the CPU (the tests do). Solver code runs in full fp32 with TF32
off (``utils.runtime.fp32_matmul``).
"""
__version__ = "0.1.0"

# Headless GL for mujoco.Renderer (utils/video.py, utils/live_viewer.py):
# a machine without a display initializes Mesa's EGL only on the
# surfaceless platform. mujoco reads MUJOCO_GL when it is imported, so the
# defaults are in place before anything imports it.
import os as _os

_os.environ.setdefault("MUJOCO_GL", "egl")
_os.environ.setdefault("EGL_PLATFORM", "surfaceless")
del _os

from .utils.runtime import fp32_matmul, resolve_device

__all__ = ["fp32_matmul", "resolve_device"]
