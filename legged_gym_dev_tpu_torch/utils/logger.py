"""Per-step state logger and dashboard plots.

Counterpart of ``legged_gym_dev_tpu/utils/logger.py``: accumulates
per-step state and reward dicts during evaluation rollouts, saves them as
a MATLAB ``.mat`` file, renders the 3x3 state dashboard with matplotlib
into a file, and prints per-term mean episode rewards. Values may be
tensors (on any device) or numpy arrays; each is stored on the host.
"""
from __future__ import annotations

import os
from collections import defaultdict
from typing import Dict, Optional

import numpy as np


def _host(value) -> np.ndarray:
    if hasattr(value, "detach"):
        value = value.detach().cpu().numpy()
    return np.asarray(value)


class Logger:
    def __init__(self, dt: float):
        self.dt = dt
        self.state_log = defaultdict(list)
        self.rew_log = defaultdict(list)
        self.num_episodes = 0

    def log_state(self, key: str, value) -> None:
        self.state_log[key].append(_host(value))

    def log_states(self, d: Dict) -> None:
        for k, v in d.items():
            self.log_state(k, v)

    def log_rewards(self, d: Dict, num_episodes: int) -> None:
        for k, v in d.items():
            if "rew" in k:
                self.rew_log[k].append(float(_host(v)) * num_episodes)
        self.num_episodes += num_episodes

    def reset(self) -> None:
        self.state_log.clear()
        self.rew_log.clear()
        self.num_episodes = 0

    def save_mat(self, path: str) -> str:
        """The accumulated state log as a MATLAB .mat file (one stacked
        array per key, and ``dt``)."""
        from scipy.io import savemat

        payload = {k: np.stack(v) for k, v in self.state_log.items()}
        payload["dt"] = self.dt
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        savemat(path, payload)
        return path

    def plot_states(self, path: Optional[str] = None):
        """The 3x3 dashboard, saved to ``path`` when given; returns the
        figure."""
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        log = {k: np.stack(v) for k, v in self.state_log.items() if v}
        fig, axs = plt.subplots(3, 3, figsize=(14, 10))
        time = None
        for v in log.values():
            time = np.linspace(0, len(v) * self.dt, len(v))
            break

        panels = [
            ("dof_pos", "dof_pos_target", "DOF Position [rad]"),
            ("dof_vel", "dof_vel_target", "DOF Velocity [rad/s]"),
            ("base_vel_x", "command_x", "Base vel x [m/s]"),
            ("base_vel_y", "command_y", "Base vel y [m/s]"),
            ("base_vel_yaw", "command_yaw", "Base vel yaw [rad/s]"),
            ("base_vel_z", None, "Base vel z [m/s]"),
            ("contact_forces_z", None, "Contact force z [N]"),
            ("dof_torque", None, "Joint torque [Nm]"),
            ("tracking_error", None, "Tracking error"),
        ]
        for ax, (key, tgt, title) in zip(axs.flat, panels):
            if key in log:
                ax.plot(time[: len(log[key])], log[key], label="measured")
            if tgt and tgt in log:
                ax.plot(time[: len(log[tgt])], log[tgt], label="target")
            ax.set(xlabel="time [s]", title=title)
            ax.legend(fontsize=6)
        fig.tight_layout()
        if path:
            fig.savefig(path, dpi=100)
        return fig

    def print_rewards(self) -> None:
        print("Average rewards per second:")
        for k, v in self.rew_log.items():
            mean = np.sum(np.array(v)) / max(self.num_episodes, 1)
            print(f" - {k}: {mean}")
        print(f"Total number of episodes: {self.num_episodes}")
