"""The port's ``cli plan`` against the JAX package's, in one process on
the CPU (``--cpu``), at --N 10 --H-rev 4: the staged path (l1, l2; with
the restoration verdict), the generic path (the rolling tubes, and
``--generic``) and ``--nominal``. The JSON lines carry the same keys;
numbers agree within 2e-3 (relative above 1: the objective is O(300)),
strings and flags exactly; the ``.mat`` plans agree within 2e-3. The
port checks a one-shot net's widths against --N and --H-rev as the JAX
package does (the same numpy weights in each package's model file: the
JAX package's pickle, the port's ``save_mlp``).

``cli mpc`` is held in tests/test_torch_cli_mpc.py, both commands with the
NN_oneshot tube in tests/test_torch_cli_nn_plan.py and
tests/test_torch_cli_nn_mpc.py (each file keeps to about two minutes).
"""
import contextlib
import io
import json
import pickle

import numpy as np
import pytest
from scipy.io import loadmat

from legged_gym_dev_tpu import cli as jax_cli
from legged_gym_dev_tpu.tube.models import MLP as JaxMLP
from legged_gym_dev_tpu_torch import cli
from legged_gym_dev_tpu_torch.interop import mlp_from_numpy
from legged_gym_dev_tpu_torch.tube.models import save_mlp
from tests.torch_port_cases import (
    mlp_weights,
    one_torch_thread,  # noqa: F401 (autouse fixture)
)

N, H_REV = 10, 4
TOL = 2e-3


def run(main, argv):
    """``main(argv)``'s last stdout line that holds JSON."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv + ["--cpu"])
    return json.loads([ln for ln in buf.getvalue().splitlines()
                       if ln.startswith("{")][-1])


def tube_models(tmp_path, n_in=H_REV + (H_REV + N) * 2, n_out=N):
    """The same one-shot net in each package's model file."""
    ws, bs = mlp_weights(n_in, n_out, 16, seed=11)
    jax_path, port_path = tmp_path / "tube.pkl", tmp_path / "tube.pt"
    with open(jax_path, "wb") as f:
        pickle.dump(JaxMLP(weights=tuple(ws), biases=tuple(bs),
                           final_activation="softplus"), f)
    save_mlp(mlp_from_numpy(ws, bs, final_activation="softplus",
                            device="cpu"), port_path)
    return str(jax_path), str(port_path)


def assert_same_record(rec, ref):
    assert sorted(rec) == sorted(ref)
    for k, v in ref.items():
        if isinstance(v, (bool, str, dict)):
            assert rec[k] == v, (k, rec[k], v)
        else:
            assert abs(rec[k] - v) <= TOL * max(1.0, abs(v)), (k, rec[k], v)


def both(cmd, extra, tmp_path, mat=None):
    """(port record, JAX record) of ``cmd`` with ``extra`` flags; NN tube
    flags get each package's model file. With ``mat`` (the arrays to hold)
    each writes a ``.mat`` file, and the files must agree."""
    jax_argv = [cmd, "--N", str(N), "--H-rev", str(H_REV)] + extra
    port_argv = list(jax_argv)
    if "NN_oneshot" in extra:
        jax_model, port_model = tube_models(tmp_path)
        jax_argv += ["--tube-model", jax_model]
        port_argv += ["--tube-model", port_model]
    if mat:
        port_argv += ["--out", str(tmp_path / "port.mat")]
        jax_argv += ["--out", str(tmp_path / "jax.mat")]
    rec, ref = run(cli.main, port_argv), run(jax_cli.main, jax_argv)
    if mat:
        outs = [loadmat(tmp_path / f) for f in ("port.mat", "jax.mat")]
        keys = [sorted(k for k in o if not k.startswith("__")) for o in outs]
        assert keys[0] == keys[1]
        for k in mat:
            assert outs[0][k].shape == outs[1][k].shape, k
            assert np.abs(outs[0][k] - outs[1][k]).max() < TOL, k
    return rec, ref


@pytest.mark.parametrize("extra", [
    ["--tube-dyn", "l1"], ["--tube-dyn", "l2"], ["--tube-dyn", "l1_rolling"],
    ["--tube-dyn", "l2_rolling"], ["--tube-dyn", "l1", "--generic"],
    ["--nominal"]], ids=lambda e: "-".join(a.strip("-") for a in e))
def test_plan_matches_jax(extra, tmp_path):
    mat = ("z", "v", "w") if extra == ["--tube-dyn", "l1"] else None
    rec, ref = both("plan", extra, tmp_path, mat=mat)
    assert_same_record(rec, ref)


@pytest.mark.parametrize("n_in,n_out", [(H_REV + (H_REV + N) * 2, N + 1),
                                        (H_REV + (H_REV + N) * 2 + 1, N)],
                         ids=["output", "input"])
def test_tube_model_widths_checked_as_jax(n_in, n_out, tmp_path):
    jax_model, port_model = tube_models(tmp_path, n_in, n_out)
    argv = ["plan", "--N", str(N), "--H-rev", str(H_REV), "--tube-dyn",
            "NN_oneshot", "--cpu", "--tube-model"]
    with pytest.raises(SystemExit) as port_exc:
        cli.main(argv + [port_model])
    with pytest.raises(SystemExit) as jax_exc:
        jax_cli.main(argv + [jax_model])
    assert str(port_exc.value) == str(jax_exc.value)
    with pytest.raises(SystemExit, match="requires --tube-model"):
        cli.main(argv[:-1])
