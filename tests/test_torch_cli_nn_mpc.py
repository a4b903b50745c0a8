"""The port's ``cli mpc --tube-dyn NN_oneshot`` (the staged closed loop on
the NN tube, the first plan's verdict) against the JAX package's on the
CPU, at --N 10 --H 4 --H-rev 4, with the same one-shot net: the same keys,
numbers within 2e-3 (relative above 1), strings and flags exactly
(helpers: tests/test_torch_cli.py)."""
from tests.test_torch_cli import assert_same_record, both
from tests.torch_port_cases import (  # noqa: F401 (autouse fixture)
    one_torch_thread,
)


def test_mpc_nn_oneshot_matches_jax(tmp_path):
    rec, ref = both("mpc", ["--tube-dyn", "NN_oneshot", "--H", "4"],
                    tmp_path)
    assert_same_record(rec, ref)
