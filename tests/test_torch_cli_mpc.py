"""The port's ``cli mpc`` against the JAX package's on the CPU, at --N 10
--H 4 --H-rev 4: the staged closed loop with the execution gate and the
first plan's verdict (l1, l2), the generic one (the rolling tubes, and
``--generic``). The same keys, numbers within 2e-3 (relative above 1),
strings, flags and the verdict counts exactly; the ``.mat`` traces of the
staged l1 loop agree within 2e-3 (helpers: tests/test_torch_cli.py)."""
import pytest

from tests.test_torch_cli import assert_same_record, both
from tests.torch_port_cases import (  # noqa: F401 (autouse fixture)
    one_torch_thread,
)


@pytest.mark.parametrize("extra", [
    ["--tube-dyn", "l1"], ["--tube-dyn", "l2"], ["--tube-dyn", "l1_rolling"],
    ["--tube-dyn", "l2_rolling"], ["--tube-dyn", "l2", "--generic"]],
    ids=lambda e: "-".join(a.strip("-") for a in e))
def test_mpc_matches_jax(extra, tmp_path):
    mat = (("z", "v", "w", "pz_x", "adopted")
           if extra == ["--tube-dyn", "l1"] else None)
    rec, ref = both("mpc", extra + ["--H", "4"], tmp_path, mat=mat)
    assert_same_record(rec, ref)
