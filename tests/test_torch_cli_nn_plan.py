"""The port's ``cli plan --tube-dyn NN_oneshot`` (the staged Woodbury
path with the restoration verdict) against the JAX package's on the CPU,
at --N 10 --H-rev 4, with the same one-shot net (numpy weights in each
package's model file): the same keys, numbers within 2e-3 (relative above
1), the verdict exactly; the ``.mat`` plans within 2e-3 (helpers:
tests/test_torch_cli.py)."""
from tests.test_torch_cli import assert_same_record, both
from tests.torch_port_cases import (  # noqa: F401 (autouse fixture)
    one_torch_thread,
)


def test_plan_nn_oneshot_matches_jax(tmp_path):
    rec, ref = both("plan", ["--tube-dyn", "NN_oneshot"], tmp_path,
                    mat=("z", "v", "w"))
    assert_same_record(rec, ref)
