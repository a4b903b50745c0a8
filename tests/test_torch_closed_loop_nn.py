"""The closed-loop check of tests/test_torch_closed_loop.py with the NN_oneshot
tube (Woodbury basis refreshed every 3 inner steps), in a file of its own
so that each file's JAX compile stays near a minute on one worker."""
from tests.test_torch_closed_loop import check_closed_loop
from tests.torch_port_cases import one_torch_thread  # noqa: F401


def test_closed_loop_matches_jax():
    check_closed_loop("NN_oneshot")
