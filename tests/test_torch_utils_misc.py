"""The port's ``utils/profiling.py`` and ``utils/grids.py`` against the
JAX package's: ``flops_tube_solve`` gives the same numbers; the grid
helpers give equal arrays (the quaternion's direction within 1e-6);
``Timing`` spans and ``trace`` on the CPU."""
import json

import numpy as np
import pytest

from legged_gym_dev_tpu.utils import grids as jgrids
from legged_gym_dev_tpu.utils import profiling as jprof
from legged_gym_dev_tpu_torch.utils import grids, profiling
from tests.torch_port_cases import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("shape", [(2048, 50, 2, 2, 20, 10),
                                   (1024, 50, 4, 2, 20, 10),
                                   (1, 200, 5, 2, 5, 6),
                                   (8, 8, 3, 2, 8, 6)])
def test_flops_tube_solve_matches_jax(shape):
    assert profiling.flops_tube_solve(*shape) == jprof.flops_tube_solve(
        *shape)


def test_grids_match_jax():
    np.testing.assert_array_equal(
        grids.generate_grid_search_configs_2d(-1.0, 2.0, 5),
        jgrids.generate_grid_search_configs_2d(-1.0, 2.0, 5))
    np.testing.assert_array_equal(
        grids.generate_robot_grids(0.0, 1.0, 3, 4, 0.1,
                                   rng=np.random.default_rng(0)),
        jgrids.generate_robot_grids(0.0, 1.0, 3, 4, 0.1,
                                    rng=np.random.default_rng(0)))
    g = np.random.default_rng(1).normal(size=(4, 9, 2))
    np.testing.assert_array_equal(grids.add_zero_z_coordinate(g),
                                  jgrids.add_zero_z_coordinate(g))
    q = np.random.default_rng(2).normal(size=(6, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    for quat in (q, q[0], [0.0, 0.0, np.sin(0.4), np.cos(0.4)]):
        d = grids.quaternion_to_direction_vector(quat)
        assert d.dtype == np.float32
        np.testing.assert_allclose(
            d, jgrids.quaternion_to_direction_vector(quat), atol=1e-6)


def test_timing_spans_on_the_cpu():
    t = profiling.Timing()
    for _ in range(3):
        with t.span("work"):
            sum(range(20000))
    with t.span("other"):
        pass
    assert len(t.spans["work"]) == 3 and t.best("work") > 0.0
    assert t.best("work") == min(t.spans["work"])
    rep = t.report(work={"work": 1e6})
    lines = rep.splitlines()
    assert lines[0].startswith("work: ") and "(n=3)" in lines[0]
    assert "TFLOP/s" in lines[0] and "% of peak" in lines[0]
    assert lines[1].startswith("other: ") and "TFLOP/s" not in lines[1]


def test_trace_writes_a_chrome_trace(tmp_path):
    import torch

    with profiling.trace(str(tmp_path / "trace")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    events = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert any("mm" in e.get("name", "")
               for e in events["traceEvents"])
