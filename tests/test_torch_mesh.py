"""The port's device mesh (``legged_gym_dev_tpu_torch/parallel/mesh.py``)
on CPU shards: the meshes' shapes and axis names, the too-few-devices and
no-card errors, ``shard_batch``'s rule (JAX's: a leaf shards when its
leading dim divides by the mesh size and, given ``batch_size``, equals
it), ``replicate``, a bit-exact ``gather`` round trip, ``map_shards``,
``shard_generators``, ``tree_bytes`` and ``place``. The module compares
nothing with the JAX package.
"""
import dataclasses

import numpy as np
import pytest
import torch

from legged_gym_dev_tpu_torch.parallel import mesh as pm
from tests.torch_port_cases import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")


def _cpus(n):
    return [CPU] * n


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_make_mesh_shape_and_axis(n):
    mesh = pm.make_mesh(n, devices=_cpus(8))
    assert mesh.axis_names == ("dp",)
    assert mesh.shape == {"dp": n}
    assert mesh.size == n and mesh.devices.shape == (n,)
    assert all(d == CPU for d in mesh.devices.flat)
    assert pm.make_mesh(n, axis="env", devices=_cpus(n)).axis_names == \
        ("env",)


def test_make_mesh_needs_enough_devices_and_a_card(monkeypatch):
    with pytest.raises(ValueError, match="need 4 devices"):
        pm.make_mesh(4, devices=_cpus(3))
    with pytest.raises(ValueError, match=r"need 8 devices for a \(2, 4\)"):
        pm.make_host_mesh(2, 4, devices=_cpus(7))
    # without devices a mesh is of CUDA cards: none here, so it raises
    # rather than landing on the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: pm.make_mesh(), lambda: pm.make_mesh(2),
                 lambda: pm.make_host_mesh(1, 2)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


def test_make_host_mesh_two_axes():
    mesh = pm.make_host_mesh(2, 4, devices=_cpus(8))
    assert mesh.axis_names == ("dcn", "ici")
    assert mesh.devices.shape == (2, 4)
    assert mesh.shape == {"dcn": 2, "ici": 4} and mesh.size == 8
    assert mesh.extent(("dcn", "ici")) == 8
    with pytest.raises(ValueError, match="not in the mesh"):
        mesh.extent("dp")
    with pytest.raises(ValueError, match="every mesh axis"):
        mesh.extent("ici")


@dataclasses.dataclass
class _State:
    obs: torch.Tensor            # (B, 3)
    sea: torch.Tensor            # (2, B nj, 8): an LSTM carry
    ranges: torch.Tensor         # (4, 2): a command-range table
    scale: torch.Tensor          # ()
    gen: torch.Generator
    step: int


def _state(B, nj=3):
    g = torch.Generator().manual_seed(0)
    return _State(obs=torch.randn(B, 3, generator=g),
                  sea=torch.randn(2, B * nj, 8, generator=g),
                  ranges=torch.randn(4, 2, generator=g),
                  scale=torch.tensor(2.0), gen=g, step=5)


@pytest.mark.parametrize("k", [2, 4])
def test_shard_batch_batch_size_rule(k):
    """With ``batch_size`` only the batch leaves shard: the (2, B nj, 8)
    carry and the (4, 2) table stay whole on every shard. Without it the
    divisibility rule alone takes the table too at mesh sizes 2 and 4, as
    in JAX (the reason for ``batch_size``)."""
    B = 8
    st = _state(B)
    mesh = pm.make_mesh(k, devices=_cpus(k))
    sh = pm.shard_batch(st, mesh, batch_size=B)
    assert len(sh) == k and sh.batch_size == B
    for i, s in enumerate(sh):
        b = B // k
        assert torch.equal(s.obs, st.obs[i * b:(i + 1) * b])
        assert s.obs.data_ptr() != st.obs.data_ptr()   # its own copy
        assert s.sea is st.sea and s.ranges is st.ranges
        assert s.scale is st.scale and s.gen is st.gen and s.step == 5
    loose = pm.shard_batch(st, mesh)
    assert loose[0].ranges.shape == (4 // k, 2)        # the heuristic
    assert loose[0].sea.shape == (2 // k, B * 3, 8) if k == 2 else \
        loose[0].sea is st.sea


def test_shard_batch_over_a_host_mesh():
    mesh = pm.make_host_mesh(2, 2, devices=_cpus(4))
    x = torch.arange(16.0).reshape(8, 2)
    sh = pm.shard_batch(x, mesh, axis=("dcn", "ici"), batch_size=8)
    assert [s[:, 0].tolist() for s in sh] == [[0.0, 2.0], [4.0, 6.0],
                                              [8.0, 10.0], [12.0, 14.0]]
    with pytest.raises(ValueError):
        pm.shard_batch(x, mesh)                  # axis "dp" is not there


def test_replicate_shares_values_and_copies_modules():
    mesh = pm.make_mesh(3, devices=_cpus(3))
    net = torch.nn.Linear(4, 2)
    tree = {"w": torch.ones(3), "net": net, "n": 7}
    rep = pm.replicate(tree, mesh)
    assert all(r["w"] is tree["w"] and r["n"] == 7 for r in rep)
    assert rep[0]["net"] is net
    for r in rep[1:]:
        assert r["net"] is not net
        for a, b in zip(r["net"].parameters(), net.parameters()):
            assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()


@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_gather_round_trip_is_bit_exact(k):
    B = 16
    st = _state(B)
    mesh = pm.make_mesh(k, devices=_cpus(k))
    back = pm.gather(pm.shard_batch(st, mesh, batch_size=B))
    assert torch.equal(back.obs, st.obs)
    assert torch.equal(back.sea, st.sea)           # replicated: shard 0's
    assert torch.equal(back.ranges, st.ranges)
    assert back.step == 5


def test_map_shards_runs_each_shard():
    mesh = pm.make_mesh(4, devices=_cpus(4))
    x = torch.arange(8.0)
    out = pm.map_shards(lambda a, s, c=0: a * s + c,
                        pm.shard_batch(x, mesh), 2.0, c=1.0)
    assert [o.tolist() for o in out] == [[1.0, 3.0], [5.0, 7.0],
                                        [9.0, 11.0], [13.0, 15.0]]
    assert torch.equal(pm.gather(out), x * 2 + 1)
    with pytest.raises(ValueError, match="Sharded"):
        pm.map_shards(lambda a: a, x)


def test_shard_generators_seed_shard_zero_as_unsharded():
    mesh = pm.make_mesh(3, devices=_cpus(3))
    gens = pm.shard_generators(mesh, 42)
    ref = torch.Generator().manual_seed(42)
    assert torch.equal(torch.rand(5, generator=gens[0]),
                       torch.rand(5, generator=ref))
    draws = [torch.rand(5, generator=g) for g in gens[1:]]
    assert not torch.equal(draws[0], draws[1])


def test_tree_bytes():
    net = torch.nn.Linear(4, 2)               # 8 weights + 2 biases
    tree = {"a": torch.zeros(3, 5), "b": [torch.zeros(2, dtype=torch.int64),
                                          net], "c": np.zeros(100)}
    assert pm.tree_bytes(tree) == 4 * 15 + 8 * 2 + 4 * 10


def test_place_moves_tensors_modules_and_heightfields():
    """``place`` keeps what already lies on the device and moves the rest:
    a module is copied there, and a heightfield sampler (its table held
    in a closure) is rebuilt there (the ``meta`` device stands in for a
    second card)."""
    from legged_gym_dev_tpu_torch.utils import terrain

    fn = terrain.Terrain(terrain.TerrainCfg(num_rows=2, num_cols=2), 4,
                         seed=0).make_terrain_fn(device="cpu")
    net = torch.nn.Linear(2, 2)
    tree = {"x": torch.ones(2), "net": net, "terrain": fn, "k": 3}
    assert pm.place(tree, CPU) is tree
    meta = pm.place(tree, "meta")
    assert meta["x"].device.type == "meta" and meta["k"] == 3
    assert meta["net"] is not net and meta["net"].weight.device.type == "meta"
    assert meta["terrain"].device.type == "meta"
    assert meta["terrain"](torch.zeros(3, 2, device="meta")).shape == (3,)
