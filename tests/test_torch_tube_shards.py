"""The port's shard writer and loaders against the JAX package's
(tests/test_native_loader.py, as JAX-against-port tests).

- ``write_rollout_shards`` writes the same bytes;
- ``window_srcmap`` and ``frames_for_variant`` give equal arrays;
- the port's native and numpy loaders give the same batches as JAX's for
  the same seed (one worker thread: with more, batches arrive in the order
  the workers finish), and as the in-memory dataset constructor;
- the port's library is built from its own source into ``build/`` and
  nothing under ``legged_gym_dev_tpu/`` changes.

Everything is exact (equal arrays and bytes). The native loader needs
``g++``; where it cannot be built the tests that need it fail rather than
skip, since the port's ``make_loader`` would then fall back silently.
"""
import filecmp
import os
from pathlib import Path

import numpy as np
import pytest

from legged_gym_dev_tpu.tube import datasets as jds
from legged_gym_dev_tpu.tube import shards as jsh
from legged_gym_dev_tpu_torch import native
from legged_gym_dev_tpu_torch.tube import datasets as tds
from legged_gym_dev_tpu_torch.tube import shards as tsh
from tests.torch_port_cases import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
VARIANTS = ["scalar", "scalar_recursive", "vector", "error"]


def make_rollout(rng, E=6, T=40, n=4, m=2):
    d = dict(z=rng.normal(size=(E, T + 1, n)).astype(np.float32),
             v=rng.normal(size=(E, T, m)).astype(np.float32),
             pz_x=rng.normal(size=(E, T + 1, n)).astype(np.float32),
             done=rng.uniform(size=(E, T)) < 0.05)
    return jds.RolloutData(**d), tds.RolloutData(**d)


@pytest.mark.parametrize("variant", VARIANTS)
def test_frames_and_shard_bytes_equal_jax(tmp_path, variant):
    rng = np.random.default_rng(0)
    parts = [make_rollout(rng), make_rollout(rng, E=3)]
    for a, b in zip(tsh.frames_for_variant(parts[0][1], variant),
                    jsh.frames_for_variant(parts[0][0], variant)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    pt = tsh.write_rollout_shards(str(tmp_path / "port"),
                                  [p[1] for p in parts], variant=variant)
    pj = jsh.write_rollout_shards(str(tmp_path / "jax"),
                                  [p[0] for p in parts], variant=variant)
    assert [os.path.basename(p) for p in pt] == [
        os.path.basename(p) for p in pj]
    for a, b in zip(pt, pj):
        assert filecmp.cmp(a, b, shallow=False), (a, b)


def test_window_srcmap_equals_jax():
    for T, N, dN in [(17, 1, 1), (17, 3, 1), (17, 3, 2), (17, 4, 5),
                     (80, 25, 1)]:
        np.testing.assert_array_equal(tsh.window_srcmap(T, N, dN),
                                      jsh.window_srcmap(T, N, dN))


def _epochs(loader, **kw):
    return [(x.copy(), y.copy()) for x, y in loader.epoch(**kw)]


@pytest.mark.parametrize("N,dN,variant", [(1, 1, "scalar"), (3, 2, "vector"),
                                          (2, 1, "error")])
def test_loaders_give_jax_batches(tmp_path, N, dN, variant):
    """Shuffled epochs of the port's native and numpy loaders equal the
    JAX package's, batch by batch, and an unshuffled native pass equals
    the dataset constructor."""
    rng = np.random.default_rng(1)
    parts = [make_rollout(rng), make_rollout(rng, E=4)]
    paths = tsh.write_rollout_shards(str(tmp_path), [p[1] for p in parts],
                                     variant=variant)
    m = parts[0][1].v.shape[-1]
    assert native.load_dataloader() is not None
    for t_cls, j_cls in ((tsh.NativeTubeLoader, jsh.NativeTubeLoader),
                         (tsh.NumpyTubeLoader, jsh.NumpyTubeLoader)):
        tl, jl = t_cls(paths, N=N, dN=dN), j_cls(paths, N=N, dN=dN)
        assert (tl.num_rows, tl.input_dim, tl.target_dim) == (
            jl.num_rows, jl.input_dim, jl.target_dim)
        for shuffle in (True, False):
            kw = dict(seed=7, batch=33, n_threads=1, shuffle=shuffle)
            bt, bj = _epochs(tl, **kw), _epochs(jl, **kw)
            assert len(bt) == len(bj)
            for (xt, yt), (xj, yj) in zip(bt, bj):
                np.testing.assert_array_equal(xt, xj)
                np.testing.assert_array_equal(yt, yj)
        tl.close()
        jl.close()
    if variant == "scalar":
        ref = tds.scalar_tube_dataset(tds.RolloutData.concatenate(
            [p[1] for p in parts]), N=N, dN=dN)
        ds = tsh.NativeTubeLoader(paths, N=N, dN=dN,
                                  n_zero_tail=m).load_all()
        np.testing.assert_array_equal(ds.data, ref.data)
        np.testing.assert_array_equal(ds.target, ref.target)


def test_threaded_epoch_and_make_loader(tmp_path):
    """A shuffled epoch on three threads yields every kept row once;
    ``make_loader`` takes the native loader where it builds."""
    rng = np.random.default_rng(2)
    _, r = make_rollout(rng, E=5, T=30)
    paths = tsh.write_rollout_shards(str(tmp_path), [r], variant="scalar")
    ld = tsh.make_loader(paths, N=2, dN=1)
    assert isinstance(ld, tsh.NativeTubeLoader)
    ref = ld.load_all()
    seen = np.concatenate([x for x, _ in ld.epoch(seed=7, batch=33,
                                                  n_threads=3)])
    assert seen.shape == ref.data.shape
    np.testing.assert_array_equal(seen[np.lexsort(seen.T)],
                                  ref.data[np.lexsort(ref.data.T)])
    ld.close()


def test_library_builds_under_build_from_the_port_source(tmp_path,
                                                         monkeypatch):
    """The port builds its own copy of the source into its build
    directory; the JAX package's native directory is left as it was."""
    jax_native = ROOT / "legged_gym_dev_tpu" / "native"

    def listing():
        return sorted((p.name, p.stat().st_size, p.stat().st_mtime_ns)
                      for p in jax_native.iterdir())

    before = listing()
    assert native.SOURCE == (ROOT / "legged_gym_dev_tpu_torch" / "csrc"
                             / "tube_dataloader.cc")
    assert native.library_path().parent == ROOT / "build" / "native"
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    lib = native.load_dataloader()
    assert lib is not None
    assert native.library_path().exists()
    assert native.library_path().parent == tmp_path / "native"
    assert listing() == before
