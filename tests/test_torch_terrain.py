"""The port's terrain (``utils/terrain.py``) and contact on terrain against
the JAX package, on numpy-drawn inputs.

- Generation (numpy on the host in both): ``height_field_raw`` and
  ``env_origins`` bit-identical for the curriculum, selected and
  randomized forms on small grids (2x2, and 2x8 with all eight families).
- The heightfield sampler ``make_terrain_fn`` (height, and the analytic
  gradient of its ``value_and_grad``) at random points, on pixel edges and
  in the border, and ``height_scan``: atol 1e-6 (the same float32 ops in
  the same order; heights of at most a meter).
- ``contact_forces`` on terrain through ``value_and_grad`` (the
  heightfield) and through autodiff (an analytic height function without
  one): rtol=atol=1e-5.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from legged_gym_dev_tpu.sim.contact import ContactParams as JaxContact
from legged_gym_dev_tpu.sim.contact import contact_forces as jax_contact
from legged_gym_dev_tpu.utils import terrain as jterrain
from legged_gym_dev_tpu_torch.interop import terrain_from_numpy
from legged_gym_dev_tpu_torch.sim.contact import ContactParams, contact_forces
from legged_gym_dev_tpu_torch.utils import terrain as tterrain
from tests.torch_port_cases import one_torch_thread  # noqa: F401

ALL_FAMILIES = (0.1, 0.1, 0.15, 0.15, 0.1, 0.2, 0.1, 0.1)
FORMS = {
    "curriculum": dict(num_rows=2, num_cols=2, curriculum=True),
    "curriculum_all_families": dict(num_rows=2, num_cols=8, curriculum=True,
                                    terrain_proportions=ALL_FAMILIES),
    "randomized": dict(num_rows=2, num_cols=2),
    "randomized_all_families": dict(num_rows=2, num_cols=2,
                                    terrain_proportions=ALL_FAMILIES),
    "selected_slope": dict(num_rows=2, num_cols=2, selected=True,
                           terrain_kwargs={"type": "pyramid_sloped_terrain",
                                           "slope": 0.3,
                                           "platform_size": 2.0}),
    "selected_stairs": dict(num_rows=2, num_cols=2, selected=True,
                            terrain_kwargs={"type": "pyramid_stairs_terrain",
                                            "step_width": 0.4,
                                            "step_height": -0.1}),
}


def both(form, seed=0):
    kw = FORMS[form]
    return (jterrain.Terrain(jterrain.TerrainCfg(**kw), 8, seed=seed),
            tterrain.Terrain(tterrain.TerrainCfg(**kw), 8, seed=seed))


@pytest.mark.parametrize("form", sorted(FORMS))
def test_generation_is_bit_identical(form):
    jt, tt = both(form, seed=3)
    assert tt.height_field_raw.dtype == np.int16
    np.testing.assert_array_equal(tt.height_field_raw, jt.height_field_raw)
    np.testing.assert_array_equal(tt.env_origins, jt.env_origins)
    assert np.abs(tt.height_field_raw).max() > 0


def test_subterrain_registry_and_plane():
    assert sorted(tterrain.SUBTERRAIN_REGISTRY) == sorted(
        jterrain.SUBTERRAIN_REGISTRY)
    fn = tterrain.Terrain(tterrain.TerrainCfg(mesh_type="plane"), 4)\
        .make_terrain_fn(device="cpu")
    h, g = fn.value_and_grad(torch.ones(3, 2))
    assert h.shape == (3,) and g.shape == (3, 2)
    assert not h.any() and not g.any() and not fn(torch.ones(5, 2)).any()


def sample_points(terrain, n, seed):
    """Random points over the grid and its border, points on pixel edges
    (x or y a whole number of pixels from the origin of the heightfield)
    and points outside the heightfield."""
    cfg = terrain.cfg
    rng = np.random.default_rng(seed)
    H, W = terrain.height_field_raw.shape
    hs, b = cfg.horizontal_scale, cfg.border_size
    lo, hi = -b, np.array([H, W]) * hs - b
    pts = [rng.uniform(lo, hi, (n, 2)),
           rng.uniform(-1.0, 1.0, (n, 2)) + terrain.env_origins[0, 0, :2]]
    edges = rng.integers(0, min(H, W) - 1, (n, 2)) * hs - b
    edges[: n // 2, 1] = rng.uniform(lo, hi[1], n // 2)
    pts += [edges, np.asarray([[lo - 3.0, 0.0], [0.0, hi[1] + 2.0],
                               [hi[0] + 1.0, hi[1] + 1.0]])]
    return np.concatenate(pts).astype(np.float32)


@pytest.mark.parametrize("form", ["curriculum_all_families", "randomized"])
def test_terrain_fn_matches_jax(form):
    jt, tt = both(form, seed=1)
    xy = sample_points(jt, 200, seed=2)
    jfn, tfn = jt.make_terrain_fn(), tt.make_terrain_fn(device="cpu")
    hj, gj = jfn.value_and_grad(jnp.asarray(xy))
    ht, gt = tfn.value_and_grad(torch.as_tensor(xy))
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), rtol=0, atol=1e-6)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tfn(torch.as_tensor(xy)).numpy(),
                               np.asarray(jfn(jnp.asarray(xy))), rtol=0,
                               atol=1e-6)
    assert float(np.abs(np.asarray(gj)).max()) > 0.1   # not all flat
    # the port's copy of a JAX terrain samples the same
    cp = terrain_from_numpy(jt).make_terrain_fn(device="cpu")
    torch.testing.assert_close(cp(torch.as_tensor(xy)),
                               tfn(torch.as_tensor(xy)), rtol=0, atol=0)
    assert dataclasses.asdict(terrain_from_numpy(jt).cfg) == \
        dataclasses.asdict(jt.cfg)


def test_height_scan_matches_jax():
    jt, tt = both("curriculum", seed=0)
    rng = np.random.default_rng(5)
    B = 6
    pos = np.concatenate([jt.env_origins.reshape(-1, 3)[rng.integers(0, 4, B),
                                                         :2]
                          + rng.uniform(-2, 2, (B, 2)),
                          rng.uniform(0.4, 0.7, (B, 1))], 1)
    q = rng.normal(size=(B, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    px = tuple(np.round(np.arange(-0.8, 0.81, 0.1), 2))
    py = tuple(np.round(np.arange(-0.5, 0.51, 0.1), 2))
    ref = jterrain.height_scan(jt.make_terrain_fn(),
                               jnp.asarray(pos, jnp.float32),
                               jnp.asarray(q, jnp.float32), px, py)
    out = tterrain.height_scan(tt.make_terrain_fn(device="cpu"),
                               torch.as_tensor(pos, dtype=torch.float32),
                               torch.as_tensor(q, dtype=torch.float32), px,
                               py)
    assert out.shape == (B, 187)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-6)


def contact_case(seed, B=16, nc=5, origin=(0.0, 0.0)):
    rng = np.random.default_rng(seed)
    pos = rng.normal(0, 0.4, (B, nc, 3)).astype(np.float32)
    pos[..., :2] += np.asarray(origin, np.float32)
    vel = rng.normal(0, 1.0, (B, nc, 3)).astype(np.float32)
    radius = rng.uniform(0.02, 0.06, nc).astype(np.float32)
    kw = dict(friction=rng.uniform(0.5, 1.25, (B, 1, 1)).astype(np.float32),
              stiffness=np.float32(5000.0), damping=np.float32(50.0))
    return pos, vel, radius, kw


def test_contact_on_heightfield_matches_jax():
    """The heightfield's fused height and gradient (``value_and_grad``)."""
    jt, tt = both("curriculum_all_families", seed=4)
    pos, vel, radius, kw = contact_case(6, origin=jt.env_origins[1, 2, :2])
    jfn = jt.make_terrain_fn()
    hj = np.asarray(jfn(jnp.asarray(pos[..., :2])))
    pos[..., 2] = hj + np.random.default_rng(1).uniform(
        -0.05, 0.05, hj.shape)
    ref = jax_contact(JaxContact.create(**kw), jnp.asarray(pos),
                      jnp.asarray(vel), jnp.asarray(radius), jfn)
    out = contact_forces(ContactParams.create(**kw, device="cpu"),
                         torch.as_tensor(pos), torch.as_tensor(vel),
                         torch.as_tensor(radius),
                         tt.make_terrain_fn(device="cpu"))
    assert float(np.abs(np.asarray(ref)).max()) > 10.0
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_contact_by_autodiff_matches_jax():
    """An analytic height function without ``value_and_grad``: the normal
    from ``torch.func.grad`` against ``jax.grad``."""
    pos, vel, radius, kw = contact_case(7)

    def jfn(xy):
        return 0.1 * jnp.sin(2.0 * xy[..., 0]) * jnp.cos(xy[..., 1])

    def tfn(xy):
        return 0.1 * torch.sin(2.0 * xy[..., 0]) * torch.cos(xy[..., 1])

    pos[..., 2] = np.asarray(jfn(jnp.asarray(pos[..., :2]))) + \
        np.random.default_rng(2).uniform(-0.05, 0.05, pos.shape[:2])
    ref = jax_contact(JaxContact.create(**kw), jnp.asarray(pos),
                      jnp.asarray(vel), jnp.asarray(radius), jfn)
    out = contact_forces(ContactParams.create(**kw, device="cpu"),
                         torch.as_tensor(pos), torch.as_tensor(vel),
                         torch.as_tensor(radius), tfn)
    g = jax.vmap(jax.grad(lambda p: jfn(p[None])[0]))(
        jnp.asarray(pos[..., :2].reshape(-1, 2)))
    assert float(jnp.abs(g).max()) > 0.1                # a sloped surface
    assert float(np.abs(np.asarray(ref)).max()) > 10.0
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
