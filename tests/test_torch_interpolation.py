"""The port's interpolation (mesh/interpolation.py) and spectra
(common/spectra.py) against the JAX package's, in float64 on the CPU:

- ``InterpolationBrick`` exact (1e-12 of the field's largest value) for
  polynomials of degree up to p, and equal to the JAX interpolator within
  1e-12 on a random nodal field, whole and in small point chunks;
- ``InterpolationCubedSphere`` on a 2 × 2 p3 sphere against the JAX one
  within 1e-12, on a smooth field, a random field and a var-major
  vector; the nodal radius interpolates to the target radii;
- ``project_cubed_sphere`` and every spectrum function against JAX
  within 1e-12.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climatemachine_tpu.common import spectra as jsp
from climatemachine_tpu.mesh import interpolation as jitp
from climatemachine_tpu.mesh.grid import make_grid as jax_make_grid
from climatemachine_tpu.mesh.topology import (
    stacked_brick_topology as jax_stacked_brick,
    stacked_cubed_sphere_topology as jax_stacked_sphere)
from climatemachine_tpu_torch.common import spectra as sp
from climatemachine_tpu_torch.mesh import interpolation as itp
from climatemachine_tpu_torch.mesh.grid import make_grid
from climatemachine_tpu_torch.mesh.topology import (
    stacked_brick_topology, stacked_cubed_sphere_topology)
from climatemachine_tpu_torch.physics.parameters import EARTH

L = 1000.0
A = EARTH.planet_radius
BOUNDARY = np.array([[0, 0], [0, 0], [1, 2]])


def _bricks(poly, nx=3, nz=4):
    r = [np.linspace(0, L, nx + 1)] * 2 + [np.linspace(0, L, nz + 1)]
    per = (True, True, False)
    return (jax_make_grid(jax_stacked_brick(r, per, BOUNDARY), poly,
                          dtype=np.float64),
            make_grid(stacked_brick_topology(r, per, BOUNDARY), poly,
                      dtype=torch.float64, device="cpu"))


def _spheres(n_horz=2, n_vert=2, poly=3):
    vr = A + np.linspace(0.0, 30e3, n_vert + 1)
    return (jax_make_grid(jax_stacked_sphere(n_horz, vr), poly,
                          dtype=np.float64),
            make_grid(stacked_cubed_sphere_topology(n_horz, vr), poly,
                      dtype=torch.float64, device="cpu"))


def _rel(got, ref):
    ref = np.asarray(ref)
    return np.max(np.abs(np.asarray(got) - ref)) / np.max(np.abs(ref))


PTS = (np.linspace(10, 990, 7), np.linspace(5, 995, 5),
       np.linspace(1, 999, 6))


@pytest.mark.parametrize("poly", [1, 2, 3, 4])
def test_brick_exact_for_polynomials(poly):
    """A polynomial of degree p in each coordinate interpolates exactly
    at order p."""
    _, g = _bricks(poly)
    x, y, z = (g.coords[..., i] for i in range(3))
    f = lambda x, y, z: (x / L) ** poly + 3 * (y / L) ** poly * (z / L) \
        + (z / L) ** poly + 1.0
    out = itp.InterpolationBrick(g, *PTS)(f(x, y, z)).numpy()
    X, Y, Z = np.meshgrid(*PTS, indexing="ij")
    assert out.shape == X.shape
    assert _rel(out, f(X, Y, Z)) < 1e-12


def test_brick_matches_jax_and_chunks(monkeypatch):
    gj, g = _bricks(4)
    f = np.random.default_rng(0).standard_normal((g.nelem, g.Np))
    ref = np.asarray(jitp.InterpolationBrick(gj, *PTS)(jnp.asarray(f)))
    whole = itp.InterpolationBrick(g, *PTS)(torch.tensor(f)).numpy()
    monkeypatch.setattr(itp, "CHUNK_POINTS", 17)
    chunked = itp.InterpolationBrick(g, *PTS)(torch.tensor(f)).numpy()
    assert _rel(whole, ref) < 1e-12
    assert np.array_equal(whole, chunked)


LATS = np.linspace(-85.0, 85.0, 9)
LONS = np.linspace(-180.0, 165.0, 24)
RADS = A + np.linspace(1e3, 29e3, 5)


def test_cubed_sphere_matches_jax():
    gj, g = _spheres()
    jin = jitp.InterpolationCubedSphere(gj, LATS, LONS, RADS)
    pin = itp.InterpolationCubedSphere(g, LATS, LONS, RADS)
    np.testing.assert_array_equal(pin.elem.numpy(), np.asarray(jin.elem))
    c = g.coords.numpy()
    r = np.linalg.norm(c, axis=-1)
    lat = np.arcsin(c[..., 2] / r)
    lon = np.arctan2(c[..., 1], c[..., 0])
    smooth = np.sin(lat) ** 2 + np.cos(lat) * np.cos(lon) + (r - A) / 30e3
    rand = np.random.default_rng(1).standard_normal((g.nelem, g.Np))
    for f in (smooth, rand, r):
        ref = np.asarray(jin(jnp.asarray(f)))
        got = pin(torch.tensor(f)).numpy()
        assert got.shape == (len(LATS), len(LONS), len(RADS))
        assert _rel(got, ref) < 1e-12
    # the radius is affine in ξ₃: the interpolated radius is the target's
    got = pin(torch.tensor(r)).numpy()
    assert np.max(np.abs(got - RADS) / RADS) < 1e-12
    # a var-major vector [E, 3, Np] → [lat, lon, rad, 3], as JAX's [E, Np, 3]
    vec = np.random.default_rng(2).standard_normal((g.nelem, g.Np, 3))
    ref = np.asarray(jin(jnp.asarray(vec)))
    got = pin(torch.tensor(vec.transpose(0, 2, 1).copy())).numpy()
    assert got.shape == ref.shape and _rel(got, ref) < 1e-12


def test_cubed_sphere_radial_interfaces():
    """The stack's radii that the interpolator takes from the grid's
    nodes equal the topology's."""
    _, g = _spheres()
    vr = A + np.linspace(0.0, 30e3, 3)
    assert np.max(np.abs(itp._radial_interfaces(g) - vr) / vr) < 1e-15


def test_project_cubed_sphere_matches_jax():
    vec = np.random.default_rng(4).standard_normal(
        (len(LATS), len(LONS), len(RADS), 3))
    ref = np.asarray(jitp.project_cubed_sphere(
        (jnp.asarray(LATS), jnp.asarray(LONS)), jnp.asarray(vec)))
    got = itp.project_cubed_sphere((LATS, LONS), vec)
    assert got.shape == ref.shape
    assert _rel(got, ref) < 1e-12


def test_spectra_match_jax():
    rng = np.random.default_rng(5)
    u, v, w = rng.standard_normal((3, 8, 8, 8))
    for got, ref in zip(sp.power_spectrum_3d(u, v, w, L),
                        jsp.power_spectrum_3d(u, v, w, L)):
        assert _rel(got, ref) < 1e-12
    f = rng.standard_normal((9, 16, 3))
    wts = np.cos(np.deg2rad(np.linspace(-80, 80, 9)))
    assert _rel(sp.power_spectrum_1d(f, wts),
                jsp.power_spectrum_1d(f, wts)) < 1e-12
    assert _rel(sp.power_spectrum_1d(f), jsp.power_spectrum_1d(f)) < 1e-12
    for a, b in zip(sp.gaussian_latitudes(12), jsp.gaussian_latitudes(12)):
        assert _rel(a, b) < 1e-12
    assert _rel(sp.gaussian_lats_deg(12), jsp.gaussian_lats_deg(12)) < 1e-12
    sinlat, wg = sp.gaussian_latitudes(12)
    P = sp.legendre_table(5, 8, sinlat)
    assert _rel(P, jsp.legendre_table(5, 8, sinlat)) < 1e-12
    g = rng.standard_normal((16, 12, 2))
    assert _rel(sp.spherical_transform(g, P, wg),
                jsp.spherical_transform(g, P, wg)) < 1e-12
    assert _rel(sp.power_spectrum_2d(g, P, wg),
                jsp.power_spectrum_2d(g, P, wg)) < 1e-12
