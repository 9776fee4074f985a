"""Shared set-up of the split-explicit parity tests
(test_torch_shallow_water.py, test_torch_split_explicit.py,
test_torch_ivdc.py): the 2-D bricks of the barotropic side in both
packages, float64 on the CPU, the port's grid carried over from the JAX
package's by interop.py; the 3-D box is tests/ocean_parity.py's (3 × 2
horizontal elements, so nx ≠ ny, over 1e6 × 1e6 × 400 m, uneven layers,
p3), and the 2-D brick lies on its horizontal ranges.

JAX references run jitted RHS under eager stepping code: a jitted JAX
split-explicit step would compile every stage's fast substeps into one
program. ``Jitted`` wraps a JAX DGModel so that its calls and
``pre_stage`` are jitted but the JAX solver reads it as a DGModel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from climatemachine_tpu.dg.numerical_fluxes import \
    CentralNumericalFluxFirstOrder as JaxCentral
from climatemachine_tpu.dg.spatial import DGModel as JaxDGModel
from climatemachine_tpu.dg.spatial import \
    init_state_auxiliary as jax_init_aux
from climatemachine_tpu.mesh.grid import make_grid as jax_make_grid
from climatemachine_tpu.mesh.topology import \
    brick_topology as jax_brick_topology
from climatemachine_tpu.ocean import problems as jpr
from climatemachine_tpu.ocean import shallow_water as jsw
from climatemachine_tpu.ocean import split_explicit as jse
from climatemachine_tpu_torch.dg.numerical_fluxes import \
    CentralNumericalFluxFirstOrder
from climatemachine_tpu_torch.dg.spatial import DGModel
from climatemachine_tpu_torch.interop import grid_from_numpy, grid_to_numpy
from climatemachine_tpu_torch.ocean import problems as ppr
from climatemachine_tpu_torch.ocean import shallow_water as psw
from climatemachine_tpu_torch.ocean import split_explicit as pse
from ocean_parity import H, L, NE, POLY, vm

WALLS = np.array([[1, 1], [1, 1]])


def ranges2(ne=NE):
    return [np.linspace(0.0, L, ne[0] + 1), np.linspace(0.0, L, ne[1] + 1)]


def grids2(periodic: bool, ne=NE, poly=POLY):
    """(JAX 2-D grid, the port's carried over from it): walls tagged 1
    where not periodic."""
    topo = jax_brick_topology(ranges2(ne), periodicity=(periodic,) * 2,
                              boundary=None if periodic else WALLS)
    gj = jax_make_grid(topo, poly, dtype=np.float64)
    return gj, grid_from_numpy(grid_to_numpy(gj), device="cpu",
                               dtype=torch.float64)


def problems(case):
    """(JAX problem, the port's): "gyre" (OceanGyre: no-slip walls, the
    wind stress, β-plane Coriolis) or "simplebox" (SimpleBox, Rotating:
    free-slip walls, f₀, no stress)."""
    if case == "gyre":
        return jpr.OceanGyre(L, L, H), ppr.OceanGyre(L, L, H)
    return (jpr.SimpleBox(L, L, H, rotation=jpr.Rotating()),
            ppr.SimpleBox(L, L, H, rotation=ppr.Rotating()))


def sw_models(case, barotropic=False, turb="visc", **kw):
    """(JAX shallow-water or barotropic model, the port's) on
    ``problems(case)`` with ``turb`` "visc" (ConstantViscosity(5e3)) or
    "drag" (LinearDrag(1e-5))."""
    pj, pt = problems(case)
    out = []
    for p, sw, se in ((pj, jsw, jse), (pt, psw, pse)):
        tu = sw.LinearDrag(1e-5) if turb == "drag" else \
            sw.ConstantViscosity(5e3)
        cls = se.BarotropicModel if barotropic else sw.ShallowWaterModel
        out.append(cls(p, turbulence=tu, **kw))
    return tuple(out)


def noisy(a, scales, seed):
    """a (node-major) plus N(0, 1) times ``scales`` per lane."""
    rng = np.random.default_rng(seed)
    a = np.asarray(a)
    return a + rng.standard_normal(a.shape) * np.asarray(scales)


class Jitted:
    """A JAX DGModel whose calls and ``pre_stage`` are jitted, with its
    ``grid`` and ``balance_law``."""

    def __init__(self, dg):
        self.dg, self.grid, self.balance_law = dg, dg.grid, dg.balance_law
        self._call = jax.jit(lambda q, a, t: dg(q, a, t))
        self._pre = jax.jit(lambda q, a, t: dg.pre_stage(q, a, t))

    # t as a Python float: a numpy float64 (the 3N coefficients') would
    # trace a second program
    def __call__(self, q, aux, t):
        return self._call(q, aux, float(t))

    def pre_stage(self, q, aux, t):
        return self._pre(q, aux, float(t))


def sw_pair(case, periodic, barotropic=False, seed=0, turb="visc",
            nf=(JaxCentral, CentralNumericalFluxFirstOrder), **kw):
    """A shallow-water (or barotropic) model on the 2-D brick in both
    packages: dict of the JAX DGModel ``dj`` (first-order flux ``nf``,
    central by default), the port's ``dg``, and a noisy state about rest (η ± 0.1, U ± 10) and the
    initial aux (the barotropic side's Gᵁ ± 1e-4), node-major ``qj``,
    ``aj`` and var-major ``q``, ``aux``; numpy ``seed``."""
    mj, mt = sw_models(case, barotropic, turb, **kw)
    gj, gt = grids2(periodic)
    dj = JaxDGModel(mj, gj, numerical_flux_first_order=nf[0]())
    dg = DGModel(mt, gt, numerical_flux_first_order=nf[1]())
    aux = np.array(jax_init_aux(mj, gj))
    q = noisy(np.zeros(aux.shape[:-1] + (3,)), [0.1, 10.0, 10.0], seed)
    if barotropic:
        sl = mj.aux_spec.index("GU")
        aux[..., sl] = noisy(aux[..., sl], [1e-4, 1e-4], seed + 1)
    return dict(dj=dj, dg=dg, qj=jnp.asarray(q), aj=jnp.asarray(aux),
                q=vm(q), aux=vm(aux), mj=mj, mt=mt)
