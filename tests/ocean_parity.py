"""Shared set-up of the ocean parity tests (test_torch_ocean_columns.py,
_hb.py, _steps.py): a small stacked ocean box in both packages, float64
on the CPU, the port's grid carried over from the JAX package's by
interop.py, the same problems and models, and per-variable errors.

The box: 3 × 2 horizontal elements (each direction more than one, so a
transposed column order fails) over 1e6 × 1e6 × H, 3 unevenly spaced
layers (fractions 0.25, 0.45, 0.3 of H from the floor), p3; coasts tag
1, the floor 2, the surface 3, as ``ocean_box_grid``.
"""

import numpy as np
import torch

from climatemachine_tpu.mesh.grid import make_grid as jax_make_grid
from climatemachine_tpu.mesh.topology import \
    stacked_brick_topology as jax_stacked_brick_topology
from climatemachine_tpu.ocean import core as joc
from climatemachine_tpu.ocean import problems as jpr
from climatemachine_tpu.ocean.hydrostatic_boussinesq import \
    HydrostaticBoussinesqModel as JaxHB
from climatemachine_tpu_torch.interop import (grid_from_numpy, grid_to_numpy,
                                              to_node_major, to_var_major)
from climatemachine_tpu_torch.ocean import core as poc
from climatemachine_tpu_torch.ocean import problems as ppr
from climatemachine_tpu_torch.ocean.hydrostatic_boussinesq import \
    HydrostaticBoussinesqModel as PortHB

L = 1e6
H = 400.0
NE = (3, 2)
LAYERS = (0.25, 0.45, 0.3)
POLY = 3
GRAV = 9.81


def ranges(H=H, ne=NE):
    z = -H + H * np.concatenate([[0.0], np.cumsum(LAYERS)])
    z[-1] = 0.0
    return [np.linspace(0.0, L, ne[0] + 1), np.linspace(0.0, L, ne[1] + 1),
            z]


def grids(H=H, ne=NE, poly=POLY):
    """(JAX grid, the port's grid carried over from it)."""
    topo = jax_stacked_brick_topology(
        ranges(H, ne), periodicity=(False, False, False),
        boundary=np.array([[1, 1], [1, 1], [2, 3]]))
    gj = jax_make_grid(topo, poly, dtype=np.float64)
    return gj, grid_from_numpy(grid_to_numpy(gj), device="cpu",
                               dtype=torch.float64)


def windstress_bcs(oc):
    """The windstress test's conditions: no-slip coasts, a free-slip
    floor, the problem's stress at the surface."""
    return (oc.OceanBC(oc.Impenetrable(oc.NoSlip()), oc.Insulating()),
            oc.OceanBC(oc.Impenetrable(oc.FreeSlip()), oc.Insulating()),
            oc.OceanBC(oc.Penetrable(oc.KinematicStress()),
                       oc.Insulating()))


def problems(case, H=H):
    """(JAX problem, the port's) of ``case``."""
    out = []
    for pr, oc in ((jpr, joc), (ppr, poc)):
        if case == "homogeneous":
            out.append(pr.HomogeneousBox(L, L, H,
                                         boundary_conditions=windstress_bcs(
                                             oc)))
        elif case == "gyre":
            out.append(pr.OceanGyre(L, L, H))
        elif case == "simplebox_fixed":
            out.append(pr.SimpleBox(L, L, H, rotation=pr.Fixed()))
        elif case == "simplebox_rotating":
            out.append(pr.SimpleBox(L, L, H, rotation=pr.Rotating()))
        else:
            raise ValueError(case)
    return out


def models(case, H=H, **kw):
    """(JAX model, the port's) of ``case`` with c_h = √(gH) and ``kw``."""
    pj, pt = problems(case, H)
    kw = dict(dict(c_h=float(np.sqrt(GRAV * H))), **kw)
    return JaxHB(pj, **kw), PortHB(pt, **kw)


def perturbed(q, seed=0):
    """q (node-major) plus N(0, 1) times (0.05, 0.05, 0.01, 1) per lane,
    from numpy ``seed``."""
    rng = np.random.default_rng(seed)
    q = np.asarray(q)
    return q + rng.standard_normal(q.shape) * np.array([0.05, 0.05, 0.01,
                                                        1.0])


def vm(a):
    return to_var_major(np.asarray(a), device="cpu", dtype=torch.float64)


def nm(t):
    return to_node_major(t)


def rel_err_per_var(got, ref):
    """max|got − ref| over max|ref| per lane of node-major arrays (lanes
    whose reference is 0 everywhere: the absolute error)."""
    got, ref = np.asarray(got), np.asarray(ref)
    out = []
    for i in range(ref.shape[-1]):
        scale = np.abs(ref[..., i]).max()
        err = np.abs(got[..., i] - ref[..., i]).max()
        out.append(float(err / scale) if scale > 0 else float(err))
    return out
