"""The composable GCM experiment (port of
``climatemachine_tpu/experiments/gcm_driver.py``, the whole module: the
base states, perturbations and moisture profiles, ``VaryingSSTTJ16``,
``parse_surface_flux``, ``make_gcm_init`` and ``gcm_driver_config``).

A GCM problem is a base state × a perturbation × a moisture profile × a
surface flux, composed into one initial condition, with the sources of
the experiment ("heldsuarez": Gravity, Coriolis and the Held-Suarez
forcing; "baroclinic_wave": Gravity and Coriolis).  Each option is chosen
by name, as the reference's ``--init-base-state``, ``--init-perturbation``,
``--init-moisture-profile``, ``--surface-flux`` and ``--experiment`` flags
choose them.  The model carries a zero kinematic viscosity so that the
bulk-formula wall fluxes take effect: it runs on the generic DG
operator's gradient path.  Coordinates ``[E, 3, Np]``, state and aux
var-major ``[E, n, Np]``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from climatemachine_tpu_torch.atmos.boundaryconditions import (
    AtmosBC, BulkFormulaEnergy, BulkFormulaMoisture)
from climatemachine_tpu_torch.atmos.hyperdiffusion import (
    DryBiharmonic, EquilMoistBiharmonic)
from climatemachine_tpu_torch.atmos.model import (AtmosModel, AtmosPhysics,
                                                  AtmosProblem)
from climatemachine_tpu_torch.atmos.moisture import DryModel, EquilMoist
from climatemachine_tpu_torch.atmos.ref_state import HydrostaticState
from climatemachine_tpu_torch.atmos.sources import Coriolis, Gravity
from climatemachine_tpu_torch.common.orientations import (
    SphericalOrientation, latitude, longitude, sphr_to_cart_vec)
from climatemachine_tpu_torch.common.turbulence import \
    ConstantKinematicViscosity
from climatemachine_tpu_torch.experiments.baroclinic_wave import (
    bcwave_base_state, bcwave_perturbation, moist_low_tropics_q)
from climatemachine_tpu_torch.experiments.held_suarez import \
    HeldSuarezForcing
from climatemachine_tpu_torch.mesh.grid import Grid, make_grid
from climatemachine_tpu_torch.mesh.topology import \
    stacked_cubed_sphere_topology
from climatemachine_tpu_torch.physics import thermodynamics as td
from climatemachine_tpu_torch.physics.parameters import EARTH
from climatemachine_tpu_torch.physics.temperature_profiles import \
    DecayingTemperatureProfile


# --- base states: (model, φ, λ, z, aux) -> (T_v, p, u_zonal) ----------------

class ZeroBaseState:
    """An isothermal 255 K atmosphere at rest."""

    def __call__(self, model, phi, lam, z, aux):
        ps = model.param_set
        T = 255.0 * torch.ones_like(z)
        p = ps.MSLP * torch.exp(-z * ps.grav / (ps.R_d * 255.0))
        return T, p, torch.zeros_like(z)


class HeldSuarezBaseState:
    """The model's reference state at rest."""

    def __call__(self, model, phi, lam, z, aux):
        T_v = model.aux_spec.get(aux, "ref_state.T")
        p = model.aux_spec.get(aux, "ref_state.p")
        return T_v, p, torch.zeros_like(z)


class BCWaveBaseState:
    """The balanced deep-atmosphere jet of Ullrich et al. (2016)."""

    def __call__(self, model, phi, lam, z, aux):
        return bcwave_base_state(model.param_set, phi, z)


# --- perturbations: (model, φ, λ, z) -> (u, v, factor on ρe) ----------------

class NoPerturbation:
    def __call__(self, model, phi, lam, z):
        zero = torch.zeros_like(z)
        return zero, zero, 1.0


class DeterministicPerturbation:
    """The DCMIP2016 localized velocity dipole of amplitude ``V_p``."""

    def __init__(self, V_p: float = 10.0):
        self.V_p = V_p

    def __call__(self, model, phi, lam, z):
        u_p, v_p = bcwave_perturbation(model.param_set, phi, lam, z,
                                       V_p=self.V_p)
        return u_p, v_p, 1.0


class RandomPerturbation:
    """Multiplicative noise 1 + ``amplitude``·U(−1, 1) on ρe, drawn on the
    host by a ``torch.Generator`` seeded with ``seed`` (the same seed
    gives the same field) and moved to z's device.  It does not reproduce
    the JAX package's ``jax.random`` stream: the two packages' random
    perturbations have the same law, not the same values."""

    def __init__(self, seed: int = 0, amplitude: float = 1e-3):
        self.seed, self.amplitude = seed, amplitude

    def __call__(self, model, phi, lam, z):
        gen = torch.Generator().manual_seed(self.seed)
        u = torch.rand(z.shape, generator=gen, dtype=z.dtype) * 2.0 - 1.0
        zero = torch.zeros_like(z)
        return zero, zero, 1.0 + self.amplitude * u.to(z.device)


# --- moisture profiles: (model, φ, p) -> q_tot -------------------------------

class NoMoistureProfile:
    def __call__(self, model, phi, p):
        return torch.zeros_like(p)


class ZeroMoistureProfile(NoMoistureProfile):
    pass


class MoistLowTropicsMoistureProfile:
    """The DCMIP2016 low-tropics humidity."""

    def __call__(self, model, phi, p):
        return moist_low_tropics_q(model.param_set, phi, p)


# --- surface fluxes ----------------------------------------------------------

class VaryingSSTTJ16:
    """The analytic sea-surface temperature of Thatcher and Jablonowski
    (2016), 271 K + 29 K exp(−φ²/2(26°)²), and the saturation specific
    humidity at it (the bulk formulas' T_sfc and q_tot_sfc)."""

    def T_sfc(self, model, q, aux, t):
        phi = latitude(model.aux_spec.get(aux, "coord"))
        dphi = 26.0 * np.pi / 180.0
        return 29.0 * torch.exp(-phi ** 2 / (2 * dphi ** 2)) + 271.0

    def q_sfc(self, model, q, aux, t):
        ps = model.param_set
        T_sfc = self.T_sfc(model, q, aux, t)
        _, p = model.thermo(q, aux)
        eps = 0.622
        return (eps / p * ps.press_triple
                * torch.exp(-ps.LH_v0 / ps.R_v
                            * (1.0 / T_sfc - 1.0 / ps.T_triple)))


def parse_surface_flux(arg: Optional[str], moist: bool,
                       C_drag: float = EARTH.C_drag):
    """The (bottom, top) boundary conditions: "default" (or None) the
    free-slip insulating walls; "bulk" the bulk energy and moisture
    fluxes with coefficient ``C_drag`` at :class:`VaryingSSTTJ16`'s
    surface values on the bottom (a moisture model needed)."""
    if arg in (None, "default"):
        return (AtmosBC(), AtmosBC())
    if arg == "bulk":
        if not moist:
            raise ValueError("need a moisture model for surface-flux: bulk")
        sst = VaryingSSTTJ16()
        bottom = AtmosBC(
            energy=BulkFormulaEnergy(C_h=C_drag, T_sfc=sst.T_sfc),
            moisture=BulkFormulaMoisture(C_q=C_drag, q_tot_sfc=sst.q_sfc))
        return (bottom, AtmosBC())
    raise ValueError(f"unknown surface flux: {arg}")


def make_gcm_init(base_state, perturbation, moisture_profile):
    """The initial condition ``(model, coords, aux, t) -> q`` (var-major)
    of a base state, a perturbation and a moisture profile: T = T_v /
    (1 + (ε − 1) q_tot), ρ from the moist gas law, ρe = ρ(e_int + |u|²/2
    + Φ) times the perturbation's factor, ρq_tot = ρ q_tot where the model
    is moist."""
    def init(model, coords, aux, t):
        ps = model.param_set
        phi, lam = latitude(coords), longitude(coords)
        Phi = model.aux_spec.get(aux, "orientation.Phi")
        z = Phi / ps.grav

        u_p, v_p, rand_pert = perturbation(model, phi, lam, z)
        T_v, p, u_ref = base_state(model, phi, lam, z, aux)
        q_tot = moisture_profile(model, phi, p) if model.moist \
            else torch.zeros_like(p)

        u_cart = sphr_to_cart_vec(
            coords, torch.stack([u_ref + u_p, v_p, torch.zeros_like(u_p)],
                                dim=1))
        M_v = ps.molmass_ratio - 1.0
        T = T_v / (1 + M_v * q_tot)
        pp = td.PhasePartition.vapor(q_tot)
        rho = p / (td.gas_constant_air(ps, pp) * T)
        ke = 0.5 * torch.sum(u_cart * u_cart, dim=1)
        e_tot = td.internal_energy(ps, T, pp) + ke + Phi
        parts = [rho[:, None], rho[:, None] * u_cart,
                 (rho * e_tot * rand_pert)[:, None]]
        if model.moist:
            parts.append((rho * q_tot)[:, None])
        return torch.cat(parts, dim=1)
    return init


BASE_STATES = {"zero": ZeroBaseState, "heldsuarez": HeldSuarezBaseState,
               "bc_wave": BCWaveBaseState}
PERTURBATIONS = {"zero": NoPerturbation,
                 "deterministic": DeterministicPerturbation,
                 "random": RandomPerturbation}
MOISTURE_PROFILES = {"zero": ZeroMoistureProfile,
                     "moist_low_tropics": MoistLowTropicsMoistureProfile}

#: experiment -> (its default base state, its sources)
PROBLEMS = {
    "baroclinic_wave": ("bc_wave", lambda: (Gravity(), Coriolis())),
    "heldsuarez": ("heldsuarez",
                   lambda: (Gravity(), Coriolis(), HeldSuarezForcing())),
}


@dataclass
class GCMDriverConfig:
    model: AtmosModel
    grid: Grid
    name: str


def gcm_driver_config(experiment: str = "heldsuarez",
                      init_base_state: Optional[str] = None,
                      init_perturbation: str = "deterministic",
                      init_moisture_profile: str = "moist_low_tropics",
                      surface_flux: str = "default",
                      moist: bool = True,
                      n_horz: int = 8, n_vert: int = 4, poly_order: int = 4,
                      domain_height: float = 30e3,
                      hyperdiffusion_tau: Optional[float] = 8 * 3600.0,
                      dtype=None, param_set=EARTH, device=None
                      ) -> GCMDriverConfig:
    """The GCM experiment of the named pieces on a stacked cubed sphere of
    n_horz × n_vert elements at ``poly_order``: a DecayingTemperature
    Profile(290, 220, 8e3) reference state, EquilMoist (DryModel with
    ``moist=False``), ConstantKinematicViscosity(0) and, unless
    ``hyperdiffusion_tau`` is None or 0, EquilMoistBiharmonic
    (DryBiharmonic dry).  ``dtype=None`` means float32, ``device=None``
    CUDA."""
    if experiment not in PROBLEMS:
        raise ValueError(f"unknown experiment: {experiment}")
    default_base, sources = PROBLEMS[experiment]
    base = BASE_STATES[init_base_state or default_base]()
    pert = PERTURBATIONS[init_perturbation]()
    mp = MOISTURE_PROFILES[init_moisture_profile]()
    hyper = None
    if hyperdiffusion_tau:
        hyper = (EquilMoistBiharmonic(hyperdiffusion_tau) if moist
                 else DryBiharmonic(hyperdiffusion_tau))
    physics = AtmosPhysics(
        param_set=param_set, orientation=SphericalOrientation(),
        ref_state=HydrostaticState(
            DecayingTemperatureProfile(290.0, 220.0, 8e3)),
        moisture=EquilMoist() if moist else DryModel(),
        turbulence=ConstantKinematicViscosity(0.0), hyperdiffusion=hyper)
    problem = AtmosProblem(
        init_state=make_gcm_init(base, pert, mp),
        boundary_conditions=parse_surface_flux(surface_flux, moist,
                                               C_drag=param_set.C_drag))
    model = AtmosModel(physics, problem, sources=sources())
    a = param_set.planet_radius
    topo = stacked_cubed_sphere_topology(
        n_horz, a + np.linspace(0.0, domain_height, n_vert + 1))
    grid = make_grid(topo, poly_order, dtype=dtype or torch.float32,
                     device=device)
    return GCMDriverConfig(model=model, grid=grid, name=experiment)
