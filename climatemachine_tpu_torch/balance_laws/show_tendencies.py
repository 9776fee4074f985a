"""The equation table of a balance law (port of
``climatemachine_tpu/balance_laws/show_tendencies.py``): per prognostic
variable, the first-order fluxes, second-order fluxes and sources of
∂_t Y + ∇·F₁(Y) + ∇·F₂(Y, G) = S(Y, G).

The F₁ and F₂ columns come from the physics switches the flux methods
read; the Source column from which variables each source's
``contributions`` touches, found by calling it on tensors of the "meta"
device (shapes only, no computation; the JAX package uses
``jax.eval_shape``).  A source that cannot run there shows "?"."""

from __future__ import annotations

import torch


def _source_vars(model, src):
    """Which prognostic variables a source contributes to."""
    shape = lambda n: torch.empty((2, n, 3), dtype=torch.float64,
                                  device="meta")
    q, aux = shape(model.prog_spec.num), shape(model.aux_spec.num)
    ngf = model.gf_spec.num
    try:
        out = src.contributions(model, q, shape(ngf) if ngf else None, aux,
                                0.0)
    except Exception:
        return ("?",)
    return tuple(out.keys())


def show_tendencies(model) -> str:
    """The formatted equation table of an ``AtmosModel``."""
    ph = model.physics
    names = model.prog_spec.names()
    F1 = {k: [] for k in names}
    F2 = {k: [] for k in names}
    S = {k: [] for k in names}

    if not ph.compressibility.is_anelastic:
        F1["rho"].append("Advect")
    F1["rhou"] += ["Advect", "PressureGradient"]
    F1["rhoe"].append("Advect")
    if not ph.energy.is_theta:
        F1["rhoe"].append("Pressure")
    if ph.radiation is not None and hasattr(ph.radiation, "energy_flux"):
        F1["rhoe"].append("Radiation")
    for grp in ("moisture", "tracers", "precipitation", "sgstke",
                "turbconv"):
        if grp in names:
            F1[grp].append("Advect")
    if ph.precipitation is not None and "precipitation" in names:
        F1["precipitation"].append("Sedimentation")

    if ph.turbulence is not None:
        F2["rhou"].append("ViscousStress")
        F2["rhoe"].append("DiffEnthalpyFlux")
        if "moisture" in names:
            F2["moisture"].append("MoistureDiffusion")
        if "tracers" in names:
            F2["tracers"].append("TracerDiffusion")
        if ph.sgstke is not None:
            F2["sgstke"].append("SGSTKEDiffusion")
    if ph.hyperdiffusion is not None:
        F2["rhou"].append("Hyperdiffusion")
        F2["rhoe"].append("Hyperdiffusion")
        gl_names = ph.hyperdiffusion.vars_gradient_laplacian().names()
        if "moisture" in names and "q_tot" in gl_names:
            F2["moisture"].append("Hyperdiffusion")

    for src in model.sources:
        label = type(src).__name__
        for var in _source_vars(model, src):
            top = var.split(".")[0]
            if top in S:
                S[top].append(label)

    rows = [("Equation (Y_i)", "Flux{FirstOrder} (F_1)",
             "Flux{SecondOrder} (F_2)", "Source (S)")]
    for k in names:
        rows.append((k, ", ".join(F1[k]) or "—",
                     ", ".join(F2[k]) or "—",
                     ", ".join(dict.fromkeys(S[k])) or "—"))
    widths = [max(len(r[i]) for r in rows) for i in range(4)]
    lines = ["PDE: ∂_t Y_i + (∇•F_1(Y))_i + (∇•F_2(Y,G))_i = (S(Y,G))_i"]
    for j, r in enumerate(rows):
        lines.append("  ".join(c.ljust(w) for c, w in zip(r, widths)))
        if j == 0:
            lines.append("-" * (sum(widths) + 6))
    return "\n".join(lines)
