"""BOMEX on one column (the port's counterpart of
``examples/bomex_single_stack.py``): the BOMEX physics, forcings and
surface fluxes of :mod:`bomex_les` on a ``SingleStackConfiguration``,
20 elements to 3,000 m on one 100 m × 100 m element, p4, float64, at a
Courant number of 0.35, with TMAR on ρq_tot after every step.

Built through the driver's entry: :func:`bomex_single_stack_config`
gives the configuration, ``bomex_les.tmar_callback`` the callback.
CLI::

    python -m climatemachine_tpu_torch.experiments.bomex_single_stack \\
        --timeend 3 --device cpu
"""

from __future__ import annotations

import argparse

import torch

from climatemachine_tpu_torch.driver.configs import SingleStackConfiguration
from climatemachine_tpu_torch.experiments.bomex_les import (bomex_model,
                                                            tmar_callback)

NELEM_VERT, ZMAX, POLY, HMAX = 20, 3000.0, 4, 100.0
COURANT = 0.35


def bomex_single_stack_config(nelem_vert: int = NELEM_VERT,
                              zmax: float = ZMAX, poly: int = POLY,
                              device=None):
    """``SingleStackConfiguration("bomex_single_stack", ...)`` of the
    BOMEX model with the prescribed surface fluxes."""
    return SingleStackConfiguration(
        "bomex_single_stack", poly, nelem_vert, zmax, bomex_model(zmax),
        hmax=HMAX, dtype=torch.float64, device=device)


def main(argv=None):
    from climatemachine_tpu_torch.driver import driver
    from climatemachine_tpu_torch.driver.solver_configs import \
        make_solver_configuration
    ap = argparse.ArgumentParser(description="BOMEX on one column")
    ap.add_argument("--nelem-vert", type=int, default=NELEM_VERT)
    ap.add_argument("--zmax", type=float, default=ZMAX)
    ap.add_argument("--poly", type=int, default=POLY)
    ap.add_argument("--timeend", type=float, default=60.0)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    driver.init(show_updates="never")
    dc = bomex_single_stack_config(args.nelem_vert, args.zmax, args.poly,
                                   args.device)
    sc = make_solver_configuration(0.0, args.timeend, dc,
                                   Courant_number=COURANT)
    print(f"dt = {sc.dt:.3f} s, elements = {dc.grid.nelem}", flush=True)
    driver.invoke(sc, user_callbacks=[tmar_callback(dc)])
    sp = dc.model.prog_spec
    qt = sp.get(sc.q, "moisture.rhoq_tot") / sp.get(sc.q, "rho")
    print(f"finite: {bool(torch.isfinite(sc.q).all())}   q_tot range: ["
          f"{qt.min().item() * 1e3:.2f}, {qt.max().item() * 1e3:.2f}] g/kg",
          flush=True)


if __name__ == "__main__":
    main()
