"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--skip-moist] [--julia-gates]
                          [--edmf-gate]

Builds the CUDA kernels from csrc/ (one nvcc per source, in parallel),
holds each kernel against its plain PyTorch version on its path's own
inputs, then drives three paths through their public entry points, all
Held-Suarez p4 on a stacked cubed sphere at n_horz=16, n_vert=8 (12,288
elements, 1.536 M nodes), float32, with the every-step exponential
filter:
- the explicit step (LSRK54, ``ExplicitSolverType().make``) with
  DryBiharmonic(8 h) hyperdiffusion: the volume kernel with F₂ and the
  four chain kernels; its steps run once with each surface pass of
  ``VarMajorRHS.surface_kernel``: "xla" (plain PyTorch, the default),
  "pallas" (the extraction and the flux + lift kernels) and "hybrid"
  (the extraction kernel only);
- at fewer steps, the same step with hyperdiffusion off, whose volume
  kernel (without F₂), one step and small reference are checked as the
  first path's are, its steps run with "xla" and with "pallas";
- the IMEX step of bench.py: ``IMEXSolverType().make``
  (ARK2GiraldoKellyConstantinescu, the block-tridiagonal column solver
  over the vertical acoustic-gravity operator, dt from the horizontal
  acoustic CFL snapped to the f64 table's) with hyperdiffusion; the two
  layout kernels (on the path's own state and at three edge shapes) and
  the two surface kernels (on the path's own state, hyperdiffusion on
  and off) against their plain versions, one step with "xla" and one
  with "pallas" against the all-plain step, one step with only the
  layouts plain, a small reference, then the table's 35 steps with exact
  launch counts and the f64-table gate, once with each surface pass on
  the same solver;
- the generic DG operator ``DGModel(model, grid)`` (the JAX package's
  "grid" layout, state var-major here) with hyperdiffusion: the dry
  volume kernel against its plain version on the inputs of its RHS and
  of the fused IMEX remainder, the RHS against the RHS with every
  stage's plain version, the all-plain RHS (the contraction and the
  per-pass chain) and the var-major RHS, the remainder against dg −
  dg_lin; then three paths on it, each with exact launch counts:
  ``ExplicitSolverType(state_layout="grid")`` (13 LSRK54 steps),
  ``IMEXSolverType(state_layout="grid")`` (the table's 35 ARK2GKC steps,
  banded solver, the generic operator as ``rhs_full``) and
  ``IMEXSolverType(columnwise_solver="dense")`` (35 steps, the dense
  column solver, the fused remainder), the f64-table gate on both IMEX
  paths;
- the moist baroclinic wave (DCMIP2016: EquilMoist with its saturation
  adjustment, EquilMoistBiharmonic(8 h), Gravity, Coriolis, no filter)
  at the same width, state [12288, 6, 125]: on the explicit path
  (``ExplicitSolverType().make``, LSRK54 at the dry dt) the moist branch
  of every kernel against its plain version on the path's own perturbed
  state (the volume kernel at nq = 6 with F₂ of ngl = 5, K1-K4 at n = 5
  rows, both surface kernels at nq = 6 with hyperdiffusion on and off),
  the whole chain, one step with "xla" and "pallas" against the
  all-plain step, the small references of both steps, 13 steps under
  each surface pass; then the IMEX path (``IMEXSolverType().make``, 30 ×
  30 column blocks) at the largest of the dry dt and its halvings that
  takes 35 steps without blowing up (moist_imex_dt_scan; the explicit
  remainder carries the vertical acoustics of the wave's departure from
  the reference state), both layout kernels at six variables against
  their plain versions and ``permute(...).contiguous()``, one step with
  "xla" and "pallas" against the all-plain step and one with only the
  layouts plain, and 35 steps under each surface pass; every run with
  exact launch counts and the JAX package's checks (finite, ρ and ρq_tot
  mass drift, max|u| < 150 m/s; 0 <= q_tot < 0.02 at the start).
  ``--skip-moist`` leaves this path and the next out (for a checkout of
  a commit without them; the default run never sets it);
- the moist wave with two passive tracers and warm rain (``baroclinic_
  wave_config(tracers=NTracers((1.0, 2.0)))``, ``replace(physics,
  precipitation=RainModel())``, sources Gravity, Coriolis, WarmRain1M;
  ρχ = ρ·(1, z/H) at the start), state [12288, 9, 125], on the generic
  DG operator, which the solver types' "auto" takes (the var-major RHS
  takes no tracers or rain, as the JAX package's): K1-K4 against their
  plain versions bit for bit on its chain input (the hook's (u_h, h_tot,
  q_tot)), the RHS against its plain-stage twin; LSRK54 through
  ``ExplicitSolverType().make`` (one step against the plain-stage step,
  13 steps), 3 steps each with the Roe, moist Roe, HLLC and LMARS fluxes
  and with RainSnowModel + RainSnow1M; ``IMEXSolverType().make`` (the
  banded solver, 45 × 45 blocks) at the moist IMEX dt, halved until 35
  steps stay stable, with both layout kernels at (1536, 8, 9, 5, 25),
  template-constant and runtime-dims branches, against their plain
  versions and ``permute(...).contiguous()`` bit for bit, one step
  against the plain-stage, plain-layout step, 35 steps; and
  ``IMEXSolverType(columnwise_solver="dense").make`` (360 × 360 columns)
  at the same dt, one step against the plain-stage step, 35 steps;
  every run with exact launch counts, the tracers' mass drift <= 1e-5,
  max ρq_rai, max|u| < 150 m/s, finite;
- on the generic operator of the first path, two solver types whose
  explicit or slow operator is a generic fused remainder:
  ``IMEXSolverType(implicit_model=AtmosAcousticLinearModel,
  columnwise_solver="dense", state_layout="grid")`` (the dry kernel's
  vertical acoustic remainder branch; 35 steps with the filter at the
  largest of the dense path's dt and its halvings that stays finite with
  max|u| < 150 m/s, dense_acoustic_dt_scan) and
  ``MultirateSolverType(timestep_ratio=4)`` (its every-direction
  acoustic-gravity branch in the slow operator; slow dt 4 × the
  explicit path's, 6 steps, finite with max|u| < 100 m/s, the checks of
  tests/test_imex.py:206-229), each with exact launch counts;
- the fused remainder of the var-major RHS (``VarMajorRHS(
  remainder_DGModel(dg, dg_lin))``), dry Held-Suarez and the moist wave
  at the same width, with and without hyperdiffusion: for each linear
  model (acoustic-gravity, acoustic) and direction ("vertical",
  "every") the volume kernel's remainder branch and, once per direction,
  the surface kernels' (na = 4, rem_lanes) against their plain versions
  bit for bit on the RHS's own inputs, the RHS under each surface pass
  against the plain-stage RHS and (dry) against the generic remainder,
  with exact launch counts; dry, the dry kernel's other remainder
  branches ((2,) without gravity, (0, 1) and (0, 1, 2) with and without)
  on the generic remainders' inputs, bit for bit, each generic remainder
  against its plain-stage twin;
- the isentropic vortex (tests/test_isentropic_vortex.py): a
  periodic 32 × 32 × 12 brick on [−L, L]³ at p4 and float32 (12,288
  elements, the grid shape of the Held-Suarez rows),
  ``AtmosPhysics(orientation=NoOrientation())``, whose default
  reference state, NoReferenceState, takes no reference pressure out
  of the fluxes: the four branches without it ("[nosub]": the
  var-major volume kernel with ``subtract_ref=False``, the dry kernel
  likewise, the extraction at na = 0, the flux + lift with
  ``subtract=False``) against their plain versions on the path's own
  perturbed state; the var-major RHS under each surface pass against
  its plain-stage twin and the generic RHS, the generic RHS of the
  Rusanov, Roe and HLLC fluxes against their plain-stage and all-plain
  twins (per variable, the momentum over its largest component); then
  ``ExplicitSolverType().make`` (LSRK54 on the var-major RHS: "auto"
  takes it for the Rusanov flux) over a quarter crossing under each
  surface pass, ``ExplicitSolverType(state_layout="grid")`` with each
  flux over an eighth, and the quarter crossing at 8 × 8 × 12, dt = 0.4
  · min node distance / 400 as the JAX test's; each run with exact
  launch counts, the L2 error against the exact solution <= 3e-4 (the
  JAX test's bound) and ρ, ρe drift <= 1e-5.  Then, on Held-Suarez with
  ``HydrostaticState(_subtract_off=False)``, the remainder branches
  without p_ref (the volume kernel's vertical acoustic-gravity and
  every-direction acoustic, the lift's, the dry kernel's vertical,
  horizontal and every) and the var-major kernel's "horizontal"
  lin_dims (0, 1) with and without p_ref against their plain versions,
  and those remainder RHS under each surface pass with their launches;
- the rising-bubble LES (experiments/risingbubble.py, the JAX package's
  examples/risingbubble.py: the 2500 m cube, lateral sides periodic,
  walls at the bottom and top, a 2 K bubble of radius 500 m at (1250,
  1000) m) at Δ = 25 m, p4, float32 (25 × 25 × 25 = 15,625 elements),
  built only through the driver's entry: ``AtmosLESConfiguration`` →
  ``make_solver_configuration`` (dt from ``calculate_dt`` at Courant
  0.4) → ``invoke`` (3 + 10 LSRK54 steps, the last 10 timed).  With
  SmagorinskyLilly(0.21) "auto" takes the generic DG operator's
  gradient path, which launches no kernel (les_path: set-up seconds, ms
  per step, peak memory, mass drift <= 1e-5, max w > 0, invoke's norm
  ratio); without a closure it takes the var-major RHS: its volume
  kernel (no F₂, p_ref taken out), extraction (na = 1, no
  hyperdiffusion) and flux + lift, and the dry volume kernel of its
  generic operator, "[les]", against their plain versions on the path's
  perturbed state, the RHS against its plain-stage twins and the
  generic RHS, then ``invoke`` under each surface pass and with
  ``state_layout="grid"``, with exact launch counts; each closure's 3 ×
  3 × 3 box, 3 steps in float32 on the card against the port's float64
  run on the CPU (LES_SMALL_TOL);
- the ocean box GCM (experiments/ocean_box.py, the JAX package's
  examples/ocean_box_gcm.py at its defaults: HydrostaticBoussinesqModel
  on 20 × 20 × 20 elements at p4 over 4e6 × 4e6 × 400 m, float64,
  LSRK144 at dt = 55 s with the vertical filters before each stage,
  driven by ``solve``) for HomogeneousBox and OceanGyre: set-up seconds,
  ms per step (10 after 3), simulated s per wall s, peak memory, max|u|,
  the η range, the drift of ∫η dV within the bound of
  tests/test_ocean.py:195, and every kernel's launches, all 0 (the
  ocean's stack integrals and filters are plain PyTorch, as XLA code in
  the JAX package); the Julia reference's golden tables in float64 at
  the JAX tests' configurations and digits
  (tests/test_ocean_golden_extra.py:94, :121: windstress, 5 × 5 × 5 p4,
  20 steps at 180 s; ocean_gyre, 30 steps at 120 s); and the one-call
  HydrostaticBoussinesqSuperModel's geostrophic adjustment with the
  assertions of tests/test_ocean.py:155-200;
- the split-explicit ocean (experiments/ocean_split_explicit.py, the JAX
  package's examples/ocean_split_explicit_box.py at the Julia
  experiment's width: CoupledHBModel on 20 × 20 × 20 elements and
  BarotropicModel on the 20 × 20 brick at p4, float64, SplitExplicitSolver
  "new" with LSRK54 slow at 5400 s and fast at 240 s, then 5 IVDC solves
  by GMRES after each slow step, the schedule on the 3-D model): set-up
  seconds, 1 + 3 slow steps with the split-explicit step and the IVDC
  solves timed apart, every GMRES residual ‖b − Lx‖/‖b‖ (b = θⁿ/Δt,
  each solve's own) within SPLIT_GMRES_TOL, θ within SPLIT_THETA_RANGE,
  the ∫η dV drift, max|u|, max|U|, peak memory, every kernel's launches 0; then the Julia reference's
  hydrostatic_spindown coupled and uncoupled tables (5 × 5 × 8 at p4,
  288 slow steps at 300 s) and the spindown_2d table (5 × 5 at p4, 288
  LSRK54 steps) in float64 at the JAX tests' configurations and digits
  (tests/test_split_explicit_refvals.py:147-183, with its three reduced
  transfer entries; tests/test_ocean_golden_extra.py:147-171), each with
  its analytic error below 0.005;
- the split-explicit ocean's split01 variants (phase ``split01``:
  ``ocean_split_explicit.make_julia`` at the Julia simple_box constants
  of tests/test_simple_box_ivd_refvals.py:41-96, 20 × 20 × 20 and 20 ×
  20 at p4, float64: "split01" LSRK54 at 5400 / 240 s with 2 added
  substeps, "split01_3n" LS3NRK33Heuns3N at 2400 / 120 s with 3, 5 IVDC
  solves each): 1 + 3 slow steps each with the split-explicit step and
  the IVDC solves timed apart, every GMRES residual, θ, the ∫η dV drift
  and every launch count (0) checked as the "new" variant's; the Julia
  multirate spindown tables at 30, 60 and 90 min (5 × 5 × 8 at p4,
  "split01" with 2 added substeps and 5 IVDC solves, fast 300 s) at the
  digits of tests/test_split_explicit_refvals.py:262-293 with the
  analytic error below 0.005; the vertical_integral tables (no
  stepping, :296-343) at their digits, initial, day, month and century
  (year and decade with ``--julia-gates``: VERTINT_TABLES);
  ``batched_gmres`` on the card on
  a batch-dependent operator against the same solve on the CPU in
  float64.  With ``--julia-gates`` the four 5-day Julia gates follow at
  the JAX tests' widths and digits: simple_box_ivd (80 slow steps),
  simple_box_2dt (80, no IVDC), simple_box_rk3 (108) and the double
  gyre (75, ``_DBL_GYRE_GATES``), and the vertical_integral year and
  decade tables; a failed gate exits non-zero;
- the GCM driver entry (phase ``gcm_driver``): Held-Suarez through
  ``held_suarez_driver`` → ``invoke`` at n_horz=16, n_vert=8, p4,
  float32, IMEX at the Courant number 0.3 of examples/heldsuarez.py,
  GCM_STEPS steps under each surface pass, against
  ``IMEXSolverType().make`` with the filter driven by ``solve`` on the
  same dt: equal bit for bit with the same launch counts; a restart (k
  steps with ``checkpoint_at_end``, ``restart_from``, k more) against 2k
  steps in one run, bit for bit; solid-body rotation at its example's
  defaults through ``AtmosGCMConfiguration`` (Roe, IMEX, Courant 0.2
  horizontal, float32, 2 h) with max |u| after every step reported (the
  JAX example does not keep the rest state there: 0.76 m/s after one
  step in float32, NaN from 1229 s) and its launches checked;
  ``gcm_driver_config
  ("heldsuarez")`` (moist, 8 × 4, p4) and its bulk surface-flux variant,
  GCM_LSRK_STEPS LSRK54 steps each, finite, with the mass drift; the
  Courant and timestep monitors and ``AdaptTimestep`` run once on the
  Held-Suarez state, with their host cost;
- the forced LES cases (phase ``les_forcing``), each built only through
  the driver's entry from its experiment module, float64, on the
  generic operator's gradient path, which runs no kernel (every launch
  count must stay 0): BOMEX at its published width (4,864 elements, p4,
  prescribed surface fluxes, TMAR on ρq_tot after every step),
  FORCING_WARM + FORCING_STEPS steps, q_tot ≥ 0 after TMAR, its mass
  change reported (its moisture sink is a mass source); DYCOMS-II RF01
  (684 elements; q_liq > 0 from the start, the stratocumulus deck), the
  convective boundary layer (4,500 elements), the stable one with each
  surface option and the Deardorff canopy, 1 + 2 steps each; each with
  ms per step, simulated s per wall s, set-up s and peak memory; then
  BOMEX, DYCOMS and the canopy on 2 × 2 × 2 elements, card against CPU;
- diagnostics and output (phase ``diagnostics``), each built through
  the driver's entry and ``invoke(..., diagnostics_config=
  DiagnosticsConfiguration(...))``: DYCOMS-II RF01 (684 elements, 1 + 2
  steps, AtmosLESDefault and AtmosLESCore every step) and BOMEX at its
  published width (4,864 elements, 3 + 10 steps with TMAR,
  AtmosLESDefault every 5 steps), written by ``NpzWriter``; each group
  at the final state against the same group computed on the CPU from
  the card's state (DIAG_PROFILE_TOL of each profile's largest |value|,
  plus DIAG_ROUNDOFF_FACTOR times the profile's change under a 2⁻⁵⁰
  relative perturbation of that state: the cases are horizontally
  uniform, so their second moments are round-off), DYCOMS's liquid
  water path > 0, cloud fraction in [0, 1], cloud top above its base,
  BOMEX's q_tot ≥ 0, no launch; Held-Suarez at bench width through
  ``held_suarez_driver(imex=True)`` under "pallas", DIAG_GCM_STEPS
  steps with AtmosGCMDefault (with vorticity) on
  ``InterpolationConfiguration``'s 91 × 180 × 32 grid,
  AtmosMassEnergyLoss, AtmosGCMSpectra and a StateCheck every step,
  against the same run without them: the final states equal bit for
  bit, both runs' launches the IMEX path's a step, the interpolated
  nodal radius equal to the target radii within INTERP_RADIUS_TOL; the
  StateCheck case of tests/test_statecheck_refvals.py (Held-Suarez p3
  at 2 × 2, 30 LSRK54 steps on the generic operator, float32: the dry
  volume and chain kernels) against the port's CPU float32 run within
  STATECHECK_TOL, each statistic's distance to
  tests/refvals/held_suarez.py reported; ``debug_init`` at bench width:
  the VTK dump parses, its fields equal the state, no lane of the state
  or aux is non-finite.  Each group's ms a write apart from ms a step,
  the dump's bytes and seconds, peak memory;
- the remaining atmosphere formulations (phase ``atmos_formulations``),
  float64 on the generic operator's gradient path, every launch count 0
  (none of the kernels is on these paths, as in the JAX package, whose
  fast paths refuse θ, anelastic and EDMF): the EDMF single stack of
  experiments/bomex_edmf.py at its example's width (15 elements to 400
  m, p4), decoupled and coupled (one updraft over the neutral dry
  surface: the first RHS and 10 LSRK144 steps with TMAR on the EDMF
  lanes) and moist (two updrafts over the BOMEX surface, EquilMoist: 3
  steps), each against the port's float64 CPU run of the same RHS and
  steps from the card's state within FORMULATION_TOL per lane (the
  momentum lanes over the largest of theirs; EDMF_LANE_TOL for the
  θ_liq variance); BOMEX on ``SingleStackConfiguration`` (20 elements
  to 3 km, experiments/bomex_single_stack.py), 3 + 10 steps through
  ``invoke`` with TMAR, q_tot ≥ 0; the ρθ rising bubble
  (``ThetaModel``, experiments/rising_bubble_theta.py, 12 × 12 × 12
  elements), 3 + 10 steps through ``invoke``, ∫ρ and ∫ρθ within
  THETA_DRIFT_TOL, max w growing, and its 2 × 2 × 2 box card against
  CPU within FORMULATION_TOL; the Anelastic1D box
  (experiments/anelastic1d.py, the configuration of
  tests/test_atmos_extras.py's ``test_anelastic1d``), 10 LSRK54 steps
  at its advective dt, ρ = ρ_ref and p = p_ref within ANELASTIC_TOL,
  against the CPU within FORMULATION_TOL; the cfsite AMIP LES
  (experiments/cfsite_amip.py, 6 × 6 × 50 elements), 3 + 10 steps
  through ``invoke`` with TMAR, q_tot ≥ 0.  Each case's ms a step
  (untraced, ending in a synchronize), kernels a step (one traced step)
  and peak device memory.  ``--edmf-gate`` adds the stored-profile gate
  of tests/test_edmf.py (400 coupled steps against
  tests/refvals/edmf_sbl_profiles.py, each variable's MSE beside its
  budget);
- the staged kernels (K1-K4, the volume kernel with and without F₂,
  both dry branches; the moist branches of K1-K4 and the volume kernel)
  and every remainder branch above at the other orders the kernels are
  built for, p1, p2, p3 and p5, on a 48-element grid: each against its
  plain version on all elements and on the first 37, then the var-major
  (dry and moist, full and each remainder under "pallas") and the
  generic RHS with their defaults against the ones with every stage's
  plain version (kernel_orders); and (vortex_kernel_orders) the four
  [nosub] branches on the vortex's 4 × 4 × 3 brick, every remainder
  branch without p_ref and the "horizontal" lin_dims on Held-Suarez
  with ``HydrostaticState(_subtract_off=False)``, and those RHS against
  their plain-stage twins.
Copied into a checkout of an earlier commit that has the same modules
and run there, the script measures that commit's kernels by the same
method, so two designs compare in one call.
Each run sets every launch count to 0 just before it starts and reads
the counts just after.  One JSON line per phase and ``surface_modes``
with the ms per step of each surface pass on both steps and of the
three generic paths, ``phase_seconds`` with each phase's wall seconds
and the total; then the card's name and power limit as nvidia-smi
reports them, a ``{"kernels": [...]}`` line (the nine earlier kernels
with launches from the IMEX path with "pallas", the dry volume kernel
with launches from the grid-layout IMEX path and its vertical
acoustic-gravity remainder branch from the dense one, the nine moist
branches, "[moist]", with launches from the moist IMEX path with
"pallas" (K1-K4 adding the tracer path's banded IMEX launches), the
two layout kernels at nvars = 9, "*_tracers", with launches from that
banded IMEX step, and the remainder branches, "[rem:...]": the var-major
kernels' with launches from the remainder RHS runs, the dry kernel's
vertical acoustic branch from the dense acoustic IMEX path, its
every-direction acoustic-gravity branch from the multirate path, its
others from the generic remainder runs; the four [nosub] branches with
launches from the vortex paths: the var-major kernels' from its "pallas"
run, the dry kernel's from the grid-layout Rusanov run; the four [les]
branches with launches from the inviscid bubble's runs: the var-major
kernels' from its "pallas" run, the dry kernel's from its grid-layout
run) and, last,
``{"ok": true,
"device": ...}``.  Any failure raises and exits non-zero without the
last line.  Without a CUDA device it exits 1 at once.

Each volume and chain kernel reports two bounds: ``bound_ms`` counts
the work the kernel does, the derivative products sum-factorised (Nq
terms: Wd and Wdiv are Kronecker operators), which leaves every kernel
bound by bytes; ``bound_dense_ms`` counts them dense (Np terms per node
and direction, as the TPU kernels compute them; K4 has no derivative,
so its two are the same).  The surface kernels' work is a gather and at
most ~130 flops a face lane, so bytes bound them (``bound_ms``);
``bound_dense_ms`` counts the extraction and the lift as the dense
products the TPU kernels compute.  The layout kernels move bytes only:
each input read once, each output written once.  Every kernel is timed
in interleaved rounds of CUDA-graph replays over rotating inputs (cold
L2; ``ms_warm`` on one input), with its plain version in the same
rounds and, for the layout kernels, ``permute(...).contiguous()``, the
one PyTorch call computing the same function; each entry of the
kernels line names the method in ``timing`` ("graph_cold_median").
The staged kernels (K1-K4, the volume kernels) are also held against
their plain versions on the first 37 elements of their inputs (a
partial last tile).

Tolerances:
- kernel vs plain, same inputs (the chain intermediates and the volume
  inputs of a perturbed initial state): per output, max|Δ| <= 1e-5 ·
  max|plain| — the kernels round as the plain versions do and sum their
  products in a GEMM's order; float32 round-off alone reaches 7.3e-6 of
  max|plain| in the first derivative of h_tot and 1.0e-5 in the volume
  tendency's ρe with F₂ (f32 against f64 on the CPU at n_horz=2, p4), so
  a different summation order would show at about this bound;
- the surface kernels vs their plain versions, on the IMEX path's
  perturbed state, its thermo and ∇Δ, the bundle and its gathered
  neighbour side: the same 1e-5 · max|plain| per output lane (each
  bundle lane, each variable; they round as the plain versions do, the
  extraction is a gather and each node's lift sums its face lanes in
  ascending order, as a GEMM does);
- the layout kernels vs their plain versions and vs one
  ``permute(...).contiguous()``, on a perturbed state and its blocks and
  at the layout dims (24, 3, 5, 5, 25), (37, 2, 5, 5, 25) and (96, 4, 5,
  4, 16): equal bit for bit (a permutation), and the round trip exact;
  one IMEX step with the layout kernels vs the same step with only the
  layouts plain: equal bit for bit;
- the whole kernel chain vs the per-pass plain chain (dg/ldg_varmajor.py):
  max|Δ| <= 1e-4 · max|plain| — 14× the 7.1e-6 of float32 against
  float64 for the whole chain on the CPU at n_horz=2, p4, since the two
  chains order their sums differently;
- one LSRK54 step, and one IMEX step, with the kernels vs one with the
  plain versions (the surface pass "xla" in both, and "pallas" in both),
  from the same state: per variable, max|Δq| <= 1e-3 ·
  max|q1 − q0| + 4 · eps32 · max|q1| — the step's increment carries the
  kernels' round-off, and where the two increments differ in their last
  bits the float32 updates q + dt·dq round a few ulp apart;
- three LSRK54 steps of a small grid (n_horz=2, n_vert=2, p4,
  hyperdiffusion on and off) in float32 on the card vs float64 on the
  CPU (the plain path the CPU tests hold against the JAX package) from
  the same float32 geometry and state: per variable, max|Δq| <= 1e-4 ·
  max|q| — 10× the 9.7e-6 (ρu, hyperdiffusion on) that the same
  comparison gives in float32 on the CPU: round-off of the
  cancellations p − p_ref, ρe/ρ − Φ and the derivative of h_tot;
- three IMEX steps of a small grid (n_horz=2, n_vert=3, p4,
  hyperdiffusion on, dt = 175 s from the horizontal CFL) in float32 on
  the card vs float64 on the CPU, the same way: per variable (ρ, ρu,
  ρe), max|Δq| <= (2e-3, 3e-1, 5e-2, 1e-1, 3e-3) · max|q| — 10× what the
  same comparison gives in float32 on the CPU, (1.9e-4, 2.9e-2, 4.7e-3,
  9.8e-3, 3.1e-4) (the JAX package in float32 gives 2.5e-4, 1.6e-2,
  8.0e-3, 9.9e-3, 5.5e-4): the column solve at α·dt = 51 s mixes ρe
  (~3e4) into ρu (~1e1) and amplifies its round-off by the systems'
  condition number;
- three moist LSRK54 steps (n_horz=2, n_vert=2, p4, dt = 0.3 · node
  distance / 350) and three moist IMEX steps (n_horz=2, n_vert=3, p4, dt
  = 0.01 · horizontal node distance / 350 = 17.5 s; the split blows up
  at 0.1 on that grid) in float32 on the card vs float64 on the CPU, the
  same way: per variable (ρ, ρu, ρe, ρq_tot) MOIST_SMALL_TOL and
  MOIST_IMEX_SMALL_TOL, 10× the larger of what the same comparison gives
  on the CPU in float32 in the JAX package and in the port
  (tests/moist_precision_gap.py): LSRK54 (2.4e-7, 2.2e-6, 2.1e-6,
  6.5e-5, 3.3e-7, 3.8e-7), IMEX (5.8e-5, 3.6e-4, 3.3e-4, 9.6e-3,
  1.2e-4, 4.7e-5); the vertical momentum carries most, as in the dry
  steps;
- the f64-table gate on the IMEX path's 35-step state: per variable
  min, max, mean and std (ddof=1) over all nodes, |f32 − table| relative
  to the table field's max magnitude, within bench.py's budgets
  (bench.py:105-107); the fraction of the CPU anchor budgets
  (tests/test_precision_gate.py:73-75, calibrated for 200 steps of a
  4×3 grid) is reported, not checked;
- mass Σ M ρ (and Σ M ρq_tot on the moist paths), summed in float64:
  relative drift <= 1e-5 over each path
  (float32 round-off; F₂ carries no mass flux, and the filter keeps each
  element's mode 0 but is not exactly conservative on curved elements);
  on the tracer paths Σ M ρχ of each tracer alone (no source touches
  them and the walls pass none, while the rain forms out of ρ and
  ρq_tot and falls out through the bottom wall: their changes are
  reported);
- the tracer path's K1-K4 and layouts against their plain versions, its
  RHS against the plain-stage RHS (GENERIC_RHS_TOL) and its steps
  against the plain-stage steps (STEP_TOL's bound), as above; with the
  kernels bit-identical, all of them equal bit for bit (reported);
- kernel_orders: each kernel on all elements and on the first 37,
  per output within KERNEL_TOL · max|reference| of its plain version on
  the card (float32) or of its plain version in float64 (on the CPU,
  from the same float32 inputs). Neither reference alone separates
  right from wrong at 1e-5 (NVIDIA H100 80GB HBM3): at 48 elements the
  card's cuBLAS sums the plain derivative product in another order than
  the kernels (and cuBLAS at the bench shape) do, and at p5 the float32
  round-off of K1's derivative of h_tot then puts the card's plain
  version 1.8e-5 of max|plain| from float64 and 1.55e-5 from the
  kernel, which is 6.3e-6 from float64; the dry kernel at p1 equals its
  plain version on the card bit for bit, and both are 7.9e-5 from
  float64 (the float32 function's own round-off).  Both errors, the
  card's plain version against float64 and which reference held are
  reported; each RHS per variable within 1e-3 · max|plain-stage RHS|,
  the generic RHS's tolerance below (the card gives at most 3.3e-7 at
  p1-p5 on an NVIDIA H100 80GB HBM3);
- the generic RHS on the card against the RHS with every stage's plain
  version, the all-plain RHS and the var-major RHS, from the same
  perturbed state: per variable, max|Δ| <= 1e-3 · max|other| — float32
  round-off of the flux terms, which cancel to ~1e-5 of their size,
  gives up to 6.4e-5 (ρu, against float64), 4.4e-5 (the kernel path
  against the contraction) and 7.4e-5 (against the var-major RHS, whose
  surface pass extracts its thermo) on the CPU at n_horz=3, n_vert=3,
  p4; the remainder against dg − dg_lin: 1e-2 · max|dg − dg_lin| per
  variable, 7.7× the 1.3e-3 the same comparison gives on the CPU (the
  remainder is the small difference of two large tendencies);
- the forced LES cases (float64): the dry boundary layers' Σ M ρ within
  FORCING_MASS_TOL = 1e-12 relative over their steps (a conservative
  scheme's round-off; their sources leave ρ alone), where ρ itself must
  have moved; TMAR where it acts (BOMEX's q_tot stays at 3-17 g/kg):
  ρq_tot set to −½ its value at TMAR_DIP_SHARE = 1 % of the nodes of
  BOMEX's card state, then q_tot ≥ 0, ∫ρq_tot within TMAR_MASS_TOL =
  1e-12 relative, the other lanes unchanged and the card against
  ``tmar`` on the CPU within TMAR_TOL = 1e-13; DYCOMS's radiation
  paths ``int_att`` / ``int_att_rev`` on the card against the same
  stack integrals of the same integrand in float64 on the CPU within
  RADIATION_TOL = 1e-12 of the path's largest magnitude; BOMEX, DYCOMS
  and the canopy after FORCING_SMALL_STEPS steps on 2 × 2 × 2 elements
  on the card against the port's run on the CPU from the same geometry,
  state and dt, per variable within FORCING_SMALL_TOL = 1e-10 (both
  float64: summation order alone);
- the remainder branches against their plain versions at the bench
  shape: equal bit for bit (they round as the plain versions round);
  the remainder RHS against its plain-stage twin: GENERIC_RHS_TOL (bit
  for bit on an NVIDIA H100 80GB HBM3), and the dry var-major remainder
  against the generic remainder: REMAINDER_TOL (3.8e-3 there, "every"
  with gravity; the surface passes extract and recompute their face
  thermo differently); at the other orders each remainder RHS against
  its plain-stage twin within REMAINDER_TOL (:func:`order_rhs_tol`).
"""

from __future__ import annotations

import argparse
import copy
import importlib.util
import json
import math
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time
from dataclasses import replace
from types import SimpleNamespace

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from climatemachine_tpu_torch import cuda_build, resolve_device
from climatemachine_tpu_torch.atmos.boundaryconditions import AtmosBC
from climatemachine_tpu_torch.atmos.linear import (
    AtmosAcousticGravityLinearModel, AtmosAcousticLinearModel)
from climatemachine_tpu_torch.atmos.model import (AtmosModel, AtmosPhysics,
                                                  AtmosProblem)
from climatemachine_tpu_torch.common.orientations import NoOrientation
from climatemachine_tpu_torch.dg import (dry_volume_kernel, ldg_kernel,
                                        ldg_tables, ldg_varmajor,
                                        surface_kernel, volume_kernel)
from climatemachine_tpu_torch.dg.fast_rhs import SURFACE_KERNELS, VarMajorRHS
from climatemachine_tpu_torch.dg.numerical_fluxes import (
    CentralNumericalFluxFirstOrder, HLLCNumericalFlux, LMARSNumericalFlux,
    RoeNumericalFlux, RoeNumericalFluxMoist, RusanovNumericalFlux)
from climatemachine_tpu_torch.dg.columns import ColumnOps
from climatemachine_tpu_torch.dg.spatial import (DGModel, init_ode_state,
                                                 init_state_auxiliary,
                                                 remainder_DGModel)
from climatemachine_tpu_torch.common.turbulence import SmagorinskyLilly
from climatemachine_tpu_torch.diagnostics.atmos_les import (
    AtmosLESCoreGroup, AtmosLESDefaultGroup)
from climatemachine_tpu_torch.diagnostics.fields import AtmosGCMDefaultGroup
from climatemachine_tpu_torch.diagnostics.groups_extra import (
    AtmosGCMSpectraGroup, AtmosMassEnergyLossGroup)
from climatemachine_tpu_torch.diagnostics.state_check import StateCheck
from climatemachine_tpu_torch.driver import callbacks as cbs
from climatemachine_tpu_torch.driver import solver_configs
from climatemachine_tpu_torch.driver.diagnostics_configs import (
    DiagnosticsConfiguration, InterpolationConfiguration)
from climatemachine_tpu_torch.driver.driver import init as driver_init
from climatemachine_tpu_torch.driver.driver import invoke
from climatemachine_tpu_torch.driver.solver_configs import \
    make_solver_configuration
from climatemachine_tpu_torch.driver.solver_types import (
    ExplicitSolverType, HEVISolverType, IMEXSolverType, ImplicitSolverType,
    MISSolverType, MultirateSolverType)
from climatemachine_tpu_torch.experiments.held_suarez import (
    HeldSuarezStepFilter, held_suarez_config, held_suarez_driver)
from climatemachine_tpu_torch.dg.reductions import weightedsum
from climatemachine_tpu_torch.experiments import (
    anelastic1d, bomex_edmf, bomex_les, bomex_single_stack, cfsite_amip,
    ocean_split_explicit, rising_bubble_bryan, rising_bubble_theta,
    solid_body_rotation, timestepping_compare)
from climatemachine_tpu_torch.experiments.forced_les import \
    CASES as FORCED_LES_CASES
from climatemachine_tpu_torch.experiments.gcm_driver import gcm_driver_config
from climatemachine_tpu_torch.experiments.ocean_box import ocean_box_config
from climatemachine_tpu_torch.experiments.risingbubble import \
    risingbubble_config
from climatemachine_tpu_torch.interop import grid_from_numpy, grid_to_numpy
from climatemachine_tpu_torch.io.vtk import readvtk
from climatemachine_tpu_torch.io.writers import NpzWriter
from climatemachine_tpu_torch.mesh.filters import tmar
from climatemachine_tpu_torch.mesh.grid import make_grid, min_node_distance
from climatemachine_tpu_torch.mesh.topology import (brick_topology,
                                                    stacked_brick_topology)
from climatemachine_tpu_torch.ocean import super_model
from climatemachine_tpu_torch.ocean.hydrostatic_boussinesq import \
    HydrostaticBoussinesqModel
from climatemachine_tpu_torch.ocean.problems import Fixed, SimpleBox
from climatemachine_tpu_torch.ocean.shallow_water import (ConstantViscosity,
                                                          ShallowWaterModel)
from climatemachine_tpu_torch.ocean.split_explicit import (
    BarotropicModel, CoupledHBModel, SplitExplicitSolver)
from climatemachine_tpu_torch.ode import ark, mis, mrigark, ssprk
from climatemachine_tpu_torch.ode.ark import ARK2GiraldoKellyConstantinescu
from climatemachine_tpu_torch.ode.lsrk import LSRK54CarpenterKennedy
from climatemachine_tpu_torch.ode.solve import solve
from climatemachine_tpu_torch.physics import thermodynamics as td
from climatemachine_tpu_torch.physics.parameters import EARTH
from climatemachine_tpu_torch.solvers import layout_kernel
from climatemachine_tpu_torch.solvers.columnwise import ColumnLayout
from climatemachine_tpu_torch.solvers.iterative import batched_gmres
from climatemachine_tpu_torch.timing import (PEAK_BYTES, PEAK_FP32_FLOPS,
                                             paired_rounds)

N_HORZ, N_VERT, POLY = 16, 8, 4
N_WARM, N_STEPS = 3, 10            # the explicit path, hyperdiffusion on
N_WARM_OFF, N_STEPS_OFF = 1, 4     # hyperdiffusion off
N_WARM_IMEX, N_STEPS_IMEX = 10, 25  # the IMEX path: the table's 35 steps
KERNEL_TOL = 1e-5
CHAIN_TOL = 1e-4
STEP_TOL = 1e-3
SMALL_TOL = 1e-4
#: per variable (ρ, ρu, ρe): 10× what float32 against float64 gives on
#: the CPU for the same three steps (module docstring)
IMEX_SMALL_TOL = (2e-3, 3e-1, 5e-2, 1e-1, 3e-3)
MASS_TOL = 1e-5
#: the bound on max|u| (m/s) of the moist baroclinic wave's runs
MAX_ABS_U = 150.0
#: the moist baroclinic wave's EquilMoistBiharmonic timescale (s)
MOIST_TAU = 8 * 3600.0
#: per variable (ρ, ρu, ρe, ρq_tot), three moist steps of a small grid in
#: float32 on the card against float64 on the CPU: 10× the larger of what
#: the same comparison gives in float32 on the CPU in the JAX package and
#: in the port (module docstring; tests/moist_precision_gap.py), LSRK54
#: and IMEX
MOIST_SMALL_TOL = (3e-6, 3e-5, 3e-5, 7e-4, 4e-6, 4e-6)
MOIST_IMEX_SMALL_TOL = (6e-4, 4e-3, 4e-3, 1e-1, 2e-3, 5e-4)
#: the moist IMEX small reference's dt: this times the horizontal node
#: distance over 350 m/s (17.5 s; 0.1 is unstable on that grid)
MOIST_SMALL_IMEX_CFL = 0.01
#: halvings of the IMEX dt tried for 35 stable moist steps at full width
MOIST_DT_HALVINGS = 4
#: the f64 table of the IMEX trajectory (data only, read by path)
REFSTATS = (pathlib.Path(__file__).resolve().parent / "tests" / "refvals"
            / "bench_heldsuarez_p4.py")
#: per-statistic (min, max, mean, std) drift budgets relative to the
#: field's max magnitude: bench.py:105-107 (checked) and the CPU anchor
#: of tests/test_precision_gate.py:73-75 (reported)
BENCH_BUDGETS = {"rho": (8e-3, 8e-3, 5e-6, 1e-5),
                 "rhou": (1e-1, 1e-1, 1e-5, 2e-3),
                 "rhoe": (1e-3, 1e-3, 1e-5, 5e-5)}
ANCHOR_BUDGETS = {"rho": (1e-4, 1e-4, 1e-5, 1e-4),
                  "rhou": (3e-2, 3e-2, 1e-5, 1e-3),
                  "rhoe": (1e-4, 1e-4, 2e-5, 1e-4)}
#: the generic RHS on the card against other RHS of the same state, per
#: variable relative to max|reference|: ~13× what float32 gives on the
#: CPU at n_horz=3, n_vert=3, p4 (module docstring)
GENERIC_RHS_TOL = 1e-3
REMAINDER_TOL = 1e-2
SOURCES = ("volume_vm", "ldg_chain", "column_layout", "surface_vm")
DRY = "dry_volume_tendency"
CHAIN = ("ldg_first", "ldg_grad_to_div", "ldg_div_to_grad", "ldg_last")
EXPLICIT = ("fused_volume_tendency_vm",) + CHAIN
LAYOUT = ("to_blocks_vm", "from_blocks_vm")
#: layout dims (Eh, nv, nvars, Nq3, ji) the layout kernels are also held
#: at: the small IMEX grid's, an odd Eh (a tail tile, scalar y side), p3
LAYOUT_EDGE_DIMS = ((24, 3, 5, 5, 25), (37, 2, 5, 5, 25), (96, 4, 5, 4, 16))
#: the layout kernels' timing: interleaved rounds of launches rotating
#: through distinct inputs (4 × 30.72 MB > the 50 MB L2)
LAYOUT_ROUNDS, LAYOUT_LAUNCHES, LAYOUT_INPUTS = 9, 20, 4
#: the staged kernels (persistent blocks over tiles of 4 elements): held
#: on a tail of TAIL_E elements as well, and at the other orders
#: (kernel_orders)
TILED = ("fused_volume_tendency_vm", "ldg_first", "ldg_grad_to_div",
         "ldg_div_to_grad", "ldg_last", "dry_volume_tendency")
KERNEL_ROUNDS, KERNEL_LAUNCHES, KERNEL_INPUTS = 9, 20, 4
#: an element count that is no multiple of the kernels' 4-element tile
TAIL_E = 37
#: the other orders the staged kernels are built for (p1-p5,
#: dg/line_ops.py:KERNEL_NQ), held on a small grid (EDGE_GRID: n_horz,
#: n_vert; 48 elements)
EDGE_ORDERS = (1, 2, 3, 5)
EDGE_GRID = (2, 2)
SURFACE = ("extract_trace_vm", "fused_surface_lift_vm")
#: the suffix of the moist branches' entries in the kernels line
MOIST = "[moist]"
#: the surface kernels each surface pass launches, once per RHS
SURFACE_LAUNCHES = {"xla": (), "hybrid": ("extract_trace_vm",),
                    "pallas": SURFACE}
#: the linear models of a fused remainder, by the names of its entries
LIN_MODELS = {"gravity": AtmosAcousticGravityLinearModel,
              "acoustic": AtmosAcousticLinearModel}
#: the remainders the var-major RHS takes: (direction, linear model)
REM_CASES = tuple((ldir, lin) for ldir in ("vertical", "every")
                  for lin in LIN_MODELS)
#: the dry kernel's remainder branches beside the dense IMEX path's
#: vertical acoustic-gravity one, by entry: (direction, linear model)
DRY_REM = {f"{ldir}:{lin}": (ldir, lin) for ldir, lin in (
    ("vertical", "acoustic"), ("horizontal", "gravity"),
    ("horizontal", "acoustic"), ("every", "gravity"), ("every", "acoustic"))}
#: the dense acoustic IMEX path's halvings of the dense path's dt tried
#: for 35 steps with max|u| < MAX_ABS_U
ACOUSTIC_DT_HALVINGS = 6
#: the multirate path: its slow dt over the explicit path's, the fast
#: solver's substep ratio (tests/test_imex.py:206-229), its steps, and
#: the bound on max|u| (m/s) after them
MULTIRATE_DT_RATIO, MULTIRATE_TIMESTEP_RATIO = 4, 4
N_WARM_MR, N_STEPS_MR = 1, 5
MULTIRATE_MAX_ABS_U = 100.0
#: the isentropic vortex (tests/test_isentropic_vortex.py): a periodic
#: VORTEX_NE × VORTEX_NE × VORTEX_NZ brick on [−L, L]³ at p4 (12,288
#: elements: the grid shape of the Held-Suarez rows), its error also at
#: VORTEX_SMALL_NE; the JAX test's L2 bound (:126, at 8 × 8 × 1) and the
#: ρ, ρe drift bound in float32 (the JAX test's float64 bound is 1e-12)
VORTEX_NE, VORTEX_NZ, VORTEX_SMALL_NE = 32, 12, 8
VORTEX_L2_TOL = 3e-4
VORTEX_DRIFT_TOL = 1e-5
#: the vortex's 48-element grid at the other orders (kernel_orders)
VORTEX_EDGE = (4, 3)
#: the vortex's flow (tests/test_isentropic_vortex.py:25-33)
V_P_INF, V_T_INF, V_U_T, V_U_V = 1e5, 300.0, 150.0, 50.0
V_ALPHA, V_R, V_L = math.pi / 4, 1.0 / 200, 1.0 / 20
VORTEX_FLUXES = {"rusanov": RusanovNumericalFlux, "roe": RoeNumericalFlux,
                 "hllc": HLLCNumericalFlux}
#: the suffix of the entries of the branches without the reference
#: pressure taken out (subtract_ref=False, na = 0, subtract=False)
NOSUB = "[nosub]"
#: the moist wave with tracers and warm rain: the tracers' diffusivity
#: ratios, the height H of the second tracer's profile ρχ₂ = ρ z/H (the
#: domain's), the banded IMEX step's layout dims (Eh, nv, nvars, Nq3, ji),
#: the suffix of its layout entries in the kernels line, the explicit steps
#: of each other flux and of rain with snow, and those fluxes
TRACER_DELTA = (1.0, 2.0)
TRACER_H = 30e3
TRACER_LAYOUT_DIMS = (1536, 8, 9, 5, 25)
#: the IMEX paths' first dt: the dry IMEX dt over 2^this, the moist
#: var-major IMEX path's first stable halving (5.46 s at full width; 10.91
#: s turned NaN on this path too, PERF.md PR 13)
TRACER_IMEX_HALVINGS = 2
#: the rain (and snow) of the runs that start with some: ρq = this · ρ
#: below RAIN_TOP, so that the microphysics, the sedimentation and the
#: rain's fall through the bottom wall act from the first step (the
#: wave's own state makes no rain in these steps)
RAIN_START, RAIN_TOP = 1e-4, 5e3
TRACERS = "_tracers"
N_STEPS_TR_FLUX = 3
TRACER_FLUXES = {"roe": RoeNumericalFlux, "roe_moist": RoeNumericalFluxMoist,
                 "hllc": HLLCNumericalFlux, "lmars": LMARSNumericalFlux}
#: kernel name -> (wrapper, plain version, source, TPU kernel it replaces)
# the rising-bubble LES (experiments/risingbubble.py, the JAX package's
# examples/risingbubble.py): the 2500 m cube at Δ = 25 m, p4
LES = "[les]"
LES_RESOLUTION = 25.0
LES_ELEMENTS = 15625
LES_COURANT = 0.4
LES_WARM, LES_STEPS = 3, 10
LES_SMALL_RESOLUTION = 2500.0 / 12      # 3 × 3 × 3 elements at p4
LES_SMALL_STEPS = 3
# float32 on the card against float64 on the CPU after LES_SMALL_STEPS
# steps of the small box, per variable (ρ, ρu, ρe; the momentum's
# components over the largest): the same gap with float32 on the CPU is
# 2.7e-7, 1.8e-3, 7.7e-7, with or without the closure (float32's
# rounding of the hydrostatic balance, felt by a momentum that starts
# at rest); these are 11-37 times that
LES_SMALL_TOL = (1e-5, 2e-2, 2e-2, 2e-2, 1e-5)
# invoke's norm(Q)/norm(Q0), as tests/test_driver.py bounds it
LES_RATIO_TOL = 0.1

# the forced LES cases (experiments/bomex_les.py, dycoms.py,
# boundary_layer_les.py, canopy_sgstke.py), float64 at their examples'
# defaults: BOMEX at the published 100 × 100 × 40 m over 6.4 × 6.4 × 3
# km (16 × 16 × 19 elements), DYCOMS-II RF01 6 × 6 × 19, the convective
# boundary layer 15 × 15 × 20, the stable one 1 × 1 × 10, the canopy 2 ×
# 2 × 5
FORCING_ELEMENTS = {"bomex": 4864, "dycoms": 684, "convective_bl": 4500,
                    "stable_bl": 10, "canopy": 20}
# BOMEX: warm steps, then timed steps; every other case 1 + 2
FORCING_WARM, FORCING_STEPS = 3, 10
FORCING_CASE_WARM, FORCING_CASE_STEPS = 1, 2
# Σ M ρ of the dry boundary layers, whose sources leave ρ alone, summed in
# float64: relative drift over their steps (float64 round-off of a
# conservative scheme; BOMEX's large-scale moisture sink and the moist
# cases' surface water flux change the mass, which is reported)
FORCING_MASS_TOL = 1e-12
# BOMEX's q_tot stays at 3-17 g/kg over its steps, so TMAR is also held
# where it acts: ρq_tot set to −½ its value at this share of the nodes,
# then ∫ρq_tot kept within TMAR_MASS_TOL relative (TMAR rescales each
# element to its integral) and the card against the CPU within TMAR_TOL
# of the largest ρq_tot (both float64)
TMAR_DIP_SHARE, TMAR_SEED = 0.01, 0
TMAR_MASS_TOL = 1e-12
TMAR_TOL = 1e-13
# the radiation's attenuation paths on the card against the same stack
# integrals of the same integrand in float64 on the CPU: max|Δ| over the
# path's largest magnitude (the card and the CPU sum in other orders)
RADIATION_TOL = 1e-12
# the 2 × 2 × 2-element boxes at p4 ((Δx, Δy, Δz), then the domain where
# the case's builder takes one: DYCOMS's is fixed) of BOMEX,
# DYCOMS and the canopy: FORCING_SMALL_STEPS steps in float64 on the card
# against the port's float64 run on the CPU from the same state, per
# variable (the momentum's components over the largest): both are float64
# and differ in summation order alone
FORCING_SMALL_BOXES = {
    "bomex": ((800.0, 800.0, 375.0), (6400.0, 6400.0, 3000.0)),
    "dycoms": ((105.0, 105.0, 187.5),),
    "canopy": ((12.5, 12.5, 12.5), (100.0, 100.0, 100.0))}
FORCING_SMALL_STEPS = 3
FORCING_SMALL_TOL = 1e-10

#: the ocean box of examples/ocean_box_gcm.py at its defaults
OCEAN_NELEM = (20, 20, 20)
OCEAN_WARM, OCEAN_STEPS = 3, 10
#: |Δ∫η dV| <= OCEAN_VOLUME_TOL · |V · η scale| + 1e-12, the volume check of
#: tests/test_ocean.py:195 (its η scale the bump's amplitude; the box's
#: the largest |η| of the run)
OCEAN_VOLUME_TOL = 1e-10
#: the Julia reference's golden tables (data only, read by path) and the
#: JAX tests' configurations: (problem, H, dt, steps, table)
REFVALS = pathlib.Path(__file__).resolve().parent / "tests" / "refvals"
OCEAN_GATES = {"windstress": ("homogeneous", 400.0, 180.0, 20,
                              "explicit_cpu"),
               "ocean_gyre": ("gyre", 1000.0, 120.0, 30, "short")}
#: the split-explicit gyre (experiments/ocean_split_explicit.py): nx × nx
#: × nz elements, warm and timed slow steps, each with its 5 IVDC solves
SPLIT_NX, SPLIT_NZ = 20, 20
SPLIT_WARM, SPLIT_STEPS = 1, 3
#: θ stays within the restoring target's [0, θᴱ = 10] widened by 1 K for
#: the DG overshoot (the initial θ lies in [0, 9]); explicit convective
#: mixing at κᶜ = 0.1 beside IVDC leaves it within 3 steps at 20 layers
SPLIT_THETA_RANGE = (-1.0, 11.0)
#: every GMRES residual ‖b − Lx‖/‖b‖, b = θⁿ/Δt of its own solve
SPLIT_GMRES_TOL = 1e-10
#: the Julia spindown of tests/test_split_explicit_refvals.py:55-183 and
#: tests/test_ocean_golden_extra.py:147-171: 5 × 5 elements (× 8 layers)
#: at p4 over 1e6 × 1e6 × 400 m, 288 steps at 300 s; the analytic bound
SPINDOWN_STEPS, SPINDOWN_DT, SPINDOWN_ERR = 288, 300.0, 0.005
#: the split01 variants at the Julia width: warm and timed slow steps
SPLIT01_WARM, SPLIT01_STEPS = 1, 3
#: the multirate spindown (tests/test_split_explicit_refvals.py:186-293):
#: slow dt in minutes and each table's digits on the primary fields
MULTIRATE_GATES = {30: ("thirty_minutes", 4.0), 60: ("sixty_minutes", 4.0),
                   90: ("ninety_minutes", 3.0)}
#: the vertical_integral tables (:296-343): t of each.  The year and
#: decade tables are 1.2e-11 and 9e-11 off the exact exp(M t) (60-digit
#: mpmath), beyond their 12-digit gate (5e-12), and the JAX package
#: computes NaN there (its expm takes more than 16 squarings), so its
#: test never held them: they run with --julia-gates, at 12 digits
VERTINT_TABLES = {"initial": 0.0, "day": 86400.0, "month": 30 * 86400.0,
                  "year": 365 * 86400.0, "decade": 3650 * 86400.0,
                  "century": 36500 * 86400.0}
VERTINT_DEFAULT = ("initial", "day", "month", "century")
#: batched_gmres on the card: systems, size, Krylov vectors, restarts; the
#: solution against the CPU's in float64, each residual against its ‖b‖
BATCHED_GMRES = (64, 200, 40, 3)
BATCHED_GMRES_TOL = 1e-10
#: the Julia 5-day gates (tests/test_simple_box_ivd_refvals.py:150-235 and
#: :392-438): (make_julia keywords, slow steps, refvals file); the window
#: diagnostics are skipped and the rest gated at 2 digits (:160-170)
JULIA_GATES = {
    "simple_box_ivd": (dict(variant="split01"), 80, "simple_box_ivd"),
    "simple_box_2dt": (dict(variant="split01", num_impl_steps=0), 80,
                       "simple_box_2dt"),
    "simple_box_rk3": (dict(variant="split01_3n"), 108, "simple_box_rk3"),
    "dbl_gyre": (None, 75, "simple_dbl_gyre")}
JULIA_WINDOW_FIELDS = ("w", "wz0", "Δη", "ΔGu[1]", "ΔGu[2]", "Gᵁ[1]",
                       "Gᵁ[2]", "Δu[1]", "Δu[2]")
#: the double gyre's gates: the digits its full run reached less one
#: (tests/test_simple_box_ivd_refvals.py:392-422), capped by the table's
DBL_GYRE_GATES = {
    ('baro Q_2D', 'U[1]'): [3.0, 3.5, 4.0, 5.0],
    ('baro Q_2D', 'U[2]'): [3.5, 2.5, 4.0, 4.0],
    ('baro Q_2D', 'η'): [4.0, 5.0, 2.0, 4.5],
    ('baro aux', 'Gᵁ[1]'): [2.0, 4.5, 3.0, 3.5],
    ('baro aux', 'Gᵁ[2]'): [3.5, 2.0, 4.0, 3.5],
    ('baro aux', 'U_c[1]'): [3.0, 3.5, 4.0, 5.0],
    ('baro aux', 'U_c[2]'): [3.5, 2.5, 4.0, 4.0],
    ('baro aux', 'U_s[1]'): [3.0, 3.5, 4.0, 5.0],
    ('baro aux', 'U_s[2]'): [3.5, 2.5, 4.0, 4.0],
    ('baro aux', 'y'): [12.0, 12.0, 12.0, 12.0],
    ('baro aux', 'Δu[1]'): [1.0, 3.5, 4.5, 4.0],
    ('baro aux', 'Δu[2]'): [3.5, 3.0, 4.5, 4.0],
    ('baro aux', 'Δη'): [1.5, 0.5, 0.5, 0.5],
    ('baro aux', 'η_c'): [4.0, 5.0, 2.0, 4.5],
    ('baro aux', 'η_diag'): [4.0, 5.0, 2.0, 4.5],
    ('baro aux', 'η_s'): [4.0, 5.0, 2.0, 4.5],
    ('oce Q_3D', 'u[1]'): [3.5, 3.5, 4.0, 5.0],
    ('oce Q_3D', 'u[2]'): [4.0, 3.5, 4.0, 4.0],
    ('oce Q_3D', 'η'): [4.0, 5.0, 2.0, 4.5],
    ('oce Q_3D', 'θ'): [1.5, 4.0, 4.0, 4.0],
    ('oce aux', 'pkin'): [4.5, 12.0, 5.0, 5.0],
    ('oce aux', 'u_d[1]'): [5.0, 4.0, 3.5, 5.0],
    ('oce aux', 'u_d[2]'): [4.0, 3.5, 3.5, 5.0],
    ('oce aux', 'w'): [3.5, 3.5, 1.5, 5.5],
    ('oce aux', 'wz0'): [2.0, 4.0, 4.5, 4.0],
    ('oce aux', 'y'): [12.0, 12.0, 12.0, 12.0],
    ('oce aux', 'ΔGu[1]'): [4.5, 2.0, 3.0, 3.5],
    ('oce aux', 'ΔGu[2]'): [2.0, 3.5, 4.0, 3.5],
}
#: the GCM driver entry: Held-Suarez steps through ``invoke`` per surface
#: pass, the restart's k, its dyadic dt (k·dt and 2k·dt exact), LSRK54
#: steps of the composable GCM, solid-body rotation's end time
GCM_STEPS = 5
GCM_RESTART_K, GCM_RESTART_DT = 3, 0.5
GCM_LSRK_STEPS = 3
#: solid-body rotation: the example's end time and the dt its Courant
#: number gives at its defaults (the JAX example's, 7200 s / 41 steps)
SBR_TIMEEND, SBR_DT = 7200.0, 7200.0 / 41
#: diagnostics: the LES cases' (warm, timed steps, write interval,
#: groups); a profile's bound against the CPU, relative to its largest
#: |value|, and the factor on its change under a 2⁻⁵⁰ relative
#: perturbation of the state that is added to it (its round-off)
DIAG_LES = {"dycoms": (1, 2, 1, ("default", "core")),
            "bomex": (FORCING_WARM, FORCING_STEPS, 5, ("default",))}
DIAG_LES_GROUPS = {"default": AtmosLESDefaultGroup, "core": AtmosLESCoreGroup}
DIAG_PROFILE_TOL = 1e-12
DIAG_ROUNDOFF_EPS, DIAG_ROUNDOFF_FACTOR = 2.0 ** -50, 64.0
DIAG_SEED = 19
#: Held-Suarez steps with and without the GCM groups; the interpolated
#: nodal radius against the target radii (relative)
DIAG_GCM_STEPS = 5
DIAG_GCM_GRID = (91, 180, 4 * N_VERT)
INTERP_RADIUS_TOL = 1e-5
#: the StateCheck case (tests/test_statecheck_refvals.py): steps, and the
#: card's float32 statistics against the CPU's float32 ones (relative;
#: the momentum's over its largest magnitude)
STATECHECK_STEPS = 30
STATECHECK_TOL = 1e-5
# the remaining atmosphere formulations, float64 at their examples'
# widths: the EDMF single stack (experiments/bomex_edmf.py, 15 elements),
# the BOMEX single stack (20), the ρθ bubble (12 × 12 × 12), the cfsite
# AMIP LES (6 × 6 × 50); the EDMF cases' steps after the first RHS
EDMF_ELEMENTS, SINGLE_STACK_ELEMENTS = 15, 20
THETA_ELEMENTS, CFSITE_ELEMENTS = 1728, 1800
EDMF_STEPS = {"decoupled": 10, "coupled": 10, "moist": 3}
EDMF_SEED = 20
# the card against the port's float64 CPU run of the same steps, per
# variable over its largest value: both float64, summed in other orders
FORMULATION_TOL = 1e-10
# the θ_liq variance lane, which the JAX package does not reproduce to
# 1e-10 itself under another XLA optimization level
# (tests/edmf_parity.py, TOL_STEPS_LANES)
EDMF_LANE_TOL = {"turbconv.en_rhoatheta_liq_cv": 5e-10}
# invoke's warm and timed steps; the ρθ bubble's relative drift of ∫ρ
# and ∫ρθ (pure advection: round-off); its 2 × 2 × 2 box against the CPU
FORMULATION_WARM, FORMULATION_STEPS = 3, 10
THETA_DRIFT_TOL = 1e-12
THETA_SMALL_RESOLUTION = (312.5, 312.5, 312.5)
# Anelastic1D: ρ = ρ_ref and p = p_ref within ANELASTIC_TOL relative, ρw
# (0 at the start, no vertical momentum tendency) within ANELASTIC_RHOW
ANELASTIC_STEPS = 10
ANELASTIC_TOL = 1e-14
ANELASTIC_RHOW = 1e-10

#: the remaining time integrators (phase_time_integrators): each ARK
#: tableau but ARK2GKC, each SSPRK method, MIS and MRI-GARK method, with
#: its stages; MIS's fast methods and substeps a unit stage (the
#: multirate path's split, dt and ratio: tests/test_imex.py:206-229)
ARK_TABLEAUS = {"ARK1ForwardBackwardEuler": 2,
                "ARK2ImplicitExplicitMidpoint": 2,
                "ARK548L2SA2KennedyCarpenter": 8,
                "ARK437L2SA1KennedyCarpenter": 7, "DBM453VoglEtAl": 5}
SSPRK_METHODS = {"SSPRK22Heuns": 2, "SSPRK22Ralstons": 2,
                 "SSPRK33ShuOsher": 3, "SSPRK34SpiteriRuuth": 4}
MIS_METHODS = {"MIS2": 4, "MIS3C": 4, "MISRK3": 4}
MIS_FAST = {"LSRK54": LSRK54CarpenterKennedy,
            "SSPRK33": ssprk.SSPRK33ShuOsher}
MRI_METHODS = {"MRIGARKERK33aSandu": 3, "MRIGARKERK45aSandu": 5}
MIS_NSUBSTEPS = 4
N_WARM_SSP, N_STEPS_SSP = 3, 10
N_WARM_MIS, N_STEPS_MIS = 1, 2
N_WARM_JFNK, N_STEPS_JFNK = 1, 1
#: a path's halvings of its dt tried until its steps stay stable
INTEGRATOR_DT_HALVINGS = 4
#: the float64 HEVI and Implicit runs' Newton and Krylov counts (those
#: of tests/test_solver_types.py)
JFNK_F64 = (3, 12)
#: the small grid's steps, card (float32) against the CPU (float64) from
#: a state with a solid-body wind, and the tolerance per solver family of
#: the error relative to each variable's max (ρu's over its components;
#: on a CPU float32 against float64 gave ≤ 1.7e-3 ARK, 2.5e-6
#: SSPRK, 2.7e-5 MIS and MRI-GARK); besides, each variable's error must
#: stay below INTEGRATOR_SMALL_CHANGE_FRACTION of what the steps change it
#: by on the CPU (the least change, ρ's, 2.8e-3 to 5.1e-3 of max ρ; the
#: largest ratio on a CPU 0.14, ARK's ρw), so a card step that leaves a
#: variable unmoved fails; the float64 HEVI and
#: Implicit card runs against the CPU's, by their Newton-Krylov
#: difference steps: a Jacobian product's round-off is ~1e-16/ε of it,
#: 1e-6 at HEVI's ε = 1e-10 (measured 6.0e-8 on an H100),
#: 1e-9 at Implicit's 1e-7 (measured 1.5e-11)
INTEGRATOR_SMALL_STEPS = 2
#: the small grid's IMEX, HEVI and Implicit dt over its horizontal
#: acoustic limit (0.1 there blows ARK1 up: its forward-Euler part)
SMALL_IMEX_CFL = 0.02
#: the card's device (the phase's CPU rehearsal sets "cpu")
CARD = "cuda"
INTEGRATOR_SMALL_TOL = {"ark": 5e-3, "ssprk": 3e-5, "mis": 3e-4,
                        "mri": 3e-4}
INTEGRATOR_SMALL_CHANGE_FRACTION = 0.5
JFNK_SMALL_TOL = {"hevi": 1e-6, "implicit": 1e-9}
#: the examples' (resolution, end time): the Bryan bubble's smoke (its
#: docstring's) and its defaults; the time-stepping comparison at 500 m
#: to its docstring's 10 s, and its defaults (float64 on the plain
#: operator on the card, 125 m to 50 s: minutes); the defaults with
#: --numerics-examples
BRYAN_SMOKE, BRYAN_DEFAULTS = (500.0, 20.0), (250.0, 100.0)
COMPARE_SMOKE, COMPARE_DEFAULTS = (500.0, 10.0), (125.0, 50.0)

KERNELS = {
    "fused_volume_tendency_vm": (
        volume_kernel.fused_volume_tendency_vm,
        volume_kernel.volume_tendency_plain, "volume_vm.cu",
        "climatemachine_tpu/dg/pallas_volume.py:264"),
    **{name: (getattr(ldg_kernel, name), getattr(ldg_kernel, name + "_plain"),
              "ldg_chain.cu", f"climatemachine_tpu/dg/pallas_ldg.py:{line}")
       for name, line in zip(CHAIN, (197, 214, 232, 249))},
    **{name: (getattr(layout_kernel, name),
              getattr(layout_kernel, name + "_plain"), "column_layout.cu",
              f"climatemachine_tpu/solvers/pallas_layout.py:{line}")
       for name, line in zip(LAYOUT, (43, 70))},
    DRY: (
        dry_volume_kernel.dry_volume_tendency,
        dry_volume_kernel.dry_volume_tendency_plain, "volume_vm.cu",
        "climatemachine_tpu/dg/pallas_volume.py:101"),
    "extract_trace_vm": (
        surface_kernel.extract_trace_vm, surface_kernel.extract_trace_plain,
        "surface_vm.cu", "climatemachine_tpu/dg/pallas_surface.py:77"),
    "fused_surface_lift_vm": (
        surface_kernel.fused_surface_lift_vm,
        surface_kernel.surface_lift_plain, "surface_vm.cu",
        "climatemachine_tpu/dg/pallas_surface.py:216")}


def emit(phase: str, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(ok: bool, what):
    """A failed check ends the run (unlike assert, also under -O)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, n: int, warm: int = 3) -> float:
    """Mean device time of ``fn`` in ms over n calls (CUDA events)."""
    for _ in range(warm):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def library_call(to_blocks: bool, dims):
    """One ``permute(...).contiguous()`` computing a layout kernel's
    function (to_blocks_vm or from_blocks_vm) at layout dims ``dims``."""
    Eh, nv, nvars, Nq3, ji = dims
    view = (Eh, nv, nvars, Nq3, ji) if to_blocks else (nv, Nq3, nvars, Eh, ji)
    perm = (1, 3, 2, 0, 4) if to_blocks else (3, 0, 2, 1, 4)
    return lambda x: x.view(view).permute(perm).contiguous()


def layout_input_shape(to_blocks: bool, dims):
    """The input shape of to_blocks_vm (x) or from_blocks_vm (y)."""
    Eh, nv, nvars, Nq3, ji = dims
    return ((Eh * nv, nvars, Nq3 * ji) if to_blocks
            else (nv, Nq3 * nvars, Eh * ji))


def launch_counts() -> dict:
    return {name: k[0].launches for name, k in KERNELS.items()}


def reset_launch_counts():
    for wrapper, *_ in KERNELS.values():
        wrapper.launches = 0


def costs(name: str, E: int, Np: int, Nq: int, n: int, nd: int, F: int,
          has_f2: bool = True, dense: bool = True, lin_dims: tuple = (),
          lin_gravity: bool = True, nq: int = 5, subtract: bool = True):
    """(bytes, flops) of one call: each input read once, each output
    written once (float32; the int32 face tables and the operator once:
    its dense matrix, or sum-factorised the Nq × Nq weights of each
    direction's lines; of ν only its first row, ν₄); the 0/1 face
    selection and lift as data movement.  The derivative products are
    counted ``dense`` (Np terms per node and direction, as the TPU
    kernels compute them) or sum-factorised (Wd and Wdiv are Kronecker
    operators with Nq nonzeros a row, as K1-K3 and the volume kernels
    compute them).  Per node, the volume tendency of nq variables does
    2·nq·3 terms for the contraction, 111 for flux, metric and mass (21
    more for the advected ρq_tot at nq = 6), 106 for F₂ (24 more for its
    q_tot row, which reads ν₄_q too) and nq for the MI scaling; the dry
    volume tendency 13 more for its thermo (e_int, T, p from q and φ in
    place of p); a remainder reads ref3 (and φ, in the var-major kernel)
    and does 8 more for p_L and the energy coefficient (9 without
    gravity) and 21 for the linear flux of each direction in
    ``lin_dims`` (29 for the vertical remainder); without ``subtract``
    p_ref is not read."""
    R, X = 3 * n, nd * 3
    K = Np if dense else Nq
    deriv = lambda rows: 2 * E * rows * nd * Np * K
    op = Np * Np if dense else Nq * Nq
    wd, sel, lift = 4 * nd * op, 4 * F, 4 * 2 * Np
    lin = (8 + (not lin_gravity) + 21 * len(lin_dims)) if lin_dims else 0
    if name == "fused_volume_tendency_vm":
        f2_rows = 3 * (nq - 1) + (1 if nq == 5 else 2)     # gl2 and ν
        nbytes = 4 * (E * Np * (nq + 1 + subtract + 9 + 1 + 1 + nq
                                + (f2_rows if has_f2 else 0)
                                + (4 if lin_dims else 0))
                      + 3 * op)
        return nbytes, E * Np * (2 * nq * 3 * K + 111 + 21 * (nq - 5) + nq
                                 + (106 + 24 * (nq - 5) if has_f2 else 0)
                                 + lin)
    if name == DRY:
        nbytes = 4 * (E * Np * (5 + 1 + subtract + 9 + 1 + 1 + 5
                                + (3 if lin_dims else 0))
                      + 3 * op)
        return nbytes, E * Np * (2 * 5 * 3 * K + 111 + 5 + 13 + lin)
    if name == "ldg_first":
        nbytes = 4 * E * (n * Np + X * Np + R * Np + n * F) + wd + sel
        return nbytes, deriv(n) + E * R * Np * (2 * nd - 1)
    if name == "ldg_grad_to_div":
        nbytes = 4 * E * (R * Np + n * F + 6 * F + Np + X * Np + n * Np
                          + n * F) + wd + sel + lift
        return nbytes, (deriv(R) + E * R * (F + 2 * Np)
                        + E * n * Np * 2 * X + E * n * F * 5)
    if name == "ldg_div_to_grad":
        nbytes = 4 * E * (n * Np + n * F + F + Np + X * Np + R * Np
                          + n * F) + wd + sel + lift
        return nbytes, (deriv(n) + E * n * (F + 2 * Np)
                        + E * R * Np * (2 * nd - 1))
    nbytes = 4 * E * (R * Np + n * F + 3 * F + Np + R * Np) + lift
    return nbytes, E * R * (F + 2 * Np)


def surface_costs(name: str, args, has_hyper: bool, dense: bool,
                  nq: int = 5, na: int = 1, lin_lanes: int = 0):
    """(bytes, flops) of one surface-kernel call of nq variables, from its
    arguments: each input the kernel needs read once (the extraction
    needs ∇Δ, ν and the normals only with hyperdiffusion, and of ν only
    its first row, ν₄, at nq = 5: the second, ν₄_q, enters only with the
    sixth variable), the int32 face tables in place of the 0/1 matrix,
    each output written once (float32).  Flops: a face lane's trace (32
    with hyperdiffusion, 7 more for the q_tot lane), its ghost, two
    fluxes, Rusanov flux and sM scaling (98, +20 for the hyperdiffusive
    correction, +10 for the sixth variable), on each of the remainder's
    ``lin_lanes`` linear face lanes its two linear fluxes and their
    Rusanov flux taken out (30 + 6 nq), the lift's sum of each lane onto
    its node and the MI scaling; ``dense`` counts the extraction and the
    lift instead as the products with the 0/1 matrix that the TPU kernels
    compute, over the rows the function needs.  ``na`` aux lanes (1, or 4
    for a remainder's bundle)."""
    nu_rows = 1 if nq == 5 else 2
    if name == "extract_trace_vm":
        qv, lift = args[0], args[6]
        E, _, Np = qv.shape
        X = lift.shape[1]
        sel_idx, _ = surface_kernel.face_tables(lift, transposed=False)
        read = list(args[:4]) + [sel_idx] + (
            [args[4], args[5][:, :nu_rows], args[7]] if has_hyper else [])
        # extracted volume rows and bundle lanes written
        rows = nq + 2 + na + (3 * (nq - 1) + nu_rows) * has_hyper
        nvb = nq + 2 + na + nq * has_hyper
        nbytes = 4 * (sum(t.numel() for t in read) + E * nvb * X)
        flops = (32 + 7 * (nq - 5)) * E * X * has_hyper + (
            2 * E * rows * Np * X if dense else 0)
        return nbytes, flops
    E, _, X = args[0].shape
    Np = args[5].shape[1]
    _, lift_idx = surface_kernel.face_tables(args[5], transposed=True)
    read = list(args[:5]) + [lift_idx, args[6]]
    nbytes = 4 * (sum(t.numel() for t in read) + E * nq * Np)
    lift = 2 * E * nq * X * Np if dense else E * nq * X
    return nbytes, (E * X * (98 + 20 * has_hyper + 10 * (nq - 5)) + lift
                    + E * lin_lanes * (30 + 6 * nq) + E * nq * Np)


def bounds(name: str, rhs, n: int, has_f2: bool = True, args=None,
           has_hyper: bool = True, kw=None) -> dict:
    """The kernel's bound, the larger of bytes over the memory rate and
    flops over the fp32 rate, for the work it does (``bound_ms``, the
    kernels line's: derivatives sum-factorised, the surface kernels'
    extraction and lift as a gather and a sum) and for the dense count
    of the TPU kernels (``bound_dense_ms``); ``kw`` the kernel's keyword
    arguments (a remainder's ``lin_dims``, ``lin_gravity``, ``na``,
    ``rem_lanes`` and face lanes)."""
    g, kw = rhs.grid, kw or {}
    nd, F = (rhs.chain.Wd.shape[0], rhs.chain.fo.F) if rhs.hd else (0, 0)
    nq = kw.get("nq", rhs.nq)
    lin_lanes = (kw["sl_hi"] - kw["sl_lo"]) if kw.get("rem_lanes") else 0
    out = {}
    for key, dense in (("", False), ("_dense", True)):
        if name in SURFACE:
            nbytes, flops = surface_costs(name, args, has_hyper, dense, nq,
                                          kw.get("na", 1), lin_lanes)
        else:
            nbytes, flops = costs(name, g.nelem, g.Np, g.Nq[0], n, nd, F,
                                  has_f2, dense, tuple(kw.get("lin_dims", ())),
                                  kw.get("lin_gravity", True), nq,
                                  kw.get("subtract_ref", True))
        t_bytes = 1e3 * nbytes / PEAK_BYTES
        t_ops = 1e3 * flops / PEAK_FP32_FLOPS
        out.update({"bytes": nbytes, "bytes_ms": t_bytes,
                    f"flops{key}": flops, f"ops{key}_ms": t_ops,
                    f"bound{key}_ms": max(t_bytes, t_ops),
                    f"bound{key}_by": ("bytes" if t_bytes > t_ops
                                       else "operations")})
    return out


def phase_device():
    dev = resolve_device(None)
    check(dev.type == "cuda", dev)
    check(torch.backends.cuda.matmul.allow_tf32 is False, "TF32 matmul on")
    check(torch.backends.cudnn.allow_tf32 is False, "TF32 cuDNN on")
    check(torch.get_float32_matmul_precision() == "highest",
          ("float32 matmul precision", torch.get_float32_matmul_precision()))
    emit("device", name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=nvidia_smi(),
         torch=torch.__version__, cuda=torch.version.cuda,
         tf32_matmul=torch.backends.cuda.matmul.allow_tf32,
         tf32_cudnn=torch.backends.cudnn.allow_tf32)


def phase_build():
    t0 = time.perf_counter()
    built = cuda_build.build(*SOURCES)
    wall = time.perf_counter() - t0
    for name, info in built.items():
        ptxas = [ln.strip() for ln in info["log"].splitlines()
                 if "registers" in ln or "spill" in ln or "Compiling" in ln]
        emit("build", library=name, built=info["built"],
             seconds=info["seconds"], parallel_wall_s=wall, ptxas=ptxas)


def chain_inputs(rhs, q, aux):
    """Each kernel's inputs on the main path from state (q, aux), the
    chain's stages run in their plain versions: {kernel name: args}, and
    the chain input."""
    g = rhs.grid
    _, p, _, _ = rhs._thermo_update(q, aux, False)
    glv = rhs.chain_input(q, aux, p)
    args, gl2 = chain_stage_args(glv, rhs.chain, g)
    volume_args = (q, p, aux[:, rhs.i_phi], aux[:, rhs.i_pref].contiguous(),
                   None, gl2, rhs.nu, rhs.xiv, g.M, g.MI, g.Wdiv)
    return glv, {"fused_volume_tendency_vm": volume_args, **args}


def chain_stage_args(glv, ops, g):
    """K1-K4's inputs from the chain input ``glv`` ``[E, n, Np]`` on the
    chain operators ``ops``, each stage run in its plain version:
    ({kernel name: args}, ∇Δ ``[E, 3·n, Np]``)."""
    vol1, rows1 = ldg_kernel.ldg_first_plain(glv, ops.xi, ops.Wd, ops.fo)
    args2 = (vol1, ldg_kernel.face_jump(rows1, ops), ops.w3, ops.nrm,
             ops.MI, ops.xi, ops.Wd, ops.fo)
    div, s = ldg_kernel.ldg_grad_to_div_plain(*args2)
    args3 = (div, ldg_kernel.face_jump(s, ops, signed=True), ops.sM, ops.MI,
             ops.xi, ops.Wd, ops.fo)
    vol3, rows3 = ldg_kernel.ldg_div_to_grad_plain(*args3)
    args4 = (vol3, ldg_kernel.face_jump(rows3, ops), ops.w3, ops.MI, ops.fo)
    gl2 = ldg_kernel.ldg_last_plain(*args4).reshape(
        g.nelem, 3 * glv.shape[1], g.Np)
    return {"ldg_first": (glv, ops.xi, ops.Wd, ops.fo),
            "ldg_grad_to_div": args2, "ldg_div_to_grad": args3,
            "ldg_last": args4}, gl2


def yardstick(name, args, rhs, has_hyper: bool = True):
    """A bare float32 torch.matmul of the kernel's largest product (not
    the same function): the derivative rows against all nd directions,
    the lift of K4, the volume's weak divergence, the surface's extraction
    of all its volume rows and its lift of the nq flux rows."""
    g, nq = rhs.grid, rhs.nq
    E, Np = g.nelem, g.Np
    if name == "extract_trace_vm":
        rows = nq + 3 + (3 * (nq - 1) + 2) * has_hyper
        a = torch.randn((E * rows, Np), device=g.device)
        b = g.lift
    elif name == "fused_surface_lift_vm":
        a, b = torch.randn((E * nq, rhs.liftT.shape[0]),
                           device=g.device), rhs.liftT
    elif name in ("fused_volume_tendency_vm", DRY):
        a, b = torch.randn((E * nq, 3 * Np), device=g.device), g.Wdiv.T
    elif name == "ldg_last":
        n = rhs.bl.gradlap_spec.num
        a, b = args[1].new_empty((E * 3 * n, args[1].shape[2])).normal_(), \
            args[4].LT
    else:
        n = rhs.bl.gradlap_spec.num
        rows = 3 * n if name == "ldg_grad_to_div" else n
        a = torch.randn((E * rows, Np), device=g.device)
        b = rhs.chain.Wd.transpose(0, 1).reshape(Np, -1)
    b = b.contiguous()
    return cuda_ms(lambda: torch.matmul(a, b), 50)


def on_cpu_f64(args):
    """``args`` with every tensor and the face tables on the CPU, the
    floating ones in float64."""
    def move(t):
        return t.to("cpu", torch.float64) if t.is_floating_point() \
            else t.cpu()
    return tuple(
        move(a) if isinstance(a, torch.Tensor)
        else ldg_tables.FaceOps(*map(move, (a.Sel, a.LT, a.sel_idx,
                                            a.lift_idx)))
        if isinstance(a, ldg_tables.FaceOps) else a for a in args)


def max_abs_diffs(got, ref) -> list:
    return [(g.double().cpu() - r.double().cpu()).abs().max().item()
            for g, r in zip(got, ref)]


def compare(name, args, kw):
    """The kernel's and the plain version's outputs on ``args``: (max|Δ|
    per output, max|plain| per output, all outputs finite, the kernel's
    outputs).  A surface kernel is held per lane of its output (each
    bundle lane and each variable against its own max|plain|)."""
    wrapper, plain, _, _ = KERNELS[name]
    out, ref = wrapper(*args, **kw), plain(*args, **kw)
    torch.cuda.synchronize()
    out = out if isinstance(out, tuple) else (out,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    if name in SURFACE:
        errs = (out[0] - ref[0]).abs().amax(dim=(0, 2)).tolist()
        scales = ref[0].abs().amax(dim=(0, 2)).tolist()
    else:
        errs = [(o - r).abs().max().item() for o, r in zip(out, ref)]
        scales = [r.abs().max().item() for r in ref]
    return errs, scales, all(bool(torch.isfinite(o).all()) for o in out), out


def first_elements(args, n: int):
    """``args`` with every tensor over the E elements of ``args[0]`` cut
    to its first ``n`` elements (views; operators and tables kept)."""
    E = args[0].shape[0]
    return tuple(a[:n] if isinstance(a, torch.Tensor) and a.dim() > 1
                 and a.shape[0] == E else a for a in args)


def graph_rounds(name, args, kw) -> dict:
    """The kernel and its plain version in KERNEL_ROUNDS interleaved
    rounds of KERNEL_LAUNCHES CUDA-graph-replayed calls rotating through
    KERNEL_INPUTS copies of the inputs (cold L2: every copy of a kernel's
    inputs is over 60 MB, the L2 50 MB), as the layout kernels are
    timed: medians with the kernel's min and max; ``ms_warm`` the
    kernel's median on ``args`` alone."""
    wrapper, plain, _, _ = KERNELS[name]
    E = args[0].shape[0]
    copies = [args] + [tuple(
        a.clone() if isinstance(a, torch.Tensor) and a.dim() > 1
        and a.shape[0] == E else a for a in args)
        for _ in range(KERNEL_INPUTS - 1)]
    contenders = {"kernel": lambda x: wrapper(*x, **kw),
                  "plain": lambda x: plain(*x, **kw)}
    cold = paired_rounds(contenders, copies, KERNEL_ROUNDS, KERNEL_LAUNCHES)
    del copies
    warm = paired_rounds({"kernel": contenders["kernel"]}, [args],
                         KERNEL_ROUNDS, KERNEL_LAUNCHES)
    return dict(timing="graph_cold_median",
                ms=statistics.median(cold["kernel"]),
                ms_min=min(cold["kernel"]), ms_max=max(cold["kernel"]),
                plain_ms=statistics.median(cold["plain"]),
                ms_warm=statistics.median(warm["kernel"]),
                rounds=KERNEL_ROUNDS, launches_per_round=KERNEL_LAUNCHES,
                inputs=KERNEL_INPUTS)


def kernel_vs_plain(name, args, rhs, n, exact: bool = False, **kw) -> dict:
    """One kernel against its plain version on the same inputs, with both
    times in graph-cold rounds (:func:`graph_rounds`), a matmul yardstick
    and its bounds; with ``exact`` (the remainder branches) equal to it
    bit for bit.  A staged kernel is also run on the first TAIL_E
    elements of the same inputs (a partial last tile): held against the
    plain version there (whose product may round otherwise at that shape)
    and equal bit for bit to its own full run's first TAIL_E elements."""
    errs, scales, finite, out = compare(name, args, kw)
    hyper = kw.get("has_hyper", True)
    timing = graph_rounds(name, args, kw)
    if name in TILED:
        tail_errs, tail_scales, tail_finite, tail = compare(
            name, first_elements(args, TAIL_E), kw)
        # each element's arithmetic is the same in a partial tile
        same = all(torch.equal(a, b[:TAIL_E]) for a, b in zip(tail, out))
        emit("kernel_tail", name=name, elements=TAIL_E,
             **{k: kw[k] for k in ("has_f2", "lin_dims", "lin_gravity",
                                   "subtract_ref", "subtract") if k in kw},
             max_abs_err_per_output=tail_errs,
             max_abs_plain_per_output=tail_scales, tol=KERNEL_TOL,
             equals_full_run=same)
        check(tail_finite, (name, "tail output not finite"))
        check(same, (name, "kernel on the tail != its full run's elements"))
        check(all(e <= KERNEL_TOL * sc for e, sc in
                  zip(tail_errs, tail_scales)),
              (name, "kernel vs plain on the tail", tail_errs, tail_scales))
    res = dict(max_abs_err=max(errs), max_abs_err_per_output=errs,
               max_abs_plain_per_output=scales, tol=KERNEL_TOL, **timing,
               matmul_yardstick_ms=yardstick(name, args, rhs, hyper),
               **bounds(name, rhs, n, kw.get("has_f2", True), args, hyper,
                        kw),
               exact=max(errs) == 0.0,
               shapes=[list(a.shape) for a in args
                       if isinstance(a, torch.Tensor)])
    res["share_of_bound"] = res["bound_ms"] / res["ms"]
    res["share_of_bound_dense"] = res["bound_dense_ms"] / res["ms"]
    emit("kernel_vs_plain", name=name,
         **{k: kw[k] for k in ("has_f2", "has_hyper", "lin_dims",
                               "lin_gravity", "subtract_ref", "subtract",
                               "i_pref", "na", "rem_lanes", "sl_lo",
                               "sl_hi") if k in kw}, **res)
    check(finite, (name, "kernel output not finite"))
    check(res["exact"] or not exact, (name, "kernel != plain bit for bit",
                                      errs))
    check(all(e <= KERNEL_TOL * sc for e, sc in zip(errs, scales)),
          (name, "kernel vs plain", errs, scales))
    return res


def volume_kwargs(rhs, has_f2: bool) -> dict:
    ps = rhs.bl.param_set
    return dict(nq=rhs.nq, ngl=rhs.bl.gradlap_spec.num, R_d=ps.R_d,
                cv_d=ps.cv_d, T_0=ps.T_0, subtract_ref=rhs.subtract,
                has_f2=has_f2)


def phase_kernels(rhs, q, aux) -> dict:
    """Each kernel against its plain version on the main path's inputs;
    then the whole kernel chain against the per-pass chain."""
    glv, inputs = chain_inputs(rhs, q, aux)
    results = {}
    for name in EXPLICIT:
        kw = (volume_kwargs(rhs, True)
              if name == "fused_volume_tendency_vm" else {})
        results[name] = kernel_vs_plain(name, inputs[name], rhs,
                                        n=glv.shape[1], **kw)

    # the whole kernel chain against the per-pass plain chain
    ops = rhs.chain
    tab, dims = ops.tab, ops.dims
    geom = ldg_tables.geom(rhs.grid, ops.faces, dims)
    grad = ldg_varmajor.grad_vm(rhs.grid, glv, tab, geom, dims)
    lap = ldg_varmajor.div_vm(rhs.grid, grad, tab, geom, dims)
    ref = ldg_varmajor.grad_vm(rhs.grid, lap, tab, geom, dims)
    got = ldg_kernel.chain_vm(glv, ops)
    torch.cuda.synchronize()
    err = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    per_var = ((got - ref).abs().amax(dim=(0, 1, 3))
               / ref.abs().amax(dim=(0, 1, 3))).tolist()
    emit("chain_vs_plain", max_abs_err=err, max_abs_plain=scale,
         rel_err_per_variable=per_var, tol=CHAIN_TOL)
    check(err <= CHAIN_TOL * scale, ("chain vs plain", err, scale))
    return results


def card_vs_cpu_f64(small: dict, kind) -> list:
    """Three steps of a small path (``build_*path`` at a small grid) in
    float32 on the card against float64 on the CPU from the same float32
    geometry and initial state (upcast), so the two differ by arithmetic
    precision only; the float64 twin is built by ``kind.make`` (the
    solver type of the path), with the Held-Suarez filter where the path
    has one.  Returns the per-variable error relative to max|q| of the
    float64 run."""
    g, model, dt = small["cfg"].grid, small["cfg"].model, small["dt"]
    grid64 = grid_from_numpy(grid_to_numpy(g), device="cpu",
                             dtype=torch.float64)
    q64, aux64 = small["q0"].double().cpu(), small["aux0"].double().cpu()
    twin = kind.make(DGModel(model, grid64), q64, aux64, dt)
    if small["hsf"] is not None:
        twin.post_step = HeldSuarezStepFilter(grid64, model).apply_vm
    runs = {"f32": (small["solver"], small["q0"], small["aux0"]),
            "f64": (twin, q64, aux64)}
    final = {}
    for name, (solver, q, aux) in runs.items():
        for i in range(3):
            q, aux = solver.step(q, aux, i * dt)
        final[name] = q.double().cpu()
    ref = final["f64"]
    return ((final["f32"] - ref).abs().amax(dim=(0, 2))
            / ref.abs().amax(dim=(0, 2))).tolist()


def small_reference_check(tau):
    """Three LSRK54 steps of a small grid (n_horz=2, n_vert=2) on the card
    against float64 steps on the CPU (:func:`card_vs_cpu_f64`)."""
    err = card_vs_cpu_f64(build_path(tau, n_horz=2, n_vert=2),
                          ExplicitSolverType())
    emit("small_reference", n_horz=2, n_vert=2, poly=POLY, steps=3,
         hyperdiffusion_tau=tau, rel_err_per_var=err, tol=SMALL_TOL)
    check(max(err) <= SMALL_TOL, ("small reference", err))


def build_path(tau, n_horz=N_HORZ, n_vert=N_VERT) -> dict:
    """The configuration (at full width unless given), its initial state
    and the LSRK54 solver with the every-step filter, as a user builds
    them (``ExplicitSolverType().make``, the filter as ``post_step``)."""
    t0 = time.perf_counter()
    cfg = held_suarez_config(n_horz=n_horz, n_vert=n_vert, poly_order=POLY,
                             dtype=torch.float32, hyperdiffusion_tau=tau,
                             device="cuda")
    dg = DGModel(cfg.model, cfg.grid)
    q0, aux0 = init_ode_state(dg)
    dt = 0.3 * min_node_distance(cfg.grid) / 350.0
    hsf = HeldSuarezStepFilter(cfg.grid, cfg.model)
    solver = ExplicitSolverType().make(dg, q0, aux0, dt)
    solver.post_step = hsf.apply_vm
    torch.cuda.synchronize()
    return dict(tau=tau, cfg=cfg, dg=dg, q0=q0, aux0=aux0, dt=dt, hsf=hsf,
                rhs=solver.vm, solver=solver,
                setup_s=time.perf_counter() - t0)


def expected_launches(per_step: dict, steps: int) -> dict:
    """Each kernel's launches in ``steps`` steps: ``per_step`` of the
    kernels it names, 0 of every other."""
    return {name: per_step.get(name, 0) * steps for name in KERNELS}


def check_launches(counts: dict, expected: dict):
    for name, want in expected.items():
        check(counts[name] == want, (name, "launches", counts[name], want))


def run_path(path: dict, n_warm: int, n_steps: int, mode=None):
    """With the var-major RHS's surface pass ``mode`` (None on the
    generic DG operator), set every launch count to 0, take ``n_warm`` +
    ``n_steps`` steps from the initial state (timing the last
    ``n_steps``) and read the counts.  Returns (summary, counts, final
    state)."""
    g, solver, dt = path["cfg"].grid, path["solver"], path["dt"]
    model = path["cfg"].model
    E, Np, nq = g.nelem, g.Np, model.prog_spec.num
    mass = lambda q, v=0: torch.sum(g.M.double() * q[:, v].double()).item()
    m0 = mass(path["q0"])
    if mode is not None:
        path["rhs"].surface_kernel = mode
    reset_launch_counts()
    q, aux, t = path["q0"], path["aux0"], 0.0
    for _ in range(n_warm):
        q, aux = solver.step(q, aux, t)
        t += dt
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(n_steps):
        q, aux = solver.step(q, aux, t)
        t += dt
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    counts = launch_counts()
    if hasattr(path["rhs"], "export_aux"):
        aux = path["rhs"].export_aux(q, aux)
    drift = abs(mass(q) - m0) / m0
    finite = bool(torch.isfinite(q).all() and torch.isfinite(aux).all())
    res = dict(card=nvidia_smi(), hyperdiffusion_tau=path["tau"],
               surface_kernel=mode, n_horz=N_HORZ, n_vert=N_VERT, poly=POLY, elements=E,
               gridpoints=E * Np, dtype="float32", dt_s=dt,
               warm_steps=n_warm, steps=n_steps, setup_s=path["setup_s"],
               ms_per_step=1e3 * wall / n_steps,
               gridpoints_per_s=E * Np * n_steps / wall,
               sim_s_per_wall_s=dt * n_steps / wall, launches=counts,
               mass_drift_rel=drift, mass_tol=MASS_TOL, finite=finite,
               shape=list(q.shape))
    check(list(q.shape) == [E, nq, Np], ("state shape", list(q.shape)))
    check(finite, "state not finite")
    check(drift <= MASS_TOL, ("mass drift", drift))
    if getattr(model, "moist", False):
        # the JAX package's checks (tests/test_baroclinic_wave.py:44-56)
        mq0 = mass(path["q0"], 5)
        q_tot = q[:, 5] / q[:, 0]
        res.update(mass_drift_rel_rhoq_tot=abs(mass(q, 5) - mq0) / mq0,
                   max_abs_u=(q[:, 1:4] / q[:, :1]).abs().max().item(),
                   q_tot_min=q_tot.min().item(), q_tot_max=q_tot.max().item(),
                   max_abs_u_bound=MAX_ABS_U)
        check(res["mass_drift_rel_rhoq_tot"] <= MASS_TOL,
              ("ρq_tot mass drift", res["mass_drift_rel_rhoq_tot"]))
        check(res["max_abs_u"] < MAX_ABS_U, ("max |u|", res["max_abs_u"]))
    return res, counts, q


def perturbed(q0, seed: int):
    """The initial state times 1 + 1e-3 · N(0, 1), from ``seed``."""
    gen = torch.Generator(device=q0.device).manual_seed(seed)
    return q0 * (1 + 1e-3 * torch.randn(q0.shape, generator=gen,
                                         device=q0.device))


def plain_rhs(dg, mode: str):
    """The RHS with every kernel's plain version, surface pass ``mode``."""
    rhs = VarMajorRHS(dg, write_aux=False,
                      volume=volume_kernel.volume_tendency_plain,
                      chain_stages=ldg_kernel.PLAIN,
                      surface_stages=surface_kernel.PLAIN)
    rhs.surface_kernel = mode
    return rhs


def step_vs_plain(path, mode: str):
    """One step with the kernels against one with the plain versions,
    both with the surface pass ``mode``, from the path's initial state."""
    plain = LSRK54CarpenterKennedy(plain_rhs(path["dg"], mode), path["dt"],
                                   post_step=path["solver"].post_step)
    q0, aux0 = path["q0"], path["aux0"]
    path["rhs"].surface_kernel = mode
    q1, _ = path["solver"].step(q0, aux0, 0.0)
    q1p, _ = plain.step(q0, aux0, 0.0)
    eps32 = torch.finfo(torch.float32).eps
    bound = (STEP_TOL * (q1p - q0).abs().amax(dim=(0, 2))
             + 4 * eps32 * q1p.abs().amax(dim=(0, 2)))
    step_err = ((q1 - q1p).abs().amax(dim=(0, 2)) / bound).tolist()
    emit("step_vs_plain", hyperdiffusion_tau=path["tau"],
         surface_kernel=mode, err_over_bound_per_var=step_err,
         max_abs_diff_per_var=(q1 - q1p).abs().amax(dim=(0, 2)).tolist(),
         tol=STEP_TOL)
    check(max(step_err) <= 1.0, ("step vs plain", step_err))


def phase_main_path(seed: int) -> dict:
    """Kernels against plain versions on the main path's inputs, one
    step against the plain step with the surface passes "xla" and
    "pallas", the small reference, then the explicit path with
    hyperdiffusion, once with each surface pass."""
    path = build_path(8 * 3600.0)
    kernels = phase_kernels(path["rhs"], perturbed(path["q0"], seed),
                            path["aux0"])
    for mode in ("xla", "pallas"):
        step_vs_plain(path, mode)
    small_reference_check(path["tau"])

    ms, rate = {}, {}
    for mode in SURFACE_KERNELS:
        res, counts, _ = run_path(path, N_WARM, N_STEPS, mode)
        expected = expected_launches(
            {name: 5 for name in EXPLICIT + SURFACE_LAUNCHES[mode]},
            N_WARM + N_STEPS)
        emit("main_path", expected_launches=expected, **res)
        check_launches(counts, expected)
        ms[mode], rate[mode] = res["ms_per_step"], res["sim_s_per_wall_s"]
    return dict(kernels=kernels, sim_s_per_wall_s=rate, ms_per_step=ms)


def phase_no_hyperdiffusion(seed: int):
    """The step with hyperdiffusion off (the configuration of the first
    slice), at fewer steps: the volume kernel without F₂ against its
    plain version on this path's inputs, one step against the plain
    step, the small reference, then the path, where only the volume
    kernel runs."""
    path = build_path(None)
    rhs, aux0, g = path["rhs"], path["aux0"], path["cfg"].grid
    qp = perturbed(path["q0"], seed)
    _, p, _, _ = rhs._thermo_update(qp, aux0, False)
    args = (qp, p, aux0[:, rhs.i_phi], aux0[:, rhs.i_pref].contiguous(),
            None, None, None, rhs.xiv, g.M, g.MI, g.Wdiv)
    kernel_vs_plain("fused_volume_tendency_vm", args, rhs, n=0,
                    **volume_kwargs(rhs, False))
    del qp, p, args
    step_vs_plain(path, "xla")
    small_reference_check(None)

    for mode in ("xla", "pallas"):
        res, counts, _ = run_path(path, N_WARM_OFF, N_STEPS_OFF, mode)
        expected = expected_launches(
            {name: 5 for name in ("fused_volume_tendency_vm",)
             + SURFACE_LAUNCHES[mode]}, N_WARM_OFF + N_STEPS_OFF)
        emit("no_hyperdiffusion_path", expected_launches=expected, **res)
        check_launches(counts, expected)


def layout_vs_plain(name, src, dims, runtime_dims: bool = False) -> dict:
    """A layout kernel against its plain version and against one
    ``permute(...).contiguous()`` (the library call) on the same input:
    all three equal bit for bit.  Times: the kernel, the plain version
    and the library call in LAYOUT_ROUNDS interleaved rounds of
    LAYOUT_LAUNCHES launches each, replayed from CUDA graphs (device time
    without the host's launch cost), rotating through LAYOUT_INPUTS
    distinct inputs (cold L2; the ms fields, medians over the rounds, with
    their min and max), and the same on ``src`` alone (warm, the *_warm
    fields: inside the step a layout's input was often just written);
    with the bytes bound.  With ``runtime_dims``, the same kernel with
    the dims as run-time values (``layout_kernel.*_runtime_dims``) joins
    the rounds and the bit-for-bit check."""
    wrapper, plain, _, _ = KERNELS[name]
    library = library_call(name == "to_blocks_vm", dims)
    out, ref = wrapper(src, dims), plain(src, dims)
    torch.cuda.synchronize()
    contenders = {"kernel": lambda x: wrapper(x, dims),
                  "library": library, "plain": lambda x: plain(x, dims)}
    if runtime_dims:
        rt = getattr(layout_kernel, name + "_runtime_dims")
        contenders["runtime_dims"] = lambda x: rt(x, dims)
        rt_out = rt(src, dims)
    inputs = [src] + [src + i for i in range(1, LAYOUT_INPUTS)]
    cold = paired_rounds(contenders, inputs, LAYOUT_ROUNDS, LAYOUT_LAUNCHES)
    warm = paired_rounds(contenders, [src], LAYOUT_ROUNDS, LAYOUT_LAUNCHES)
    del inputs
    med = {k: statistics.median(v) for k, v in cold.items()}
    nbytes = 2 * src.numel() * src.element_size()
    res = dict(max_abs_err=(out - ref).abs().max().item(),
               exact=torch.equal(out, ref),
               library_exact=torch.equal(library(src).reshape(out.shape),
                                         out),
               tol=0.0, timing="graph_cold_median", ms=med["kernel"],
               ms_min=min(cold["kernel"]),
               ms_max=max(cold["kernel"]), plain_ms=med["plain"],
               library_ms=med["library"],
               library_ms_min=min(cold["library"]),
               library_ms_max=max(cold["library"]),
               over_library=med["kernel"] / med["library"],
               ms_warm=statistics.median(warm["kernel"]),
               library_ms_warm=statistics.median(warm["library"]),
               rounds=LAYOUT_ROUNDS, launches_per_round=LAYOUT_LAUNCHES,
               inputs=LAYOUT_INPUTS, bytes=nbytes,
               bound_ms=1e3 * nbytes / PEAK_BYTES, bound_by="bytes",
               shape=list(src.shape), out_shape=list(out.shape))
    res["share_of_bound"] = res["bound_ms"] / res["ms"]
    if runtime_dims:
        res.update(runtime_dims_exact=torch.equal(rt_out, ref),
                   runtime_dims_ms=med["runtime_dims"])
        check(res["runtime_dims_exact"], (name, "runtime dims vs plain"))
    emit("kernel_vs_plain", name=name, layout_dims=list(dims), **res)
    check(res["exact"] and res["library_exact"], (name, "kernel vs plain"))
    return res


def layout_edge_shapes(seed: int):
    """Both layout kernels against their plain versions and the library
    call, bit for bit, and the round trip at LAYOUT_EDGE_DIMS."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    for dims in LAYOUT_EDGE_DIMS:
        res = {}
        for name, inverse in zip(LAYOUT, LAYOUT[::-1]):
            to = name == "to_blocks_vm"
            wrapper, plain, _, _ = KERNELS[name]
            src = torch.randn(layout_input_shape(to, dims), generator=gen,
                              device="cuda")
            out, ref = wrapper(src, dims), plain(src, dims)
            res[name] = dict(
                exact=torch.equal(out, ref),
                library_exact=torch.equal(
                    library_call(to, dims)(src).reshape(out.shape), out),
                max_abs_err=(out - ref).abs().max().item(),
                round_trip_exact=torch.equal(
                    KERNELS[inverse][0](out, dims), src))
        emit("layout_edge_shape", dims=list(dims), **res)
        check(all(r["exact"] and r["library_exact"] and r["round_trip_exact"]
                  for r in res.values()), ("layout edge shape", dims, res))


def phase_layout_kernels(layout, q, seed: int) -> dict:
    """Both layout kernels on a state and its blocks, the round trip,
    and both kernels at the edge shapes."""
    dims = layout.layout_dims
    res = {"to_blocks_vm": layout_vs_plain("to_blocks_vm", q, dims)}
    yb = layout.to_blocks(q)
    res["from_blocks_vm"] = layout_vs_plain("from_blocks_vm", yb, dims)
    back = layout.from_blocks(yb)
    torch.cuda.synchronize()
    emit("layout_round_trip", exact=torch.equal(back, q))
    check(torch.equal(back, q), "from_blocks(to_blocks(x)) != x")
    layout_edge_shapes(seed)
    return res


def phase_surface_kernels(rhs, q, aux) -> dict:
    """Both surface kernels against their plain versions on a path's own
    inputs: the state's thermo and ∇Δ (through the chain kernels), then
    the bundle of the plain extraction and its gathered neighbour side,
    with hyperdiffusion on and off.  Returns the results with
    hyperdiffusion, the path's."""
    g, ps, nq = rhs.grid, rhs.bl.param_set, rhs.nq
    _, p, c_s, aux = rhs._thermo_update(q, aux, False)
    gl2 = rhs._chain(q, aux, p)
    p_ref = aux[:, rhs.i_pref].contiguous()
    results = {}
    for hyper in (True, False):
        ext_args = (q, p, c_s, p_ref[:, None], gl2 if hyper else None,
                    rhs.nu if hyper else None, g.lift, rhs.nrm)
        ext_kw = dict(nq=nq, na=1, ngl=rhs.bl.gradlap_spec.num,
                      has_hyper=hyper)
        ext = kernel_vs_plain("extract_trace_vm", ext_args, rhs, n=0,
                              **ext_kw)
        Bf = surface_kernel.extract_trace_plain(*ext_args, **ext_kw)
        lift_args = (Bf, rhs._gather_faces(Bf), rhs.nrm, rhs.sM, rhs.bmask,
                     rhs.liftT, g.MI)
        lift = kernel_vs_plain(
            "fused_surface_lift_vm", lift_args, rhs, n=0, nq=nq,
            nvb=Bf.shape[1], subtract=True, i_pref=nq + 2, has_hyper=hyper,
            rem_lanes=(), sl_lo=0, sl_hi=0, R_d_T0=ps.R_d * ps.T_0,
            R_over_cv=ps.R_d / ps.cv_d)
        if hyper:
            results = {"extract_trace_vm": ext, "fused_surface_lift_vm": lift}
        del Bf, lift_args
    return results


def build_imex_path(tau, n_horz=N_HORZ, n_vert=N_VERT, dtype=torch.float32,
                    device="cuda", table=None) -> dict:
    """The IMEX configuration, its initial state and the solver as a user
    builds them (``IMEXSolverType().make`` with the filter as
    ``post_step``); dt = 0.1 · min_node_distance(horizontal) / 350,
    snapped to ``table.dt`` within 1e-5 relative, as bench.py:182-189
    does.  ``setup_s`` is the time of ``make``: the operator's probing,
    the stencil check and the factorization."""
    t0 = time.perf_counter()
    cfg = held_suarez_config(n_horz=n_horz, n_vert=n_vert, poly_order=POLY,
                             dtype=dtype, hyperdiffusion_tau=tau,
                             device=device)
    dg = DGModel(cfg.model, cfg.grid)
    q0, aux0 = init_ode_state(dg)
    dt = 0.1 * min_node_distance(cfg.grid, "horizontal") / 350.0
    snapped = table is not None and abs(table.dt - dt) < 1e-5 * dt
    if snapped:
        dt = table.dt
    hsf = HeldSuarezStepFilter(cfg.grid, cfg.model)
    sync = torch.cuda.synchronize if device == "cuda" else lambda: None
    sync()
    t1 = time.perf_counter()
    solver = IMEXSolverType().make(dg, q0, aux0, dt)
    sync()
    setup_s = time.perf_counter() - t1
    solver.post_step = hsf.apply_vm
    return dict(tau=tau, cfg=cfg, dg=dg, q0=q0, aux0=aux0, dt=dt, hsf=hsf,
                rhs=solver.rhs_full, solver=solver, setup_s=setup_s,
                build_s=time.perf_counter() - t0, dt_snapped=snapped)


def imex_step_vs_plain(path, mode: str):
    """One IMEX step with every kernel against one where the layouts,
    the volume, the chain and the surface stages take their plain
    versions, both with the surface pass ``mode``, from the path's
    initial state (the same assembled operator and factors)."""
    imex = path["solver"]
    plain_sv = copy.copy(imex.solver)
    plain_sv.layout = ColumnLayout(
        path["cfg"].grid, imex.solver.layout.nvars,
        to_blocks=layout_kernel.to_blocks_vm_plain,
        from_blocks=layout_kernel.from_blocks_vm_plain)
    plain = ARK2GiraldoKellyConstantinescu(
        None, None, plain_sv, path["dt"],
        rhs_full=plain_rhs(path["dg"], mode), post_step=imex.post_step)
    q0, aux0 = path["q0"], path["aux0"]
    path["rhs"].surface_kernel = mode
    q1, _ = imex.step(q0, aux0, 0.0)
    q1p, _ = plain.step(q0, aux0, 0.0)
    eps32 = torch.finfo(torch.float32).eps
    bound = (STEP_TOL * (q1p - q0).abs().amax(dim=(0, 2))
             + 4 * eps32 * q1p.abs().amax(dim=(0, 2)))
    diff = (q1 - q1p).abs().amax(dim=(0, 2))
    step_err = (diff / bound).tolist()
    emit("imex_step_vs_plain", surface_kernel=mode,
         err_over_bound_per_var=step_err,
         max_abs_diff_per_var=diff.tolist(), tol=STEP_TOL)
    check(max(step_err) <= 1.0, ("IMEX step vs plain", step_err))


def imex_layout_step_vs_plain(path):
    """One IMEX step (surface pass "pallas") with the layout kernels
    against the same step with only the layouts swapped to their plain
    versions (the same RHS, operator and factors), from the path's
    initial state: equal bit for bit, a permutation changes no bit.
    The step with the kernels is taken twice, to show it repeats bit
    for bit."""
    imex = path["solver"]
    plain_sv = copy.copy(imex.solver)
    plain_sv.layout = ColumnLayout(
        path["cfg"].grid, imex.solver.layout.nvars,
        to_blocks=layout_kernel.to_blocks_vm_plain,
        from_blocks=layout_kernel.from_blocks_vm_plain)
    plain = ARK2GiraldoKellyConstantinescu(
        None, None, plain_sv, path["dt"], rhs_full=imex.rhs_full,
        post_step=imex.post_step)
    q0, aux0 = path["q0"], path["aux0"]
    path["rhs"].surface_kernel = "pallas"
    q1, _ = imex.step(q0, aux0, 0.0)
    q1p, _ = plain.step(q0, aux0, 0.0)
    q1r, _ = imex.step(q0, aux0, 0.0)
    res = dict(surface_kernel="pallas", exact=torch.equal(q1, q1p),
               repeats_exact=torch.equal(q1, q1r),
               max_abs_diff=(q1 - q1p).abs().max().item())
    emit("imex_layout_step_vs_plain", **res)
    check(res["exact"], ("IMEX step: layout kernels vs plain layouts", res))


def imex_small_reference(device="cuda") -> list:
    """Three IMEX steps of a small grid (n_horz=2, n_vert=3, p4,
    DryBiharmonic(8 h), the filter) on ``device`` against float64 on the
    CPU (:func:`card_vs_cpu_f64`), each through ``IMEXSolverType().make``."""
    return card_vs_cpu_f64(
        build_imex_path(8 * 3600.0, n_horz=2, n_vert=3, device=device),
        IMEXSolverType())


def load_refstats():
    """The f64 statistics table of the IMEX trajectory, read from its
    path (it is data: it only assigns numbers)."""
    spec = importlib.util.spec_from_file_location("bench_refstats", REFSTATS)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def table_gate(q, model, table) -> dict:
    """Per variable min, max, mean and std (ddof=1) of ``q`` over all
    nodes in float64, each as |got − table| relative to the table
    field's max magnitude (bench.py:108-125); the worst fraction of each
    budget set and the bench budgets' failures."""
    qn = q.double().cpu()
    rel = {}
    for i, name in enumerate(model.prog_spec.flattened_names()):
        a = qn[:, i].reshape(-1)
        got = (a.min().item(), a.max().item(), a.mean().item(),
               a.std().item())
        ref = table.stats[name]
        scale = max(abs(ref[0]), abs(ref[1]), 1e-300)
        rel[name] = [abs(g - r) / scale for g, r in zip(got, ref)]

    def against(budgets):
        worst, failures = 0.0, []
        for name, drifts in rel.items():
            budget = budgets[name.split("[")[0]]
            for stat, r, b in zip(("min", "max", "mean", "std"), drifts,
                                  budget):
                worst = max(worst, r / b)
                if r > b:
                    failures.append((name, stat, r, b))
        return worst, failures

    worst, failures = against(BENCH_BUDGETS)
    anchor_worst, anchor_failures = against(ANCHOR_BUDGETS)
    return dict(rel_drift=rel, worst_fraction_of_budget=worst,
                failures=failures, anchor_worst_fraction=anchor_worst,
                anchor_failures=anchor_failures)


def phase_imex(seed: int, explicit: dict) -> dict:
    """The IMEX path: build it at full width (dt snapped to the f64
    table's), hold the layout kernels against their plain versions on a
    perturbed state and its blocks and the surface kernels on that state,
    one step with the surface passes "xla" and "pallas" against the
    all-plain step, the small reference; then, with each surface pass,
    10 + 25 steps with the launch counts and the f64-table gate on the
    35-step state."""
    table = load_refstats()
    torch.cuda.reset_peak_memory_stats()
    path = build_imex_path(8 * 3600.0, table=table)
    setup_peak = torch.cuda.max_memory_allocated()
    dt = path["dt"]
    # bench.py:87-88: no gate unless this is the table's trajectory
    check(path["dt_snapped"] and abs(table.dt - dt) <= 1e-9 * dt,
          ("dt off the table's", dt, table.dt))
    sv = path["solver"].solver
    g = path["cfg"].grid

    kernels = phase_layout_kernels(sv.layout, perturbed(path["q0"], seed),
                                   seed)
    kernels.update(phase_surface_kernels(path["rhs"],
                                         perturbed(path["q0"], seed),
                                         path["aux0"]))
    for mode in ("xla", "pallas"):
        imex_step_vs_plain(path, mode)
    imex_layout_step_vs_plain(path)
    err = imex_small_reference()
    emit("imex_small_reference", n_horz=2, n_vert=3, poly=POLY, steps=3,
         hyperdiffusion_tau=8 * 3600.0, rel_err_per_var=err,
         tol=IMEX_SMALL_TOL)
    check(all(e <= t for e, t in zip(err, IMEX_SMALL_TOL)),
          ("IMEX small reference", err))

    # the column algebra alone, on the path's own operator (plain torch),
    # and the diagonal blocks' product in the solver's form against the
    # JAX package's form and einsum, both on its [nv, j, i, ncol] layout
    xb = sv.layout.to_blocks(perturbed(path["q0"], seed))
    gamma_dt = next(iter(sv._cached))            # ARK2GKC's one γ·dt
    D_jax = sv.Dc.permute(0, 3, 2, 1).contiguous()
    algebra = dict(
        apply_op_blocks_ms=cuda_ms(lambda: sv.apply_op_blocks(xb), 5, warm=1),
        solve_blocks_ms=cuda_ms(lambda: sv.solve_blocks(xb, gamma_dt), 5,
                                warm=1),
        bmv_ms=cuda_ms(lambda: sv._bmv(sv.Dc, xb), 10, warm=2),
        bmv_jax_form_ms=cuda_ms(lambda: (D_jax * xb[:, :, None, :]).sum(1),
                                10, warm=2),
        bmv_einsum_ms=cuda_ms(lambda: torch.einsum("vjic,vjc->vic", D_jax,
                                                   xb), 10, warm=2))
    del xb, D_jax

    # the table's 35 steps once with each surface pass, on the same
    # solver: its rhs_full switches passes, nothing is set up again
    n = N_WARM_IMEX + N_STEPS_IMEX
    ms, launches = {}, {}
    for mode in SURFACE_KERNELS:
        torch.cuda.reset_peak_memory_stats()
        res, counts, q = run_path(path, N_WARM_IMEX, N_STEPS_IMEX, mode)
        expected = expected_launches(
            {**{name: 3 for name in EXPLICIT + SURFACE_LAUNCHES[mode]},
             "to_blocks_vm": 3, "from_blocks_vm": 2}, n)
        gate = table_gate(q, path["cfg"].model, table)
        res.update(
            solver="ARK2GiraldoKellyConstantinescu+BlockTridiag",
            setup_s=path["setup_s"], build_s=path["build_s"],
            active_unknowns=sv.active_count, block_size=sv.nb,
            peak_memory_setup_bytes=setup_peak,
            peak_memory_steps_bytes=torch.cuda.max_memory_allocated(),
            expected_launches=expected,
            dt_snapped_to_table=path["dt_snapped"],
            explicit_ms_per_step=explicit["ms_per_step"][mode],
            explicit_sim_s_per_wall_s=explicit["sim_s_per_wall_s"][mode],
            **algebra)
        emit("imex_path", **res)
        emit("table_gate", surface_kernel=mode, steps=n, dt_s=dt,
             table_dt_s=table.dt, **gate)
        check_launches(counts, expected)
        check(not gate["failures"], ("f64-table gate", mode,
                                     gate["failures"]))
        ms[mode], launches[mode] = res["ms_per_step"], counts
        del q
    path["rhs"].surface_kernel = "xla"
    return dict(kernels=kernels, launches=launches["pallas"],
                ms_per_step=ms)


# --- the generic DG operator: state_layout="grid" and the dense solver -------

def dry_volume_args(dg, q, aux):
    """The dry volume kernel's (args, kwargs) on ``dg``'s path at state q
    and aux, as its RHS hands them over."""
    return dry_volume_kernel.volume_tendency_from_grid(
        dg, q, aux, volume=lambda *args, **kw: (args, kw))


def dry_inputs(dg, q, aux):
    """The vertical linear operator of ``dg``'s model, the fused
    remainder ``dg − dg_lin`` and the dry kernel's (args, kwargs) on the
    RHS of each at q, aux: (dg_lin, dg_rem, {entry of the kernels line:
    (args, kwargs)})."""
    dg_lin = DGModel(AtmosAcousticGravityLinearModel(dg.balance_law),
                     dg.grid, direction="vertical", update_aux=False)
    dg_rem = remainder_DGModel(dg, dg_lin)
    return dg_lin, dg_rem, {entry: dry_volume_args(d, q, aux) for entry, d
                            in ((DRY, dg), (DRY + "_remainder", dg_rem))}


def per_var_err(got, ref) -> list:
    """max |got − ref| per variable, relative to max |ref| of that
    variable; both var-major ``[E, n, Np]``."""
    return ((got - ref).abs().amax(dim=(0, 2))
            / ref.abs().amax(dim=(0, 2))).tolist()


def build_generic_base():
    """The configuration at full width with DryBiharmonic(8 h), its
    initial state and the generic DG operator ``DGModel(model, grid)``
    with its defaults (the dry volume kernel, the chain kernels, the
    var-major surface pass), shared by the three paths."""
    t0 = time.perf_counter()
    cfg = held_suarez_config(n_horz=N_HORZ, n_vert=N_VERT, poly_order=POLY,
                             dtype=torch.float32, hyperdiffusion_tau=8 * 3600.0,
                             device="cuda")
    dg = DGModel(cfg.model, cfg.grid)
    q0, aux0 = init_ode_state(dg)
    torch.cuda.synchronize()
    return dict(tau=8 * 3600.0, cfg=cfg, dg=dg, q0=q0, aux0=aux0,
                hsf=HeldSuarezStepFilter(cfg.grid, cfg.model),
                build_s=time.perf_counter() - t0)


def phase_generic_checks(base, seed: int) -> dict:
    """On a perturbed initial state: the dry volume kernel against its
    plain version on the inputs of the generic RHS and of the fused
    remainder; the generic RHS against the one with every stage's plain
    version, the all-plain one (contraction and per-pass chain), the
    var-major RHS, and the remainder against dg − dg_lin; each RHS's time.
    Returns the kernel results by entry of the kernels line."""
    dg, model, g = base["dg"], base["cfg"].model, base["cfg"].grid
    q = perturbed(base["q0"], seed)
    aux = model.update_auxiliary_state(q, base["aux0"], g)
    dg_lin, dg_rem, dry = dry_inputs(dg, q, aux)
    grid_only = SimpleNamespace(grid=g, hd=None, nq=5)
    kernels = {entry: kernel_vs_plain(DRY, args, grid_only, n=0, **kw)
               for entry, (args, kw) in dry.items()}

    def rhs(d):
        return d(q, base["aux0"], 0.0)[0]

    ref = rhs(dg)
    plain_stages = DGModel(model, g, volume=KERNELS[DRY][1],
                           chain_stages=ldg_kernel.PLAIN)
    all_plain = DGModel(model, g, volume_kernel="xla",
                        ldg_kernel="varmajor")
    vm = VarMajorRHS(dg)
    others = {"plain_stages": rhs(plain_stages), "all_plain": rhs(all_plain),
              "var_major": vm(q, base["aux0"], 0.0)[0]}
    lin, _ = dg_lin(q, aux, 0.0)
    rem = rhs(dg_rem)
    torch.cuda.synchronize()
    errs = {name: per_var_err(ref, other) for name, other in others.items()}
    errs["remainder_vs_difference"] = per_var_err(rem, ref - lin)
    times = {name: cuda_ms(fn, 10, warm=2) for name, fn in (
        ("generic_rhs_ms", lambda: rhs(dg)),
        ("generic_all_plain_rhs_ms", lambda: rhs(all_plain)),
        ("remainder_rhs_ms", lambda: rhs(dg_rem)),
        ("linear_rhs_ms", lambda: dg_lin(q, aux, 0.0)),
        ("var_major_rhs_ms", lambda: vm(q, base["aux0"], 0.0)))}
    emit("generic_rhs", card=nvidia_smi(), rel_err_per_var=errs,
         tol=GENERIC_RHS_TOL, remainder_tol=REMAINDER_TOL,
         max_abs_per_var=ref.abs().amax(dim=(0, 2)).tolist(), **times)
    for name, err in errs.items():
        tol = REMAINDER_TOL if name.startswith("remainder") \
            else GENERIC_RHS_TOL
        check(all(torch.isfinite(torch.tensor(err))) and max(err) <= tol,
              ("generic RHS", name, err))
    return kernels


def generic_path(base, kind: str, table=None) -> dict:
    """One of the three generic paths on ``base``, built as a user builds
    it: "explicit" (``ExplicitSolverType(state_layout="grid")``, dt at the
    every-direction acoustic limit), "imex" (``IMEXSolverType(
    state_layout="grid")``) or "dense" (``IMEXSolverType(
    columnwise_solver="dense")``), dt from the horizontal acoustic CFL
    snapped to the f64 table's; the filter as ``post_step``.
    ``setup_s`` is the time of ``make``."""
    g, dg = base["cfg"].grid, base["dg"]
    q0, aux0 = base["q0"], base["aux0"]
    snapped = False
    if kind == "explicit":
        dt = 0.3 * min_node_distance(g) / 350.0
    else:
        dt = 0.1 * min_node_distance(g, "horizontal") / 350.0
        snapped = table is not None and abs(table.dt - dt) < 1e-5 * dt
        if snapped:
            dt = table.dt
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    if kind == "explicit":
        solver = ExplicitSolverType(state_layout="grid").make(dg, q0, aux0,
                                                              dt)
    elif kind == "imex":
        solver = IMEXSolverType(state_layout="grid").make(dg, q0, aux0, dt)
    else:
        solver = IMEXSolverType(columnwise_solver="dense").make(dg, q0, aux0,
                                                                dt)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    solver.post_step = base["hsf"].apply_vm
    return dict(base, dt=dt, rhs=dg, solver=solver, setup_s=setup_s,
                dt_snapped=snapped,
                peak_memory_setup_bytes=torch.cuda.max_memory_allocated())


def phase_generic(seed: int) -> dict:
    """The generic DG operator at full width: its checks, then the three
    paths with exact launch counts (the dry kernel and the four chain
    kernels in each RHS; the layout kernels on the banded IMEX step), the
    f64-table gate on both IMEX paths and the mass drift on all three;
    then the dense IMEX path on the acoustic linear model and the
    multirate path (:func:`phase_solver_remainders`)."""
    table = load_refstats()
    base = build_generic_base()
    kernels = phase_generic_checks(base, seed)
    per_rhs = {DRY: 1, **{name: 1 for name in CHAIN}}
    runs = {"explicit": (N_WARM, N_STEPS, 5, {}),
            "imex": (N_WARM_IMEX, N_STEPS_IMEX, 3,
                     {"to_blocks_vm": 3, "from_blocks_vm": 2}),
            "dense": (N_WARM_IMEX, N_STEPS_IMEX, 3, {})}
    launches, ms = {}, {}
    for kind, (n_warm, n_steps, n_rhs, layout) in runs.items():
        path = generic_path(base, kind, table)
        torch.cuda.reset_peak_memory_stats()
        res, counts, q = run_path(path, n_warm, n_steps)
        expected = expected_launches(
            {**{k: n_rhs * v for k, v in per_rhs.items()}, **layout},
            n_warm + n_steps)
        res.update(path=kind, state_layout="grid" if kind != "dense"
                   else "grid (dense solver)",
                   build_s=base["build_s"],
                   peak_memory_setup_bytes=path["peak_memory_setup_bytes"],
                   peak_memory_steps_bytes=torch.cuda.max_memory_allocated(),
                   expected_launches=expected,
                   dt_snapped_to_table=path["dt_snapped"])
        sv = path["solver"].solver if kind != "explicit" else None
        if kind == "dense":
            gamma_dt = next(iter(sv._cached))
            res.update(
                dense_apply_op_ms=cuda_ms(lambda: sv.apply_op(q), 5, warm=1),
                dense_solve_ms=cuda_ms(lambda: sv.solve(q, gamma_dt), 5,
                                       warm=1),
                dense_matrix_bytes=sv.A.numel() * sv.A.element_size())
        emit("generic_path", **res)
        check_launches(counts, expected)
        if kind != "explicit":
            check(path["dt_snapped"], ("dt off the table's", path["dt"]))
            gate = table_gate(q, base["cfg"].model, table)
            emit("table_gate", path=kind, steps=n_warm + n_steps,
                 dt_s=path["dt"], table_dt_s=table.dt, **gate)
            check(not gate["failures"], ("f64-table gate", kind,
                                         gate["failures"]))
        launches[kind], ms[kind] = counts, res["ms_per_step"]
        del path, sv, q
        torch.cuda.empty_cache()
    solvers = phase_solver_remainders(base, table)
    for kind, res in solvers.items():
        launches[kind], ms[kind] = res["launches"], res["ms_per_step"]
    return dict(kernels=kernels, launches=launches, ms_per_step=ms,
                dt_s={kind: res["dt_s"] for kind, res in solvers.items()})


# --- the moist baroclinic wave -------------------------------------------------

def build_moist_path(imex: bool, n_horz=N_HORZ, n_vert=N_VERT,
                     device="cuda", dt=None, cfl=None) -> dict:
    # imported here: a checkout of an earlier commit, run with
    # --skip-moist, has no baroclinic wave
    from climatemachine_tpu_torch.experiments.baroclinic_wave import \
        baroclinic_wave_config
    """The moist baroclinic wave (EquilMoist, EquilMoistBiharmonic(8 h),
    Gravity, Coriolis; no filter), its initial state and the solver as a
    user builds them: ``IMEXSolverType().make`` with ``imex``, else
    ``ExplicitSolverType().make``.  dt, unless given, is ``cfl`` (0.1
    IMEX, 0.3 explicit, as the dry paths) times the horizontal (IMEX) or
    every-direction (explicit) node distance over 350 m/s.  ``setup_s``
    is the time of ``make``."""
    t0 = time.perf_counter()
    cfg = baroclinic_wave_config(n_horz=n_horz, n_vert=n_vert,
                                 poly_order=POLY, dtype=torch.float32,
                                 hyperdiffusion_tau=MOIST_TAU, device=device)
    dg = DGModel(cfg.model, cfg.grid)
    q0, aux0 = init_ode_state(dg)
    if dt is None:
        dt = ((cfl or 0.1) * min_node_distance(cfg.grid, "horizontal")
              if imex else (cfl or 0.3) * min_node_distance(cfg.grid)) / 350.0
    sync = torch.cuda.synchronize if device == "cuda" else lambda: None
    sync()
    t1 = time.perf_counter()
    solver = (IMEXSolverType() if imex else ExplicitSolverType()).make(
        dg, q0, aux0, dt)
    sync()
    return dict(tau=MOIST_TAU, cfg=cfg, dg=dg, q0=q0, aux0=aux0, dt=dt,
                hsf=None, rhs=solver.rhs_full if imex else solver.vm,
                solver=solver, setup_s=time.perf_counter() - t1,
                build_s=time.perf_counter() - t0)


def moist_small_reference(imex: bool) -> list:
    """Three steps of the moist wave on a small grid (n_horz=2, p4;
    n_vert=2 explicit at dt = 0.3 · node distance / 350, n_vert=3 IMEX at
    MOIST_SMALL_IMEX_CFL) on the card against float64 on the CPU
    (:func:`card_vs_cpu_f64`), each through its solver type's ``make``."""
    small = build_moist_path(imex, n_horz=2, n_vert=3 if imex else 2,
                             cfl=MOIST_SMALL_IMEX_CFL if imex else None)
    return card_vs_cpu_f64(
        small, IMEXSolverType() if imex else ExplicitSolverType())


def moist_imex_stable_path() -> dict:
    """The full-width moist IMEX path at the largest dt of dt₀ / 2^k, k =
    0..MOIST_DT_HALVINGS (dt₀ the dry IMEX path's, from the horizontal
    CFL), whose 35 "pallas" steps from the initial state stay finite
    with max|u| < MAX_ABS_U; each trial is reported, and none raises."""
    dt0 = None
    for k in range(MOIST_DT_HALVINGS + 1):
        path = build_moist_path(True, dt=None if dt0 is None else dt0 / 2 ** k)
        dt0 = dt0 or path["dt"]
        path["rhs"].surface_kernel = "pallas"
        q, aux, bad, umax = path["q0"], path["aux0"], None, 0.0
        for i in range(N_WARM_IMEX + N_STEPS_IMEX):
            q, aux = path["solver"].step(q, aux, i * path["dt"])
            umax = (q[:, 1:4] / q[:, :1]).abs().max().item()
            if not (bool(torch.isfinite(q).all()) and umax < MAX_ABS_U):
                bad = i + 1
                break
        emit("moist_imex_dt_scan", card=nvidia_smi(), dt_s=path["dt"],
             halvings=k, steps=N_WARM_IMEX + N_STEPS_IMEX,
             stable=bad is None, first_bad_step=bad, max_abs_u=umax)
        if bad is None:
            path["dt_halvings"] = k
            return path
        del path, q, aux
        torch.cuda.empty_cache()
    raise RuntimeError("chip_smoke check failed: no stable moist IMEX dt")


def phase_moist(seed: int) -> dict:
    """The moist baroclinic wave at full width: the explicit path's
    kernels against their plain versions on its perturbed state (the
    volume kernel at nq = 6 with F₂, K1-K4 at n = 5, both surface kernels
    at nq = 6 with hyperdiffusion on and off), the whole chain, one
    LSRK54 step with "xla" and "pallas" against the all-plain step, the
    small reference, 13 steps under each surface pass; then the IMEX path
    at the largest stable dt (moist_imex_stable_path): both layout
    kernels at six variables against their plain versions and the library
    call, the round trip, one IMEX step with "xla" and "pallas" against
    the all-plain step and one with only the layouts plain, the small
    reference, and 35 steps under each surface pass; exact launch counts
    and the JAX package's checks on every run."""
    path = build_moist_path(False)
    model, g = path["cfg"].model, path["cfg"].grid
    q_tot0 = path["q0"][:, 5] / path["q0"][:, 0]
    emit("moist_initial_state", q_tot_min=q_tot0.min().item(),
         q_tot_max=q_tot0.max().item(), setup_s=path["setup_s"],
         build_s=path["build_s"])
    check(0.0 <= q_tot0.min().item() and q_tot0.max().item() < 0.02,
          "initial q_tot outside [0, 0.02)")
    rhs = path["rhs"]
    check(rhs.moist and rhs.write_aux and rhs.nq == 6, "moist var-major RHS")
    qp = perturbed(path["q0"], seed)
    kernels = phase_kernels(rhs, qp, path["aux0"])
    kernels.update(phase_surface_kernels(rhs, qp, path["aux0"]))
    del qp
    for mode in ("xla", "pallas"):
        step_vs_plain(path, mode)
    for imex, tol in ((False, MOIST_SMALL_TOL), (True, MOIST_IMEX_SMALL_TOL)):
        err = moist_small_reference(imex)
        emit("moist_small_reference", solver="IMEX" if imex else "LSRK54",
             n_horz=2, n_vert=3 if imex else 2, poly=POLY, steps=3,
             rel_err_per_var=err, tol=tol)
        check(all(e <= t for e, t in zip(err, tol)),
              ("moist small reference", imex, err))

    explicit_ms = {}
    for mode in SURFACE_KERNELS:
        res, counts, _ = run_path(path, N_WARM, N_STEPS, mode)
        expected = expected_launches(
            {name: 5 for name in EXPLICIT + SURFACE_LAUNCHES[mode]},
            N_WARM + N_STEPS)
        emit("moist_path", solver="LSRK54", expected_launches=expected,
             **res)
        check_launches(counts, expected)
        explicit_ms[mode] = res["ms_per_step"]
    del path, rhs
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    path = moist_imex_stable_path()
    setup_peak = torch.cuda.max_memory_allocated()
    sv = path["solver"].solver
    check(sv.layout.nvars == 6 and sv.nb == 30, ("moist blocks", sv.nb))
    kernels.update(phase_layout_kernels(sv.layout,
                                        perturbed(path["q0"], seed), seed))
    for mode in ("xla", "pallas"):
        imex_step_vs_plain(path, mode)
    imex_layout_step_vs_plain(path)

    n = N_WARM_IMEX + N_STEPS_IMEX
    imex_ms, launches = {}, {}
    for mode in SURFACE_KERNELS:
        torch.cuda.reset_peak_memory_stats()
        res, counts, q = run_path(path, N_WARM_IMEX, N_STEPS_IMEX, mode)
        expected = expected_launches(
            {**{name: 3 for name in EXPLICIT + SURFACE_LAUNCHES[mode]},
             "to_blocks_vm": 3, "from_blocks_vm": 2}, n)
        res.update(solver="ARK2GiraldoKellyConstantinescu+BlockTridiag",
                   build_s=path["build_s"], block_size=sv.nb,
                   active_unknowns=sv.active_count,
                   dt_halvings=path["dt_halvings"],
                   peak_memory_setup_bytes=setup_peak,
                   peak_memory_steps_bytes=torch.cuda.max_memory_allocated(),
                   expected_launches=expected)
        emit("moist_path", **res)
        check_launches(counts, expected)
        imex_ms[mode], launches[mode] = res["ms_per_step"], counts
        del q
    path["rhs"].surface_kernel = "xla"
    return dict(kernels=kernels, launches=launches["pallas"],
                explicit_ms_per_step=explicit_ms, imex_ms_per_step=imex_ms,
                imex_dt_s=path["dt"])


def phase_moist_kernel_orders(seed: int):
    """The moist branches at each of EDGE_ORDERS on the small moist grid
    (48 elements): K1-K4 at n = 5 and the volume kernel at nq = 6 with
    and without F₂ on the var-major RHS's inputs, each held on all
    elements and on the first TAIL_E (:func:`hold`); then the moist
    var-major RHS against the one with every stage's plain version."""
    from climatemachine_tpu_torch.experiments.baroclinic_wave import \
        baroclinic_wave_config
    for poly in EDGE_ORDERS:
        cfg = baroclinic_wave_config(*EDGE_GRID, poly, dtype=torch.float32,
                                     hyperdiffusion_tau=MOIST_TAU,
                                     device="cuda")
        dg = DGModel(cfg.model, cfg.grid)
        q0, aux0 = init_ode_state(dg)
        q = perturbed(q0, seed)
        rhs = VarMajorRHS(dg)
        _, inputs = chain_inputs(rhs, q, aux0)
        cases = {name: (name, inputs[name], {}) for name in CHAIN}
        for f2 in (True, False):
            cases["fused_volume_tendency_vm" + ("" if f2 else "_no_f2")] = (
                "fused_volume_tendency_vm",
                inputs["fused_volume_tendency_vm"], volume_kwargs(rhs, f2))
        rem_cases, rhs_errs = remainder_order_cases(dg, q, aux0, moist=True)
        cases.update(rem_cases)
        held = {entry: hold(name, args, kw)
                for entry, (name, args, kw) in cases.items()}
        rhs_errs["var_major"] = per_var_err(
            rhs(q, aux0, 0.0)[0], plain_rhs(dg, "xla")(q, aux0, 0.0)[0])
        torch.cuda.synchronize()
        emit("kernel_orders", moist=True, poly=poly, Np=cfg.grid.Np,
             elements=cfg.grid.nelem, tail_elements=TAIL_E, tol=KERNEL_TOL,
             kernels=held, rhs_rel_err_per_var=rhs_errs,
             rhs_tol=GENERIC_RHS_TOL, remainder_rhs_tol=REMAINDER_TOL)
        for name, err in rhs_errs.items():
            check(all(torch.isfinite(torch.tensor(err)))
                  and max(err) <= order_rhs_tol(name),
                  ("moist RHS at order", poly, name, err))


# --- the moist wave with tracers and warm rain: the generic DG operator ------

def tracer_model(model, precip: str = "warm_rain"):
    """The moist wave's model (with its tracers) with a precipitation
    model and its microphysics source added from the public parts, as a
    user builds them: ``replace(physics, precipitation=RainModel())`` and
    sources (Gravity(), Coriolis(), WarmRain1M()); or, "rain_snow",
    RainSnowModel and RainSnow1M."""
    from climatemachine_tpu_torch.atmos import precipitation as pr
    from climatemachine_tpu_torch.atmos.sources import Coriolis, Gravity
    prec, src = {"warm_rain": (pr.RainModel, pr.WarmRain1M),
                 "rain_snow": (pr.RainSnowModel, pr.RainSnow1M)}[precip]
    return AtmosModel(replace(model.physics, precipitation=prec()),
                      model.problem, sources=(Gravity(), Coriolis(), src()))


def build_tracer_base(precip: str = "warm_rain", grid_cfg=None,
                      n_horz=N_HORZ, n_vert=N_VERT, device="cuda") -> dict:
    """The moist wave with two tracers (``baroclinic_wave_config(tracers=
    NTracers(TRACER_DELTA))``, EquilMoistBiharmonic(8 h), no filter) and
    the precipitation of ``precip``, the generic DG operator
    ``DGModel(model, grid)``, and its initial state with ρχ = ρ·(1,
    z/TRACER_H) (tests/test_moisture.py:85-86; the wave's own initial
    state leaves ρχ and ρq_rai zero).  ``grid_cfg``: a config whose grid
    and physics to reuse."""
    from climatemachine_tpu_torch.atmos.tracers import NTracers
    from climatemachine_tpu_torch.experiments.baroclinic_wave import \
        baroclinic_wave_config
    t0 = time.perf_counter()
    cfg = grid_cfg or baroclinic_wave_config(
        n_horz=n_horz, n_vert=n_vert, poly_order=POLY, dtype=torch.float32,
        hyperdiffusion_tau=MOIST_TAU, tracers=NTracers(TRACER_DELTA),
        device=device)
    model = tracer_model(cfg.model, precip)
    dg = DGModel(model, cfg.grid)
    q0, aux0 = init_ode_state(dg)
    sp = model.prog_spec
    z = model.aux_spec.get(aux0, "orientation.Phi") / model.param_set.grav
    rho = q0[:, 0]
    q0[:, sp.index("tracers.rhochi")] = torch.stack(
        [rho, rho * z / TRACER_H], dim=1)
    if device == "cuda":
        torch.cuda.synchronize()
    return dict(tau=MOIST_TAU, cfg=SimpleNamespace(model=model,
                                                   grid=cfg.grid),
                base_cfg=cfg, dg=dg, q0=q0, aux0=aux0, hsf=None,
                precip=precip, n_horz=n_horz, n_vert=n_vert,
                build_s=time.perf_counter() - t0)


def with_rain(base) -> dict:
    """The base with ρq = RAIN_START · ρ on every precipitation lane below
    RAIN_TOP in its initial state."""
    model = base["cfg"].model
    sp = model.prog_spec
    z = model.aux_spec.get(base["aux0"], "orientation.Phi") \
        / model.param_set.grav
    q0 = base["q0"].clone()
    low = RAIN_START * torch.where(z < RAIN_TOP, q0[:, 0], 0.0)
    for i, name in enumerate(sp.flattened_names()):
        if name.startswith("precipitation."):
            q0[:, i] = low
    return dict(base, q0=q0, precip=base["precip"] + "+rain_start")


def tracer_make(base, kind: str, dt: float, dg=None):
    """(solver, set-up s, peak device bytes of the set-up) of ``kind``:
    "explicit" (``ExplicitSolverType().make``), "imex"
    (``IMEXSolverType().make``: "auto" takes the generic operator, the
    banded solver) or "dense" (``IMEXSolverType(columnwise_solver=
    "dense").make``), on ``dg`` (the base's unless given)."""
    dg = dg or base["dg"]
    make = {"explicit": ExplicitSolverType(), "imex": IMEXSolverType(),
            "dense": IMEXSolverType(columnwise_solver="dense")}[kind].make
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    solver = make(dg, base["q0"], base["aux0"], dt)
    torch.cuda.synchronize()
    check(solver.vm is None, (kind, "the generic operator"))
    return (solver, time.perf_counter() - t0,
            torch.cuda.max_memory_allocated())


def tracer_masses(model, g, q) -> dict:
    """Σ M q of ρ, ρq_tot, each precipitation lane and each tracer, in
    float64."""
    return {name: torch.sum(g.M.double() * q[:, i].double()).item()
            for i, name in enumerate(model.prog_spec.flattened_names())
            if i == 0 or i >= 5}


def run_tracer_path(base, solver, dt: float, n_warm: int, n_steps: int,
                    per_step: dict, label: str, stable_only=False) -> dict:
    """Set every launch count to 0, take ``n_warm`` + ``n_steps`` steps
    from the base's initial state (timing the last ``n_steps``), read the
    counts; report ms a step, launches against ``per_step`` × steps, the
    masses' relative changes (the tracers' held to MASS_TOL: no source
    touches them and the walls pass none; ρ, ρq_tot and the rain's move
    with the microphysics and the rain's fall through the bottom wall),
    max ρq_rai (and ρq_sno), max|u| (< MAX_ABS_U) and finiteness.  With
    ``stable_only`` an unstable run returns its report instead of
    raising."""
    g, model = base["cfg"].grid, base["cfg"].model
    m0 = tracer_masses(model, g, base["q0"])
    reset_launch_counts()
    q, aux, t = base["q0"], base["aux0"], 0.0
    for _ in range(n_warm):
        q, aux = solver.step(q, aux, t)
        t += dt
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(n_steps):
        q, aux = solver.step(q, aux, t)
        t += dt
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    counts = launch_counts()
    n = n_warm + n_steps
    expected = expected_launches(per_step, n)
    m1 = tracer_masses(model, g, q)
    change = {k: abs(m1[k] - m0[k]) / max(abs(m0[k]), 1e-300) for k in m0}
    tracers = {k: v for k, v in change.items() if k.startswith("tracers")}
    finite = bool(torch.isfinite(q).all() and torch.isfinite(aux).all())
    umax = (q[:, 1:4] / q[:, :1]).abs().max().item()
    sp = model.prog_spec
    res = dict(card=nvidia_smi(), path=label, precip=base["precip"],
               nq=sp.num, n_horz=base["n_horz"], n_vert=base["n_vert"],
               poly=POLY,
               elements=g.nelem, gridpoints=g.nelem * g.Np,
               dtype="float32", dt_s=dt, warm_steps=n_warm,
               steps=n_steps, ms_per_step=1e3 * wall / n_steps,
               sim_s_per_wall_s=dt * n_steps / wall, launches=counts,
               expected_launches=expected, mass_change_rel=change,
               tracer_mass_drift_rel=tracers, tracer_mass_tol=MASS_TOL,
               max_abs_u=umax, max_abs_u_bound=MAX_ABS_U, finite=finite,
               shape=list(q.shape),
               **{"max_" + name.split(".")[1]: q[:, i].max().item()
                  for i, name in enumerate(sp.flattened_names())
                  if name.startswith("precipitation.")})
    res["stable"] = finite and umax < MAX_ABS_U
    if stable_only and not res["stable"]:
        return res
    check(finite, (label, "state not finite"))
    check(umax < MAX_ABS_U, (label, "max |u|", umax))
    check(max(tracers.values()) <= MASS_TOL, (label, "tracer mass drift",
                                              tracers))
    check_launches(counts, expected)
    return res


def per_var_err0(got, ref) -> list:
    """:func:`per_var_err` with 0 where a variable is 0 in both."""
    diff = (got - ref).abs().amax(dim=(0, 2))
    scale = ref.abs().amax(dim=(0, 2))
    return torch.where(diff == 0, 0.0, diff / scale).tolist()


def tracer_step_vs_plain(solver, plain, q0, aux0, label: str):
    """One step of ``solver`` (the kernels) against one of ``plain`` (the
    same with the chain's and the layouts' plain versions) from (q0,
    aux0): per variable within STEP_TOL's bound (:func:`step_vs_plain`),
    0 where both steps leave a variable unchanged; and whether the two
    are equal bit for bit."""
    q1, _ = solver.step(q0, aux0, 0.0)
    q1p, _ = plain.step(q0, aux0, 0.0)
    eps32 = torch.finfo(torch.float32).eps
    bound = (STEP_TOL * (q1p - q0).abs().amax(dim=(0, 2))
             + 4 * eps32 * q1p.abs().amax(dim=(0, 2)))
    diff = (q1 - q1p).abs().amax(dim=(0, 2))
    err = torch.where(diff == 0, 0.0, diff / bound).tolist()
    emit("tracer_step_vs_plain", path=label, err_over_bound_per_var=err,
         max_abs_diff_per_var=diff.tolist(), exact=torch.equal(q1, q1p),
         tol=STEP_TOL)
    check(max(err) <= 1.0, (label, "step vs plain", err))


def tracer_kernels(base, seed: int) -> dict:
    """K1-K4 against their plain versions, bit for bit, on the generic
    operator's own chain input at a perturbed state (the gradient-
    Laplacian hook's (u_h, h_tot, q_tot), n = 5, after the aux refresh),
    each stage's input from the plain stages before it; then the RHS
    against the one with the chain's plain stages and with the node-
    gather surface pass it takes, and both RHS' times."""
    dg, model, g = base["dg"], base["cfg"].model, base["cfg"].grid
    q = perturbed(base["q0"], seed)
    aux = model.update_auxiliary_state(q, base["aux0"], g)
    direction = model.hyperdiffusion_direction or dg.direction
    ops = dg.ldg_operators(direction)
    glv = model.compute_gradient_laplacian_argument(q, aux, 0.0)
    check(glv.shape[1] == 5, ("chain rows", glv.shape))
    args, _ = chain_stage_args(glv, ops, g)
    view = SimpleNamespace(grid=g, hd=model.physics.hyperdiffusion,
                           chain=ops, nq=model.prog_spec.num, bl=model)
    kernels = {name: kernel_vs_plain(name, args[name], view, n=5,
                                     exact=True) for name in CHAIN}
    del args
    plain = DGModel(model, g, chain_stages=ldg_kernel.PLAIN)
    check(not dg.fast_surface and not dg.dry_volume, "generic moist route")
    got, ref = dg(q, base["aux0"], 0.0)[0], plain(q, base["aux0"], 0.0)[0]
    torch.cuda.synchronize()
    err = per_var_err0(got, ref)
    times = {key: cuda_ms(lambda d=d: d(q, base["aux0"], 0.0), 10, warm=2)
             for key, d in (("generic_rhs_ms", dg),
                            ("plain_stages_rhs_ms", plain))}
    emit("tracer_rhs", card=nvidia_smi(), rel_err_per_var=err,
         exact=torch.equal(got, ref), tol=GENERIC_RHS_TOL,
         max_abs_per_var=ref.abs().amax(dim=(0, 2)).tolist(), **times)
    check(all(math.isfinite(e) for e in err) and max(err) <= GENERIC_RHS_TOL,
          ("tracer RHS vs plain stages", err))
    return kernels


def phase_moist_tracers(seed: int) -> dict:
    """The moist baroclinic wave with two passive tracers and warm rain
    (nq = 9) on the generic DG operator at full width: K1-K4 against
    their plain versions on its chain input and its RHS against the
    plain-stage RHS (:func:`tracer_kernels`); LSRK54 through
    ``ExplicitSolverType().make`` ("auto": the generic operator) at the
    moist explicit dt, one step against the plain-stage step, then
    N_WARM + N_STEPS steps; 3 steps each with the Roe, moist Roe, HLLC
    and LMARS fluxes, and, from a state with rain below RAIN_TOP
    (:func:`with_rain`), 5 with warm rain and 5 with RainSnowModel +
    RainSnow1M (nq = 10, snow as well); the banded IMEX path
    (``IMEXSolverType().make``: 45 × 45 blocks) at the moist IMEX dt
    (TRACER_IMEX_HALVINGS), halved until 35 steps stay stable: both
    layout kernels
    at (1536, 8, 9, 5, 25), their template-constant and runtime-dims
    branches, against their plain versions and the library call, one
    step against the plain-stage, plain-layout step, 35 steps; the dense
    IMEX path at the same dt (360 × 360 columns), one step against the
    plain-stage step, 35 steps.  Every run with exact
    launch counts, the tracers' mass drift, max ρq_rai, max|u|."""
    base = build_tracer_base()
    model, g = base["cfg"].model, base["cfg"].grid
    check(model.prog_spec.num == 9 and model.prog_spec.flattened_names()[5:]
          == ["moisture.rhoq_tot", "precipitation.rhoq_rai",
              "tracers.rhochi[0]", "tracers.rhochi[1]"], "the 9 lanes")
    emit("tracer_initial_state", build_s=base["build_s"],
         masses=tracer_masses(model, g, base["q0"]))
    kernels = tracer_kernels(base, seed)
    chain = {name: 1 for name in CHAIN}
    ms, setup, peak, launches = {}, {}, {}, {}

    # explicit, the Rusanov flux (the default)
    dt_ex = 0.3 * min_node_distance(g) / 350.0
    solver, setup["explicit"], peak["explicit"] = tracer_make(
        base, "explicit", dt_ex)
    check(solver.rhs is base["dg"], "explicit: the generic operator")
    plain_dg = DGModel(model, g, chain_stages=ldg_kernel.PLAIN)
    tracer_step_vs_plain(solver, ExplicitSolverType().make(
        plain_dg, base["q0"], base["aux0"], dt_ex), base["q0"],
        base["aux0"], "explicit")
    res = run_tracer_path(base, solver, dt_ex, N_WARM, N_STEPS,
                          {k: 5 * v for k, v in chain.items()}, "explicit")
    emit("tracer_path", solver="LSRK54", setup_s=setup["explicit"],
         peak_memory_setup_bytes=peak["explicit"], **res)
    ms["explicit"], launches["explicit"] = res["ms_per_step"], res["launches"]
    del solver

    # the other first-order fluxes, and rain with snow
    for name, flux in TRACER_FLUXES.items():
        dg = DGModel(model, g, numerical_flux_first_order=flux())
        solver, s_s, _ = tracer_make(base, "explicit", dt_ex, dg=dg)
        res = run_tracer_path(base, solver, dt_ex, 0, N_STEPS_TR_FLUX,
                              {k: 5 * v for k, v in chain.items()},
                              f"explicit:{name}")
        emit("tracer_path", solver="LSRK54", flux=name, setup_s=s_s, **res)
        ms[f"explicit:{name}"] = res["ms_per_step"]
    snow = with_rain(build_tracer_base(
        "rain_snow", grid_cfg=base["base_cfg"], n_horz=base["n_horz"],
        n_vert=base["n_vert"], device=g.device.type))
    check(snow["cfg"].model.prog_spec.num == 10, "rain and snow lanes")
    for label, b in (("explicit:rain_start", with_rain(base)),
                     ("explicit:rain_snow", snow)):
        solver, s_s, _ = tracer_make(b, "explicit", dt_ex)
        res = run_tracer_path(b, solver, dt_ex, 0, N_STEPS_TR_FLUX,
                              {k: 5 * v for k, v in chain.items()}, label)
        emit("tracer_path", solver="LSRK54", setup_s=s_s,
             start_masses=tracer_masses(b["cfg"].model, g, b["q0"]), **res)
        ms[label] = res["ms_per_step"]
    del solver, snow, dg, b
    torch.cuda.empty_cache()

    # banded IMEX at the moist IMEX dt, halved until stable
    dt0 = 0.1 * min_node_distance(g, "horizontal") / 350.0
    for k in range(TRACER_IMEX_HALVINGS, MOIST_DT_HALVINGS + 1):
        dt_im = dt0 / 2 ** k
        solver, setup["imex"], peak["imex"] = tracer_make(base, "imex",
                                                          dt_im)
        sv = solver.solver
        check(solver.rhs_full is base["dg"] and sv.layout.nvars == 9
              and sv.nb == 45, ("banded blocks", sv.nb))
        if k == TRACER_IMEX_HALVINGS:
            dims = sv.layout.layout_dims
            check(tuple(dims) == TRACER_LAYOUT_DIMS, ("layout dims", dims))
            qp = perturbed(base["q0"], seed)
            kernels["to_blocks_vm" + TRACERS] = layout_vs_plain(
                "to_blocks_vm", qp, dims, runtime_dims=True)
            yb = sv.layout.to_blocks(qp)
            kernels["from_blocks_vm" + TRACERS] = layout_vs_plain(
                "from_blocks_vm", yb, dims, runtime_dims=True)
            check(torch.equal(sv.layout.from_blocks(yb), qp),
                  "from_blocks(to_blocks(x)) != x at nvars = 9")
            del qp, yb
            plain_sv = copy.copy(sv)
            plain_sv.layout = ColumnLayout(
                g, 9, to_blocks=layout_kernel.to_blocks_vm_plain,
                from_blocks=layout_kernel.from_blocks_vm_plain)
            tracer_step_vs_plain(solver, ARK2GiraldoKellyConstantinescu(
                None, None, plain_sv, dt_im, rhs_full=plain_dg),
                base["q0"], base["aux0"], "imex")
            del plain_sv
        res = run_tracer_path(
            base, solver, dt_im, N_WARM_IMEX, N_STEPS_IMEX,
            {**{c: 3 * v for c, v in chain.items()},
             "to_blocks_vm": 3, "from_blocks_vm": 2}, "imex",
            stable_only=True)
        emit("tracer_path", solver="ARK2GiraldoKellyConstantinescu"
             "+BlockTridiag", halvings=k, block_size=sv.nb,
             active_unknowns=sv.active_count, setup_s=setup["imex"],
             peak_memory_setup_bytes=peak["imex"], **res)
        del solver, sv
        torch.cuda.empty_cache()
        if res["stable"]:
            break
    check(res["stable"], "no stable IMEX dt on the tracer path")
    ms["imex"], launches["imex"] = res["ms_per_step"], res["launches"]

    # dense IMEX at the same dt
    solver, setup["dense"], peak["dense"] = tracer_make(base, "dense",
                                                        dt_im)
    sv = solver.solver
    check(sv.layout.nvars == 9 and sv.A.shape[-1] == sv.layout.Nv,
          ("dense columns", sv.A.shape))
    plain = copy.copy(solver)
    plain.rhs_ex = replace(solver.rhs_ex, chain_stages=ldg_kernel.PLAIN)
    tracer_step_vs_plain(solver, plain, base["q0"], base["aux0"], "dense")
    del plain
    res = run_tracer_path(base, solver, dt_im, N_WARM_IMEX, N_STEPS_IMEX,
                          {c: 3 * v for c, v in chain.items()}, "dense")
    emit("tracer_path", solver="ARK2GiraldoKellyConstantinescu+dense",
         setup_s=setup["dense"], peak_memory_setup_bytes=peak["dense"],
         column_unknowns=sv.layout.Nv,
         dense_matrix_bytes=sv.A.numel() * sv.A.element_size(), **res)
    ms["dense"], launches["dense"] = res["ms_per_step"], res["launches"]
    del solver, sv, base
    torch.cuda.empty_cache()
    return dict(kernels=kernels, launches=launches, ms_per_step=ms,
                setup_s=setup, peak_memory_setup_bytes=peak, imex_dt_s=dt_im)


# --- the fused remainder -------------------------------------------------------

def rem_entry(name, *parts, moist=False) -> str:
    """The kernels line's entry of a remainder branch of kernel ``name``:
    its direction, linear model and other parts, "[moist]" at nq = 6."""
    return (name + (MOIST if moist else "") + "[rem"
            + "".join(f":{part}" for part in parts if part) + "]")


def linear_dg(dg, ldir: str, lin: str):
    """The linear model ``lin`` of ``dg``'s model in direction ``ldir``, as
    the solver types build it."""
    return DGModel(LIN_MODELS[lin](dg.balance_law), dg.grid, direction=ldir,
                   update_aux=False)


def remainder_kernel_inputs(rhs, q, aux, hyper: bool = None) -> dict:
    """The kernels' (args, kwargs) on the var-major remainder RHS ``rhs`` at
    (q, aux), as it hands them over: the volume kernel with ``lin_dims``,
    the extraction at na = 4 and the flux + lift with ``rem_lanes`` on the
    plain extraction's bundle and its neighbour side; with ``hyper``
    False the surface kernels without the n·F₂ trace lanes (on a model
    with hyperdiffusion)."""
    g, ps, nq, sp = rhs.grid, rhs.bl.param_set, rhs.nq, rhs.bl.aux_spec
    hyper = rhs.hd is not None if hyper is None else hyper
    _, p, c_s, aux = rhs._thermo_update(q, aux, False)
    gl2 = rhs._chain(q, aux, p) if rhs.hd is not None else None
    nu = rhs.nu if rhs.hd is not None else None
    p_ref = aux[:, rhs.i_pref].contiguous()
    ref3 = torch.stack([sp.get(aux, "ref_state.rhoe"),
                        sp.get(aux, "ref_state.rho"), p_ref], dim=1)
    vol = ((q, p, aux[:, rhs.i_phi].contiguous(), p_ref, ref3, gl2, nu,
            rhs.xiv, g.M, g.MI, g.Wdiv),
           dict(volume_kwargs(rhs, rhs.hd is not None),
                lin_dims=rhs.lin_dims, lin_gravity=rhs.lin_gravity))
    ext = ((q, p, c_s, rhs._aux_lanes(aux), gl2 if hyper else None,
            nu if hyper else None, g.lift, rhs.nrm),
           dict(nq=nq, na=4, ngl=rhs.bl.gradlap_spec.num, has_hyper=hyper))
    Bf = surface_kernel.extract_trace_plain(*ext[0], **ext[1])
    sl_lo, sl_hi = rhs.lin_lanes
    lift = ((Bf, rhs._gather_faces(Bf), rhs.nrm, rhs.sM, rhs.bmask,
             rhs.liftT, g.MI),
            dict(nq=nq, nvb=Bf.shape[1], subtract=rhs.subtract,
                 i_pref=nq + 2,
                 has_hyper=hyper, rem_lanes=(nq + 3, nq + 4, nq + 5),
                 sl_lo=sl_lo, sl_hi=sl_hi, R_d_T0=ps.R_d * ps.T_0,
                 R_over_cv=ps.R_d / ps.cv_d))
    return {"fused_volume_tendency_vm": vol, "extract_trace_vm": ext,
            "fused_surface_lift_vm": lift}


def remainder_config(moist: bool, tau, n_horz=N_HORZ, n_vert=N_VERT,
                     poly=POLY):
    """The model at ``tau`` (None: no hyperdiffusion), its DGModel and
    initial state: dry Held-Suarez, or the moist baroclinic wave."""
    if moist:
        from climatemachine_tpu_torch.experiments.baroclinic_wave import \
            baroclinic_wave_config
        cfg = baroclinic_wave_config(n_horz, n_vert, poly,
                                     dtype=torch.float32,
                                     hyperdiffusion_tau=tau, device="cuda")
    else:
        cfg = held_suarez_config(n_horz=n_horz, n_vert=n_vert,
                                 poly_order=poly, dtype=torch.float32,
                                 hyperdiffusion_tau=tau, device="cuda")
    dg = DGModel(cfg.model, cfg.grid)
    return (cfg, dg) + tuple(init_ode_state(dg))


def remainder_rhs_run(dg_rem, rhs, q, aux0, moist: bool) -> dict:
    """The var-major remainder RHS ``rhs`` once under each surface pass,
    its launches counted from 0, against the RHS with every stage's plain
    version under the same pass and (dry) against the generic remainder
    ``dg_rem``: per variable errors, whether each equals its plain-stage
    twin bit for bit, the launches and each pass's ms per call."""
    reset_launch_counts()
    out = {}
    for mode in SURFACE_KERNELS:
        rhs.surface_kernel = mode
        out[mode] = rhs(q, aux0, 0.0)[0]
    torch.cuda.synchronize()
    counts = launch_counts()
    errs, exact, ms = {}, {}, {}
    plain = plain_rhs(dg_rem, "xla")
    for mode in SURFACE_KERNELS:
        plain.surface_kernel = mode
        ref = plain(q, aux0, 0.0)[0]
        exact[mode] = torch.equal(out[mode], ref)
        errs[mode] = per_var_err(out[mode], ref)
        rhs.surface_kernel = mode
        ms[mode] = cuda_ms(lambda: rhs(q, aux0, 0.0), 5, warm=1)
    if not moist:
        errs["generic_remainder"] = per_var_err(out["xla"],
                                                dg_rem(q, aux0, 0.0)[0])
    rhs.surface_kernel = "xla"
    return dict(launches=counts, exact=exact, rel_err_per_var=errs,
                rhs_ms=ms)


def phase_remainder(seed: int, moist: bool) -> dict:
    """The fused remainder of the var-major RHS at full width
    (``VarMajorRHS(remainder_DGModel(dg, dg_lin))``), dry Held-Suarez or
    the moist baroclinic wave, with hyperdiffusion (8 h) and without: for
    each linear model (acoustic-gravity, acoustic) and direction
    ("vertical", "every") the volume kernel's branch against its plain
    version bit for bit (and on the tail), the surface kernels' (na = 4,
    rem_lanes) likewise once per direction; the RHS under each surface
    pass against the plain-stage RHS and (dry) the generic remainder,
    with its launches.  Dry with hyperdiffusion, the dry kernel's new
    branches on the generic remainder's inputs, bit for bit, and each
    generic remainder against dg − dg_lin with its launches.  Returns
    {"kernels": {entry: result}, "launches": {entry: launches}}."""
    kernels, launches = {}, {}
    for tau in (MOIST_TAU if moist else 8 * 3600.0, None):
        hyper = tau is not None
        cfg, dg, q0, aux0 = remainder_config(moist, tau)
        q = perturbed(q0, seed)
        no_hyper = None if hyper else "no_hyper"
        for ldir, lin in REM_CASES:
            dg_rem = remainder_DGModel(dg, linear_dg(dg, ldir, lin))
            rhs = VarMajorRHS(dg_rem, write_aux=False)
            inputs = remainder_kernel_inputs(rhs, q, aux0)
            entries = {
                "fused_volume_tendency_vm": rem_entry(
                    "fused_volume_tendency_vm", ldir, lin,
                    None if hyper else "no_f2", moist=moist),
                "extract_trace_vm": rem_entry("extract_trace_vm", no_hyper,
                                              moist=moist),
                "fused_surface_lift_vm": rem_entry(
                    "fused_surface_lift_vm", ldir, no_hyper, moist=moist)}
            for name, entry in entries.items():
                if entry in kernels:      # the surface kernels' once
                    continue
                args, kw = inputs[name]
                kernels[entry] = kernel_vs_plain(name, args, rhs, n=0,
                                                 exact=True, **kw)
            del inputs
            res = remainder_rhs_run(dg_rem, rhs, q, aux0, moist)
            per_rhs = {name: 1 for name in ("fused_volume_tendency_vm",)
                       + (CHAIN if hyper else ())}
            expected = {name: 3 * per_rhs.get(name, 0) + {
                "extract_trace_vm": 2, "fused_surface_lift_vm": 1}.get(
                    name, 0) for name in KERNELS}
            emit("remainder_rhs", card=nvidia_smi(), moist=moist,
                 hyperdiffusion_tau=tau, direction=ldir, linear=lin,
                 lin_dims=list(rhs.lin_dims), expected_launches=expected,
                 tol=GENERIC_RHS_TOL, remainder_tol=REMAINDER_TOL, **res)
            check_launches(res["launches"], expected)
            for key, err in res["rel_err_per_var"].items():
                tol = REMAINDER_TOL if key == "generic_remainder" \
                    else GENERIC_RHS_TOL
                check(all(torch.isfinite(torch.tensor(err)))
                      and max(err) <= tol, ("remainder RHS", moist, tau,
                                            ldir, lin, key, err))
            for name, entry in entries.items():
                launches[entry] = launches.get(entry, 0) \
                    + res["launches"][name]
            del dg_rem, rhs
        if not moist and hyper:
            kernels.update(dry_remainder_branches(dg, q, aux0, launches))
        del cfg, dg, q0, aux0, q
        torch.cuda.empty_cache()
    return dict(kernels=kernels, launches=launches)


def dry_remainder_branches(dg, q, aux0, launches: dict) -> dict:
    """The dry kernel's new remainder branches (DRY_REM) on the generic
    remainder's inputs against the plain version, bit for bit; each
    generic remainder RHS against the one with every stage's plain
    version (GENERIC_RHS_TOL), its launches counted into ``launches``;
    its distance from the two-call difference dg − dg_lin is reported,
    not held (float32 cancellation: the remainder is the small difference
    of two large tendencies, and "every" cancels in all directions)."""
    g, model = dg.grid, dg.balance_law
    aux = model.update_auxiliary_state(q, aux0, g)
    grid_only = SimpleNamespace(grid=g, hd=None, nq=5)
    full = dg(q, aux0, 0.0)[0]
    kernels = {}
    for part, (ldir, lin) in DRY_REM.items():
        dg_lin = linear_dg(dg, ldir, lin)
        dg_rem = remainder_DGModel(dg, dg_lin)
        entry = rem_entry(DRY, part)
        args, kw = dry_volume_args(dg_rem, q, aux)
        kernels[entry] = kernel_vs_plain(DRY, args, grid_only, n=0,
                                         exact=True, **kw)
        del args
        reset_launch_counts()
        rem = dg_rem(q, aux0, 0.0)[0]
        torch.cuda.synchronize()
        counts = launch_counts()
        plain = remainder_DGModel(
            DGModel(model, g, volume=KERNELS[DRY][1],
                    chain_stages=ldg_kernel.PLAIN), dg_lin)
        ref = plain(q, aux0, 0.0)[0]
        err = per_var_err(rem, ref)
        expected = expected_launches({DRY: 1, **{k: 1 for k in CHAIN}}, 1)
        emit("generic_remainder", card=nvidia_smi(), direction=ldir,
             linear=lin, lin_dims=list(kw["lin_dims"]),
             lin_gravity=kw["lin_gravity"], rel_err_per_var=err,
             exact=torch.equal(rem, ref), tol=GENERIC_RHS_TOL,
             rel_err_vs_difference_per_var=per_var_err(
                 rem, full - dg_lin(q, aux, 0.0)[0]),
             launches=counts, expected_launches=expected,
             ms=cuda_ms(lambda: dg_rem(q, aux0, 0.0), 5, warm=1))
        check_launches(counts, expected)
        check(all(torch.isfinite(torch.tensor(err)))
              and max(err) <= GENERIC_RHS_TOL,
              ("generic remainder vs plain stages", ldir, lin, err))
        launches[entry] = counts[DRY]
    return kernels


def dense_acoustic_path(base, table) -> dict:
    """``IMEXSolverType(implicit_model=AtmosAcousticLinearModel,
    columnwise_solver="dense", state_layout="grid")`` on ``base`` with the
    filter: from the dense path's dt (the table's), halved up to
    ACOUSTIC_DT_HALVINGS times until its steps stay finite with max|u| <
    MAX_ABS_U for the table's 35 steps (each trial reported); then the 35
    steps with exact launch counts (3 a step of the dry kernel's vertical
    acoustic branch and of each chain kernel)."""
    g, dg = base["cfg"].grid, base["dg"]
    dt0 = 0.1 * min_node_distance(g, "horizontal") / 350.0
    if abs(table.dt - dt0) < 1e-5 * dt0:
        dt0 = table.dt
    n = N_WARM_IMEX + N_STEPS_IMEX
    for k in range(ACOUSTIC_DT_HALVINGS + 1):
        dt = dt0 / 2 ** k
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solver = IMEXSolverType(implicit_model=AtmosAcousticLinearModel,
                                columnwise_solver="dense",
                                state_layout="grid").make(
            dg, base["q0"], base["aux0"], dt)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        solver.post_step = base["hsf"].apply_vm
        q, aux, bad, umax = base["q0"], base["aux0"], None, 0.0
        for i in range(n):
            q, aux = solver.step(q, aux, i * dt)
            umax = (q[:, 1:4] / q[:, :1]).abs().max().item()
            if not (bool(torch.isfinite(q).all()) and umax < MAX_ABS_U):
                bad = i + 1
                break
        emit("dense_acoustic_dt_scan", card=nvidia_smi(), dt_s=dt,
             halvings=k, steps=n, stable=bad is None, first_bad_step=bad,
             max_abs_u=umax)
        del q, aux
        if bad is None:
            return dict(base, dt=dt, rhs=dg, solver=solver, setup_s=setup_s,
                        halvings=k)
        del solver
        torch.cuda.empty_cache()
    raise RuntimeError("chip_smoke check failed: no stable acoustic dense "
                       "IMEX dt")


def phase_solver_remainders(base, table) -> dict:
    """The two solver types whose explicit or slow operator is a generic
    remainder the earlier paths do not build, at full width, each with
    exact launch counts: the dense IMEX step on the acoustic linear model
    (:func:`dense_acoustic_path`; the dry kernel's vertical acoustic
    branch) and ``MultirateSolverType`` (slow dt MULTIRATE_DT_RATIO times
    the explicit path's, fast substeps at 1/MULTIRATE_TIMESTEP_RATIO of
    it, 6 steps, no filter: the dry kernel's every-direction
    acoustic-gravity branch in its slow operator), finite with max|u| <
    MULTIRATE_MAX_ABS_U.  Returns each path's launches and ms a step."""
    per_rhs = {DRY: 1, **{name: 1 for name in CHAIN}}
    out = {}
    torch.cuda.reset_peak_memory_stats()
    path = dense_acoustic_path(base, table)
    n = N_WARM_IMEX + N_STEPS_IMEX
    res, counts, q = run_path(path, N_WARM_IMEX, N_STEPS_IMEX)
    expected = expected_launches({k: 3 * v for k, v in per_rhs.items()}, n)
    res.update(path="dense_acoustic", implicit_model="AtmosAcousticLinearModel",
               dt_halvings=path["halvings"], expected_launches=expected,
               max_abs_u=(q[:, 1:4] / q[:, :1]).abs().max().item(),
               max_abs_u_bound=MAX_ABS_U,
               peak_memory_bytes=torch.cuda.max_memory_allocated())
    emit("solver_path", **res)
    check_launches(counts, expected)
    out["dense_acoustic"] = dict(launches=counts, ms_per_step=res[
        "ms_per_step"], dt_s=path["dt"])
    del path, q
    torch.cuda.empty_cache()

    g, dg = base["cfg"].grid, base["dg"]
    dt = MULTIRATE_DT_RATIO * 0.3 * min_node_distance(g) / 350.0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    solver = MultirateSolverType(
        timestep_ratio=MULTIRATE_TIMESTEP_RATIO).make(dg, base["q0"],
                                                      base["aux0"], dt)
    path = dict(base, dt=dt, rhs=dg, solver=solver,
                setup_s=time.perf_counter() - t0)
    res, counts, q = run_path(path, N_WARM_MR, N_STEPS_MR)
    n = N_WARM_MR + N_STEPS_MR
    expected = expected_launches({k: 5 * v for k, v in per_rhs.items()}, n)
    umax = (q[:, 1:4] / q[:, :1]).abs().max().item()
    res.update(path="multirate", fast_model="AtmosAcousticGravityLinearModel",
               timestep_ratio=MULTIRATE_TIMESTEP_RATIO,
               fast_dt_s=solver.fast.dt, slow_direction=dg.direction,
               expected_launches=expected, max_abs_u=umax,
               max_abs_u_bound=MULTIRATE_MAX_ABS_U)
    emit("solver_path", **res)
    check_launches(counts, expected)
    check(umax < MULTIRATE_MAX_ABS_U, ("multirate max |u|", umax))
    out["multirate"] = dict(launches=counts, ms_per_step=res["ms_per_step"],
                            dt_s=dt)
    return out


def order_rhs_tol(key: str) -> float:
    """The tolerance of an RHS against its plain-stage twin at the other
    orders: REMAINDER_TOL for a remainder (the small difference of two
    large tendencies: at 48 elements the card's cuBLAS sums the plain
    volume product in another order, which the remainder's cancellation
    amplifies to 1.3e-3 of its max at p5, NVIDIA H100 80GB HBM3), else
    GENERIC_RHS_TOL."""
    return REMAINDER_TOL if key.startswith("var_major[rem") \
        else GENERIC_RHS_TOL


def remainder_order_cases(dg, q, aux0, moist: bool):
    """The remainder branches at one of EDGE_ORDERS on ``dg``'s state (q,
    aux0): the cases for :func:`hold` (the volume kernel's, with and
    without F₂, for each of REM_CASES; the surface kernels', with and
    without the trace lanes, for each direction; dry, the dry kernel's
    DRY_REM branches on the generic remainders' inputs) and each
    remainder's var-major RHS (surface pass "pallas") against its
    plain-stage twin, per variable."""
    vm = "fused_volume_tendency_vm"
    cases, errs = {}, {}
    for ldir, lin in REM_CASES:
        dg_rem = remainder_DGModel(dg, linear_dg(dg, ldir, lin))
        rhs = VarMajorRHS(dg_rem, write_aux=False)
        inputs = remainder_kernel_inputs(rhs, q, aux0)
        args, kw = inputs[vm]
        for f2 in (True, False):
            cases[rem_entry(vm, ldir, lin, None if f2 else "no_f2",
                            moist=moist)] = (vm, args, dict(kw, has_f2=f2))
        if lin == "gravity":
            for hyper in (True, False):
                inp = inputs if hyper else remainder_kernel_inputs(
                    rhs, q, aux0, hyper=False)
                part = None if hyper else "no_hyper"
                if ldir == "vertical":
                    cases[rem_entry(SURFACE[0], part, moist=moist)] = (
                        SURFACE[0],) + inp[SURFACE[0]]
                cases[rem_entry(SURFACE[1], ldir, part, moist=moist)] = (
                    SURFACE[1],) + inp[SURFACE[1]]
        rhs.surface_kernel = "pallas"
        errs[rem_entry("var_major", ldir, lin)] = per_var_err(
            rhs(q, aux0, 0.0)[0], plain_rhs(dg_rem, "pallas")(q, aux0, 0.0)[0])
    if not moist:
        aux = dg.balance_law.update_auxiliary_state(q, aux0, dg.grid)
        for part, (ldir, lin) in DRY_REM.items():
            cases[rem_entry(DRY, part)] = (DRY,) + tuple(dry_volume_args(
                remainder_DGModel(dg, linear_dg(dg, ldir, lin)), q, aux))
    return cases, errs


# --- the isentropic vortex: the branches without the reference pressure ------

def vortex_state(model, coords, t):
    """The vortex's exact state ``[E, 5, Np]`` at time t of coords ``[E, 3,
    Np]`` (tests/test_isentropic_vortex.py:36-56): a Gaussian vortex
    carried by a uniform stream, wrapped into the periodic box."""
    ps = EARTH
    rho_inf = V_P_INF / (ps.R_d * V_T_INF)
    u_inf = (V_U_T * math.cos(V_ALPHA), V_U_T * math.sin(V_ALPHA))
    x = [coords[:, d] - u_inf[d] * t for d in range(2)]
    x = [xd - torch.floor((xd + V_L) / (2 * V_L)) * 2 * V_L for xd in x]
    r2 = x[0] ** 2 + x[1] ** 2
    gauss = torch.exp(-r2 / V_R ** 2 / 2.0)
    u = torch.stack([u_inf[0] - V_U_V * x[1] / V_R * gauss,
                     u_inf[1] + V_U_V * x[0] / V_R * gauss,
                     torch.zeros_like(gauss)], dim=1)
    T = V_T_INF * (1 - ps.kappa_d * V_U_V ** 2 / 2 * rho_inf / V_P_INF
                   * torch.exp(-r2 / V_R ** 2))
    p = V_P_INF * (T / V_T_INF) ** (1.0 / ps.kappa_d)
    rho = p / (ps.R_d * T)
    rhoe = rho * (td.internal_energy(ps, T) + 0.5 * torch.sum(u * u, dim=1))
    return torch.cat([rho[:, None], rho[:, None] * u, rhoe[:, None]], dim=1)


def build_vortex(ne=VORTEX_NE, nz=VORTEX_NZ, poly=POLY, nf=None) -> dict:
    """The vortex as a user builds it (tests/test_isentropic_vortex.py
    ``_setup``): a periodic ne × ne × nz brick on [−L, L]³, float32 on the
    card, ``AtmosPhysics(orientation=NoOrientation())`` (the default
    reference state, NoReferenceState, takes nothing out of the fluxes),
    dry Euler, no sources, numerical flux ``nf`` (None: Rusanov)."""
    t0 = time.perf_counter()
    r = ([np.linspace(-V_L, V_L, ne + 1)] * 2
         + [np.linspace(-V_L, V_L, nz + 1)])
    grid = make_grid(brick_topology(r, periodicity=(True, True, True)),
                     poly, dtype=torch.float32, device="cuda")
    model = AtmosModel(
        AtmosPhysics(orientation=NoOrientation()),
        AtmosProblem(init_state=lambda m, c, aux, t: vortex_state(m, c, t),
                     boundary_conditions=(AtmosBC(),)))
    dg = DGModel(model, grid, numerical_flux_first_order=nf)
    q0, aux0 = init_ode_state(dg)
    torch.cuda.synchronize()
    return dict(model=model, grid=grid, dg=dg, q0=q0, aux0=aux0,
                setup_s=time.perf_counter() - t0)


def vortex_dt(grid, t_end: float):
    """(dt, steps) of the JAX test's ``_advance``: 0.4 · min node
    distance / 400, shortened so that whole steps reach ``t_end``."""
    n = int(math.ceil(t_end / (0.4 * min_node_distance(grid) / 400.0)))
    return t_end / n, n


def vortex_err(got, ref) -> list:
    """max|got − ref| per variable over max|ref| of it, the momentum's
    three components over the largest (ρw's tendency is round-off about
    zero)."""
    scale = ref.abs().amax(dim=(0, 2))
    scale[1:4] = scale[1:4].max()
    return ((got - ref).abs().amax(dim=(0, 2)) / scale).tolist()


def vortex_l2_error(grid, q, q_exact) -> float:
    """The JAX test's ``_l2_error`` (tests/test_isentropic_vortex.py:90-99)
    in float64: Σ over ρ, ρu, ρe of Σ M (q − q_exact)² over the field's
    max|q_exact|², square-rooted."""
    M = grid.M.double()[:, None]
    err = 0.0
    for sl in (slice(0, 1), slice(1, 4), slice(4, 5)):
        d = q[:, sl].double() - q_exact[:, sl]
        err += float(torch.sum(M * d * d)
                     / q_exact[:, sl].abs().max() ** 2)
    return math.sqrt(err)


def run_vortex(v: dict, solver, dt: float, steps: int, mode=None,
               expected=None) -> dict:
    """``steps`` steps of ``solver`` from the vortex's initial state, its
    launch counts from 0 (with ``mode`` the var-major RHS's surface
    pass), the L2 error against the exact solution at the final time and
    the ρ and ρe drift; checks the JAX test's conditions and, with
    ``expected``, the launches."""
    g, model = v["grid"], v["model"]
    mass = lambda q, k: torch.sum(g.M.double() * q[:, k].double()).item()
    if mode is not None:
        solver.vm.surface_kernel = mode
    reset_launch_counts()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    q, aux = v["q0"], v["aux0"]
    for i in range(steps):
        q, aux = solver.step(q, aux, i * dt)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    counts = launch_counts()
    q_exact = vortex_state(model, g.coords.double().transpose(1, 2),
                           steps * dt)
    err = vortex_l2_error(g, q, q_exact)
    drift = {name: abs(mass(q, k) - mass(v["q0"], k)) / abs(mass(v["q0"], k))
             for name, k in (("rho", 0), ("rhoe", 4))}
    finite = bool(torch.isfinite(q).all())
    res = dict(card=nvidia_smi(), elements=g.nelem, poly=g.Nq[0] - 1,
               surface_kernel=mode, flux=type(v["dg"].nf1).__name__,
               var_major=solver.vm is not None, dt_s=dt, steps=steps,
               t_end_s=steps * dt, setup_s=v["setup_s"],
               ms_per_step=1e3 * wall / steps,
               gridpoints_per_s=g.nelem * g.Np * steps / wall,
               l2_error=err, l2_tol=VORTEX_L2_TOL, drift_rel=drift,
               drift_tol=VORTEX_DRIFT_TOL, finite=finite, launches=counts)
    check(finite, "vortex state not finite")
    check(err <= VORTEX_L2_TOL, ("vortex L2 error", err))
    check(max(drift.values()) <= VORTEX_DRIFT_TOL, ("vortex drift", drift))
    if expected is not None:
        res["expected_launches"] = expected
        check_launches(counts, expected)
    return res


def var_major_kernel_inputs(rhs, q, aux) -> dict:
    """The var-major kernels' (args, kwargs) on a path's RHS ``rhs`` without
    hyperdiffusion at (q, aux), as it hands them over: the volume kernel
    without F₂, the extraction and the flux + lift on the plain
    extraction's bundle and its neighbour side; with p_ref where the RHS
    reads it (na = 1, the bubble: taken out), else without (na = 0, the
    vortex: subtract=False)."""
    g, ps, nq = rhs.grid, rhs.bl.param_set, rhs.nq
    _, p, c_s, aux = rhs._thermo_update(q, aux, False)
    has_pref = rhs.i_pref is not None
    p_ref = aux[:, rhs.i_pref].contiguous() if has_pref else None
    vol = ((q, p, aux[:, rhs.i_phi].contiguous(), p_ref, None, None, None,
            rhs.xiv, g.M, g.MI, g.Wdiv), volume_kwargs(rhs, False))
    ext = ((q, p, c_s, rhs._aux_lanes(aux), None, None, g.lift, rhs.nrm),
           dict(nq=nq, na=int(has_pref), ngl=0, has_hyper=False))
    Bf = surface_kernel.extract_trace_plain(*ext[0], **ext[1])
    lift = ((Bf, rhs._gather_faces(Bf), rhs.nrm, rhs.sM, rhs.bmask,
             rhs.liftT, g.MI),
            dict(nq=nq, nvb=Bf.shape[1], subtract=rhs.subtract,
                 i_pref=nq + 2 if has_pref else nq, has_hyper=False,
                 rem_lanes=(), sl_lo=0, sl_hi=0, R_d_T0=ps.R_d * ps.T_0,
                 R_over_cv=ps.R_d / ps.cv_d))
    return {"fused_volume_tendency_vm": vol, "extract_trace_vm": ext,
            "fused_surface_lift_vm": lift}


def vortex_rhs_errs(v: dict, q, fluxes=VORTEX_FLUXES) -> dict:
    """A path's RHS at state q (the vortex's, and the inviscid bubble's
    with the Rusanov flux alone): the var-major RHS under each surface
    pass against its plain-stage twin and against the generic RHS, and
    the generic RHS of each of ``fluxes`` against its plain-stage twin
    (the dry kernel's plain version) and its all-plain twin (the
    contraction); per variable (:func:`vortex_err`)."""
    model, g, dg, aux0 = v["model"], v["grid"], v["dg"], v["aux0"]
    rhs = VarMajorRHS(dg, write_aux=False)
    errs = {}
    generic = dg(q, aux0, 0.0)[0]
    for mode in SURFACE_KERNELS:
        rhs.surface_kernel = mode
        out = rhs(q, aux0, 0.0)[0]
        errs[f"var_major:{mode}"] = vortex_err(
            out, plain_rhs(dg, mode)(q, aux0, 0.0)[0])
        errs[f"var_major:{mode}_vs_generic"] = vortex_err(out, generic)
    for name, nf in fluxes.items():
        dg_f = DGModel(model, g, numerical_flux_first_order=nf())
        ref = dg_f(q, aux0, 0.0)[0]
        for twin, d in (("plain_stages", DGModel(
                model, g, numerical_flux_first_order=nf(),
                volume=KERNELS[DRY][1])), ("all_plain", DGModel(
                    model, g, numerical_flux_first_order=nf(),
                    volume_kernel="xla"))):
            errs[f"generic:{name}_vs_{twin}"] = vortex_err(
                ref, d(q, aux0, 0.0)[0])
    torch.cuda.synchronize()
    return errs


def nosub_model(model):
    """``model`` with its hydrostatic reference state kept in aux but not
    taken out of the fluxes and sources (``HydrostaticState(
    _subtract_off=False)``)."""
    ph = model.physics
    return AtmosModel(replace(ph, ref_state=replace(ph.ref_state,
                                                    _subtract_off=False)),
                      model.problem, model.sources)


def nosub_entry(entry: str) -> str:
    """The kernels-line name of ``entry``'s branch without p_ref."""
    name, _, rest = entry.partition("[")
    return name + NOSUB + ("[" + rest if rest else "")


def nosub_remainders(seed: int) -> dict:
    """The remainder branches without the reference pressure taken out, on
    Held-Suarez at full width with ``HydrostaticState(_subtract_off=
    False)`` (its reference state still in aux: the remainder reads it)
    and DryBiharmonic(8 h), on a perturbed initial state: the volume
    kernel's vertical acoustic-gravity (with F₂) and every-direction
    acoustic (without) branches and the flux + lift's (subtract=False
    with rem_lanes, with and without the trace lanes) against their
    plain versions on the RHS's own inputs, and each RHS under each
    surface pass against its plain-stage twin with its launches; the
    var-major kernel's "horizontal" lin_dims (0, 1), with and without
    p_ref, on the vertical remainder's inputs (no var-major RHS takes a
    horizontal remainder); the dry kernel's vertical, horizontal and
    every branches on the generic remainders' inputs."""
    cfg = held_suarez_config(n_horz=N_HORZ, n_vert=N_VERT, poly_order=POLY,
                             dtype=torch.float32,
                             hyperdiffusion_tau=8 * 3600.0, device="cuda")
    model = nosub_model(cfg.model)
    dg = DGModel(model, cfg.grid)
    q0, aux0 = init_ode_state(dg)
    q = perturbed(q0, seed)
    vm = "fused_volume_tendency_vm"
    kernels = {}
    for ldir, lin, f2 in (("vertical", "gravity", True),
                          ("every", "acoustic", False)):
        dg_rem = remainder_DGModel(dg, linear_dg(dg, ldir, lin))
        rhs = VarMajorRHS(dg_rem, write_aux=False)
        check(not rhs.subtract and rhs.i_pref is not None,
              "the remainder's bundle carries p_ref without subtracting")
        inputs = remainder_kernel_inputs(rhs, q, aux0)
        args, kw = inputs[vm]
        kw = dict(kw, has_f2=f2)
        kernels[nosub_entry(rem_entry(vm, ldir, lin, None if f2
                                      else "no_f2"))] = kernel_vs_plain(
            vm, args, rhs, n=0, **kw)
        if ldir == "vertical":
            for sub in (True, False):
                entry = rem_entry(vm, "horizontal", lin)
                kernels[entry if sub else nosub_entry(entry)] = \
                    kernel_vs_plain(vm, args, rhs, n=0, **dict(
                        kw, lin_dims=(0, 1), subtract_ref=sub))
        for hyper in (True, False):
            args, kw = (inputs if hyper else remainder_kernel_inputs(
                rhs, q, aux0, hyper=False))[SURFACE[1]]
            kernels[nosub_entry(rem_entry(SURFACE[1], ldir, None if hyper
                                          else "no_hyper"))] = \
                kernel_vs_plain(SURFACE[1], args, rhs, n=0, **kw)
        del inputs, args
        res = remainder_rhs_run(dg_rem, rhs, q, aux0, moist=False)
        expected = {name: 3 * (name in (vm,) + CHAIN) + {
            "extract_trace_vm": 2, "fused_surface_lift_vm": 1}.get(name, 0)
            for name in KERNELS}
        emit("remainder_rhs", card=nvidia_smi(), moist=False,
             subtract_ref=False, hyperdiffusion_tau=8 * 3600.0,
             direction=ldir, linear=lin, expected_launches=expected,
             tol=GENERIC_RHS_TOL, remainder_tol=REMAINDER_TOL, **res)
        check_launches(res["launches"], expected)
        for key, err in res["rel_err_per_var"].items():
            tol = REMAINDER_TOL if key == "generic_remainder" \
                else GENERIC_RHS_TOL
            check(all(torch.isfinite(torch.tensor(err))) and max(err) <= tol,
                  ("remainder RHS without p_ref", ldir, lin, key, err))
        del dg_rem, rhs
    aux = model.update_auxiliary_state(q, aux0, cfg.grid)
    grid_only = SimpleNamespace(grid=cfg.grid, hd=None, nq=5)
    for ldir, lin in (("vertical", "gravity"), ("horizontal", "acoustic"),
                      ("every", "acoustic")):
        args, kw = dry_volume_args(
            remainder_DGModel(dg, linear_dg(dg, ldir, lin)), q, aux)
        kernels[nosub_entry(rem_entry(DRY, ldir, lin))] = kernel_vs_plain(
            DRY, args, grid_only, n=0, **kw)
    del cfg, dg, q0, aux0, q, aux
    torch.cuda.empty_cache()
    return kernels


def phase_vortex(seed: int) -> dict:
    """The isentropic vortex at full width (module docstring): the four
    branches without the reference pressure ([nosub]) against their plain
    versions on the path's own perturbed state, the RHS checks, then the
    paths: ``ExplicitSolverType().make`` (the var-major RHS: "auto"
    takes it for the Rusanov flux) over a quarter crossing under each
    surface pass, ``ExplicitSolverType(state_layout="grid")`` with the
    Rusanov, Roe and HLLC fluxes over an eighth each, and the quarter
    crossing at VORTEX_SMALL_NE on the var-major RHS; each with exact
    launch counts, the L2 error against the exact solution and the ρ and
    ρe drift.  Then the remainder branches without p_ref
    (:func:`nosub_remainders`).  Returns {"kernels": {entry: result},
    "launches": {entry: launches}, "ms_per_step": {run: ms}}."""
    t_phase = time.perf_counter()
    v = build_vortex()
    g, dg = v["grid"], v["dg"]
    q = perturbed(v["q0"], seed)
    aux = v["model"].update_auxiliary_state(q, v["aux0"], g)
    rhs = VarMajorRHS(dg, write_aux=False)
    check(not rhs.subtract and rhs.i_pref is None,
          "the vortex's bundle carries no p_ref")
    kernels = {}
    for name, (args, kw) in var_major_kernel_inputs(rhs, q,
                                                    v["aux0"]).items():
        kernels[name + NOSUB] = kernel_vs_plain(name, args, rhs, n=0, **kw)
    args, kw = dry_volume_args(dg, q, aux)
    check(kw["subtract_ref"] is False and args[2] is None,
          "the generic vortex RHS hands the dry kernel no p_ref")
    kernels[DRY + NOSUB] = kernel_vs_plain(
        DRY, args, SimpleNamespace(grid=g, hd=None, nq=5), n=0, **kw)
    del args
    errs = vortex_rhs_errs(v, q)
    emit("vortex_rhs", card=nvidia_smi(), rel_err_per_var=errs,
         tol=GENERIC_RHS_TOL)
    for key, err in errs.items():
        check(all(torch.isfinite(torch.tensor(err)))
              and max(err) <= GENERIC_RHS_TOL, ("vortex RHS", key, err))

    launches, ms = {}, {}
    t_end = 2 * V_L / V_U_T / 4
    dt, steps = vortex_dt(g, t_end)
    solver = ExplicitSolverType().make(dg, v["q0"], v["aux0"], dt)
    check(solver.vm is not None, "auto takes the var-major RHS (Rusanov)")
    for mode in SURFACE_KERNELS:
        per_step = {name: 5 for name in ("fused_volume_tendency_vm",)
                    + SURFACE_LAUNCHES[mode]}
        res = run_vortex(v, solver, dt, steps, mode,
                         expected_launches(per_step, steps))
        emit("vortex_path", layout="vm", crossing=0.25, **res)
        ms[f"vm:{mode}"] = res["ms_per_step"]
        if mode == "pallas":
            launches.update({name + NOSUB: res["launches"][name]
                             for name in per_step})
    dt8, steps8 = vortex_dt(g, t_end / 2)
    for name, nf in VORTEX_FLUXES.items():
        vf = dict(v, dg=DGModel(v["model"], g,
                                numerical_flux_first_order=nf()))
        solver = ExplicitSolverType(state_layout="grid").make(
            vf["dg"], v["q0"], v["aux0"], dt8)
        res = run_vortex(vf, solver, dt8, steps8,
                         expected=expected_launches({DRY: 5}, steps8))
        emit("vortex_path", layout="grid", crossing=0.125, **res)
        ms[f"grid:{name}"] = res["ms_per_step"]
        if name == "rusanov":
            launches[DRY + NOSUB] = res["launches"][DRY]
    del v, dg, rhs, solver, q, aux
    torch.cuda.empty_cache()
    small = build_vortex(VORTEX_SMALL_NE)
    dt_s, steps_s = vortex_dt(small["grid"], t_end)
    res = run_vortex(small, ExplicitSolverType().make(
        small["dg"], small["q0"], small["aux0"], dt_s), dt_s, steps_s,
        "xla")
    emit("vortex_path", layout="vm", crossing=0.25, small=True, **res)
    del small
    kernels.update(nosub_remainders(seed))
    emit("vortex_phase", card=nvidia_smi(),
         seconds=time.perf_counter() - t_phase, ms_per_step=ms)
    return dict(kernels=kernels, launches=launches, ms_per_step=ms)


def phase_vortex_kernel_orders(seed: int):
    """The [nosub] branches at each of EDGE_ORDERS: the vortex's four on a
    VORTEX_EDGE brick (48 elements: a partial last tile), the remainder
    branches without p_ref on Held-Suarez (EDGE_GRID) with
    ``HydrostaticState(_subtract_off=False)`` (every remainder case of
    :func:`remainder_order_cases`, and the var-major "horizontal"
    lin_dims with and without p_ref), each held as
    :func:`phase_kernel_orders` holds its kernels; then the vortex's
    var-major RHS under "pallas" and generic RHS, and each remainder RHS,
    against their plain-stage twins."""
    vm = "fused_volume_tendency_vm"
    for poly in EDGE_ORDERS:
        ne, nz = VORTEX_EDGE
        v = build_vortex(ne, nz, poly)
        q = perturbed(v["q0"], seed)
        aux = v["model"].update_auxiliary_state(q, v["aux0"],
                                                v["grid"])
        rhs = VarMajorRHS(v["dg"], write_aux=False)
        cases = {name + NOSUB: (name,) + inp for name, inp in
                 var_major_kernel_inputs(rhs, q, v["aux0"]).items()}
        cases[DRY + NOSUB] = (DRY,) + tuple(dry_volume_args(v["dg"], q, aux))
        rhs.surface_kernel = "pallas"
        errs = {"vortex:var_major": vortex_err(
            rhs(q, v["aux0"], 0.0)[0],
            plain_rhs(v["dg"], "pallas")(q, v["aux0"], 0.0)[0]),
            "vortex:generic": vortex_err(
                v["dg"](q, v["aux0"], 0.0)[0],
                DGModel(v["model"], v["grid"], volume=KERNELS[DRY][1])(
                    q, v["aux0"], 0.0)[0])}
        cfg = held_suarez_config(*EDGE_GRID, poly, dtype=torch.float32,
                                 hyperdiffusion_tau=8 * 3600.0,
                                 device="cuda")
        dg = DGModel(nosub_model(cfg.model), cfg.grid)
        q0, aux0 = init_ode_state(dg)
        qh = perturbed(q0, seed)
        rem_cases, rem_errs = remainder_order_cases(dg, qh, aux0,
                                                    moist=False)
        cases.update({nosub_entry(k): c for k, c in rem_cases.items()})
        errs.update({nosub_entry(k): e for k, e in rem_errs.items()})
        _, args, kw = rem_cases[rem_entry(vm, "vertical", "gravity")]
        for sub in (True, False):
            entry = rem_entry(vm, "horizontal", "gravity")
            cases[entry if sub else nosub_entry(entry)] = (vm, args, dict(
                kw, lin_dims=(0, 1), subtract_ref=sub))
        held = {entry: hold(name, args, kw)
                for entry, (name, args, kw) in cases.items()}
        torch.cuda.synchronize()
        emit("vortex_kernel_orders", poly=poly, Np=v["grid"].Np,
             elements=v["grid"].nelem, tail_elements=TAIL_E,
             tol=KERNEL_TOL, kernels=held, rhs_rel_err_per_var=errs,
             rhs_tol=GENERIC_RHS_TOL, remainder_rhs_tol=REMAINDER_TOL)
        for name, err in errs.items():
            check(all(torch.isfinite(torch.tensor(err)))
                  and max(err) <= order_rhs_tol(name.replace(NOSUB, "")),
                  ("RHS without p_ref at order", poly, name, err))


# --- the staged kernels at the other orders ----------------------------------

class StepTimer:
    """A ``solve`` callback: the host clock, after a synchronize, at the
    end of step ``warm`` and at the end of the run."""

    def __init__(self, warm: int):
        self.warm = warm
        self.start = self.end = None
        self.steps = 0

    def call(self, state):
        if state.step == self.warm:
            torch.cuda.synchronize()
            self.start = time.perf_counter()
        return False

    def fini(self, state):
        torch.cuda.synchronize()
        self.end = time.perf_counter()
        self.steps = state.step - self.warm


def les_config(turbulence, resolution=LES_RESOLUTION, solver_type=None,
               dc=None):
    """(driver configuration, solver configuration) of the rising bubble
    as a user builds them: ``AtmosLESConfiguration`` (through
    ``risingbubble_config``; float32 on the card) and
    ``make_solver_configuration`` (dt from ``calculate_dt`` at Courant
    0.4, ``ExplicitSolverType()`` unless ``solver_type``); ``dc`` reuses
    a driver configuration."""
    dc = dc or risingbubble_config(resolution, POLY, turbulence,
                                   torch.float32, "cuda")
    sc = make_solver_configuration(0.0, -1.0, dc, ode_solver_type=solver_type,
                                   Courant_number=LES_COURANT)
    return dc, sc


def run_les(sc, q0, aux0, expected: dict, mode=None) -> dict:
    """``invoke`` of ``sc`` from (q0, aux0) over LES_WARM + LES_STEPS
    steps (with ``mode`` the var-major RHS's surface pass), every launch
    count set to 0 just before and read just after, the last LES_STEPS
    steps timed; checks the state (shape, finite), the mass drift, that
    the bubble rises (max w > 0), invoke's norm ratio and the launches."""
    g = sc.dg.grid
    if mode is not None:
        sc.solver.vm.surface_kernel = mode
    sc.q, sc.aux, sc.t0 = q0, aux0, 0.0
    sc.timeend = (LES_WARM + LES_STEPS) * sc.dt
    timer = StepTimer(LES_WARM)
    reset_launch_counts()
    ratio = invoke(sc, user_callbacks=(timer,))
    counts = launch_counts()
    q = sc.q
    mass = lambda x: torch.sum(g.M.double() * x[:, 0].double()).item()
    drift = abs(mass(q) - mass(q0)) / mass(q0)
    finite = bool(torch.isfinite(q).all())
    wall = timer.end - timer.start
    res = dict(card=nvidia_smi(), elements=g.nelem, poly=g.Nq[0] - 1,
               gridpoints=g.nelem * g.Np, dtype="float32", dt_s=sc.dt,
               warm_steps=LES_WARM, steps=timer.steps,
               var_major=sc.solver.vm is not None, surface_kernel=mode,
               ms_per_step=1e3 * wall / timer.steps,
               gridpoints_per_s=g.nelem * g.Np * timer.steps / wall,
               sim_s_per_wall_s=sc.dt * timer.steps / wall,
               norm_ratio=ratio, mass_drift_rel=drift, mass_tol=MASS_TOL,
               max_w=(q[:, 3] / q[:, 0]).max().item(), finite=finite,
               launches=counts, expected_launches=expected)
    check(timer.steps == LES_STEPS, ("LES steps timed", timer.steps))
    check(list(q.shape) == [g.nelem, 5, g.Np], ("LES state shape",
                                                 list(q.shape)))
    check(finite, "LES state not finite")
    check(drift <= MASS_TOL, ("LES mass drift", drift))
    check(res["max_w"] > 0.0, ("the bubble does not rise", res["max_w"]))
    check(math.isfinite(ratio) and abs(ratio - 1.0) <= LES_RATIO_TOL,
          ("invoke's norm ratio", ratio))
    check_launches(counts, expected)
    return res


def les_small_reference(turbulence) -> list:
    """LES_SMALL_STEPS steps of the bubble on the small box
    (LES_SMALL_RESOLUTION: 3 × 3 × 3 elements at p4) in float32 on the
    card against the port's float64 run on the CPU from the same float32
    geometry and initial state (upcast), the same solver type ("auto"):
    the per-variable error (:func:`vortex_err`)."""
    dc, sc = les_config(turbulence, LES_SMALL_RESOLUTION)
    check(dc.grid.nelem == 27, ("small LES box", dc.grid.nelem))
    grid64 = grid_from_numpy(grid_to_numpy(dc.grid), device="cpu",
                             dtype=torch.float64)
    sc64 = make_solver_configuration(0.0, -1.0, replace(dc, grid=grid64),
                                     ode_dt=sc.dt)
    check((sc.solver.vm is None) == (sc64.solver.vm is None),
          "the small reference's twin takes the card run's RHS")
    runs = {"f32": (sc.solver, sc.q, sc.aux),
            "f64": (sc64.solver, sc.q.double().cpu(),
                    sc.aux.double().cpu())}
    final = {}
    for name, (solver, q, aux) in runs.items():
        for i in range(LES_SMALL_STEPS):
            q, aux = solver.step(q, aux, i * sc.dt)
        final[name] = q.double().cpu()
    return vortex_err(final["f32"], final["f64"])


def phase_les_bubble(seed: int) -> dict:
    """The rising-bubble LES with SmagorinskyLilly(0.21) at full size
    (15,625 elements, p4, float32), built only through the driver's
    entry: ``AtmosLESConfiguration`` → ``make_solver_configuration`` →
    ``invoke``.  "auto" puts it on the generic DG operator with its
    gradient pass, which runs no kernel (as in the JAX package: the dry
    volume kernel and the var-major surface pass take no gradient flux),
    so every launch count stays 0.  Reports the set-up seconds, ms per
    LSRK54 step (LES_STEPS after LES_WARM), the peak device memory, the
    mass drift, max w, invoke's norm ratio, then the small box against
    float64."""
    t_phase = time.perf_counter()
    driver_init(show_updates="never")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    dc, sc = les_config(SmagorinskyLilly(0.21))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    dg = sc.dg
    check(dc.grid.nelem == LES_ELEMENTS, ("LES elements", dc.grid.nelem))
    check(sc.solver.vm is None and dg.n_gradient == 5
          and not dg.dry_volume and not dg.fast_surface,
          "the closure takes the generic operator's gradient path")
    res = run_les(sc, sc.q, sc.aux, expected_launches({}, 0))
    res.update(setup_s=setup_s,
               peak_memory_bytes=torch.cuda.max_memory_allocated())
    emit("les_path", closure="SmagorinskyLilly(0.21)", layout="grid", **res)
    del dc, sc, dg
    torch.cuda.empty_cache()
    err = les_small_reference(SmagorinskyLilly(0.21))
    emit("les_small_reference", closure="SmagorinskyLilly(0.21)",
         elements=27, poly=POLY, steps=LES_SMALL_STEPS, rel_err_per_var=err,
         tol=LES_SMALL_TOL)
    check(all(e <= t for e, t in zip(err, LES_SMALL_TOL)),
          ("LES small reference", err))
    emit("les_bubble_phase", card=nvidia_smi(),
         seconds=time.perf_counter() - t_phase)
    return dict(ms_per_step=res["ms_per_step"], setup_s=setup_s,
                peak_memory_bytes=res["peak_memory_bytes"])


def les_perturbed(q0, seed: int):
    """The bubble's initial state (at rest) times 1 + 1e-3 · N(0, 1), its
    momentum then ρ·u with u ~ N(0, 1) m/s, from ``seed``: every lane of
    the kernels' inputs away from 0."""
    q = perturbed(q0, seed)
    gen = torch.Generator(device=q.device).manual_seed(seed + 1)
    q[:, 1:4] = q[:, :1] * torch.randn(q[:, 1:4].shape, generator=gen,
                                       device=q.device)
    return q


def phase_les_inviscid(seed: int) -> dict:
    """The rising bubble without a closure at full size, built through
    the driver's entry as :func:`phase_les_bubble`: "auto" takes the
    var-major RHS on the walled, stacked brick (FlatOrientation,
    HydrostaticState(DryAdiabaticProfile), Gravity).  Its kernels (the
    volume kernel without F₂, the extraction at na = 1 without
    hyperdiffusion, the flux + lift) and the dry volume kernel of its
    generic operator against their plain versions on the path's own
    perturbed state (E = 15,625: the staged kernels' last tile holds one
    element), the RHS checks, then ``invoke`` under each surface pass and
    with ``ExplicitSolverType(state_layout="grid")``, each with exact
    launch counts, and the small box against float64.  Returns
    {"kernels": {entry: result}, "launches": {entry: launches},
    "ms_per_step": {run: ms}, "setup_s": s}."""
    t_phase = time.perf_counter()
    driver_init(show_updates="never")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    dc, sc = les_config(None)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    dg, rhs = sc.dg, sc.solver.vm
    check(rhs is not None and dg.dry_volume and dg.fast_surface
          and dg.n_gradient == 0, "auto takes the var-major RHS")
    q0, aux0 = sc.q, sc.aux
    q = les_perturbed(q0, seed)
    kernels = {}
    for name, (args, kw) in var_major_kernel_inputs(rhs, q, aux0).items():
        kernels[name + LES] = kernel_vs_plain(name, args, rhs, n=0, **kw)
    args, kw = dry_volume_args(dg, q, dg.balance_law.update_auxiliary_state(
        q, aux0, dg.grid))
    check(kw["subtract_ref"] is True and args[2] is not None,
          "the bubble's generic RHS hands the dry kernel p_ref")
    kernels[DRY + LES] = kernel_vs_plain(
        DRY, args, SimpleNamespace(grid=dg.grid, hd=None, nq=5), n=0, **kw)
    del args
    errs = vortex_rhs_errs(dict(model=dg.balance_law, grid=dg.grid, dg=dg,
                                aux0=aux0), q,
                           {"rusanov": RusanovNumericalFlux})
    emit("les_rhs", card=nvidia_smi(), rel_err_per_var=errs,
         tol=GENERIC_RHS_TOL)
    for key, err in errs.items():
        check(all(torch.isfinite(torch.tensor(err)))
              and max(err) <= GENERIC_RHS_TOL, ("LES RHS", key, err))
    del q

    launches, ms = {}, {}
    steps = LES_WARM + LES_STEPS
    for mode in SURFACE_KERNELS:
        per_step = {name: 5 for name in ("fused_volume_tendency_vm",)
                    + SURFACE_LAUNCHES[mode]}
        res = run_les(sc, q0, aux0, expected_launches(per_step, steps), mode)
        emit("les_path", closure=None, layout="vm", setup_s=setup_s, **res)
        ms[f"vm:{mode}"] = res["ms_per_step"]
        if mode == "pallas":
            launches.update({name + LES: res["launches"][name]
                             for name in per_step})
    _, sc_g = les_config(None, solver_type=ExplicitSolverType(
        state_layout="grid"), dc=dc)
    res = run_les(sc_g, q0, aux0, expected_launches({DRY: 5}, steps))
    emit("les_path", closure=None, layout="grid", **res)
    ms["grid"] = res["ms_per_step"]
    launches[DRY + LES] = res["launches"][DRY]
    del dc, sc, sc_g, dg, rhs, q0, aux0
    torch.cuda.empty_cache()
    err = les_small_reference(None)
    emit("les_small_reference", closure=None, elements=27, poly=POLY,
         steps=LES_SMALL_STEPS, rel_err_per_var=err, tol=LES_SMALL_TOL)
    check(all(e <= t for e, t in zip(err, LES_SMALL_TOL)),
          ("LES small reference (inviscid)", err))
    emit("les_inviscid_phase", card=nvidia_smi(),
         seconds=time.perf_counter() - t_phase, ms_per_step=ms)
    return dict(kernels=kernels, launches=launches, ms_per_step=ms,
                setup_s=setup_s)


# --- the forced LES cases -----------------------------------------------------

def forcing_path(name: str, warm: int, steps: int) -> dict:
    """Case ``name`` at its example's defaults, built only through the
    driver's entry (the experiment's ``AtmosLESConfiguration``,
    ``make_solver_configuration``), then ``invoke`` over warm + steps
    steps with its callbacks, every launch count set to 0 just before and
    read just after (all must stay 0: the gradient path runs no
    kernel), the last ``steps`` timed.  Checks the element count, the
    generic operator's gradient path, the state (finite) and the
    launches; reports ms per step, simulated s per wall s, set-up s, peak
    device memory, the mass change, max |w|.  Returns (result, solver
    configuration, initial state)."""
    case = FORCED_LES_CASES[name]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    dc = case.config(device="cuda")
    sc = make_solver_configuration(0.0, -1.0, dc,
                                   ode_solver_type=case.solver_type,
                                   Courant_number=case.courant)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    g, dg, model = dc.grid, sc.dg, dc.model
    key = name.split("_custom")[0]
    check(g.nelem == FORCING_ELEMENTS[key], (name, "elements", g.nelem))
    check(g.dtype == torch.float64 and g.Nq[0] == POLY + 1,
          (name, "float64 at p4"))
    check(sc.solver.vm is None and dg.n_gradient > 0 and not dg.dry_volume
          and not dg.fast_surface,
          (name, "the closure takes the generic operator's gradient path"))
    q0, aux0 = sc.q, sc.aux
    mass = lambda x: torch.sum(g.M * x[:, 0]).item()
    run = invoke_timed(name, sc, case.callbacks(dc), warm, steps)
    q = sc.q
    sp = model.prog_spec
    rho = sp.get(q, "rho")
    res = dict(card=nvidia_smi(), case=name, elements=g.nelem, poly=POLY,
               gridpoints=g.nelem * g.Np, dtype="float64", dt_s=sc.dt,
               courant=case.courant, setup_s=setup_s,
               peak_memory_bytes=torch.cuda.max_memory_allocated(),
               mass_change_rel=(mass(q) - mass(q0)) / mass(q0),
               rho_change_max_rel=((rho - q0[:, 0]).abs()
                                   / q0[:, 0]).max().item(),
               max_abs_w=(sp.get(q, "rhou")[:, 2] / rho).abs().max().item(),
               **run)
    return res, sc, q0, aux0


def invoke_timed(name: str, sc, callbacks, warm: int, steps: int) -> dict:
    """``invoke`` of solver configuration ``sc`` over warm + steps steps
    with ``callbacks``, every launch count set to 0 just before and read
    just after (all must stay 0: the gradient path runs no kernel), the
    last ``steps`` timed; checks the steps timed, the state (finite),
    invoke's norm ratio and the launches.  Returns the run's fields."""
    sc.timeend = (warm + steps) * sc.dt
    timer = StepTimer(warm)
    reset_launch_counts()
    ratio = invoke(sc, user_callbacks=(*callbacks, timer))
    counts = launch_counts()
    wall = timer.end - timer.start
    res = dict(warm_steps=warm, steps=timer.steps,
               ms_per_step=1e3 * wall / timer.steps,
               sim_s_per_wall_s=sc.dt * timer.steps / wall,
               norm_ratio=ratio, finite=bool(torch.isfinite(sc.q).all()),
               launches=counts)
    check(timer.steps == steps, (name, "steps timed", timer.steps))
    check(res["finite"], (name, "state not finite"))
    check(math.isfinite(ratio) and abs(ratio - 1.0) <= LES_RATIO_TOL,
          (name, "invoke's norm ratio", ratio))
    check_launches(counts, expected_launches({}, 0))
    return res


def bomex_tmar_check(sc) -> dict:
    """TMAR where it acts: BOMEX's card state with ρq_tot set to −½ its
    value at TMAR_DIP_SHARE of the nodes (drawn from TMAR_SEED; no
    element's integral turns negative), through the case's
    callback on the card: q_tot ≥ 0 after it, ∫ρq_tot kept within
    TMAR_MASS_TOL relative, the other lanes untouched, and the result
    against :func:`tmar` of the same input in float64 on the CPU within
    TMAR_TOL of its largest value."""
    dc, sp = sc.driver_config, sc.dg.balance_law.prog_spec
    lane = sp.index("moisture.rhoq_tot").start
    gen = torch.Generator().manual_seed(TMAR_SEED)
    dip = torch.rand(sc.q[:, lane].shape, generator=gen) < TMAR_DIP_SHARE
    q = sc.q.clone()
    q[:, lane] = torch.where(dip.to(q.device), -0.5 * q[:, lane],
                             q[:, lane])
    state = SimpleNamespace(q=q.clone())
    FORCED_LES_CASES["bomex"].callbacks(dc)[0].fn(state)
    g = dc.grid
    ref = tmar(grid_from_numpy(grid_to_numpy(g), device="cpu",
                               dtype=torch.float64), q.cpu(), fields=[lane])
    got = state.q
    qt = got[:, lane] / got[:, 0]
    integral = lambda x: torch.sum(g.M * x[:, lane]).item()
    others = [i for i in range(q.shape[1]) if i != lane]
    res = dict(tmar_negative_nodes=int((q[:, lane] < 0).sum().item()),
               tmar_q_tot_min=qt.min().item(),
               tmar_mass_change_rel=abs(integral(got) - integral(q))
               / integral(q),
               tmar_rel_err=((got.cpu() - ref).abs().max()
                             / ref[:, lane].abs().max()).item())
    check(res["tmar_negative_nodes"] > 0, ("TMAR: no negative node",))
    check(res["tmar_q_tot_min"] >= 0.0, ("TMAR q_tot", res["tmar_q_tot_min"]))
    check(res["tmar_mass_change_rel"] <= TMAR_MASS_TOL,
          ("TMAR ∫ρq_tot", res["tmar_mass_change_rel"]))
    check(torch.equal(got[:, others], q[:, others]), "TMAR: other lanes")
    check(res["tmar_rel_err"] <= TMAR_TOL, ("TMAR card against CPU",
                                            res["tmar_rel_err"]))
    return res


def radiation_paths_check(sc) -> float:
    """The attenuation paths ``radiation.int_att`` / ``int_att_rev`` that
    the card's aux update writes, against the same stack integrals of the
    same integrand (κ ρ q_liq of the card's state and moisture lanes) in
    float64 on the CPU on the same geometry: the larger relative error."""
    model, grid = sc.dg.balance_law, sc.dg.grid
    aux = model.update_auxiliary_state(sc.q, sc.aux, grid)
    f = model.physics.radiation.integrand(model, sc.q, aux).cpu()[:, None]
    ops = ColumnOps(grid_from_numpy(grid_to_numpy(grid), device="cpu",
                                    dtype=torch.float64))
    err = 0.0
    for lane, ref in (("radiation.int_att", ops.indefinite_integral(f)),
                      ("radiation.int_att_rev",
                       ops.reverse_indefinite_integral(f))):
        got = model.aux_spec.get(aux, lane).cpu()
        err = max(err, ((got - ref[:, 0]).abs().max()
                        / ref.abs().max()).item())
    return err


def small_reference(name: str, dc, courant: float, solver_type=None,
                    callbacks=lambda dc: ()) -> list:
    """FORCING_SMALL_STEPS steps of ``invoke`` of the 2 × 2 × 2-element
    driver configuration ``dc`` of case ``name`` in float64 on the card
    against the port's float64 run on the CPU from the same geometry,
    state and dt: the per-variable error (:func:`vortex_err`)."""
    check(dc.grid.nelem == 8, (name, "small box", dc.grid.nelem))
    sc = make_solver_configuration(0.0, -1.0, dc, ode_solver_type=solver_type,
                                   Courant_number=courant)
    dc64 = replace(dc, grid=grid_from_numpy(grid_to_numpy(dc.grid),
                                            device="cpu",
                                            dtype=torch.float64))
    sc64 = make_solver_configuration(0.0, -1.0, dc64, ode_dt=sc.dt,
                                     ode_solver_type=solver_type)
    q0, aux0, final = sc.q, sc.aux, {}
    for run, d, s in (("card", dc, sc), ("cpu", dc64, sc64)):
        s.q, s.aux = q0.to(d.grid.device), aux0.to(d.grid.device)
        s.timeend = FORCING_SMALL_STEPS * sc.dt
        invoke(s, user_callbacks=callbacks(d))
        final[run] = s.q.cpu()
    return vortex_err(final["card"], final["cpu"])


def forcing_small_reference(name: str) -> list:
    """:func:`small_reference` of forced LES case ``name`` on its box."""
    case = FORCED_LES_CASES[name]
    return small_reference(name, case.config(*FORCING_SMALL_BOXES[name],
                                             device="cuda"),
                           case.courant, case.solver_type, case.callbacks)


def phase_les_forcing() -> dict:
    """The forced LES cases, each built only through the driver's entry
    (``AtmosLESConfiguration`` → ``make_solver_configuration`` →
    ``invoke``), float64, on the generic operator's gradient path, which
    runs no kernel (every launch count stays 0): BOMEX at its published
    width (4,864 elements, p4, prescribed surface fluxes, TMAR on ρq_tot
    after every step; q_tot ≥ 0 after it; TMAR where it acts,
    :func:`bomex_tmar_check`; its mass change is reported, its moisture
    sink being a mass source), FORCING_WARM + FORCING_STEPS steps;
    DYCOMS-II RF01 (684 elements: the stratocumulus deck makes q_liq > 0
    from the start; its radiation paths on the card against float64 on
    the CPU within RADIATION_TOL), the convective boundary layer (4,500
    elements), the stable one with both surface options and the
    Deardorff canopy, each 1 + 2 steps, the dry boundary layers' mass
    drift within FORCING_MASS_TOL where ρ moved; then BOMEX, DYCOMS and
    the canopy on 2 × 2 × 2 elements, card against CPU within
    FORCING_SMALL_TOL."""
    t_phase = time.perf_counter()
    driver_init(show_updates="never")
    out = {}
    for name in ("bomex", "dycoms", "convective_bl", "stable_bl",
                 "stable_bl_custom_sbl", "canopy"):
        warm, steps = ((FORCING_WARM, FORCING_STEPS) if name == "bomex"
                       else (FORCING_CASE_WARM, FORCING_CASE_STEPS))
        res, sc, q0, aux0 = forcing_path(name, warm, steps)
        model, sp = sc.dg.balance_law, sc.dg.balance_law.prog_spec
        if name == "bomex":
            qt = sp.get(sc.q, "moisture.rhoq_tot") / sp.get(sc.q, "rho")
            res.update(q_tot_min=qt.min().item(), q_tot_max=qt.max().item())
            check(res["q_tot_min"] >= 0.0, ("BOMEX q_tot after TMAR",
                                            res["q_tot_min"]))
            res.update(bomex_tmar_check(sc))
        if name == "dycoms":
            q_liq0 = model.aux_spec.get(aux0, "moisture.q_liq").max().item()
            q_liq = model.aux_spec.get(model.update_auxiliary_state(
                sc.q, sc.aux, sc.dg.grid), "moisture.q_liq").max().item()
            res.update(max_q_liq_initial=q_liq0, max_q_liq=q_liq,
                       radiation_rel_err=radiation_paths_check(sc),
                       radiation_tol=RADIATION_TOL)
            check(q_liq0 > 0.0 and q_liq > 0.0, ("DYCOMS q_liq", q_liq0,
                                                  q_liq))
            check(res["radiation_rel_err"] <= RADIATION_TOL,
                  ("DYCOMS radiation paths", res["radiation_rel_err"]))
        if name.startswith(("convective_bl", "stable_bl")):
            res["mass_tol"] = FORCING_MASS_TOL
            check(res["rho_change_max_rel"] > 0.0,
                  (name, "ρ did not move: the mass gate checks nothing"))
            check(abs(res["mass_change_rel"]) <= FORCING_MASS_TOL,
                  (name, "mass drift", res["mass_change_rel"]))
        emit("les_forcing_path", **res)
        out[name] = {k: res[k] for k in ("ms_per_step", "sim_s_per_wall_s",
                                         "setup_s", "peak_memory_bytes")}
        del sc, q0, aux0
    small = {}
    for name in FORCING_SMALL_BOXES:
        err = forcing_small_reference(name)
        small[name] = err
        emit("les_forcing_small_reference", case=name, elements=8, poly=POLY,
             steps=FORCING_SMALL_STEPS, rel_err_per_var=err,
             tol=FORCING_SMALL_TOL)
        check(max(err) <= FORCING_SMALL_TOL, (name, "small reference", err))
    torch.cuda.empty_cache()
    emit("les_forcing_phase", card=nvidia_smi(),
         seconds=time.perf_counter() - t_phase, **out)
    return out


# --- the ocean box GCM ---------------------------------------------------------

def ocean_volume(dg, q) -> float:
    """∫η dV in float64."""
    eta = dg.balance_law.prog_spec.get(q, "eta")
    return torch.sum(dg.grid.M * eta).item()


def ocean_path(problem: str) -> dict:
    """``ocean_box_config(problem)`` at the example's defaults on the
    card, driven by ``solve``: OCEAN_WARM steps, then OCEAN_STEPS timed on
    the host clock ending in a synchronize, every launch count set to 0
    just before and read just after (all 0: the path runs no kernel);
    checks the state (shape, finite), the drift of ∫η dV and the
    launches."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    dg, q0, aux0, solver = ocean_box_config(problem, OCEAN_NELEM,
                                            device="cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    g, model = dg.grid, dg.balance_law
    check(g.nelem == int(np.prod(OCEAN_NELEM)) and g.dtype == torch.float64,
          ("ocean grid", g.nelem, g.dtype))
    check(dg.n_gradient == 3 and not dg.dry_volume and not dg.fast_surface,
          "the ocean takes the generic operator's gradient path")
    dt = solver.dt
    vol0 = ocean_volume(dg, q0)
    reset_launch_counts()
    st = solve(q0, aux0, solver, OCEAN_WARM * dt)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    st = solve(st.q, st.aux, solver, (OCEAN_WARM + OCEAN_STEPS) * dt,
               t0=OCEAN_WARM * dt)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    counts = launch_counts()
    q = st.q
    u, eta = model.prog(q, "u"), model.prog(q, "eta")
    eta_scale = eta.abs().max().item()
    drift = abs(ocean_volume(dg, q) - vol0)
    bound = OCEAN_VOLUME_TOL * abs(torch.sum(g.M).item() * eta_scale) + 1e-12
    finite = bool(torch.isfinite(q).all())
    res = dict(card=nvidia_smi(), problem=problem, elements=g.nelem,
               poly=g.Nq[0] - 1, gridpoints=g.nelem * g.Np, dtype="float64",
               dt_s=dt, warm_steps=OCEAN_WARM, steps=st.step,
               setup_s=setup_s, ms_per_step=1e3 * wall / st.step,
               sim_s_per_wall_s=dt * st.step / wall,
               gridpoints_per_s=g.nelem * g.Np * st.step / wall,
               peak_memory_bytes=torch.cuda.max_memory_allocated(),
               max_abs_u=u.abs().max().item(),
               eta_range=[eta.min().item(), eta.max().item()],
               eta_volume_drift=drift, eta_volume_bound=bound, finite=finite,
               launches=counts)
    check(st.step == OCEAN_STEPS, ("ocean steps timed", st.step))
    check(list(q.shape) == [g.nelem, 4, g.Np], ("ocean state shape",
                                                 list(q.shape)))
    check(finite, ("ocean state not finite", problem))
    check(drift <= bound, ("ocean ∫η dV drift", problem, drift, bound))
    check_launches(counts, expected_launches({}, 0))
    return res


def field_stats(model, q, aux) -> dict:
    """{(label, lane): [min, max, mean, std (ddof 1)]} of every
    prognostic and aux lane, in float64 on the host, as the golden tables
    hold them."""
    out = {}
    for label, spec, x in (("state", model.prog_spec, q),
                           ("aux", model.aux_spec, aux)):
        a = x.detach().double().cpu().numpy()
        for i, name in enumerate(spec.flattened_names()):
            v = a[:, i]
            out[(label, name)] = [float(v.min()), float(v.max()),
                                  float(v.mean()), float(v.std(ddof=1))]
    return out


def check_digits(fields, ref, parr) -> tuple:
    """The check of tests/test_ocean_refvals.py ``check_parr``: each
    statistic within 5·10^−d relative of the table (|g| <= 10^−d where the
    table holds 0), d from ``parr`` (0: skipped).  Returns (the digits
    each statistic reached, the failures)."""
    reached, failures = {}, []
    for key, row in ref.items():
        for stat, g, r, d in zip(("min", "max", "mean", "std"), fields[key],
                                 row, parr[key]):
            if d == 0:
                continue
            name = f"{key[0]}.{key[1]}|{stat}"
            if r == 0.0:
                reached[name] = (16.0 if g == 0.0
                                 else min(-math.log10(abs(g)), 16.0))
                ok = abs(g) <= 10.0 ** (-d)
            else:
                rel = abs(g - r) / abs(r)
                reached[name] = (16.0 if rel == 0.0
                                 else min(-math.log10(rel / 5.0), 16.0))
                ok = rel <= 5.0 * 10.0 ** (-d)
            if not ok:
                failures.append((name, g, r, d))
    return reached, failures


def ocean_gate(name: str) -> dict:
    """The Julia reference's table ``name`` (tests/refvals/<name>.py, read
    by path) against the port in float64 on the card at the JAX test's
    configuration (5 × 5 × 5 p4 over 1e6 × 1e6 × H, c_h = √(gH), LSRK144
    with the filters, through ``solve``) and digits: windstress with the
    u means at 9 (tests/test_ocean_golden_extra.py:113-116), the gyre at
    5 with θ's minimum skipped (:132-140)."""
    problem, H, dt, steps, table = OCEAN_GATES[name]
    spec = importlib.util.spec_from_file_location(
        "rv_" + name, REFVALS / f"{name}.py")
    rv = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(rv)
    if name == "windstress":
        parr = dict(rv.parr)
        parr[("state", "u[0]")] = [12, 12, 9, 12]
        parr[("state", "u[1]")] = [12, 12, 9, 12]
    else:
        parr = {k: [min(d, 5) for d in v] for k, v in rv.parr.items()}
        parr[("state", "theta")][0] = 0
    dg, q0, aux0, solver = ocean_box_config(
        problem, (5, 5, 5), 4, (1e6, 1e6, H), dt,
        floor_free_slip=(problem == "homogeneous"), device="cuda")
    reset_launch_counts()
    t0 = time.perf_counter()
    st = solve(q0, aux0, solver, steps * dt)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    check(st.step == steps and bool(torch.isfinite(st.q).all()),
          (name, "steps", st.step))
    reached, failures = check_digits(
        field_stats(dg.balance_law, st.q, st.aux), getattr(rv, table), parr)
    res = dict(card=nvidia_smi(), table=f"tests/refvals/{name}.py:{table}",
               problem=problem, elements=dg.grid.nelem, steps=st.step,
               dt_s=dt, seconds=wall, min_digits_reached=min(reached.values()),
               digits_reached=reached, failures=failures, launches=counts)
    emit("ocean_golden_gate", **res)
    check(not failures, (name, "golden table", failures))
    check_launches(counts, expected_launches({}, 0))
    return res


def ocean_super_model() -> dict:
    """HydrostaticBoussinesqSuperModel's geostrophic adjustment on the card
    in float64 at tests/test_ocean.py:155's configuration (Ne = (20, 1, 1),
    p4, y periodic, LS3NRK33Heuns at 100 s) with its assertions: 36
    steps to 1 h, finite, ∫η dV kept, the bump decays and its
    disturbance radiates past 4 widths."""
    Lx, f, grav = 1e6, 1e-4, 9.81
    U, Lg = 0.1, Lx / 40
    a, x0 = f * U * Lg / grav, Lx / 4
    gauss = lambda x: torch.exp(-x ** 2 / (2 * Lg ** 2))
    domain = super_model.RectangularDomain(
        Ne=(20, 1, 1), Np=4, x=(0, Lx), y=(0, Lx), z=(-400.0, 0.0),
        periodicity=(False, True, False))
    t0 = time.perf_counter()
    model = super_model.HydrostaticBoussinesqSuperModel(
        domain, time_step=100.0,
        initial_conditions=super_model.InitialConditions(
            v=lambda x, y, z: -U * (x - x0) / Lg * gauss(x - x0),
            eta=lambda x, y, z: 2 * a * gauss(x - x0)),
        coriolis=dict(f_0=f, beta=0.0),
        turbulence_closure=dict(nu_h=1e3, nu_z=1e-2, kappa_h=1e3,
                                kappa_z=1e-4),
        rusanov_wave_speeds=dict(c_h=math.sqrt(grav * 400.0), c_z=1e-3),
        device="cuda")
    M = model.grid.M
    eta0 = model.fields["eta"].clone()
    vol0 = torch.sum(M * eta0).item()
    reset_launch_counts()
    model.solve(until=3600.0)
    torch.cuda.synchronize()
    counts = launch_counts()
    eta1 = model.fields["eta"]
    vol1 = torch.sum(M * eta1).item()
    x = model.grid.coords[..., 0]
    far = (x - x0).abs() > 4 * Lg
    cart = model.cartesian_field("eta").assemble()
    res = dict(card=nvidia_smi(), steps=model.step_count,
               seconds=time.perf_counter() - t0,
               volume_drift=abs(vol1 - vol0),
               volume_bound=OCEAN_VOLUME_TOL * abs(torch.sum(M).item() * a)
               + 1e-12,
               eta_max=[eta0.max().item(), eta1.max().item()],
               far_eta_max=[eta0[far].abs().max().item(),
                            eta1[far].abs().max().item()],
               cartesian_shape=list(cart.shape), launches=counts)
    emit("ocean_super_model", **res)
    check(model.step_count == 36, ("super model steps", model.step_count))
    check(bool(torch.isfinite(eta1).all()), "super model η not finite")
    check(res["volume_drift"] <= res["volume_bound"],
          ("super model volume", res["volume_drift"], res["volume_bound"]))
    check(res["eta_max"][1] < 0.95 * res["eta_max"][0],
          ("the bump does not decay", res["eta_max"]))
    check(res["far_eta_max"][1] > 10 * res["far_eta_max"][0],
          ("the disturbance does not radiate", res["far_eta_max"]))
    check(list(cart.shape) == [81, 5, 5], ("cartesian field",
                                            list(cart.shape)))
    check_launches(counts, expected_launches({}, 0))
    return res


def phase_ocean() -> dict:
    """The ocean box GCM at full width for both problems, the golden
    gates and the super model (module docstring).  Returns {problem:
    {ms_per_step, setup_s, peak_memory_bytes}}."""
    t_phase = time.perf_counter()
    out = {}
    for problem in ("homogeneous", "gyre"):
        res = ocean_path(problem)
        emit("ocean_path", **res)
        out[problem] = {k: res[k] for k in ("ms_per_step", "setup_s",
                                            "peak_memory_bytes")}
    torch.cuda.empty_cache()
    for name in OCEAN_GATES:
        ocean_gate(name)
    ocean_super_model()
    emit("ocean_phase", card=nvidia_smi(),
         seconds=time.perf_counter() - t_phase)
    return out


# --- the split-explicit ocean ---------------------------------------------------

def split_explicit_path() -> dict:
    """experiments/ocean_split_explicit.py at its defaults on the card
    (20 × 20 × 20 at p4, the 20 × 20 barotropic brick, float64, LSRK54
    slow at 5400 s and fast at 240 s, 5 IVDC solves a slow step):
    SPLIT_WARM slow steps, then SPLIT_STEPS timed, each part on the host
    clock after a synchronize, every launch count set to 0 just before
    and read just after (all 0: the path runs no kernel); checks the
    state pair (shape, finite), θ within SPLIT_THETA_RANGE, every GMRES
    residual, the drift of ∫η dV and the launches."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg = ocean_split_explicit.make(SPLIT_NX, SPLIT_NZ, device="cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    g3, g2 = cfg.dg3.grid, cfg.dg2.grid
    check((g3.nelem, g2.nelem, g3.dim, g2.dim)
          == (SPLIT_NX ** 2 * SPLIT_NZ, SPLIT_NX ** 2, 3, 2)
          and g3.dtype == g2.dtype == torch.float64,
          ("split-explicit grids", g3.nelem, g2.nelem, g3.dtype))
    check(cfg.dg3.n_gradient == 5 and cfg.dg2.n_gradient == 2
          and not (cfg.dg3.dry_volume or cfg.dg3.fast_surface
                   or cfg.dg2.dry_volume or cfg.dg2.fast_surface),
          "the split-explicit ocean takes the generic gradient path")
    fast_steps = cfg.solver.fast_steps()
    check(sum(fast_steps) == 24, ("fast steps a slow step", fast_steps))
    dt = cfg.solver.dt
    vol0 = ocean_volume(cfg.dg3, cfg.q[0])
    q, aux, t = cfg.q, cfg.aux, 0.0
    reset_launch_counts()
    residuals, split_s, ivdc_s = [], [], []
    for i in range(SPLIT_WARM + SPLIT_STEPS):
        q, aux, res, ts, ti = ocean_split_explicit.step(
            cfg, q, aux, t, sync=torch.cuda.synchronize)
        t += dt
        residuals.append([r.item() for r in res])
        if i >= SPLIT_WARM:
            split_s.append(ts)
            ivdc_s.append(ti)
    counts = launch_counts()
    wall = sum(split_s) + sum(ivdc_s)
    eta = cfg.m3.prog(q[0], "eta")
    eta_scale = eta.abs().max().item()
    drift = abs(ocean_volume(cfg.dg3, q[0]) - vol0)
    bound = OCEAN_VOLUME_TOL * abs(torch.sum(g3.M).item() * eta_scale) \
        + 1e-12
    summary = ocean_split_explicit.summary(cfg, q)
    res = dict(card=nvidia_smi(), elements_3d=g3.nelem,
               elements_2d=g2.nelem, poly=g3.Nq[0] - 1,
               gridpoints_3d=g3.nelem * g3.Np, dtype="float64", dt_s=dt,
               fast_dt_s=cfg.solver.fast_dt, fast_steps=fast_steps,
               ivdc_solves_per_step=cfg.m3.num_impl_steps,
               warm_steps=SPLIT_WARM, steps=SPLIT_STEPS, setup_s=setup_s,
               ms_per_step=1e3 * wall / SPLIT_STEPS,
               split_explicit_ms_per_step=1e3 * sum(split_s) / SPLIT_STEPS,
               ivdc_ms_per_step=1e3 * sum(ivdc_s) / SPLIT_STEPS,
               step_ms=[1e3 * (a + b) for a, b in zip(split_s, ivdc_s)],
               sim_s_per_wall_s=dt * SPLIT_STEPS / wall,
               peak_memory_bytes=torch.cuda.max_memory_allocated(),
               gmres_residuals=residuals,
               eta_volume=[vol0, ocean_volume(cfg.dg3, q[0])],
               eta_volume_drift=drift, eta_volume_bound=bound,
               launches=counts, **summary)
    emit("split_explicit_path", **res)
    check(list(q[0].shape) == [g3.nelem, 4, g3.Np]
          and list(q[1].shape) == [g2.nelem, 3, g2.Np],
          ("split-explicit state shapes", list(q[0].shape),
           list(q[1].shape)))
    check(summary["finite"], "split-explicit state not finite")
    # each ‖b − Lx‖ / ‖b‖ against its own right-hand side b = θⁿ/Δt
    check(all(math.isfinite(r) and r <= SPLIT_GMRES_TOL
              for row in residuals for r in row),
          ("GMRES residuals", residuals))
    lo, hi = SPLIT_THETA_RANGE
    check(lo <= summary["theta_range"][0] and summary["theta_range"][1] <= hi,
          ("split-explicit θ range", summary["theta_range"]))
    check(drift <= bound, ("split-explicit ∫η dV drift", drift, bound))
    check_launches(counts, expected_launches({}, 0))
    return res


def spindown_stats(pairs) -> dict:
    """{(label, field): [min, max, mean, std (ddof 1)]} of the named
    lanes, in float64 on the host."""
    out = {}
    for key, x in pairs:
        a = x.detach().double().cpu().numpy()
        out[key] = [float(a.min()), float(a.max()), float(a.mean()),
                    float(a.std(ddof=1))]
    return out


def load_refvals(name):
    spec = importlib.util.spec_from_file_location("rv_" + name,
                                                  REFVALS / f"{name}.py")
    rv = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(rv)
    return rv


def spindown_gate(coupled: bool) -> dict:
    """The Julia reference's hydrostatic spindown table (tests/refvals/
    hydrostatic_spindown.py, "coupled" or "uncoupled") against the port in
    float64 on the card at tests/test_split_explicit_refvals.py:55-183's
    configuration: SimpleBox(Fixed) with αᵀ = κ = 0 and no advection,
    CoupledHBModel with BarotropicModel (or HydrostaticBoussinesqModel
    with ShallowWaterModel) on the periodic 5 × 5 × 8 box at p4 and the
    5 × 5 brick, ``SplitExplicitSolver`` with LSRK54 slow and fast at
    300 s, 288 steps; the analytic errors below SPINDOWN_ERR and the
    table at the test's digits, the coupled transfer entries at its
    reduced ones."""
    Lx = Ly = 1e6
    H = 400.0
    problem = SimpleBox(Lx, Ly, H, rotation=Fixed())
    kw = dict(c_h=1.0, alpha_T=0.0, kappa_h=0.0, kappa_z=0.0,
              momentum_advection=None, tracer_advection=None)
    m3 = CoupledHBModel(problem, **kw) if coupled else \
        HydrostaticBoussinesqModel(problem, **kw)
    m2 = (BarotropicModel if coupled else ShallowWaterModel)(
        problem, turbulence=ConstantViscosity(m3.nu_h), advection=None,
        c=1.0)
    ranges = [np.linspace(0.0, Lx, 6), np.linspace(0.0, Ly, 6)]
    g2 = make_grid(brick_topology(ranges, periodicity=(True, True)), 4,
                   dtype=torch.float64, device="cuda")
    g3 = make_grid(stacked_brick_topology(
        ranges + [np.linspace(-H, 0.0, 9)], periodicity=(True, True, False),
        boundary=np.array([[0, 0], [0, 0], [1, 2]])), 4,
        dtype=torch.float64, device="cuda")
    dg3 = DGModel(m3, g3)
    dg2 = DGModel(m2, g2,
                  numerical_flux_first_order=CentralNumericalFluxFirstOrder())
    q2, aux2 = init_ode_state(dg2, init_state=problem.sw_init_state)
    q3, aux3 = init_ode_state(dg3)
    dt = SPINDOWN_DT
    se = SplitExplicitSolver(LSRK54CarpenterKennedy(dg3, dt),
                             LSRK54CarpenterKennedy(dg2, dt), dg3, dg2,
                             dt=dt, fast_dt=dt, coupled=coupled)
    q, aux, t = (q3, q2), (aux3, aux2), 0.0
    reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(SPINDOWN_STEPS):
        q, aux = se.step(q, aux, t)
        t += dt
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    (q3, q2), (aux3, aux2) = q, aux
    c3, c2 = g3.coords.transpose(1, 2), g2.coords.transpose(1, 2)
    qe3 = problem.init_state(m3, c3, aux3, t)
    qe2 = problem.sw_init_state(m2, c2, aux2, t)
    err3 = ((q3 - qe3).norm() / qe3.norm()).item()
    err2 = ((q2 - qe2).norm() / qe2.norm()).item()
    pairs = []
    for i in (0, 1):
        pairs += [(("3D state", f"u[{i + 1}]"), m3.prog(q3, "u")[:, i]),
                  (("3D aux", f"uᵈ[{i + 1}]"), m3.aux_get(aux3, "ud")[:, i]),
                  (("3D aux", f"ΔGᵘ[{i + 1}]"),
                   m3.aux_get(aux3, "dGu")[:, i]),
                  (("2D state", f"U[{i + 1}]"), m2.prog(q2, "U")[:, i]),
                  (("2D aux", f"Gᵁ[{i + 1}]"), m2.aux_get(aux2, "GU")[:, i]),
                  (("2D aux", f"Δu[{i + 1}]"), m2.aux_get(aux2, "du")[:, i])]
    pairs += [(("3D state", "η"), m3.prog(q3, "eta")),
              (("3D state", "θ"), m3.prog(q3, "theta")),
              (("2D state", "η"), m2.prog(q2, "eta")),
              (("2D aux", "y"), m2.aux_get(aux2, "y"))]
    pairs += [(("3D aux", name), m3.aux_get(aux3, name))
              for name in ("y", "w", "pkin", "wz0")]
    rv = load_refvals("hydrostatic_spindown")
    parr = dict(rv.parr)
    if coupled:
        # tests/test_split_explicit_refvals.py:170-172
        parr[("3D aux", "ΔGᵘ[1]")] = [10.0, 10.0, 0.0, 11.0]
        parr[("2D aux", "Gᵁ[1]")] = [10.0, 10.0, 0.0, 11.0]
        parr[("2D aux", "Δu[1]")] = [8.0, 8.0, 0.0, 8.0]
    table = "coupled" if coupled else "uncoupled"
    reached, failures = check_digits(spindown_stats(pairs),
                                     getattr(rv, table), parr)
    res = dict(card=nvidia_smi(),
               table=f"tests/refvals/hydrostatic_spindown.py:{table}",
               elements_3d=g3.nelem, elements_2d=g2.nelem,
               steps=SPINDOWN_STEPS, dt_s=dt, seconds=wall,
               ms_per_step=1e3 * wall / SPINDOWN_STEPS,
               analytic_err_3d=err3, analytic_err_2d=err2,
               analytic_bound=SPINDOWN_ERR,
               min_digits_reached=min(reached.values()),
               digits_reached=reached, failures=failures, launches=counts)
    emit("split_explicit_golden_gate", **res)
    check(bool(torch.isfinite(q3).all()) and bool(torch.isfinite(q2).all()),
          (table, "spindown not finite"))
    check(err3 < SPINDOWN_ERR and err2 < SPINDOWN_ERR,
          (table, "analytic error", err3, err2))
    check(not failures, (table, "golden table", failures))
    check_launches(counts, expected_launches({}, 0))
    return res


def spindown_2d_gate() -> dict:
    """The Julia reference's 2-D spindown table (tests/refvals/
    spindown_2d.py "explicit") against the port in float64 on the card at
    tests/test_ocean_golden_extra.py:147-171's configuration:
    ShallowWaterModel(ConstantViscosity(5e3), advection None, c = 1, f = 0)
    on the periodic 5 × 5 brick at p4, central flux, LSRK54 at 300 s, 288
    steps from the analytic barotropic state; the analytic error below
    SPINDOWN_ERR and the table at the test's digits."""
    Lx = Ly = 1e6
    problem = SimpleBox(Lx, Ly, 400.0, rotation=Fixed())
    model = ShallowWaterModel(problem, turbulence=ConstantViscosity(5e3),
                              advection=None, c=1.0, f_o=0.0, beta=0.0)
    r = [np.linspace(0.0, Lx, 6), np.linspace(0.0, Ly, 6)]
    g = make_grid(brick_topology(r, periodicity=(True, True)), 4,
                  dtype=torch.float64, device="cuda")
    dg = DGModel(model, g,
                 numerical_flux_first_order=CentralNumericalFluxFirstOrder())
    q0, aux0 = init_ode_state(dg, init_state=problem.sw_init_state)
    solver = LSRK54CarpenterKennedy(dg, SPINDOWN_DT, pre_stage=dg.pre_stage)
    reset_launch_counts()
    t0 = time.perf_counter()
    st = solve(q0, aux0, solver, SPINDOWN_STEPS * SPINDOWN_DT)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    qe = problem.sw_init_state(model, g.coords.transpose(1, 2), st.aux,
                               SPINDOWN_STEPS * SPINDOWN_DT)
    err = ((st.q - qe).norm() / qe.norm()).item()
    rv = load_refvals("spindown_2d")
    reached, failures = check_digits(field_stats(model, st.q, st.aux),
                                     rv.explicit, rv.parr)
    res = dict(card=nvidia_smi(), table="tests/refvals/spindown_2d.py:"
               "explicit", elements=g.nelem, steps=st.step,
               dt_s=SPINDOWN_DT, seconds=wall, analytic_err=err,
               analytic_bound=SPINDOWN_ERR,
               min_digits_reached=min(reached.values()),
               digits_reached=reached, failures=failures, launches=counts)
    emit("split_explicit_golden_gate", **res)
    check(st.step == SPINDOWN_STEPS and bool(torch.isfinite(st.q).all()),
          ("spindown_2d steps", st.step))
    check(err < SPINDOWN_ERR, ("spindown_2d analytic error", err))
    check(not failures, ("spindown_2d golden table", failures))
    check_launches(counts, expected_launches({}, 0))
    return res


def phase_split_explicit() -> dict:
    """The split-explicit ocean at full width, then the Julia reference's
    spindown tables (module docstring).  Returns {ms_per_step,
    split_explicit_ms_per_step, ivdc_ms_per_step, setup_s,
    peak_memory_bytes, sim_s_per_wall_s}."""
    t_phase = time.perf_counter()
    res = split_explicit_path()
    torch.cuda.empty_cache()
    spindown_gate(coupled=True)
    spindown_gate(coupled=False)
    spindown_2d_gate()
    emit("split_explicit_phase", card=nvidia_smi(),
         seconds=time.perf_counter() - t_phase)
    return {k: res[k] for k in ("ms_per_step", "split_explicit_ms_per_step",
                                "ivdc_ms_per_step", "setup_s",
                                "peak_memory_bytes", "sim_s_per_wall_s")}


# --- the split01 variants -------------------------------------------------

def split01_path(variant: str) -> dict:
    """``ocean_split_explicit.make_julia(variant)`` on the card at the Julia
    width: SPLIT01_WARM slow steps, then SPLIT01_STEPS timed, the
    split-explicit step and the IVDC solves apart (each on the host clock
    after a synchronize), every launch count set to 0 just before and read
    just after (all 0); the checks of :func:`split_explicit_path`."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg = ocean_split_explicit.make_julia(variant, SPLIT_NX, SPLIT_NZ,
                                          device="cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    g3, g2 = cfg.dg3.grid, cfg.dg2.grid
    check((g3.nelem, g2.nelem) == (SPLIT_NX ** 2 * SPLIT_NZ, SPLIT_NX ** 2)
          and g3.dtype == g2.dtype == torch.float64
          and cfg.solver.variant == variant,
          ("split01 grids", variant, g3.nelem, g2.nelem))
    windows = cfg.solver.windows()
    dt = cfg.solver.dt
    vol0 = ocean_volume(cfg.dg3, cfg.q[0])
    q, aux, t = cfg.q, cfg.aux, 0.0
    reset_launch_counts()
    residuals, split_s, ivdc_s = [], [], []
    for i in range(SPLIT01_WARM + SPLIT01_STEPS):
        q, aux, res, ts, ti = ocean_split_explicit.step(
            cfg, q, aux, t, sync=torch.cuda.synchronize)
        t += dt
        residuals.append([r.item() for r in res])
        if i >= SPLIT01_WARM:
            split_s.append(ts)
            ivdc_s.append(ti)
    counts = launch_counts()
    wall = sum(split_s) + sum(ivdc_s)
    eta_scale = cfg.m3.prog(q[0], "eta").abs().max().item()
    drift = abs(ocean_volume(cfg.dg3, q[0]) - vol0)
    bound = OCEAN_VOLUME_TOL * abs(torch.sum(g3.M).item() * eta_scale) \
        + 1e-12
    summary = ocean_split_explicit.summary(cfg, q)
    m2 = cfg.m2
    res = dict(card=nvidia_smi(), variant=variant, elements_3d=g3.nelem,
               elements_2d=g2.nelem, poly=g3.Nq[0] - 1, dtype="float64",
               dt_s=dt, fast_dt_s=cfg.solver.fast_dt,
               add_fast_substeps=cfg.m3.add_fast_substeps,
               windows=[w[:3] for w in windows],
               fast_steps_per_slow_step=sum(w[2] for w in windows),
               ivdc_solves_per_step=cfg.m3.num_impl_steps,
               warm_steps=SPLIT01_WARM, steps=SPLIT01_STEPS,
               setup_s=setup_s, ms_per_step=1e3 * wall / SPLIT01_STEPS,
               split_explicit_ms_per_step=1e3 * sum(split_s) / SPLIT01_STEPS,
               ivdc_ms_per_step=1e3 * sum(ivdc_s) / SPLIT01_STEPS,
               step_ms=[1e3 * (a + b) for a, b in zip(split_s, ivdc_s)],
               sim_s_per_wall_s=dt * SPLIT01_STEPS / wall,
               peak_memory_bytes=torch.cuda.max_memory_allocated(),
               gmres_residuals=residuals,
               max_abs_U_c=m2.aux_get(aux[1], "U_c").abs().max().item(),
               max_abs_deta=m2.aux_get(aux[1], "deta").abs().max().item(),
               eta_volume_drift=drift, eta_volume_bound=bound,
               launches=counts, **summary)
    emit("split01_path", **res)
    check(summary["finite"], (variant, "state not finite"))
    check(all(math.isfinite(r) and r <= SPLIT_GMRES_TOL
              for row in residuals for r in row),
          (variant, "GMRES residuals", residuals))
    check(len(residuals[0]) == cfg.m3.num_impl_steps == 5,
          (variant, "IVDC solves a step", residuals[0]))
    lo, hi = SPLIT_THETA_RANGE
    check(lo <= summary["theta_range"][0] and summary["theta_range"][1] <= hi,
          (variant, "θ range", summary["theta_range"]))
    check(drift <= bound, (variant, "∫η dV drift", drift, bound))
    check_launches(counts, expected_launches({}, 0))
    return res


def multirate_gate(minutes: int) -> dict:
    """The Julia multirate spindown table at a slow dt of ``minutes``
    (tests/test_split_explicit_refvals.py:186-293) in float64 on the
    card: SimpleBox(Fixed) with αᵀ = κ = 0 and no advection,
    CoupledHBModel with 2 added substeps and 5 IVDC solves at dt/5,
    BarotropicModel with the central flux, the periodic 5 × 5 × 8 box and
    5 × 5 brick at p4, "split01" with LSRK54 slow and fast at 300 s, one
    day; the analytic error below SPINDOWN_ERR and the table at the
    test's digits."""
    table, digits = MULTIRATE_GATES[minutes]
    dt = minutes * 60.0
    Lx = Ly = 1e6
    H = 400.0
    problem = SimpleBox(Lx, Ly, H, rotation=Fixed())
    m3 = CoupledHBModel(problem, c_h=1.0, alpha_T=0.0, kappa_h=0.0,
                        kappa_z=0.0, momentum_advection=None,
                        tracer_advection=None, num_impl_steps=5,
                        ivdc_dt=dt / 5.0, add_fast_substeps=2)
    m2 = BarotropicModel(problem, turbulence=ConstantViscosity(m3.nu_h),
                         advection=None, c=1.0)
    ranges = [np.linspace(0.0, Lx, 6), np.linspace(0.0, Ly, 6)]
    g2 = make_grid(brick_topology(ranges, periodicity=(True, True)), 4,
                   dtype=torch.float64, device="cuda")
    g3 = make_grid(stacked_brick_topology(
        ranges + [np.linspace(-H, 0.0, 9)], periodicity=(True, True, False),
        boundary=np.array([[0, 0], [0, 0], [1, 2]])), 4,
        dtype=torch.float64, device="cuda")
    dg3 = DGModel(m3, g3)
    dg2 = DGModel(m2, g2,
                  numerical_flux_first_order=CentralNumericalFluxFirstOrder())
    q2, aux2 = init_ode_state(dg2, init_state=problem.sw_init_state)
    q3, aux3 = init_ode_state(dg3)
    se = SplitExplicitSolver(LSRK54CarpenterKennedy(dg3, dt),
                             LSRK54CarpenterKennedy(dg2, 300.0), dg3, dg2,
                             dt=dt, fast_dt=300.0, variant="split01")
    nsteps = int(round(86400.0 / dt))
    q, aux, t = (q3, q2), (aux3, aux2), 0.0
    reset_launch_counts()
    residuals = []
    t0 = time.perf_counter()
    for _ in range(nsteps):
        q, aux = se.step(q, aux, t)
        residuals += se.ivdc_residuals
        t += dt
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    (q3, q2), (aux3, aux2) = q, aux
    qe3 = problem.init_state(m3, g3.coords.transpose(1, 2), aux3, t)
    err3 = ((q3 - qe3).norm() / qe3.norm()).item()
    pairs = []
    for i in (0, 1):
        pairs += [(("3D state", f"u[{i + 1}]"), m3.prog(q3, "u")[:, i]),
                  (("3D aux", f"uᵈ[{i + 1}]"), m3.aux_get(aux3, "ud")[:, i]),
                  (("3D aux", f"ΔGᵘ[{i + 1}]"),
                   m3.aux_get(aux3, "dGu")[:, i]),
                  (("2D state", f"U[{i + 1}]"), m2.prog(q2, "U")[:, i]),
                  (("2D aux", f"Gᵁ[{i + 1}]"), m2.aux_get(aux2, "GU")[:, i]),
                  (("2D aux", f"Δu[{i + 1}]"), m2.aux_get(aux2, "du")[:, i])]
    pairs += [(("3D state", "η"), m3.prog(q3, "eta")),
              (("3D state", "θ"), m3.prog(q3, "theta")),
              (("2D state", "η"), m2.prog(q2, "eta")),
              (("2D aux", "y"), m2.aux_get(aux2, "y"))]
    pairs += [(("3D aux", name), m3.aux_get(aux3, name))
              for name in ("y", "w", "pkin", "wz0")]
    rv = load_refvals("hydrostatic_spindown")
    parr = {k: [min(d, digits) for d in v] for k, v in rv.parr.items()}
    parr[("3D aux", "w")] = [2.0, 2.0, 0.0, 2.0]
    parr[("3D aux", "wz0")] = [1.0, 1.0, 0.0, 1.0]
    for k in (("3D aux", "ΔGᵘ[1]"), ("2D aux", "Gᵁ[1]"),
              ("2D aux", "Δu[1]")):
        parr[k] = [0.0, 0.0, 0.0, 0.0]
    reached, failures = check_digits(spindown_stats(pairs),
                                     getattr(rv, table), parr)
    gmres = [r.item() for r in residuals]
    res = dict(card=nvidia_smi(),
               table=f"tests/refvals/hydrostatic_spindown.py:{table}",
               elements_3d=g3.nelem, elements_2d=g2.nelem, steps=nsteps,
               dt_s=dt, seconds=wall, ms_per_step=1e3 * wall / nsteps,
               analytic_err_3d=err3, analytic_bound=SPINDOWN_ERR,
               max_gmres_residual=max(gmres),
               min_digits_reached=min(reached.values()),
               digits_reached=reached, failures=failures, launches=counts)
    emit("split01_golden_gate", **res)
    check(bool(torch.isfinite(q3).all()) and bool(torch.isfinite(q2).all()),
          (table, "multirate spindown not finite"))
    check(err3 < SPINDOWN_ERR, (table, "analytic error", err3))
    check(not failures, (table, "golden table", failures))
    check(max(gmres) <= SPLIT_GMRES_TOL, (table, "GMRES", max(gmres)))
    check_launches(counts, expected_launches({}, 0))
    return res


def vertical_integral_gate(table: str) -> dict:
    """The Julia vertical_integral table ``table`` (tests/
    test_split_explicit_refvals.py:296-343) on the card in float64: the
    indefinite column integral of the analytic spindown u against the
    analytic barotropic state, no stepping."""
    t = VERTINT_TABLES[table]
    Lx = Ly = 1e6
    H = 400.0
    problem = SimpleBox(Lx, Ly, H, rotation=Fixed())
    m3 = HydrostaticBoussinesqModel(problem, c_h=1.0, alpha_T=0.0,
                                    kappa_h=0.0, kappa_z=0.0,
                                    momentum_advection=None,
                                    tracer_advection=None)
    m2 = ShallowWaterModel(problem, turbulence=ConstantViscosity(m3.nu_h),
                           advection=None, c=1.0)
    ranges = [np.linspace(0.0, Lx, 6), np.linspace(0.0, Ly, 6)]
    g2 = make_grid(brick_topology(ranges, periodicity=(True, True)), 4,
                   dtype=torch.float64, device="cuda")
    g3 = make_grid(stacked_brick_topology(
        ranges + [np.linspace(-H, 0.0, 9)], periodicity=(True, True, False),
        boundary=np.array([[0, 0], [0, 0], [1, 2]])), 4,
        dtype=torch.float64, device="cuda")
    aux3 = init_state_auxiliary(m3, g3)
    aux2 = init_state_auxiliary(m2, g2)
    q3 = problem.init_state(m3, g3.coords.transpose(1, 2), aux3, t)
    q2 = problem.sw_init_state(m2, g2.coords.transpose(1, 2), aux2, t)
    int_u = ColumnOps(g3).indefinite_integral(m3.prog(q3, "u"))
    pairs = [(("∫u", "∫x[1]"), int_u[:, 0]),
             (("∫u", "∫x[2]"), int_u[:, 1]),
             (("U", "η"), m2.prog(q2, "eta")),
             (("U", "U[1]"), m2.prog(q2, "U")[:, 0]),
             (("U", "U[2]"), m2.prog(q2, "U")[:, 1])]
    rv = load_refvals("vertical_integral")
    reached, failures = check_digits(spindown_stats(pairs),
                                     getattr(rv, table), rv.parr)
    res = dict(card=nvidia_smi(),
               table=f"tests/refvals/vertical_integral.py:{table}", t_s=t,
               min_digits_reached=min(reached.values()), failures=failures)
    emit("split01_golden_gate", **res)
    check(not failures, (table, "vertical_integral table", failures))
    return res


def batched_gmres_check(seed: int) -> dict:
    """``batched_gmres`` on the card against the same solve on the CPU, in
    float64, for BATCHED_GMRES systems whose operator differs per row
    (I + 0.3 N(0, 1)/√n, made from ``seed``): max|x_card − x_cpu| over
    max|x_cpu| and each residual ‖Ax − b‖/‖b‖."""
    B, n, k, restarts = BATCHED_GMRES
    rng = np.random.default_rng(seed)
    A = np.eye(n)[None] + 0.3 * rng.standard_normal((B, n, n)) / n ** 0.5
    b = rng.standard_normal((B, n))
    out = {}
    for dev in ("cuda", "cpu"):
        At = torch.as_tensor(A, device=dev)
        out[dev] = batched_gmres(lambda x: torch.einsum("bij,bj->bi", At, x),
                                 torch.as_tensor(b, device=dev), n_krylov=k,
                                 restarts=restarts)
    torch.cuda.synchronize()
    x_card, r_card = (v.cpu() for v in out["cuda"])
    x_cpu = out["cpu"][0]
    bn = torch.linalg.vector_norm(torch.as_tensor(b), dim=1)
    rel = (r_card / bn).max().item()
    err = ((x_card - x_cpu).abs().max() / x_cpu.abs().max()).item()
    res = dict(card=nvidia_smi(), systems=B, n=n, n_krylov=k,
               restarts=restarts, max_rel_residual=rel,
               max_rel_diff_from_cpu=err, tol=BATCHED_GMRES_TOL)
    emit("batched_gmres", **res)
    check(rel <= BATCHED_GMRES_TOL, ("batched_gmres residual", rel))
    check(err <= BATCHED_GMRES_TOL, ("batched_gmres against the CPU", err))
    return res


def phase_split01(seed: int) -> dict:
    """The split01 variants at the Julia width, the multirate spindown
    and vertical_integral tables, ``batched_gmres`` (module docstring).
    Returns {variant: {ms_per_step, split_explicit_ms_per_step,
    ivdc_ms_per_step, sim_s_per_wall_s}}."""
    t_phase = time.perf_counter()
    out = {}
    for variant in ocean_split_explicit.JULIA:
        res = split01_path(variant)
        out[variant] = {k: res[k] for k in (
            "ms_per_step", "split_explicit_ms_per_step", "ivdc_ms_per_step",
            "sim_s_per_wall_s", "setup_s", "peak_memory_bytes")}
    torch.cuda.empty_cache()
    for minutes in MULTIRATE_GATES:
        multirate_gate(minutes)
    for table in VERTINT_DEFAULT:
        vertical_integral_gate(table)
    batched_gmres_check(seed)
    emit("split01_phase", card=nvidia_smi(),
         seconds=time.perf_counter() - t_phase)
    return out


def julia_gate(name: str) -> dict:
    """One of the Julia 5-day simple_box gates (JULIA_GATES) at the JAX
    test's width, steps and digits, on the card in float64."""
    kw, nsteps, refvals = JULIA_GATES[name]
    torch.cuda.empty_cache()
    if kw is None:
        cfg = ocean_split_explicit.make_dbl_gyre(device="cuda")
    else:
        cfg = ocean_split_explicit.make_julia(nx=20, nz=20, device="cuda",
                                              **kw)
    rv = load_refvals(refvals)
    if kw is None:
        parr = {k: [min(float(d), g) for d, g in zip(rv.parr[k], gates)]
                for k, gates in DBL_GYRE_GATES.items()}
    else:
        parr = {k: [0.0] * 4 if k[1] in JULIA_WINDOW_FIELDS
                else [min(float(d), 2.0) for d in v]
                for k, v in rv.parr.items()}
    q, aux, t, dt = cfg.q, cfg.aux, 0.0, cfg.solver.dt
    reset_launch_counts()
    residuals = []
    t0 = time.perf_counter()
    for _ in range(nsteps):
        q, aux = cfg.solver.step(q, aux, t)
        residuals += cfg.solver.ivdc_residuals
        t += dt
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    reached, failures = check_digits(
        ocean_split_explicit.julia_fields(cfg, q, aux), rv.varr, parr)
    gmres = [r.item() for r in residuals]
    summary = ocean_split_explicit.summary(cfg, q)
    res = dict(card=nvidia_smi(), gate=name,
               table=f"tests/refvals/{refvals}.py:varr",
               variant=cfg.solver.variant, elements_3d=cfg.dg3.grid.nelem,
               elements_2d=cfg.dg2.grid.nelem, steps=nsteps, dt_s=dt,
               seconds=wall, ms_per_step=1e3 * wall / nsteps,
               max_gmres_residual=max(gmres, default=0.0),
               min_digits_reached=min(reached.values()),
               digits_reached=reached, failures=failures, launches=counts,
               **summary)
    emit("julia_gate", **res)
    check(summary["finite"], (name, "state not finite"))
    check(not failures, (name, "golden table", failures))
    check(max(gmres, default=0.0) <= SPLIT_GMRES_TOL,
          (name, "GMRES", max(gmres, default=0.0)))
    check_launches(counts, expected_launches({}, 0))
    return res


def phase_julia_gates() -> dict:
    """``--julia-gates``: the four 5-day Julia gates and the
    vertical_integral tables the default run leaves out; each failure is
    reported with the others' results before the run exits non-zero."""
    t_phase = time.perf_counter()
    out, failed = {}, []
    gates = [(name, julia_gate) for name in JULIA_GATES]
    gates += [(table, vertical_integral_gate) for table in VERTINT_TABLES
              if table not in VERTINT_DEFAULT]
    for name, gate in gates:
        try:
            out[name] = gate(name)
        except RuntimeError as e:
            failed.append((name, str(e)[:2000]))
    emit("julia_gates_phase", card=nvidia_smi(), failed=failed,
         seconds=time.perf_counter() - t_phase)
    check(not failed, ("Julia gates failed", [f[0] for f in failed]))
    return out


# --- the GCM driver entry -------------------------------------------------

def gcm_invoke_vs_direct(mode: str) -> dict:
    """Held-Suarez at bench width through the driver entry
    (``held_suarez_driver``, IMEX at Courant 0.3, ``invoke``) and through
    ``IMEXSolverType().make`` with the filter driven by ``solve``, on the
    same dt, GCM_STEPS steps each under surface pass ``mode``, every
    launch count set to 0 just before each run and read just after: the
    states equal bit for bit, the counts equal and are the IMEX path's a
    step."""
    driver_init(show_updates="never")
    t0 = time.perf_counter()
    sc = held_suarez_driver(N_HORZ, N_VERT, POLY, timeend=0.0, imex=True,
                            device="cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    dt = sc.dt
    sc.timeend = GCM_STEPS * dt
    sc.solver.vm.surface_kernel = mode
    reset_launch_counts()
    t1 = time.perf_counter()
    invoke(sc)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    counts = launch_counts()
    cfg = held_suarez_config(n_horz=N_HORZ, n_vert=N_VERT, poly_order=POLY,
                             device="cuda")
    dg = DGModel(cfg.model, cfg.grid)
    q0, aux0 = init_ode_state(dg)
    solver = IMEXSolverType().make(dg, q0, aux0, dt)
    solver.post_step = HeldSuarezStepFilter(cfg.grid, cfg.model).apply_vm
    solver.rhs_full.surface_kernel = mode
    reset_launch_counts()
    st = solve(q0, aux0, solver, GCM_STEPS * dt)
    torch.cuda.synchronize()
    direct = launch_counts()
    per_step = {"fused_volume_tendency_vm": 3, **{k: 3 for k in CHAIN},
                "to_blocks_vm": 3, "from_blocks_vm": 2,
                **{k: 3 for k in SURFACE_LAUNCHES[mode]}}
    res = dict(card=nvidia_smi(), surface_kernel=mode, n_horz=N_HORZ,
               n_vert=N_VERT, poly=POLY, dtype="float32", dt_s=dt,
               courant_number=sc.cfl, steps=GCM_STEPS, setup_s=setup_s,
               ms_per_step_invoke=1e3 * wall / GCM_STEPS,
               exact=bool(torch.equal(sc.q, st.q)), launches=counts,
               launches_direct=direct, finite=bool(torch.isfinite(
                   sc.q).all()))
    emit("gcm_invoke_vs_direct", **res)
    check(res["finite"], ("Held-Suarez invoke not finite", mode))
    check(res["exact"], ("invoke against the direct IMEX path", mode))
    check(counts == direct, ("invoke launches", counts, direct))
    check_launches(counts, expected_launches(per_step, GCM_STEPS))
    return res


def gcm_restart() -> dict:
    """k steps through ``invoke`` with ``checkpoint_at_end``, a restart
    from that checkpoint and k more against 2k steps in one run, bit for
    bit (Held-Suarez IMEX at bench width, float32, dt GCM_RESTART_DT)."""
    import tempfile
    k, dt = GCM_RESTART_K, GCM_RESTART_DT
    kw = dict(imex=True, device="cuda", ode_dt=dt)
    with tempfile.TemporaryDirectory() as tmp:
        driver_init(show_updates="never")
        whole = held_suarez_driver(N_HORZ, N_VERT, POLY, 2 * k * dt, **kw)
        invoke(whole)
        driver_init(show_updates="never", checkpoint_dir=tmp,
                    checkpoint_at_end=True)
        first = held_suarez_driver(N_HORZ, N_VERT, POLY, k * dt, **kw)
        invoke(first)
        t0 = time.perf_counter()
        driver_init(show_updates="never", checkpoint_dir=tmp)
        second = held_suarez_driver(N_HORZ, N_VERT, POLY, 2 * k * dt,
                                    restart_from=(tmp, 9999), **kw)
        restart_s = time.perf_counter() - t0
        invoke(second)
        torch.cuda.synchronize()
        size = sum(f.stat().st_size for f in pathlib.Path(tmp).iterdir())
    res = dict(card=nvidia_smi(), k=k, dt_s=dt, t0_restart=second.t0,
               restart_setup_s=restart_s, checkpoint_bytes=size,
               dtype=str(second.q.dtype),
               exact=bool(torch.equal(second.q, whole.q)))
    emit("gcm_restart", **res)
    check(second.t0 == k * dt and second.q.dtype == torch.float32,
          ("restart t0 and dtype", second.t0, second.q.dtype))
    check(res["exact"], "restart against the unbroken run")
    return res


def gcm_monitors() -> dict:
    """``MonitorCourant``, ``MonitorTimestepDuration`` and ``AdaptTimestep``
    once each on Held-Suarez at bench width (IMEX), each callback's host
    seconds from its call to a synchronize."""
    driver_init(show_updates="never")
    sc = held_suarez_driver(N_HORZ, N_VERT, POLY, timeend=0.0, imex=True,
                            device="cuda")
    state = SimpleNamespace(q=sc.q, aux=sc.aux, t=0.0, step=0)
    out = {}
    mon = cbs.MonitorCourant(sc.dg.grid, sc.dg.balance_law, sc.dt,
                             every_steps=1)
    tmon = cbs.MonitorTimestepDuration(every_steps=1)
    adapt = cbs.AdaptTimestep(sc, every_steps=1, rtol=0.0)
    dt0 = sc.solver.dt
    for name, cb in (("courant", mon.make()), ("timestep", tmon.make()),
                     ("adapt_timestep", adapt.make())):
        cb.init(state)
        state.step = 1
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cb.call(state)
        torch.cuda.synchronize()
        out[name + "_host_ms"] = 1e3 * (time.perf_counter() - t0)
        state.step = 0
    res = dict(card=nvidia_smi(), courant_advective=mon.last[0],
               courant_acoustic=mon.last[1], dt_s=dt0,
               adapted_dt_s=sc.solver.dt, **out)
    emit("gcm_monitors", **res)
    check(all(math.isfinite(v) for v in mon.last), ("Courant", mon.last))
    check(math.isfinite(sc.solver.dt) and sc.solver.dt > dt0,
          ("AdaptTimestep on the linear model's sound speed",
           sc.solver.dt, dt0))
    return res


class _MaxSpeed:
    """A callback: (t, max |u|) after every step."""

    def __init__(self):
        self.rows = []

    def call(self, state):
        q = state.q
        u = torch.linalg.vector_norm(q[:, 1:4] / q[:, :1], dim=1).max()
        self.rows.append((state.t, u.item()))
        return False


def gcm_solid_body_rotation() -> dict:
    """examples/solid_body_rotation.py at its defaults through
    ``AtmosGCMConfiguration`` (4 × 3, p4, float32 as the example runs on
    an accelerator, Roe, IMEX, Courant 0.2 horizontal, SBR_TIMEEND), max
    |u| after every step reported with the first time it reaches 0.5
    m/s: the JAX example does not keep the rest state there (float32 on
    the CPU: 0.76 m/s after its first step, NaN from 1229 s; float64:
    8.2e-6 m/s at 1800 s, 9.47 at 3600, NaN at 7200; ROADMAP reference
    caveats), so the check is the run's: its dt, a finite first step and
    the kernels' launches a step (the dry volume kernel on the generic
    operator's 3 explicit stages, the layouts 3 and 2)."""
    driver_init(show_updates="never")
    t0 = time.perf_counter()
    sc = solid_body_rotation.solid_body_rotation_config(
        timeend=SBR_TIMEEND, device="cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    q0, speed = sc.q, _MaxSpeed()
    steps = int(round(SBR_TIMEEND / sc.dt))
    reset_launch_counts()
    t1 = time.perf_counter()
    invoke(sc, user_callbacks=(speed,))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    counts = launch_counts()
    s = solid_body_rotation.rest_summary(sc, q0, sc.q)
    bound = solid_body_rotation.MAX_ABS_U
    broke = [t for t, u in speed.rows if not u < bound]
    res = dict(card=nvidia_smi(), dtype="float32", elements=sc.dg.grid.nelem,
               dt_s=sc.dt, timeend_s=SBR_TIMEEND, steps=len(speed.rows),
               setup_s=setup_s, ms_per_step=1e3 * wall / len(speed.rows),
               max_abs_u_bound=bound,
               first_t_at_bound=broke[0] if broke else None,
               max_abs_u_by_step=speed.rows, launches=counts, **s)
    emit("gcm_solid_body_rotation", **res)
    check(len(speed.rows) == steps and abs(sc.dt - SBR_DT) < 1e-9 * SBR_DT,
          ("solid-body rotation steps and dt", len(speed.rows), sc.dt))
    check(math.isfinite(speed.rows[0][1]),
          ("solid-body rotation's first step", speed.rows[0]))
    check_launches(counts, expected_launches(
        {DRY: 3, "to_blocks_vm": 3, "from_blocks_vm": 2}, steps))
    return res


def gcm_composable(surface_flux: str) -> dict:
    """``gcm_driver_config("heldsuarez")`` (moist, 8 × 4, p4, float32) with
    ``surface_flux``: GCM_LSRK_STEPS LSRK54 steps at 0.3 of the acoustic
    CFL on the generic operator; finite, the mass drift reported."""
    cfg = gcm_driver_config("heldsuarez", surface_flux=surface_flux,
                            device="cuda")
    dg = DGModel(cfg.model, cfg.grid)
    q0, aux0 = init_ode_state(dg)
    dt = 0.3 * min_node_distance(cfg.grid) / 350.0
    solver = LSRK54CarpenterKennedy(dg, dt)
    m = lambda q: torch.sum(cfg.grid.M.double() * q[:, 0].double()).item()
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = solve(q0, aux0, solver, GCM_LSRK_STEPS * dt)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    res = dict(card=nvidia_smi(), surface_flux=surface_flux,
               elements=cfg.grid.nelem, dt_s=dt, steps=st.step,
               ms_per_step=1e3 * wall / st.step,
               mass_drift_rel=abs(m(st.q) - m(q0)) / m(q0),
               finite=bool(torch.isfinite(st.q).all()), launches=counts)
    emit("gcm_composable", **res)
    check(res["finite"], ("gcm_driver_config not finite", surface_flux))
    check(res["mass_drift_rel"] <= MASS_TOL,
          ("gcm_driver_config mass", res["mass_drift_rel"]))
    return res


def phase_gcm_driver() -> dict:
    """The GCM driver entry (module docstring).  Returns {ms_per_step_invoke
    per surface pass, the solid-body rotation's ms_per_step}."""
    t_phase = time.perf_counter()
    out = {}
    for mode in SURFACE_KERNELS:
        out[mode] = gcm_invoke_vs_direct(mode)["ms_per_step_invoke"]
        torch.cuda.empty_cache()
    gcm_restart()
    torch.cuda.empty_cache()
    gcm_monitors()
    out["solid_body_rotation"] = gcm_solid_body_rotation()["ms_per_step"]
    for flux in ("default", "bulk"):
        gcm_composable(flux)
    driver_init(show_updates="never")
    emit("gcm_driver_phase", card=nvidia_smi(),
         seconds=time.perf_counter() - t_phase)
    return out


# --- diagnostics and output ---------------------------------------------------

class CallClock:
    """Wraps ``obj.<method>``: each call's start and host seconds, the
    card synchronised before and after; ``last`` holds its last result."""

    def __init__(self, obj, method: str = "write"):
        self.calls, self.last = [], None
        inner = getattr(obj, method)

        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            self.last = inner(*args, **kwargs)
            torch.cuda.synchronize()
            self.calls.append((t0, time.perf_counter() - t0))
            return self.last

        setattr(obj, method, timed)

    def ms(self) -> float:
        """The mean ms a call."""
        return 1e3 * statistics.fmean(d for _, d in self.calls)

    def seconds_after(self, t0: float) -> float:
        return sum(d for t, d in self.calls if t >= t0)


def profiles_vs_cpu(card: dict, cpu: dict, cpu_eps: dict) -> dict:
    """Each value of ``card`` against ``cpu`` (the same group on the CPU)
    within DIAG_PROFILE_TOL of its largest |value| plus DIAG_ROUNDOFF_FACTOR
    times its change ``cpu_eps`` − ``cpu`` under a 2⁻⁵⁰ relative
    perturbation of the state, NaN where the CPU has NaN: the largest
    error over that bound, the worst value, and the values whose
    round-off term exceeds their relative bound (round-off profiles)."""
    worst, worst_key, roundoff = 0.0, None, []
    for k, ref in cpu.items():
        got, ref, eps = (np.asarray(a, dtype=np.float64)
                         for a in (card[k], ref, cpu_eps[k]))
        nan = np.isnan(ref)
        check(np.array_equal(np.isnan(got), nan), ("NaN pattern", k))
        if nan.all():
            continue
        scale = np.max(np.abs(ref[~nan]))
        noise = DIAG_ROUNDOFF_FACTOR * np.max(np.abs(eps - ref)[~nan])
        if noise > DIAG_PROFILE_TOL * scale:
            roundoff.append(k)
        bound = DIAG_PROFILE_TOL * scale + noise
        err = np.max(np.abs(got - ref)[~nan])
        ratio = err / bound if bound > 0 else (0.0 if err == 0 else math.inf)
        if ratio > worst or worst_key is None:
            worst, worst_key = ratio, k
    return dict(err_over_bound=worst, worst=worst_key, roundoff=roundoff,
                n_values=len(cpu))


def diagnostics_les(name: str) -> dict:
    """Case ``name`` of DIAG_LES through the driver's entry and ``invoke``
    with its groups (``NpzWriter``) in a ``DiagnosticsConfiguration``;
    checks and reports as the module docstring says."""
    warm, steps, every, kinds = DIAG_LES[name]
    case = FORCED_LES_CASES[name]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    dc = case.config(device="cuda")
    sc = make_solver_configuration(0.0, -1.0, dc,
                                   ode_solver_type=case.solver_type,
                                   Courant_number=case.courant)
    g, model = dc.grid, dc.model
    check(g.nelem == FORCING_ELEMENTS[name], (name, "elements", g.nelem))
    sc.timeend = (warm + steps) * sc.dt
    with tempfile.TemporaryDirectory() as tmp:
        groups = {k: DIAG_LES_GROUPS[k](sc.dg, writer=NpzWriter(),
                                        out_path=f"{tmp}/{name}_{k}.npz")
                  for k in kinds}
        clocks = {k: CallClock(grp) for k, grp in groups.items()}
        timer = StepTimer(warm)
        reset_launch_counts()
        invoke(sc, user_callbacks=(*case.callbacks(dc), timer),
               diagnostics_config=DiagnosticsConfiguration(
                   tuple(groups.values()), every_steps=every))
        counts = launch_counts()
        files = len(list(pathlib.Path(tmp).iterdir()))
    check_launches(counts, expected_launches({}, 0))
    check(files == len(kinds) * (1 + (warm + steps) // every),
          (name, "files written", files))
    wall = timer.end - timer.start
    writes = sum(c.seconds_after(timer.start) for c in clocks.values())
    g64 = grid_from_numpy(grid_to_numpy(g), device="cpu", dtype=torch.float64)
    dg64 = DGModel(model, g64,
                   numerical_flux_first_order=dc.numerical_flux_first_order,
                   numerical_flux_gradient=dc.numerical_flux_gradient,
                   numerical_flux_second_order=dc.numerical_flux_second_order)
    q, aux, t = sc.q.cpu(), sc.aux.cpu(), sc.timeend
    gen = torch.Generator().manual_seed(DIAG_SEED)
    q_eps = q * (1 + DIAG_ROUNDOFF_EPS * torch.randn(q.shape, generator=gen,
                                                     dtype=q.dtype))
    res = dict(card=nvidia_smi(), case=name, elements=g.nelem, poly=POLY,
               dtype="float64", dt_s=sc.dt, warm_steps=warm, steps=steps,
               every_steps=every, ms_per_step=1e3 * (wall - writes) / steps,
               peak_memory_bytes=torch.cuda.max_memory_allocated(),
               launches=counts, groups={})
    for k, grp in groups.items():
        card = grp.collect(sc.q, sc.aux, t)
        cpu_grp = DIAG_LES_GROUPS[k](dg64)
        cmp = profiles_vs_cpu(card, cpu_grp.collect(q, aux, t),
                              cpu_grp.collect(q_eps, aux, t))
        res["groups"][k] = dict(ms_per_write=clocks[k].ms(),
                                writes=len(clocks[k].calls), **cmp)
        check(cmp["err_over_bound"] <= 1.0,
              (name, k, "profiles against the CPU", cmp))
        if k == "default":
            res.update(lwp=float(card["lwp"]), cld_top=float(card["cld_top"]),
                       cld_base=float(card["cld_base"]),
                       cld_frac_max=float(card["cld_frac"].max()),
                       qt_min=float(card["qt"].min()))
            check(res["qt_min"] >= 0.0, (name, "q_tot profile", res["qt_min"]))
            if name == "dycoms":
                check(res["lwp"] > 0.0, ("DYCOMS lwp", res["lwp"]))
                check(card["cld_frac"].min() >= 0.0
                      and res["cld_frac_max"] <= 1.0, "DYCOMS cld_frac")
                check(res["cld_top"] > res["cld_base"],
                      ("DYCOMS cloud top and base", res["cld_top"],
                       res["cld_base"]))
        else:
            res["core_frac_max"] = float(card["core_frac"].max())
    emit("diagnostics_les", **res)
    return res


def gcm_diagnostics_run(with_diagnostics: bool) -> dict:
    """Held-Suarez at bench width through ``held_suarez_driver`` (IMEX,
    "pallas"), DIAG_GCM_STEPS steps through ``invoke``, with or without
    the GCM groups and a StateCheck every step; the steps after the first
    timed."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sc = held_suarez_driver(N_HORZ, N_VERT, POLY, timeend=0.0, imex=True,
                            device="cuda")
    sc.timeend = DIAG_GCM_STEPS * sc.dt
    sc.solver.vm.surface_kernel = "pallas"
    out, config, clocks = {}, None, {}
    with tempfile.TemporaryDirectory() as tmp:
        if with_diagnostics:
            itp = InterpolationConfiguration(sc.driver_config)
            check(itp.out_shape == DIAG_GCM_GRID, ("grid", itp.out_shape))
            r = torch.linalg.vector_norm(sc.dg.grid.coords, dim=-1)
            rads = torch.as_tensor(itp.latlon[2], device=r.device)
            out["radius_rel_err"] = ((itp(r) - rads) / rads).abs().max().item()
            check(out["radius_rel_err"] <= INTERP_RADIUS_TOL,
                  ("interpolated radius", out["radius_rel_err"]))
            w = NpzWriter
            groups = {
                "gcm_default": AtmosGCMDefaultGroup(
                    sc.dg, itp, writer=w(), out_path=f"{tmp}/default.npz"),
                "mass_energy_loss": AtmosMassEnergyLossGroup(
                    sc.dg, writer=w(), out_path=f"{tmp}/mel.npz"),
                "gcm_spectra": AtmosGCMSpectraGroup(
                    sc.dg, itp, writer=w(), out_path=f"{tmp}/spec.npz")}
            clocks = {k: CallClock(grp) for k, grp in groups.items()}
            state_check = StateCheck(tracked=(
                (lambda st: st.q, sc.dg.balance_law.prog_spec, "Q"),))
            clocks["state_check"] = CallClock(state_check, "snapshot")
            config = DiagnosticsConfiguration(
                (*groups.values(), state_check), every_steps=1)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        timer = StepTimer(1)
        reset_launch_counts()
        invoke(sc, user_callbacks=(timer,), diagnostics_config=config)
        counts = launch_counts()
        out["bytes_written"] = sum(f.stat().st_size
                                   for f in pathlib.Path(tmp).iterdir())
    writes = sum(c.seconds_after(timer.start) for c in clocks.values())
    out.update(q=sc.q, launches=counts, setup_s=setup_s,
               ms_per_step=1e3 * (timer.end - timer.start - writes)
               / timer.steps, steps=timer.steps,
               peak_memory_bytes=torch.cuda.max_memory_allocated(),
               ms_per_write={k: c.ms() for k, c in clocks.items()},
               writes={k: len(c.calls) for k, c in clocks.items()})
    if with_diagnostics:
        last = clocks["gcm_default"].last
        out.update(finite=all(np.isfinite(v).all() for v in last.values()),
                   max_abs_vort=float(np.abs(last["vort"]).max()),
                   delta_mass=float(clocks["mass_energy_loss"].last[
                       "delta_mass"]),
                   spectrum_1d_shape=list(clocks["gcm_spectra"].last[
                       "spectrum_1d"].shape))
        check(out["finite"], "AtmosGCMDefault not finite")
        check(len(state_check.history) == DIAG_GCM_STEPS,
              ("StateCheck snapshots", len(state_check.history)))
    return out


def diagnostics_gcm() -> dict:
    """The GCM groups' run against the same run without them."""
    driver_init(show_updates="never")
    runs = {d: gcm_diagnostics_run(d) for d in (True, False)}
    per_step = {"fused_volume_tendency_vm": 3, **{k: 3 for k in CHAIN},
                "to_blocks_vm": 3, "from_blocks_vm": 2,
                **{k: 3 for k in SURFACE_LAUNCHES["pallas"]}}
    for run in runs.values():
        check_launches(run["launches"],
                       expected_launches(per_step, DIAG_GCM_STEPS))
    on = runs[True]
    res = dict(card=nvidia_smi(), n_horz=N_HORZ, n_vert=N_VERT, poly=POLY,
               dtype="float32", surface_kernel="pallas",
               grid=list(DIAG_GCM_GRID),
               exact=bool(torch.equal(on.pop("q"), runs[False].pop("q"))),
               with_diagnostics=on, without=runs[False])
    emit("diagnostics_gcm", **res)
    check(res["exact"], "the GCM state with diagnostics against without")
    return res


def diagnostics_state_check() -> dict:
    """tests/test_statecheck_refvals.py's case on the card (float32, the
    generic operator: the dry volume and chain kernels) against the port's
    CPU float32 run from the same initial state and dt."""
    cfg = held_suarez_config(n_horz=2, n_vert=2, poly_order=3,
                             device="cuda")
    dt = 0.3 * min_node_distance(cfg.grid) / 350.0
    g_cpu = grid_from_numpy(grid_to_numpy(cfg.grid), device="cpu",
                            dtype=torch.float32)
    spec = cfg.model.prog_spec
    q0, aux0 = init_ode_state(DGModel(cfg.model, cfg.grid))
    snaps, counts = {}, None
    for run, grid in (("card", cfg.grid), ("cpu", g_cpu)):
        dg = DGModel(cfg.model, grid)
        sc = StateCheck(tracked=((lambda st: st.q, spec, "Q"),))
        reset_launch_counts()
        solve(q0.to(grid.device), aux0.to(grid.device),
              LSRK54CarpenterKennedy(dg, dt), STATECHECK_STEPS * dt,
              callbacks=(sc.make_callback(STATECHECK_STEPS),))
        if run == "card":
            torch.cuda.synchronize()
            counts = launch_counts()
        snaps[run] = sc.history[-1]
    mom = max(max(abs(snaps["cpu"][("Q", f"rhou[{i}]")][s])
                  for s in ("min", "max")) for i in range(3))
    err, to_ref = {}, {}
    refvals = load_refvals("held_suarez").refvals
    for key, cpu in snaps["cpu"].items():
        card = snaps["card"][key]
        scale = lambda s: mom if key[1].startswith("rhou") else abs(cpu[s])
        err[key[1]] = max(abs(card[s] - cpu[s]) / scale(s)
                          for s in ("min", "max", "mean", "std"))
        to_ref[key[1]] = {s: abs(card[s] - refvals[key][s])
                          / abs(refvals[key][s])
                          for s in ("min", "max", "mean", "std")}
    res = dict(card=nvidia_smi(), elements=cfg.grid.nelem, poly=3,
               dtype="float32", steps=STATECHECK_STEPS, dt_s=dt,
               rel_err_vs_cpu=err, tol=STATECHECK_TOL,
               rel_dist_to_refvals=to_ref, launches=counts)
    emit("diagnostics_state_check", **res)
    check(max(err.values()) <= STATECHECK_TOL, ("StateCheck card vs CPU", err))
    check_launches(counts, expected_launches(
        {DRY: 5, **{k: 5 for k in CHAIN}}, STATECHECK_STEPS))
    return res


def diagnostics_debug_init() -> dict:
    """``debug_init`` on the Held-Suarez driver entry at bench width: the
    dump's bytes and seconds, parsed back, its fields equal to the state
    within the ascii's 10 digits, no lane of state or aux non-finite."""
    dump = solver_configs.vtk_dump_state
    clock = SimpleNamespace(vtk_dump_state=dump)
    timed = CallClock(clock, "vtk_dump_state")
    try:
        solver_configs.vtk_dump_state = clock.vtk_dump_state
        with tempfile.TemporaryDirectory() as tmp:
            driver_init(show_updates="never", debug_init=True,
                        output_dir=tmp)
            sc = held_suarez_driver(N_HORZ, N_VERT, POLY, timeend=0.0,
                                    imex=True, device="cuda")
            path = pathlib.Path(timed.last)
            size = path.stat().st_size
            t0 = time.perf_counter()
            parsed = readvtk(str(path))
            parse_s = time.perf_counter() - t0
    finally:
        solver_configs.vtk_dump_state = dump
        driver_init(show_updates="never")
    model, g = sc.dg.balance_law, sc.dg.grid
    q = sc.q.cpu().double().numpy()
    field_err = max(
        np.max(np.abs(parsed[n.replace(".", "_").replace("[", "_")
                             .rstrip("]")] - q[:, i].reshape(-1)))
        / np.max(np.abs(q[:, i])) for i, n in
        enumerate(model.prog_spec.flattened_names()))
    res = dict(card=nvidia_smi(), elements=g.nelem, points=g.nelem * g.Np,
               bytes=size, dump_s=timed.calls[0][1], parse_s=parse_s,
               field_rel_err=field_err,
               not_finite=cbs.show_not_finite_fields(model.prog_spec, sc.q)
               + cbs.show_not_finite_fields(model.aux_spec, sc.aux))
    emit("diagnostics_debug_init", **res)
    check(parsed["points"].shape == (g.nelem * g.Np, 3), "dump points")
    check(all(np.isfinite(v).all() for v in parsed.values()), "dump finite")
    check(field_err <= 1e-9, ("dump fields", field_err))
    check(not res["not_finite"], ("non-finite lanes", res["not_finite"]))
    return res


def phase_diagnostics() -> dict:
    """Diagnostics and output (module docstring).  Returns the ms per
    step and per write of each run."""
    t_phase = time.perf_counter()
    driver_init(show_updates="never")
    out = {}
    for name in DIAG_LES:
        les = diagnostics_les(name)
        out[name] = dict(ms_per_step=les["ms_per_step"],
                         ms_per_write={k: v["ms_per_write"]
                                       for k, v in les["groups"].items()})
    gcm = diagnostics_gcm()
    out["gcm"] = dict(
        ms_per_step=gcm["with_diagnostics"]["ms_per_step"],
        ms_per_step_without=gcm["without"]["ms_per_step"],
        ms_per_write=gcm["with_diagnostics"]["ms_per_write"],
        peak_memory_bytes=gcm["with_diagnostics"]["peak_memory_bytes"])
    diagnostics_state_check()
    dump = diagnostics_debug_init()
    out["debug_init"] = {k: dump[k] for k in ("bytes", "dump_s", "parse_s")}
    torch.cuda.empty_cache()
    emit("diagnostics_phase", card=nvidia_smi(),
         seconds=time.perf_counter() - t_phase, **out)
    return out


# --- the remaining atmosphere formulations ------------------------------------

def lane_errs(got, ref, names) -> list:
    """max|got − ref| per lane over the lane's largest |ref|: the
    momentum lanes (ρu's and the updrafts' ρaw) share the largest of
    theirs, a lane that is 0 throughout is scaled by 1."""
    scale = ref.abs().amax(dim=(0, 2))
    mom = [i for i, n in enumerate(names)
           if n.startswith(("rhou[", "turbconv.up_rhoaw"))]
    scale[mom] = scale[mom].max()
    scale = torch.where(scale > 0, scale, torch.ones_like(scale))
    return ((got - ref).abs().amax(dim=(0, 2)) / scale).tolist()


def worst_lane(errs, names, tols) -> dict:
    """The lane whose error is the largest share of its tolerance."""
    i = max(range(len(errs)), key=lambda j: errs[j] / tols[j])
    return dict(lane=names[i], err=errs[i], tol=tols[i])


def launches_per_call(fn) -> int:
    """The CUDA kernels one call of ``fn`` launches (traced once; counted
    on the profiler's raw events, without building its event list)."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA)


def edmf_formulation(case: str) -> dict:
    """The EDMF single stack ``case`` of experiments/bomex_edmf.py at its
    example's width (15 elements to 400 m, p4, float64): the first RHS
    (at the initial state times 1 + 1e-3 · N(0, 1) from EDMF_SEED) and
    EDMF_STEPS[case] LSRK144 steps with TMAR on the card, every launch
    count 0, against the port's float64 run of the same RHS and steps on
    the CPU from the card's initial state and dt, per lane
    (:func:`lane_errs`) within FORMULATION_TOL (EDMF_LANE_TOL where it
    names the lane); ms a step, kernels a step (one traced step), peak
    device memory."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model, dg, grid, q0, aux0 = bomex_edmf.sbl_stack(case, device="cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    check(grid.nelem == EDMF_ELEMENTS and grid.dtype == torch.float64,
          (case, "elements", grid.nelem))
    check(dg.n_gradient > 0 and not dg.dry_volume and not dg.fast_surface,
          (case, "the generic operator's gradient path"))
    names = model.prog_spec.flattened_names()
    tols = [EDMF_LANE_TOL.get(n, FORMULATION_TOL) for n in names]
    step, dt = bomex_edmf.stepper(model, dg, grid)
    cmodel, cdg, cgrid, _, _ = bomex_edmf.sbl_stack(case, device="cpu")
    cstep, _ = bomex_edmf.stepper(cmodel, cdg, cgrid, dt)
    steps = EDMF_STEPS[case]
    reset_launch_counts()
    # the first RHS at the initial state times 1 + 1e-3 · N(0, 1): at the
    # hydrostatic, horizontally uniform state itself ρ's tendency is
    # round-off
    qp = perturbed(q0, EDMF_SEED)
    rhs = dg(qp, aux0, 0.0)[0]
    q, aux = q0, aux0
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for i in range(steps):
        q, aux = step(q, aux, i * dt)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    t2 = time.perf_counter()
    launches = launches_per_call(lambda: step(q, aux, steps * dt))
    t3 = time.perf_counter()
    qc, auxc = q0.cpu(), aux0.cpu()
    rhs_err = lane_errs(rhs.cpu(), cdg(qp.cpu(), auxc, 0.0)[0], names)
    for i in range(steps):
        qc, auxc = cstep(qc, auxc, i * dt)
    err = lane_errs(q.cpu(), qc, names)
    sp = model.prog_spec
    up = sp.get(q, "turbconv.up_rhoa")
    seconds = dict(total=time.perf_counter() - t0, trace=t3 - t2,
                   cpu=time.perf_counter() - t3)
    res = dict(card=nvidia_smi(), case=case, elements=grid.nelem,
               poly=POLY, dtype="float64", n_up=up.shape[1], dt_s=dt,
               steps=steps, setup_s=setup_s, ms_per_step=1e3 * wall / steps,
               kernels_per_step=launches, peak_memory_bytes=peak,
               rhs_rel_err=worst_lane(rhs_err, names, tols),
               rel_err=worst_lane(err, names, tols),
               rel_err_per_lane=dict(zip(names, err)),
               max_updraft_area=(up / sp.get(q, "rho")[:, None]).max().item(),
               min_tmar_lane=q[:, bomex_edmf.tmar_slots(model)].min().item(),
               finite=bool(torch.isfinite(q).all()), seconds=seconds,
               launches=counts)
    emit("formulation_edmf", **res)
    check(res["finite"], (case, "state not finite"))
    check(all(e <= t for e, t in zip(rhs_err, tols)),
          (case, "first RHS against the CPU", res["rhs_rel_err"]))
    check(all(e <= t for e, t in zip(err, tols)),
          (case, "steps against the CPU", res["rel_err"]))
    check(res["min_tmar_lane"] >= 0.0, (case, "TMAR lanes"))
    check(res["max_updraft_area"] > 0.0, (case, "no updraft area"))
    check_launches(counts, expected_launches({}, 0))
    return res


def invoke_formulation(name: str, dc, courant: float, callbacks=(),
                       warm: int = FORMULATION_WARM,
                       steps: int = FORMULATION_STEPS):
    """``make_solver_configuration`` (Courant ``courant``) and
    :func:`invoke_timed` of the driver configuration ``dc``, then one
    traced step's kernels and the peak device memory: (result, solver
    configuration, initial state)."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sc = make_solver_configuration(0.0, -1.0, dc, Courant_number=courant)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    g, dg = dc.grid, sc.dg
    check(g.dtype == torch.float64 and sc.solver.vm is None
          and not dg.dry_volume and not dg.fast_surface,
          (name, "float64 on the generic operator"))
    q0 = sc.q
    run = invoke_timed(name, sc, callbacks, warm, steps)
    peak = torch.cuda.max_memory_allocated()
    q = sc.q
    t1 = time.perf_counter()
    launches = launches_per_call(lambda: sc.solver.step(q, sc.aux, 0.0))
    t2 = time.perf_counter()
    res = dict(card=nvidia_smi(), case=name, elements=g.nelem, poly=POLY,
               dtype="float64", dt_s=sc.dt, courant=courant,
               setup_s=setup_s, kernels_per_step=launches,
               peak_memory_bytes=peak,
               seconds=dict(total=t2 - t0, trace=t2 - t1), **run)
    return res, sc, q0


def q_tot_range(sc) -> dict:
    sp = sc.dg.balance_law.prog_spec
    qt = sp.get(sc.q, "moisture.rhoq_tot") / sp.get(sc.q, "rho")
    return dict(q_tot_min=qt.min().item(), q_tot_max=qt.max().item())


def anelastic_formulation() -> dict:
    """The Anelastic1D box of experiments/anelastic1d.py (the
    configuration of tests/test_atmos_extras.py's ``test_anelastic1d``):
    ANELASTIC_STEPS LSRK54 steps at its advective dt on the card, ρ = ρ_ref
    and the thermodynamic pressure = the reference pressure within
    ANELASTIC_TOL relative at the start and after the steps, ρw within
    ANELASTIC_RHOW, finite, and the same steps on the CPU within
    FORMULATION_TOL per variable; dt over the acoustic limit
    min_node_distance / c(300 K)."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model, dg, grid, q0, aux0 = anelastic1d.anelastic_box("cuda")
    step, dt = anelastic1d.stepper(dg, grid)
    sp, ap = model.prog_spec, model.aux_spec
    rho_ref, p_ref = ap.get(aux0, "ref_state.rho"), ap.get(aux0,
                                                           "ref_state.p")

    def constraint(q, aux):
        aux = model.update_auxiliary_state(q, aux, grid)
        _, p = model.thermo(q, aux)
        return (((sp.get(q, "rho") - rho_ref).abs() / rho_ref).max().item(),
                ((p - p_ref).abs() / p_ref).max().item())

    rho0_err, p0_err = constraint(q0, aux0)
    reset_launch_counts()
    q, aux = q0, aux0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(ANELASTIC_STEPS):
        q, aux = step(q, aux, i * dt)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    launches = launches_per_call(lambda: step(q, aux, 0.0))
    rho_err, p_err = constraint(q, aux)
    cstep, _ = anelastic1d.stepper(*anelastic1d.anelastic_box("cpu")[1:3])
    qc, auxc = q0.cpu(), aux0.cpu()
    for i in range(ANELASTIC_STEPS):
        qc, auxc = cstep(qc, auxc, i * dt)
    err = vortex_err(q.cpu(), qc)
    c = td.soundspeed_air(model.param_set, torch.tensor(300.0)).item()
    res = dict(card=nvidia_smi(), case="anelastic1d", elements=grid.nelem,
               poly=POLY, dtype="float64", dt_s=dt,
               dt_over_acoustic=dt * c / min_node_distance(grid),
               steps=ANELASTIC_STEPS, ms_per_step=1e3 * wall / ANELASTIC_STEPS,
               kernels_per_step=launches, peak_memory_bytes=peak,
               rho_rel_err=[rho0_err, rho_err], p_rel_err=[p0_err, p_err],
               max_abs_rhow=sp.get(q, "rhou")[:, 2].abs().max().item(),
               cpu_rel_err_per_var=err,
               finite=bool(torch.isfinite(q).all()), launches=counts)
    emit("formulation_anelastic", **res)
    check(res["finite"], ("anelastic", "state not finite"))
    check(max(rho0_err, rho_err) <= ANELASTIC_TOL, ("anelastic ρ = ρ_ref",
                                                    rho0_err, rho_err))
    check(max(p0_err, p_err) <= ANELASTIC_TOL, ("anelastic p = p_ref",
                                                p0_err, p_err))
    check(res["max_abs_rhow"] <= ANELASTIC_RHOW, ("anelastic ρw",
                                                  res["max_abs_rhow"]))
    check(max(err) <= FORMULATION_TOL, ("anelastic against the CPU", err))
    check_launches(counts, expected_launches({}, 0))
    return res


def phase_atmos_formulations() -> dict:
    """The remaining atmosphere formulations (module docstring), each
    through its entry point, float64 on the generic operator, whose
    gradient path runs no kernel (every launch count 0): the EDMF single
    stack decoupled, coupled and moist; the BOMEX single stack; the ρθ
    bubble and its small box against the CPU; the Anelastic1D box; the
    cfsite AMIP LES.  Returns each case's ms a step, kernels a step and
    peak device memory."""
    t_phase = time.perf_counter()
    driver_init(show_updates="never")
    out = {}

    def keep(res):
        out[res["case"]] = {k: res[k] for k in (
            "ms_per_step", "kernels_per_step", "peak_memory_bytes")}

    for case in EDMF_STEPS:
        keep(edmf_formulation(case))
    dc = bomex_single_stack.bomex_single_stack_config(device="cuda")
    check(dc.grid.nelem == SINGLE_STACK_ELEMENTS and dc.grid.n_vert
          == SINGLE_STACK_ELEMENTS, ("single stack", dc.grid.nelem))
    res, sc, _ = invoke_formulation("bomex_single_stack", dc,
                                    bomex_single_stack.COURANT,
                                    (bomex_les.tmar_callback(dc),))
    res.update(q_tot_range(sc))
    emit("formulation_invoke", **res)
    check(res["q_tot_min"] >= 0.0, ("single stack q_tot", res["q_tot_min"]))
    keep(res)
    dc = rising_bubble_theta.theta_bubble_config(device="cuda")
    check(dc.grid.nelem == THETA_ELEMENTS, ("theta bubble", dc.grid.nelem))
    res, sc, q0 = invoke_formulation("rising_bubble_theta", dc,
                                     rising_bubble_theta.COURANT)
    g, sp = dc.grid, dc.model.prog_spec
    drift = [abs(weightedsum(g, sc.q, i).item() / weightedsum(g, q0, i).item()
                 - 1.0) for i in (0, 4)]
    w = lambda x: (sp.get(x, "rhou")[:, 2] / sp.get(x, "rho")).max().item()
    res.update(mass_drift_rel=drift[0], rhotheta_drift_rel=drift[1],
               max_w_initial=w(q0), max_w=w(sc.q),
               small_box_rel_err_per_var=small_reference(
                   "rising_bubble_theta",
                   rising_bubble_theta.theta_bubble_config(
                       THETA_SMALL_RESOLUTION, device="cuda"),
                   rising_bubble_theta.COURANT))
    emit("formulation_invoke", **res)
    check(max(drift) <= THETA_DRIFT_TOL, ("theta drift", drift))
    check(res["max_w"] > res["max_w_initial"], ("theta bubble w", res))
    check(max(res["small_box_rel_err_per_var"]) <= FORMULATION_TOL,
          ("theta small box", res["small_box_rel_err_per_var"]))
    keep(res)
    keep(anelastic_formulation())
    dc = cfsite_amip.cfsite_config(device="cuda")
    check(dc.grid.nelem == CFSITE_ELEMENTS, ("cfsite", dc.grid.nelem))
    res, sc, _ = invoke_formulation("cfsite_amip", dc, cfsite_amip.COURANT,
                                    (bomex_les.tmar_callback(dc),))
    res.update(q_tot_range(sc))
    emit("formulation_invoke", **res)
    check(res["q_tot_min"] >= 0.0, ("cfsite q_tot", res["q_tot_min"]))
    keep(res)
    torch.cuda.empty_cache()
    emit("atmos_formulations_phase", card=nvidia_smi(),
         seconds=time.perf_counter() - t_phase, **out)
    return out


def phase_edmf_gate() -> dict:
    """``--edmf-gate``: the stored-profile gate of tests/test_edmf.py's
    ``test_sbl_edmf_mse_gate`` on the card: the coupled EDMF single stack
    at the example's width, the refvals' NSTEPS LSRK144 steps with TMAR,
    then each budgeted variable's profile (nodes ordered by height,
    stably) against tests/refvals/edmf_sbl_profiles.py: MSE =
    mean((got − ref)²) / (mean(ref²) + 1e-30) beside its budget; every
    failure reported before the run exits non-zero."""
    t_phase = time.perf_counter()
    rv = load_refvals("edmf_sbl_profiles")
    model, dg, grid, q, aux = bomex_edmf.sbl_stack("coupled", device="cuda")
    step, dt = bomex_edmf.stepper(model, dg, grid)
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(rv.NSTEPS):
        q, aux = step(q, aux, i * dt)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    z = grid.coords[..., 2].reshape(-1).cpu().numpy()
    order = np.argsort(z, kind="stable")
    names = model.prog_spec.flattened_names()
    qn = q.cpu().numpy()
    mse, failures = {}, []
    for v, budget in rv.budgets.items():
        got = qn[:, names.index(v)].reshape(-1)[order]
        ref = rv.profiles[v]
        mse[v] = float(np.mean((got - ref) ** 2)
                       / (np.mean(ref ** 2) + 1e-30))
        if mse[v] > budget:
            failures.append((v, mse[v], budget))
    res = dict(card=nvidia_smi(), case="coupled", elements=grid.nelem,
               steps=rv.NSTEPS, dt_s=dt, seconds=wall,
               ms_per_step=1e3 * wall / rv.NSTEPS,
               mse={v: [mse[v], b] for v, b in rv.budgets.items()},
               failures=failures, finite=bool(torch.isfinite(q).all()),
               launches=counts)
    emit("edmf_gate", **res)
    emit("edmf_gate_phase", card=nvidia_smi(),
         seconds=time.perf_counter() - t_phase)
    check(res["finite"], ("EDMF gate", "state not finite"))
    check(not failures, ("EDMF gate", failures))
    check_launches(counts, expected_launches({}, 0))
    return res


# --- the remaining time integrators and solvers ----------------------------

def with_winds(q0, coords, seed: int):
    """The state times 1 + 1e-3 · N(0, 1) (from ``seed``) with a 10 m/s
    solid-body wind about the polar axis (the initial state is at rest);
    ``coords`` ``[E, Np, 3]``."""
    q = perturbed(q0, seed)
    x, y = coords[..., 0], coords[..., 1]
    r = torch.sqrt(x * x + y * y).clamp_min(1.0)
    u = torch.stack([-10.0 * y / r, 10.0 * x / r, torch.zeros_like(x)],
                    dim=1).to(q.dtype)
    return torch.cat([q[:, :1], q[:, :1] * u, q[:, 4:]], dim=1)


def rel_err_momentum_grouped(got, ref) -> list:
    """max |got − ref| per variable over the max |ref| of ρ, of ρu over
    its three components (the vertical one alone is the small growth of
    a state in balance) and of ρe."""
    peak = ref.abs().amax(dim=(0, 2))
    peak[1:4] = peak[1:4].max()
    return ((got - ref).abs().amax(dim=(0, 2)) / peak).tolist()


def integrator_run(solver, g, q0, aux0, dt: float, n_warm: int,
                   n_steps: int, umax_bound: float):
    """With every launch count set to 0, ``n_warm`` + ``n_steps`` steps of
    ``solver`` from (q0, aux0), the last ``n_steps`` timed; then the
    counts, and whether the state is finite, its max|u| below
    ``umax_bound`` and its ρ mass drift within MASS_TOL (no check here).
    Returns (summary, counts, final state)."""
    mass = lambda q: torch.sum(g.M.double() * q[:, 0].double()).item()
    reset_launch_counts()
    q, aux, t = q0, aux0, 0.0
    for _ in range(n_warm):
        q, aux = solver.step(q, aux, t)
        t += dt
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(n_steps):
        q, aux = solver.step(q, aux, t)
        t += dt
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    counts = launch_counts()
    finite = bool(torch.isfinite(q).all())
    umax = (q[:, 1:4] / q[:, :1]).abs().max().item()
    drift = abs(mass(q) / mass(q0) - 1.0)
    return dict(dt_s=dt, warm_steps=n_warm, steps=n_steps,
                ms_per_step=1e3 * wall / n_steps, finite=finite,
                max_abs_u=umax, max_abs_u_bound=umax_bound,
                mass_drift_rel=drift, mass_tol=MASS_TOL,
                stable=finite and umax < umax_bound and drift <= MASS_TOL,
                shape=list(q.shape)), counts, q


def stable_integrator_path(label: str, make, base, dt0: float, n_warm: int,
                           n_steps: int, umax_bound: float,
                           per_step: dict) -> dict:
    """``make(dt)`` at dt0 and its halvings (up to INTEGRATOR_DT_HALVINGS)
    until its n_warm + n_steps steps stay stable (each trial reported);
    then the launch counts of that run against ``per_step`` · steps,
    exactly.  Returns the run's summary with its counts."""
    g = base["cfg"].grid
    for k in range(INTEGRATOR_DT_HALVINGS + 1):
        dt = dt0 / 2 ** k
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solver = make(dt)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        res, counts, q = integrator_run(solver, g, base["q0"], base["aux0"],
                                        dt, n_warm, n_steps, umax_bound)
        res.update(path=label, halvings=k, setup_s=setup_s)
        emit("integrator_dt_scan", card=nvidia_smi(),
             **{key: res[key] for key in ("path", "dt_s", "halvings",
                                          "stable", "finite", "max_abs_u",
                                          "mass_drift_rel")})
        del solver, q
        if res["stable"]:
            expected = expected_launches(per_step, n_warm + n_steps)
            res.update(card=nvidia_smi(), launches=counts,
                       expected_launches=expected,
                       launches_per_step={k: v // (n_warm + n_steps)
                                          for k, v in counts.items() if v})
            emit("integrator_path", **res)
            check_launches(counts, expected)
            torch.cuda.empty_cache()
            return res
        torch.cuda.empty_cache()
    raise RuntimeError(f"chip_smoke check failed: no stable dt for {label}")


def jfnk_run(label: str, solver, base, dt: float, per_step: dict) -> dict:
    """N_WARM_JFNK + N_STEPS_JFNK steps of a Newton-Krylov solver type's
    solver with exact launch counts and the stability checks of
    :func:`integrator_run` (finite, max|u|, mass drift), reporting every
    solve's final ‖F‖ and its GMRES least-squares residual a Newton step
    (not gated: in float32 the solves stop unconverged, in the JAX
    package too)."""
    res, counts, q = integrator_run(solver, base["cfg"].grid, base["q0"],
                                    base["aux0"], dt, N_WARM_JFNK,
                                    N_STEPS_JFNK, MAX_ABS_U)
    log = getattr(solver, "residuals", None)
    if log is None:
        log = solver.solver.residuals
    n = N_WARM_JFNK + N_STEPS_JFNK
    expected = expected_launches(per_step, n)
    res.update(card=nvidia_smi(), path=label, dtype=str(q.dtype),
               solves=[dict(newton_residual=float(r), gmres_residuals=gm)
                       for r, gm in log],
               launches=counts, expected_launches=expected)
    emit("jfnk_path", **res)
    check_launches(counts, expected)
    check(res["stable"], (label, "not stable", res["finite"],
                          res["max_abs_u"], res["mass_drift_rel"]))
    return res


def small_integrators(device: str, dtype, seed: int) -> dict:
    """On the small grid (n_horz=2, n_vert=3, p4, DryBiharmonic(8 h)),
    built on the card in float32 and its twin on the CPU in float64 from
    the same geometry: each case's solver, dt and initial state (with
    winds).  The ARK tableaus take the pieces one
    ``IMEXSolverType(solver_method=DBM453VoglEtAl).make`` builds, as make
    hands them to any tableau."""
    cfg = held_suarez_config(n_horz=2, n_vert=3, poly_order=POLY,
                             dtype=torch.float32,
                             hyperdiffusion_tau=8 * 3600.0, device=CARD)
    g = cfg.grid
    if device == "cpu":
        g = grid_from_numpy(grid_to_numpy(cfg.grid), device="cpu",
                            dtype=dtype)
    dg = DGModel(cfg.model, g)
    q0, aux0 = init_ode_state(DGModel(cfg.model, cfg.grid))
    q = with_winds(q0, cfg.grid.coords, seed).to(device=device, dtype=dtype)
    aux0 = aux0.to(device=device, dtype=dtype)
    filt = HeldSuarezStepFilter(g, cfg.model).apply_vm
    dt_imex = SMALL_IMEX_CFL * min_node_distance(cfg.grid,
                                                 "horizontal") / 350.0
    dt_exp = 0.3 * min_node_distance(cfg.grid) / 350.0
    dt_mis = MULTIRATE_DT_RATIO * dt_exp
    cases = {}
    m = IMEXSolverType(solver_method=ark.DBM453VoglEtAl).make(dg, q, aux0,
                                                              dt_imex)
    if m.vm is not None:
        m.vm.surface_kernel = "pallas"
    for name in ARK_TABLEAUS:
        cases[("ark", name)] = (getattr(ark, name)(
            m.rhs_ex, m.rhs_im, m.solver, dt_imex, rhs_full=m.rhs_full,
            post_step=filt), dt_imex)
    for name in SSPRK_METHODS:
        sol = ExplicitSolverType(solver_method=getattr(ssprk, name)).make(
            dg, q, aux0, dt_exp)
        sol.post_step = filt
        if sol.vm is not None:
            sol.vm.surface_kernel = "pallas"
        cases[("ssprk", name)] = (sol, dt_exp)
    for name in MIS_METHODS:
        for fast, method in MIS_FAST.items():
            cases[("mis", f"{name}+{fast}")] = (MISSolverType(
                mis_method=getattr(mis, name), fast_method=method,
                nsubsteps=MIS_NSUBSTEPS).make(dg, q, aux0, dt_mis), dt_mis)
    split = cases[("mis", "MIS2+LSRK54")][0]
    for name in MRI_METHODS:
        cases[("mri", name)] = (getattr(mrigark, name)(
            split.slow_rhs, split.fast_rhs,
            lambda rhs, d: LSRK54CarpenterKennedy(rhs, d), MIS_NSUBSTEPS,
            dt_mis), dt_mis)
    return dict(cases=cases, q=q, aux0=aux0)


def integrator_small_reference(seed: int) -> dict:
    """INTEGRATOR_SMALL_STEPS steps of every case of
    :func:`small_integrators` on the card (float32, kernels) against the
    CPU (float64): the error relative to each variable's max, within its
    family's INTEGRATOR_SMALL_TOL and within
    INTEGRATOR_SMALL_CHANGE_FRACTION of the CPU steps' change of that
    variable, relative to the same max."""
    runs = {"card": small_integrators(CARD, torch.float32, seed),
            "cpu": small_integrators("cpu", torch.float64, seed)}
    out, change = {}, {}
    for key in runs["card"]["cases"]:
        final = []
        for side in ("card", "cpu"):
            r = runs[side]
            sol, dt = r["cases"][key]
            q, aux = r["q"], r["aux0"]
            for i in range(INTEGRATOR_SMALL_STEPS):
                q, aux = sol.step(q, aux, i * dt)
            final.append(q.double().cpu())
        label = "/".join(key)
        out[label] = err = rel_err_momentum_grouped(final[0], final[1])
        change[label] = chg = rel_err_momentum_grouped(
            runs["cpu"]["q"].double().cpu(), final[1])
        check(max(err) <= INTEGRATOR_SMALL_TOL[key[0]]
              and all(e <= INTEGRATOR_SMALL_CHANGE_FRACTION * c
                      for e, c in zip(err, chg)),
              ("small reference", key, err, chg))
    emit("integrator_small_reference", card=nvidia_smi(), n_horz=2,
         n_vert=3, poly=POLY, steps=INTEGRATOR_SMALL_STEPS,
         tol=INTEGRATOR_SMALL_TOL,
         change_fraction=INTEGRATOR_SMALL_CHANGE_FRACTION,
         rel_err_per_var=out, rel_change_per_var=change)
    return out


def jfnk_float64(base, dt: float, seed: int) -> dict:
    """HEVI and Implicit in float64 at full width on the generic operator
    with its plain stages (the kernels take float32), JFNK_F64 Newton and
    Krylov counts, N_WARM_JFNK + N_STEPS_JFNK steps each, stable, no
    launch; and one step of each on the small grid against the CPU within
    JFNK_SMALL_TOL."""
    g32, model = base["cfg"].grid, base["cfg"].model
    n_newton, n_krylov = JFNK_F64
    types = {"hevi": HEVISolverType(nonlinear_max_iterations=n_newton,
                                    linear_max_subspace_size=n_krylov),
             "implicit": ImplicitSolverType(n_newton=n_newton,
                                            n_krylov=n_krylov)}
    g = grid_from_numpy(grid_to_numpy(g32), device=CARD,
                        dtype=torch.float64)
    dg = DGModel(model, g, volume_kernel="xla", ldg_kernel="varmajor")
    b64 = dict(base, cfg=SimpleNamespace(grid=g, model=model),
               q0=base["q0"].double(), aux0=base["aux0"].double())
    out = {}
    for kind, st in types.items():
        out[kind] = jfnk_run(f"{kind}_float64", st.make(
            dg, b64["q0"], b64["aux0"], dt), b64, dt, {})
    del b64, dg
    torch.cuda.empty_cache()
    # the small grid, card against CPU, both float64
    cfg = held_suarez_config(n_horz=2, n_vert=3, poly_order=POLY,
                             dtype=torch.float64,
                             hyperdiffusion_tau=8 * 3600.0, device=CARD)
    q0, aux0 = init_ode_state(DGModel(cfg.model, cfg.grid))
    q0 = with_winds(q0, cfg.grid.coords, seed)
    dt_small = SMALL_IMEX_CFL * min_node_distance(cfg.grid,
                                                  "horizontal") / 350.0
    errs = {}
    for kind, st in types.items():
        final = []
        for dev in (CARD, "cpu"):
            grid = cfg.grid if dev == CARD else grid_from_numpy(
                grid_to_numpy(cfg.grid), device="cpu", dtype=torch.float64)
            d = DGModel(cfg.model, grid, volume_kernel="xla",
                        ldg_kernel="varmajor")
            sol = st.make(d, q0.to(dev), aux0.to(dev), dt_small)
            final.append(sol.step(q0.to(dev), aux0.to(dev), 0.0)[0].cpu())
        errs[kind] = rel_err_momentum_grouped(final[0], final[1])
    emit("jfnk_small_reference", card=nvidia_smi(), n_horz=2, n_vert=3,
         poly=POLY, dtype="float64", steps=1, newton=JFNK_F64,
         tol=JFNK_SMALL_TOL, rel_err_per_var=errs)
    for kind, err in errs.items():
        check(max(err) <= JFNK_SMALL_TOL[kind], ("JFNK small reference",
                                                 kind, err))
    return out


def numerics_examples(full: bool) -> dict:
    """The two examples: the Bryan bubble with "lsrk" and "ssprk" at its
    smoke settings (or its defaults with ``full``) through
    ``AtmosLESConfiguration`` → ``invoke``, finite, its max updraft
    reported; the time-stepping comparison at COMPARE_SMOKE (its defaults
    with ``full``) in float64, each solver's error against the control
    below 0.5.  Neither launches a kernel (the bubble's closure takes the
    generic gradient path; the comparison in float64 the plain operator,
    timestepping_compare.run_menu)."""
    driver_init(show_updates="never")
    out = {}
    resolution, timeend = BRYAN_DEFAULTS if full else BRYAN_SMOKE
    for fm in ("lsrk", "ssprk"):
        reset_launch_counts()
        t0 = time.perf_counter()
        sc, w = rising_bubble_bryan.run(fm, resolution, timeend,
                                        device=CARD)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
        steps = round(timeend / sc.dt)
        res = dict(card=nvidia_smi(), fast_method=fm, resolution=resolution,
                   timeend=timeend, elements=sc.dg.grid.nelem, dt_s=sc.dt,
                   steps=steps, seconds=wall,
                   ms_per_step=1e3 * wall / steps, max_updraft_m_s=w,
                   finite=True, launches=counts)
        emit("example_rising_bubble_bryan", **res)
        check_launches(counts, expected_launches({}, 0))
        check(math.isfinite(w) and w > 0.0, ("bubble updraft", w))
        out[f"bryan_{fm}"] = res
    resolution, timeend = COMPARE_DEFAULTS if full else COMPARE_SMOKE
    reset_launch_counts()
    rows, dt_ac = timestepping_compare.run_menu(timeend, resolution,
                                                device=CARD)
    counts = launch_counts()
    emit("example_timestepping_compare", card=nvidia_smi(),
         timeend=timeend, resolution=resolution, dtype="float64",
         dt_acoustic_s=dt_ac, rows=rows, launches=counts)
    check_launches(counts, expected_launches({}, 0))
    timestepping_compare.check(rows[1:])
    check(rows[0]["finite"], "the comparison's control is not finite")
    out["timestepping_compare"] = {r["name"]: r["seconds"] for r in rows}
    return out


def phase_time_integrators(seed: int, full_examples: bool = False) -> dict:
    """The remaining time integrators and solvers at full width on dry
    Held-Suarez (module docstring), each through its solver type's
    ``make`` with exact launch counts: IMEX with each other ARK tableau
    (var-major, "pallas"), LSRK54 replaced by each SSPRK (var-major,
    "pallas"; SSPRK33 on the generic operator too), MIS2, MIS3C and
    MISRK3 with LSRK54 and SSPRK33 fast steps, MRI-GARK ERK33a and ERK45a
    on the MIS split, each at its path's dt or the largest stable
    halving; HEVI and Implicit in float32 with the kernels (the JAX
    defaults; their unconverged ‖F‖ a reference caveat, reported) and in
    float64 on the plain operator, each stable; the small grid against
    the CPU; the examples.
    Returns each path's ms a step."""
    check(torch.backends.cuda.matmul.allow_tf32 is False, "TF32 matmul on")
    t_phase = time.perf_counter()
    table = load_refstats()
    base = build_generic_base()
    g, dg = base["cfg"].grid, base["dg"]
    q0, aux0, hsf = base["q0"], base["aux0"], base["hsf"]
    dt_imex = 0.1 * min_node_distance(g, "horizontal") / 350.0
    if abs(table.dt - dt_imex) < 1e-5 * dt_imex:
        dt_imex = table.dt
    dt_exp = 0.3 * min_node_distance(g) / 350.0
    ms = {}

    def imex(name):
        def make(dt):
            sol = IMEXSolverType(solver_method=getattr(ark, name)).make(
                dg, q0, aux0, dt)
            sol.post_step = hsf.apply_vm
            sol.rhs_full.surface_kernel = "pallas"
            return sol
        return make

    for name, s in ARK_TABLEAUS.items():
        per_step = {**{k: s for k in EXPLICIT + SURFACE},
                    "to_blocks_vm": s, "from_blocks_vm": s - 1}
        ms[name] = stable_integrator_path(
            f"imex/{name}", imex(name), base, dt_imex, N_WARM_IMEX,
            N_STEPS_IMEX, MAX_ABS_U, per_step)["ms_per_step"]

    def explicit(name, layout):
        def make(dt):
            sol = ExplicitSolverType(solver_method=getattr(ssprk, name),
                                     state_layout=layout).make(dg, q0, aux0,
                                                               dt)
            sol.post_step = hsf.apply_vm
            if sol.vm is not None:
                sol.vm.surface_kernel = "pallas"
            return sol
        return make

    for name, s in SSPRK_METHODS.items():
        ms[name] = stable_integrator_path(
            f"explicit/{name}", explicit(name, "vm"), base, dt_exp,
            N_WARM_SSP, N_STEPS_SSP, MAX_ABS_U,
            {k: s for k in EXPLICIT + SURFACE})["ms_per_step"]
    ms["SSPRK33ShuOsher/grid"] = stable_integrator_path(
        "explicit_grid/SSPRK33ShuOsher", explicit("SSPRK33ShuOsher", "grid"),
        base, dt_exp, N_WARM_SSP, N_STEPS_SSP, MAX_ABS_U,
        {k: 3 for k in (DRY,) + CHAIN})["ms_per_step"]

    dt_mis = MULTIRATE_DT_RATIO * dt_exp
    for name, s in MIS_METHODS.items():
        for fast, method in MIS_FAST.items():
            make = (lambda dt, name=name, method=method: MISSolverType(
                mis_method=getattr(mis, name), fast_method=method,
                nsubsteps=MIS_NSUBSTEPS).make(dg, q0, aux0, dt))
            ms[f"{name}+{fast}"] = stable_integrator_path(
                f"mis/{name}+{fast}", make, base, dt_mis, N_WARM_MIS,
                N_STEPS_MIS, MULTIRATE_MAX_ABS_U,
                {k: s - 1 for k in (DRY,) + CHAIN})["ms_per_step"]
    for name, s in MRI_METHODS.items():
        def make(dt, name=name):
            split = MISSolverType(nsubsteps=MIS_NSUBSTEPS).make(dg, q0, aux0,
                                                                dt)
            return getattr(mrigark, name)(
                split.slow_rhs, split.fast_rhs,
                lambda rhs, d: LSRK54CarpenterKennedy(rhs, d), MIS_NSUBSTEPS,
                dt)
        ms[name] = stable_integrator_path(
            f"mrigark/{name}", make, base, dt_mis, N_WARM_MIS, N_STEPS_MIS,
            MULTIRATE_MAX_ABS_U,
            {k: s for k in (DRY,) + CHAIN})["ms_per_step"]

    # HEVI and Implicit in float32 through the kernels, the JAX defaults:
    # per step the full operator 2 (HEVI) or n(1 + k) + 2 (Implicit)
    # times, HEVI's vertical one 4 + n(1 + k) + 1 times (its chain too)
    hevi, implicit = HEVISolverType(), ImplicitSolverType()
    nk = hevi.nonlinear_max_iterations * (
        1 + hevi.linear_max_subspace_size)
    ms["HEVI/float32"] = jfnk_run(
        "hevi_float32", hevi.make(dg, q0, aux0, dt_imex), base, dt_imex,
        {DRY: 2, **{k: 2 + 4 + nk + 1 for k in CHAIN}})["ms_per_step"]
    nk = implicit.n_newton * (1 + implicit.n_krylov)
    ms["Implicit/float32"] = jfnk_run(
        "implicit_float32", implicit.make(dg, q0, aux0, dt_imex), base,
        dt_imex, {k: nk + 2 for k in (DRY,) + CHAIN})["ms_per_step"]
    torch.cuda.empty_cache()
    f64 = jfnk_float64(base, dt_imex, seed)
    ms["HEVI/float64"] = f64["hevi"]["ms_per_step"]
    ms["Implicit/float64"] = f64["implicit"]["ms_per_step"]
    del base
    torch.cuda.empty_cache()

    integrator_small_reference(seed)
    examples = numerics_examples(full_examples)
    emit("time_integrators_phase", card=nvidia_smi(),
         seconds=time.perf_counter() - t_phase, ms_per_step=ms,
         examples=examples)
    return dict(ms_per_step=ms, examples=examples)


def hold(name, args, kw) -> dict:
    """The kernel on ``args`` and on their first TAIL_E elements against
    two references, its plain version on the card (float32) and in
    float64 (on the CPU, from the same float32 inputs): per output max|Δ|
    and max|reference| of each, and the card's plain version against
    float64; raises if an output is not finite or off by more than
    KERNEL_TOL · max|reference| from both references."""
    wrapper, plain, _, _ = KERNELS[name]
    res = {}
    for key, a in (("all", args), ("tail", first_elements(args, TAIL_E))):
        out, card = wrapper(*a, **kw), plain(*a, **kw)
        f64 = plain(*on_cpu_f64(a), **kw)
        out, card, f64 = (o if isinstance(o, tuple) else (o,)
                          for o in (out, card, f64))
        refs = {"card_plain": card, "float64": f64}
        errs = {r: max_abs_diffs(out, ref) for r, ref in refs.items()}
        scales = {r: [x.abs().max().item() for x in ref]
                  for r, ref in refs.items()}
        held_by = [[r for r in refs if errs[r][i] <= KERNEL_TOL
                    * scales[r][i]] for i in range(len(out))]
        res[key] = dict(
            max_abs_err_per_output=errs, max_abs_ref_per_output=scales,
            card_plain_err_f64_per_output=max_abs_diffs(card, f64),
            held_by=held_by)
        check(all(bool(torch.isfinite(o).all()) for o in out),
              (name, key, "output not finite"))
        check(all(held_by), (name, key, "kernel vs plain", errs, scales))
    return res


def phase_kernel_orders(seed: int):
    """The staged kernels at each of EDGE_ORDERS on a small grid's
    perturbed state (48 elements: a partial last tile at 4 and at 2
    elements a tile): K1-K4 and the volume kernel with and without F₂ on
    the var-major RHS's inputs, the dry kernel on the generic RHS's and the
    fused remainder's, each held on all elements and on the first TAIL_E;
    then the var-major RHS and the generic RHS with their defaults (the
    kernels) against the ones with every stage's plain version."""
    for poly in EDGE_ORDERS:
        cfg = held_suarez_config(*EDGE_GRID, poly, dtype=torch.float32,
                                 hyperdiffusion_tau=8 * 3600.0,
                                 device="cuda")
        dg = DGModel(cfg.model, cfg.grid)
        q0, aux0 = init_ode_state(dg)
        q = perturbed(q0, seed)
        aux = cfg.model.update_auxiliary_state(q, aux0, cfg.grid)
        rhs = VarMajorRHS(dg)
        glv, inputs = chain_inputs(rhs, q, aux0)
        cases = {name: (name, inputs[name], {}) for name in CHAIN}
        for f2 in (True, False):
            cases["fused_volume_tendency_vm" + ("" if f2 else "_no_f2")] = (
                "fused_volume_tendency_vm",
                inputs["fused_volume_tendency_vm"], volume_kwargs(rhs, f2))
        _, _, dry = dry_inputs(dg, q, aux)
        cases.update({entry: (DRY, args, kw)
                      for entry, (args, kw) in dry.items()})
        rem_cases, rhs_errs = remainder_order_cases(dg, q, aux0, moist=False)
        cases.update(rem_cases)
        held = {entry: hold(name, args, kw)
                for entry, (name, args, kw) in cases.items()}
        plain_generic = DGModel(cfg.model, cfg.grid,
                                volume=KERNELS[DRY][1],
                                chain_stages=ldg_kernel.PLAIN)
        rhs_errs.update(
            var_major=per_var_err(rhs(q, aux0, 0.0)[0],
                                  plain_rhs(dg, "xla")(q, aux0, 0.0)[0]),
            generic=per_var_err(dg(q, aux0, 0.0)[0],
                                plain_generic(q, aux0, 0.0)[0]))
        torch.cuda.synchronize()
        emit("kernel_orders", poly=poly, Np=cfg.grid.Np,
             elements=cfg.grid.nelem, tail_elements=TAIL_E, tol=KERNEL_TOL,
             kernels=held, rhs_rel_err_per_var=rhs_errs,
             rhs_tol=GENERIC_RHS_TOL, remainder_rhs_tol=REMAINDER_TOL)
        for name, err in rhs_errs.items():
            check(all(torch.isfinite(torch.tensor(err)))
                  and max(err) <= order_rhs_tol(name),
                  ("RHS at order", poly, name, err))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--skip-moist", action="store_true",
                    help="leave out the moist baroclinic wave (to run this "
                    "script in a checkout of a commit without it)")
    ap.add_argument("--edmf-gate", action="store_true",
                    help="also run the EDMF stored-profile gate (400 "
                    "coupled LSRK144 steps of the single stack): minutes "
                    "more")
    ap.add_argument("--numerics-examples", action="store_true",
                    help="run the numerics examples at their defaults: "
                    "the Bryan bubble at 250 m to 100 s, the time-stepping "
                    "comparison to 50 s (minutes more)")
    ap.add_argument("--julia-gates", action="store_true",
                    help="also run the four 5-day Julia split01 gates "
                    "(simple_box_ivd, simple_box_2dt, simple_box_rk3, the "
                    "double gyre): minutes more")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    emit("options", seed=args.seed, skip_moist=args.skip_moist,
         julia_gates=args.julia_gates, edmf_gate=args.edmf_gate,
         numerics_examples=args.numerics_examples)
    start, seconds = time.perf_counter(), {}

    def timed(name, phase, *a, **kw):
        """``phase(*a, **kw)``, its wall seconds kept under ``name``."""
        t0 = time.perf_counter()
        out = phase(*a, **kw)
        seconds[name] = time.perf_counter() - t0
        return out

    timed("device", phase_device)
    timed("build", phase_build)
    explicit = timed("main_path", phase_main_path, args.seed)
    timed("no_hyperdiffusion", phase_no_hyperdiffusion, args.seed)
    imex = timed("imex", phase_imex, args.seed, explicit)
    generic = timed("generic", phase_generic, args.seed)
    remainder = timed("remainder", phase_remainder, args.seed, moist=False)
    moist = None if args.skip_moist else timed("moist", phase_moist,
                                               args.seed)
    if moist:
        moist_rem = timed("moist_remainder", phase_remainder, args.seed,
                          moist=True)
        remainder["kernels"].update(moist_rem["kernels"])
        remainder["launches"].update(moist_rem["launches"])
    tracers = None if args.skip_moist else timed(
        "moist_tracers", phase_moist_tracers, args.seed)
    vortex = timed("vortex", phase_vortex, args.seed)
    les = timed("les_bubble", phase_les_bubble, args.seed)
    les_inviscid = timed("les_inviscid", phase_les_inviscid, args.seed)
    les_forcing = timed("les_forcing", phase_les_forcing)
    ocean = timed("ocean", phase_ocean)
    split_explicit = timed("split_explicit", phase_split_explicit)
    split01 = timed("split01", phase_split01, args.seed)
    if args.julia_gates:
        timed("julia_gates", phase_julia_gates)
    gcm = timed("gcm_driver", phase_gcm_driver)
    diagnostics = timed("diagnostics", phase_diagnostics)
    formulations = timed("atmos_formulations", phase_atmos_formulations)
    if args.edmf_gate:
        timed("edmf_gate", phase_edmf_gate)
    integrators = timed("time_integrators", phase_time_integrators,
                        args.seed, args.numerics_examples)
    timed("kernel_orders", phase_kernel_orders, args.seed)
    if moist:
        timed("moist_kernel_orders", phase_moist_kernel_orders, args.seed)
    timed("vortex_kernel_orders", phase_vortex_kernel_orders, args.seed)
    emit("phase_seconds", card=nvidia_smi(),
         total=time.perf_counter() - start, **seconds)
    emit("surface_modes", card=nvidia_smi(),
         vortex_ms_per_step=vortex["ms_per_step"],
         les_ms_per_step=les["ms_per_step"], les_setup_s=les["setup_s"],
         les_peak_memory_bytes=les["peak_memory_bytes"],
         les_inviscid_ms_per_step=les_inviscid["ms_per_step"],
         les_forcing=les_forcing,
         ocean=ocean, split_explicit=split_explicit, split01=split01,
         gcm_driver=gcm, diagnostics=diagnostics,
         atmos_formulations=formulations,
         time_integrators=integrators,
         explicit_ms_per_step=explicit["ms_per_step"],
         imex_ms_per_step=imex["ms_per_step"],
         generic_ms_per_step=generic["ms_per_step"],
         dense_acoustic_dt_s=generic["dt_s"]["dense_acoustic"],
         multirate_dt_s=generic["dt_s"]["multirate"],
         **({} if moist is None else dict(
             moist_explicit_ms_per_step=moist["explicit_ms_per_step"],
             moist_imex_ms_per_step=moist["imex_ms_per_step"],
             moist_imex_dt_s=moist["imex_dt_s"],
             tracer_ms_per_step=tracers["ms_per_step"],
             tracer_setup_s=tracers["setup_s"],
             tracer_peak_memory_setup_bytes=tracers[
                 "peak_memory_setup_bytes"],
             tracer_imex_dt_s=tracers["imex_dt_s"])))
    # each kernel's launches from the run of its path: the var-major IMEX
    # step with "pallas" (all nine earlier kernels), the dry kernel from
    # the grid-layout IMEX step and its remainder branch from the dense one
    results = {**explicit["kernels"], **imex["kernels"],
               **generic["kernels"]}
    entries = [(name, name, imex["launches"][name])
               for name in KERNELS if name != DRY]
    entries += [(DRY, DRY, generic["launches"]["imex"][DRY]),
                (DRY + "_remainder", DRY,
                 generic["launches"]["dense"][DRY])]
    # the moist branches, with launches from the moist IMEX step with
    # "pallas" and, K1-K4, the tracer path's banded IMEX step beside it;
    # the layouts at nvars = 9 from that step
    if moist:
        results.update({name + MOIST: k
                        for name, k in moist["kernels"].items()})
        tr = tracers["launches"]["imex"]
        entries += [(name + MOIST, name, moist["launches"][name]
                     + (tr[name] if name in CHAIN else 0))
                    for name in EXPLICIT + SURFACE + LAYOUT]
        results.update({name + TRACERS: tracers["kernels"][name + TRACERS]
                        for name in LAYOUT})
        entries += [(name + TRACERS, name, tr[name]) for name in LAYOUT]
    # the remainder branches: the var-major RHS's with launches from its
    # remainder RHS runs; the dry kernel's vertical acoustic branch from
    # the dense acoustic IMEX path, its every-direction acoustic-gravity
    # branch from the multirate path, the others from the generic
    # remainder RHS runs
    results.update(remainder["kernels"])
    path_launches = {
        rem_entry(DRY, "vertical:acoustic"):
            generic["launches"]["dense_acoustic"][DRY],
        rem_entry(DRY, "every:gravity"):
            generic["launches"]["multirate"][DRY]}
    entries += [(entry, entry.split("[")[0],
                 path_launches.get(entry, remainder["launches"].get(entry)))
                for entry in remainder["kernels"]]
    # the branches without the reference pressure, with launches from the
    # vortex paths: the var-major kernels' from its "pallas" run, the dry
    # kernel's from the grid-layout Rusanov run
    results.update(vortex["kernels"])
    entries += [(entry, entry.split("[")[0], vortex["launches"][entry])
                for entry in vortex["launches"]]
    # the inviscid bubble's: the var-major kernels' launches from its
    # "pallas" run, the dry kernel's from its grid-layout run
    results.update(les_inviscid["kernels"])
    entries += [(entry, entry.split("[")[0], les_inviscid["launches"][entry])
                for entry in les_inviscid["launches"]]
    print(nvidia_smi(), flush=True)
    print(json.dumps({"kernels": [{
        "name": entry, "route": "cuda",
        "source": f"climatemachine_tpu_torch/csrc/{KERNELS[name][2]}",
        "replaces": KERNELS[name][3], "launches": launches,
        "max_abs_err": k["max_abs_err"], "ms": k["ms"],
        "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
        "bound_by": k["bound_by"], "library_ms": k.get("library_ms"),
        **({"bound_dense_ms": k["bound_dense_ms"]}
           if "bound_dense_ms" in k else {}),
        "timing": k["timing"]}
        for entry, name, launches in entries
        for k in [results[entry]]]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
