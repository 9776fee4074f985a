"""PyTorch/CUDA port of climatemachine_tpu for NVIDIA Hopper (H100).

The JAX package ``climatemachine_tpu`` is the reference this package is
held against (tests/test_torch_*.py).  This package imports torch and
numpy only, never JAX or the JAX package.

It covers the dry Held-Suarez step, with or without DryBiharmonic
hyperdiffusion: grid build, model and initial state, the var-major RHS
(dg/fast_rhs.py) whose volume tendency (csrc/volume_vm.cu) and
hyperdiffusion chain (csrc/ldg_chain.cu) are hand-written CUDA kernels,
the every-step exponential filter, LSRK54, and the IMEX step
(driver/solver_types.py ``IMEXSolverType``: ARK2GKC with the
block-tridiagonal column solver of the vertical linear operator, whose
grid↔column-block conversions are CUDA kernels, csrc/column_layout.cu);
both steps also on the generic DG operator (dg/spatial.py ``DGModel``,
the JAX package's "grid" layout, and the dense column solver on the
fused IMEX remainder), whose volume tendency is the dry kernel
(dg/dry_volume_kernel.py, a branch of csrc/volume_vm.cu).  Entry points take
``device=None``, meaning ``"cuda"``; tests pass ``device="cpu"``, where
every kernel wrapper runs its plain PyTorch version.  Beside the
atmosphere it runs the ocean box GCM (``ocean/``: the hydrostatic
Boussinesq model on the generic operator, float64, with its stack
integrals and vertical filters, which are plain PyTorch as they are XLA
code in the JAX package).
"""

from climatemachine_tpu_torch.device import resolve_device  # noqa: F401
