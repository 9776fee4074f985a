"""PyTorch/CUDA port of climatemachine_tpu for NVIDIA Hopper (H100).

The JAX package ``climatemachine_tpu`` is the reference this package is
held against (tests/test_torch_*.py).  This package imports torch and
numpy only, never JAX or the JAX package.

Slice 1 covers the explicit dry Held-Suarez step: grid build, model and
initial state, the var-major RHS (dg/fast_rhs.py) whose volume tendency
is a hand-written CUDA kernel (csrc/volume_vm.cu), the every-step
exponential filter and LSRK54.  Entry points take ``device=None``,
meaning ``"cuda"``; tests pass ``device="cpu"``, where every kernel
wrapper runs its plain PyTorch version.
"""

from climatemachine_tpu_torch.device import resolve_device  # noqa: F401
