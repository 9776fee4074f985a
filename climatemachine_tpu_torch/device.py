"""Device selection and numerical setup shared by every entry point."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``"cuda"``.  A CUDA device without a card raises
    RuntimeError: nothing carries on silently on the CPU.

    On CUDA, TF32 is switched off for matmuls and cuDNN: every
    contraction of the port runs in full float32, as the JAX package
    pins ``Precision.HIGHEST`` (its worst incident was a reduced-
    precision float32 dot)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' explicitly "
                "to run the plain PyTorch versions")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


def require_full_fp32(what: str):
    """Raise RuntimeError if float32 matmuls may run in TF32 (``what``
    names the caller that needs them in full float32)."""
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError(
            f"{what} needs full float32 matmuls: set "
            "torch.backends.cuda.matmul.allow_tf32 = False and "
            "torch.set_float32_matmul_precision('highest')")
