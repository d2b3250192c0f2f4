"""Device resolution and the fp32 guard shared by every entry point of the
port."""
from __future__ import annotations

import contextlib

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``torch.device`` for ``device``; raises when a CUDA device is asked
    for and no card is present (there is no silent CPU fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path")
    return dev


@contextlib.contextmanager
def fp32_exact():
    """Run the float path with every sum in IEEE fp32: TF32 off for cuDNN
    convolutions and for matmuls, and no reduced-precision reduction in
    bf16 or fp16 matmuls (cuBLAS may otherwise sum split-K partials in the
    16-bit type), whatever the caller's globals say.  PyTorch's defaults
    let cuDNN use TF32 and cuBLAS reduce in 16 bits; the reference does
    neither.  The caller's settings are put back on exit.  Usable as a
    decorator."""
    mm = torch.backends.cuda.matmul
    saved = (torch.backends.cudnn.allow_tf32, mm.allow_tf32,
             mm.allow_bf16_reduced_precision_reduction,
             mm.allow_fp16_reduced_precision_reduction)
    torch.backends.cudnn.allow_tf32 = False
    mm.allow_tf32 = False
    mm.allow_bf16_reduced_precision_reduction = False
    mm.allow_fp16_reduced_precision_reduction = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32, mm.allow_tf32,
         mm.allow_bf16_reduced_precision_reduction,
         mm.allow_fp16_reduced_precision_reduction) = saved
