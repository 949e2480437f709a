"""The device rule shared by every entry point of the port.

Entry points take ``device=`` and default to ``"cuda"``. Without CUDA they
raise unless the caller asked for the CPU: there is no silent fallback
anywhere in the port. Kernel wrappers decide by the device of the tensors
they are given (a CPU tensor takes the plain PyTorch version, a CUDA tensor
launches the kernel or raises).
"""

from __future__ import annotations

import torch


def resolve_device(device: "str | torch.device" = "cuda") -> torch.device:
    """``device`` as a ``torch.device`` (``"cuda"`` becomes the current
    card, ``cuda:N``); raises if it names CUDA and no card is visible.

    Also pins float32 matmuls to full precision. PyTorch's defaults already
    keep cuBLAS matmuls in IEEE f32, but a library or a user may have turned
    TF32 on; k-means, the coarse assignment and the exact re-rank need the
    full 24-bit mantissa (SIFT-scale inner products reach 8.3e6, which TF32's
    10-bit mantissa cannot hold), so the port turns it off for both cuBLAS
    and cuDNN here, at every entry point."""
    dev = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU"
        )
    # name the card: tensors report cuda:N, and devices compare by index
    return dev if dev.index is not None else torch.device(
        "cuda", torch.cuda.current_device()
    )
