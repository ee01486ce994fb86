"""Device resolution (CUDA by default, the CPU only when asked for) and
the f32 precision guard."""

from __future__ import annotations

import contextlib
from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """'cuda' (the default) or 'cpu' -> torch.device.

    Raises when CUDA is asked for, or defaulted to, and absent: the port
    never falls back to the CPU on its own.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain versions on the CPU")
    return dev


@contextlib.contextmanager
def no_tf32():
    """Full f32 convolutions and matmuls inside, the caller's flags after.

    compute_dtype='float32' means f32: neither cuDNN (which rounds to TF32 by
    default) nor cuBLAS may drop to TF32 on the card.
    """
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
