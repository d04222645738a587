"""Device selection for the entry points.

Entry points run on CUDA unless the caller names another device; without a
GPU they raise instead of quietly running on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless ``device`` says
    otherwise.  Raises when CUDA is wanted and absent.

    On CUDA, TF32 is turned off for matmuls and convolutions: it keeps about
    three decimal digits, and the parity of the float32 hot path with the
    reference relies on full float32 arithmetic."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev
