"""Device selection for the port's entry points.

Entry points default to CUDA. Without a GPU they raise unless the caller asks
for the CPU explicitly: nothing falls back to the CPU on its own.
"""

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means CUDA; a CUDA device without a GPU raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "pita_torch entry points run on CUDA by default and no GPU is "
            "available; pass device='cpu' to run the plain PyTorch versions"
        )
    return dev
