"""Device selection for the package's entry points.

Entry points run on the card unless the caller asks for the CPU.  There is
no silent fallback: asking for CUDA on a machine without a card raises.
"""
import torch


def resolve_device(device=None) -> torch.device:
    """`device` (default "cuda") as a `torch.device` with its index, checked to exist."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA was requested but torch.cuda.is_available() is False; "
                "pass device='cpu' to run on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
