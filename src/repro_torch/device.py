"""The port's one device rule: ``"cuda"`` unless the caller says otherwise,
and never a silent fall back to the CPU."""

from __future__ import annotations

from typing import Union

import torch

Device = Union[str, torch.device]


def resolve_device(device: Device = "cuda") -> torch.device:
    """``device`` as a `torch.device`; raises when it names CUDA and no card
    is present (pass ``device="cpu"`` to run the plain PyTorch path)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: no CUDA device is available; pass device='cpu' to "
            "run the plain PyTorch versions of the kernels"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"repro_torch runs on 'cuda' or 'cpu', not {dev}")
    return dev


def to_numpy(x):
    """A tensor (any device) or array-like as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    import numpy as np

    return np.asarray(x)
