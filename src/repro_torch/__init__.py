"""PyTorch + CUDA port of the HQP serving path, for NVIDIA Hopper.

Mirrors the layout of the JAX package (``configs``, ``compress``,
``kernels``, ``models``, ``serving``, ``launch``) and never imports it: the
JAX package is the reference the tests hold this one against.

Entry points (``Engine``, ``serial_decode``, ``init_params``,
``launch.checkpoint.load_artifact``, ``python -m repro_torch.launch.serve``,
``launch.train`` and ``launch.quickstart``) run on the card unless the
caller passes ``device="cpu"``; see ``resolve_device``.
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means the card. It raises when CUDA is absent instead of
    quietly picking the CPU: a CPU run is asked for by name."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run the plain versions")
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
