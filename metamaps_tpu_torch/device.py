"""Device selection for the port: always explicit, never a global default.

The main path (``TorchMapperEngine``, ``mapDirectly``) runs on CUDA and
raises when no card is present; the CPU is used only when a caller names it
(the CPU tests do).
"""
from __future__ import annotations

import torch


def require_cuda(device="cuda") -> torch.device:
    """Resolve ``device``; raise if it is a CUDA device and CUDA is absent.

    ``"cpu"`` must be asked for explicitly: there is no quiet fallback."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "metamaps_tpu_torch: CUDA is not available; the mapping engine "
            "runs on a CUDA device (pass device='cpu' explicitly to run the "
            "plain PyTorch versions on the host)"
        )
    return dev
