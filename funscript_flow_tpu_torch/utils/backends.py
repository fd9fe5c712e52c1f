"""Backend/device detection (reference: get_available_backends/get_gpu_info,
FunscriptFlow.pyw:32-100; the port's counterpart of the JAX package's
``utils/backends.py``).

The reference probes cv2 for CUDA device counts, OpenCL availability and
the DNN module; the port's equivalents are PyTorch's CUDA inventory and
the DIS algorithm (always available: PyTorch ops, with their plain twins on
the CPU), and the native C++ decode runtime (built at first use).
"""

from __future__ import annotations

import torch

__all__ = ["get_available_backends", "get_device_info"]


def get_available_backends() -> dict:
    """{backend_name: available} for every selectable backend."""
    from .. import runtime

    return {"CUDA": torch.cuda.is_available(), "DIS": True, "CPU": True,
            "native_decode": runtime.available()}


def get_device_info() -> str:
    """Human-readable accelerator inventory (reference's get_gpu_info
    analog): each CUDA device's name, compute capability and memory."""
    if not torch.cuda.is_available():
        return "CUDA: not available (torch " + torch.__version__ + ")"
    lines = []
    for i in range(torch.cuda.device_count()):
        p = torch.cuda.get_device_properties(i)
        lines.append(f"cuda:{i}: {p.name} (sm_{p.major}{p.minor}, "
                     f"{p.total_memory / 2**30:.1f} GiB)")
    lines.append(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    return "\n".join(lines)
