"""funscript_flow_tpu_torch — the PyTorch/CUDA port of funscript_flow_tpu.

Video in, ``.funscript`` out, on an NVIDIA GPU: host decode feeds uint8
grayscale frame windows to the card, pyramidal Farnebäck flow (or DIS flow,
``backend="DIS"``) and the per-pair reductions run there (the flows' hot
steps are five hand-written CUDA kernels, ``csrc/``), and the signal chain
emits the funscript: the NumPy host chain, or for clips of 65,536 samples
or more the device chain. Same module layout as the JAX package, so each
counterpart is easy to find:

  io/        host decode, funscript JSON
  ops/       Farnebäck flow, reductions, signal chains (host and device),
             cuda/ kernel wrappers
  models/    DIS flow, the per-window flow program and its streaming driver
  runtime/   native C++ decode pump and clip encoder (libav; built with
             the system compiler at first use)
  utils/     params, config, logging, strings
  runner     per-video driver + headless folder runner
  worker     background batch worker (the GUI's)
  gui/       tkinter desktop GUI and preview
  cli        headless entry point (no input: the GUI)

The port imports torch, numpy and the standard library only (cv2 and
tkinter inside the functions that need them): nothing of JAX and nothing of
the JAX package. Every entry point runs on ``cuda`` unless
the caller asks for ``"cpu"``; there is no silent fallback.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"

__all__ = ["default_device"]


def default_device(device=None) -> torch.device:
    """The device an entry point runs on.

    ``None`` or ``"cuda"`` means the first CUDA device, and raises
    ``RuntimeError`` when CUDA is absent; ``"cpu"`` (what the tests pass)
    is honoured as asked. Any other torch device string is passed through
    with the same CUDA check.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", 0)
    return dev
