"""Device lists for the port's data and sequence parallelism.

The JAX package builds a ``jax.sharding.Mesh`` and lets XLA compile the
collectives; the port's counterpart is a plain list of ``torch.device``s
that one process drives: each flow window, and each shard of the signal,
is a tensor on its device (``parallel.dp``, ``parallel.signal_sp``).
"""

from __future__ import annotations

import torch

__all__ = ["make_mesh"]


def make_mesh(n: int, device=None) -> list:
    """A list of ``n`` devices.

    ``device`` ``None`` or of type ``cuda``: ``cuda:0`` .. ``cuda:n-1``;
    raises when fewer CUDA devices exist (nothing falls back to the CPU).
    ``device="cpu"``: ``[cpu] * n``, the counterpart of the JAX package's
    virtual CPU mesh, which the tests ask for.
    """
    if n < 1:
        raise ValueError(f"a mesh needs at least one device, got {n}")
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return [torch.device("cpu")] * n
    if dev.type != "cuda":
        raise ValueError(f"unsupported mesh device type: {dev.type}")
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < n:
        raise RuntimeError(f"Requested {n} CUDA devices, only {have} "
                           "available")
    return [torch.device("cuda", i) for i in range(n)]
