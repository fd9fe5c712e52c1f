"""config.json persistence (reference: FunscriptFlow.pyw:2266-2312; the
port's copy of the JAX package's ``utils/config.py``).

The reference saves/loads all GUI settings to ``config.json`` next to the
app (save never wired to a UI button — the GUI exposes it). Keys match
``Params`` field names (``Params.to_dict``); ``Params.from_dict`` ignores
unknown keys on load, so configs from newer or older versions, and those
the JAX package saved (with its ``use_pallas``/``warp_backend`` and backend
``TPU``), load.
"""

from __future__ import annotations

import json
import os

from .params import Params

__all__ = ["save_config", "load_config", "DEFAULT_CONFIG_PATH"]

DEFAULT_CONFIG_PATH = "config.json"


def save_config(params: Params, path: str = DEFAULT_CONFIG_PATH) -> None:
    with open(path, "w") as f:
        json.dump(params.to_dict(), f, indent=2)


def load_config(path: str = DEFAULT_CONFIG_PATH) -> Params:
    """Load params; missing/corrupt file -> defaults (reference tolerates
    absent config on startup, :2283-2295)."""
    if not os.path.exists(path):
        return Params()
    try:
        with open(path) as f:
            return Params.from_dict(json.load(f))
    except Exception:
        return Params()
