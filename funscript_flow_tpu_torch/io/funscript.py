"""Funscript JSON emitter/loader — the output format contract.

``{"version": "1.0", "actions": [{"at": ms, "pos": 0-100}, ...]}`` written
with ``indent=2`` (reference: FunscriptFlow.pyw:1391-1394). ``pos`` is
already inverted by the signal chain's emitter.
"""

from __future__ import annotations

import json

__all__ = ["write_funscript", "load_funscript", "funscript_path"]


def funscript_path(video_path: str) -> str:
    import os

    base, _ = os.path.splitext(video_path)
    return base + ".funscript"


def write_funscript(path: str, actions: list) -> None:
    with open(path, "w") as f:
        json.dump({"version": "1.0", "actions": actions}, f, indent=2)


def load_funscript(path: str) -> dict:
    with open(path) as f:
        return json.load(f)
