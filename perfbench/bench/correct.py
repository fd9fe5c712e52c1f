"""What decides ``correct``: the timed path's own outputs against the
plain reference's, on the same frames.

Two numbers per compared clip, the worst over the clips:

* ``dots_gap``: the widest gap between the program's per-pair dot and the
  reference's, over the largest |dot| of the reference's clip. A cut flag
  that differs shows here: a cut pair's dot is 0.
* ``pos_gap``: the widest gap, in ``pos`` units, between the program's
  funscript (the file it wrote) and the reference's actions, both read as
  piecewise-linear curves over the union of their ``at`` times.

A clip whose pair count differs from the reference's reads ``inf``.
"""

from __future__ import annotations

import math

import numpy as np

NUMBERS = ("dots_gap", "pos_gap")


def dots_gap(dots, ref_dots) -> float:
    dots = np.asarray(dots, dtype=np.float64)
    ref = np.asarray(ref_dots, dtype=np.float64)
    if dots.shape != ref.shape or not len(ref):
        return math.inf
    scale = max(float(np.abs(ref).max()), 1e-12)
    return float(np.abs(dots - ref).max()) / scale


def pos_gap(actions, ref_actions) -> float:
    if not actions or not ref_actions:
        return 0.0 if not actions and not ref_actions else math.inf
    at = np.array([a["at"] for a in actions], dtype=np.float64)
    pos = np.array([a["pos"] for a in actions], dtype=np.float64)
    rat = np.array([a["at"] for a in ref_actions], dtype=np.float64)
    rpos = np.array([a["pos"] for a in ref_actions], dtype=np.float64)
    t = np.union1d(at, rat)
    return float(np.abs(np.interp(t, at, pos) - np.interp(t, rat, rpos)).max())


def compare(dots, actions, ref) -> dict:
    """The numbers of one clip; ``ref`` is (dots, actions) of the
    reference. Cut flags enter through the dots (a cut pair's dot is 0)
    and through the actions (a cut resets the integration)."""
    return {"dots_gap": dots_gap(dots, ref[0]),
            "pos_gap": pos_gap(actions, ref[1])}


def worst(rows) -> dict:
    return {k: max((r[k] for r in rows), default=math.inf) for k in NUMBERS}


def sample(clips, seed: int, extra: int = 1) -> list:
    """The clips to compare: the one with the most pairs, and ``extra``
    more drawn from the seed among the rest (``clips`` in window order;
    returns their positions)."""
    if not clips:
        return []
    longest = max(range(len(clips)), key=lambda i: (clips[i].frames, -i))
    rest = [i for i in range(len(clips)) if i != longest]
    rng = np.random.default_rng([seed, 0x5A17])
    pick = rng.choice(len(rest), size=min(extra, len(rest)), replace=False) \
        if rest else []
    return [longest] + sorted(rest[int(j)] for j in pick)


def verdict(numbers: dict, limits: dict, failed: int) -> bool:
    return failed == 0 and all(numbers[k] <= limits[k] for k in NUMBERS)
