"""The one traffic generator: clips made from ``--seed`` and a traffic
file (``perfbench/traffic/<mix>.json``).

A clip is a blurred-noise texture zoomed about the frame's centre with
scale ``1 + a sin(2 pi t / (p fps) + phase)``: a period ``p`` and an
amplitude ``a`` of the clip's own, and in some clips a scene cut to a
second texture. Keys of a traffic file:

* ``source``: ``generated``, frames served from memory (no decode), the
  one source the harness has;
* ``fps``; ``size`` ([h, w] of the frames the program gets);
* ``clip_frames``: ``{"dist": "log_uniform", "min", "max", "strata"}``:
  blocks of ``strata`` clips, one at the middle of each of ``strata``
  equal log-spaced bands, in an order drawn from the seed, so that every
  seed runs the same lengths;
* ``period_s``, ``amplitude``: [low, high] ranges, drawn uniformly;
* ``cut_share``: the chance that a clip has a scene cut, placed uniformly
  in its middle 60%;
* ``textures``: how many textures the seed makes; ``scale_levels``: the
  zoom's scale is quantised to this many levels over the amplitude range,
  so that a generated cell's frames are slices of one pool of
  ``textures x scale_levels`` frames made on the device;
* ``warmup_frames``: the lengths of the clips that set-up converts first,
  chosen so that they dispatch every window size the cell's clips do.

Other keys (``origin``: where each value comes from) are for the reader.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

TEXTURE = 512       # texture side, px
BLUR_SIGMA = 3.0    # the texture's Gaussian blur, px
MEAN, STD = 128.0, 40.0


@dataclass(frozen=True)
class ClipSpec:
    index: int
    frames: int
    texture: int
    cut_texture: int
    cut_at: int          # first frame of the second texture (frames: none)
    period_s: float
    amplitude: float
    phase: float


def block_lengths(traffic: dict) -> list:
    """The clip lengths of one block, in frames."""
    d = traffic["clip_frames"]
    if d["dist"] == "log_uniform":
        lo, hi, k = math.log(d["min"]), math.log(d["max"]), int(d["strata"])
        return [int(round(math.exp(lo + (i + 0.5) / k * (hi - lo))))
                for i in range(k)]
    raise ValueError(f"unknown clip_frames dist {d['dist']!r}")


def plan(traffic: dict, seed: int):
    """The cell's clips in order, without end: the same seed gives the
    same clips."""
    rng = np.random.default_rng(seed)
    lengths = block_lengths(traffic)
    n_tex = int(traffic["textures"])
    index = 0
    while True:
        for j in rng.permutation(len(lengths)):
            n = lengths[j]
            tex = int(rng.integers(n_tex))
            other = int((tex + 1 + rng.integers(max(n_tex - 1, 1))) % n_tex)
            cut = rng.random() < traffic["cut_share"]
            at = int(n * rng.uniform(0.2, 0.8))
            yield ClipSpec(
                index=index, frames=n, texture=tex, cut_texture=other,
                cut_at=at if cut else n,
                period_s=float(rng.uniform(*traffic["period_s"])),
                amplitude=float(rng.uniform(*traffic["amplitude"])),
                phase=float(rng.uniform(0.0, 2 * math.pi)))
            index += 1


def scale_range(traffic: dict) -> tuple:
    a = float(traffic["amplitude"][1])
    return 1.0 - a, 1.0 + a


def frame_index(spec: ClipSpec, traffic: dict) -> tuple:
    """(texture [N], scale level [N]) of each frame of the clip."""
    t = np.arange(spec.frames, dtype=np.float64)
    s = 1.0 + spec.amplitude * np.sin(
        2 * math.pi * t / (spec.period_s * traffic["fps"]) + spec.phase)
    lo, hi = scale_range(traffic)
    levels = int(traffic["scale_levels"])
    lev = np.rint((s - lo) / (hi - lo) * (levels - 1)).astype(np.int64)
    tex = np.where(t >= spec.cut_at, spec.cut_texture, spec.texture)
    return tex.astype(np.int64), np.clip(lev, 0, levels - 1)


def textures(traffic: dict, seed: int, device) -> torch.Tensor:
    """[T, 1, 512, 512] float32 textures on ``device``: uniform noise from
    the seed, blurred (Gaussian, sigma 3 px, reflected edges) by shifted
    sums, scaled to mean 128 and deviation 40."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    n = int(traffic["textures"])
    tex = torch.rand((n, 1, TEXTURE, TEXTURE), generator=g, device=device)
    r = int(3 * BLUR_SIGMA)
    taps = np.exp(-np.arange(-r, r + 1) ** 2 / (2 * BLUR_SIGMA ** 2))
    taps /= taps.sum()
    for dim in (2, 3):
        pad = (0, 0, r, r) if dim == 2 else (r, r, 0, 0)
        xp = F.pad(tex, pad, mode="reflect")
        tex = sum(float(t) * xp.narrow(dim, i, TEXTURE)
                  for i, t in enumerate(taps))
    mean = tex.mean(dim=(1, 2, 3), keepdim=True)
    std = tex.std(dim=(1, 2, 3), keepdim=True)
    return ((tex - mean) / std * STD + MEAN).clamp(0, 255)


def render(tex: torch.Tensor, tex_ids, scales, h: int, w: int) -> torch.Tensor:
    """uint8 [n, h, w] frames: texture ``tex_ids[i]`` zoomed by
    ``scales[i]`` about the centre, its central 256x256 view stretched
    to h x w."""
    dev = tex.device
    tex_ids = torch.as_tensor(np.asarray(tex_ids), device=dev)
    s = torch.as_tensor(np.asarray(scales), dtype=torch.float32, device=dev)
    c = (TEXTURE - 1) / 2
    px = (torch.arange(w, dtype=torch.float32, device=dev) - (w - 1) / 2) * 256 / w
    py = (torch.arange(h, dtype=torch.float32, device=dev) - (h - 1) / 2) * 256 / h
    X = (c + px[None, None, :] / s[:, None, None]) / c - 1
    Y = (c + py[None, :, None] / s[:, None, None]) / c - 1
    grid = torch.stack([X.expand(-1, h, w), Y.expand(-1, h, w)], dim=-1)
    img = F.grid_sample(tex[tex_ids], grid, mode="bilinear",
                        align_corners=True)
    return img[:, 0].round().clamp(0, 255).to(torch.uint8)


def pool(traffic: dict, seed: int, device, chunk: int = 256) -> np.ndarray:
    """[T, L, h, w] uint8 on the host: every texture at every scale level,
    made on ``device`` in a few large calls."""
    h, w = traffic["size"]
    tex = textures(traffic, seed, device)
    levels = int(traffic["scale_levels"])
    lo, hi = scale_range(traffic)
    scales = np.linspace(lo, hi, levels)
    T = tex.shape[0]
    ids = np.repeat(np.arange(T), levels)
    sc = np.tile(scales, T)
    out = torch.empty((T * levels, h, w), dtype=torch.uint8,
                      pin_memory=torch.device(device).type == "cuda")
    for a in range(0, len(ids), chunk):
        out[a: a + chunk].copy_(render(tex, ids[a: a + chunk],
                                       sc[a: a + chunk], h, w))
    return out.numpy().reshape(T, levels, h, w)


def clip_frames(pool_arr: np.ndarray, spec: ClipSpec, traffic: dict) -> np.ndarray:
    """[N, h, w] uint8: the clip's frames gathered from the pool."""
    tex, lev = frame_index(spec, traffic)
    return pool_arr[tex, lev]


class PoolSource:
    """A frame source over the pool (``get_batch``/``close``, what
    ``process_video(preopened=...)`` reads): views of the pool's frames,
    so serving a frame copies nothing."""

    def __init__(self, pool_arr: np.ndarray, spec: ClipSpec, traffic: dict):
        self._pool = pool_arr
        self._tex, self._lev = frame_index(spec, traffic)
        self._i = 0

    def get_batch(self, n: int) -> list:
        with torch.profiler.record_function("perfbench.frames"):
            a, b = self._i, min(self._i + n, len(self._tex))
            self._i = b
            return [self._pool[t, lv] for t, lv in
                    zip(self._tex[a:b].tolist(), self._lev[a:b].tolist())]

    def close(self) -> None:
        self._i = len(self._tex)

