"""One clip through the plain reference: gray frames to per-pair dots and
cut flags to funscript actions.

Flow and reductions run in plain PyTorch in ``dtype`` (float32, as the
configurations state; the benchmark's control passes bfloat16) on
``device``, ``chunk`` pairs at a time; the centres are smoothed over the
whole clip at once, and the signal chain runs in float64 on the host.
Nothing here imports the program under test.
"""

from __future__ import annotations

import numpy as np
import torch

from . import dis, farneback, reductions, signal


def flow_fn(params: dict):
    """The flow of the configuration's ``backend``: ``CUDA`` is the
    reference's Farnebäck path, ``DIS`` its DNN (cv2 DIS) path."""
    if params["backend"] == "DIS":
        preset = params["dis_preset"]
        return lambda f0, f1: dis.flow(f0, f1, preset)
    if params["backend"] == "CUDA":
        return farneback.flow
    raise ValueError(f"no reference for backend {params['backend']!r}")


@torch.inference_mode()
def pair_signal(frames: np.ndarray, params: dict, device, dtype=torch.float32,
                chunk: int = 256):
    """(dots float32 [N-1], cuts bool [N-1]) of frames [N, H, W] uint8."""
    flow = flow_fn(params)
    pov = bool(params["pov_mode"])
    n = len(frames) - 1
    us, vs, cs, mags = [], [], [], []
    for a in range(0, n, chunk):
        b = min(n, a + chunk)
        win = torch.from_numpy(np.ascontiguousarray(frames[a: b + 1])).to(device)
        win = win.to(dtype)
        u, v = flow(win[:-1], win[1:])
        us.append(u)
        vs.append(v)
        mags.append(reductions.mean_magnitude(u, v))
        if not pov:
            cs.append(reductions.centers(u, v))
    H, W = frames.shape[1:]
    if pov:
        c = torch.tensor([[W // 2, H - 1]], dtype=dtype, device=device).expand(n, 2)
    else:
        c = reductions.smooth(torch.cat(cs))
    cuts = torch.cat(mags) > float(params["cut_threshold"])
    dots = torch.cat([
        reductions.radial(u, v, c[a: a + len(u)], cuts[a: a + len(u)], pov)
        for a, u, v in zip(range(0, n, chunk), us, vs)])
    return (dots.to(torch.float32).cpu().numpy(), cuts.cpu().numpy())


def clip_actions(dots, cuts, params: dict, fps: float, step: int):
    """The funscript actions of one clip's (dots, cuts)."""
    return signal.actions(dots, cuts, step, fps, fps / step,
                          float(params["detrend_window"]),
                          float(params["norm_window"]),
                          bool(params["keyframe_reduction"]))
