"""A file decoded through cv2, as on a machine where the port's native pump
does not build (no libav headers): the port's ``process_video`` of a
cv2-written mp4v clip against the JAX package's on the same file, both
decoding through cv2 (``use_native_decode="off"``; the JAX side warps with
its Pallas kernel in interpret mode, the exact f32 warp). Timestamps equal,
positions within the ±2 of tests/test_runner.py.

Then the port's default ``use_native_decode="auto"`` with the pump made
unavailable: it decodes through cv2, logs why the pump was not taken, and
writes the same bytes as ``off``.

The analysis frames are 256x256 whatever the clip's size, so the clip is
short (12 frames at 5 fps, a 1 s norm window of 5 samples) and fits one
window of 16 pairs: one JAX compile, shared by the flat and VR cases.
"""

import json

import numpy as np
import pytest
import torch

import reference_cv as ref
from funscript_flow_tpu import runner as jrun
from funscript_flow_tpu.utils.params import Params as JParams
from funscript_flow_tpu_torch import runner as trun
from funscript_flow_tpu_torch import runtime as trt
from funscript_flow_tpu_torch.utils.params import Params

# the tests run in several worker processes at once: one torch thread
# each keeps them from oversubscribing the cores
torch.set_num_threads(1)

KW = dict(overwrite=True, pair_batch=16, norm_window=1.0)


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    import cv2

    frames = ref.make_synthetic_frames(12, h=180, w=320, period=4, seed=7)
    path = str(tmp_path_factory.mktemp("cv2_file") / "clip.mp4")
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 5.0,
                         (320, 180))
    assert vw.isOpened()
    for f in frames:
        vw.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
    vw.release()
    return path


def _run(process_video, video, params, **kw):
    """(actions, bytes, log) of one process_video of ``video``."""
    logs = []
    assert not process_video(video, params, logs.append, **kw), logs
    with open(video.rsplit(".", 1)[0] + ".funscript", "rb") as f:
        data = f.read()
    return json.loads(data)["actions"], data, logs


@pytest.fixture(scope="module")
def jax_runs(clip):
    """The JAX process_video of the clip, flat and VR (its tail-bucket
    prewarm skipped: the clip has one window)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jrun, "_prewarm_tail_async", lambda *a, **k: None)
    try:
        return {vr: _run(jrun.process_video, clip,
                         JParams(use_native_decode="off", warp_backend="pallas",
                                 vr_mode=vr, **KW))[0]
                for vr in (False, True)}
    finally:
        mp.undo()


@pytest.mark.parametrize("vr", [False, True], ids=["flat", "vr"])
def test_cv2_file_matches_jax_process_video(clip, jax_runs, vr,
                                            record_property):
    """Both packages decode the file through cv2: the same ``at``, ``pos``
    within 2."""
    got, _, logs = _run(trun.process_video, clip,
                        Params(use_native_decode="off", vr_mode=vr, **KW),
                        device="cpu")
    assert any(m.startswith("Decode: OpenCV") and
               "native pump not taken: use_native_decode=off" in m
               for m in logs), logs
    want = jax_runs[vr]
    assert len(want) >= 3
    assert [a["at"] for a in got] == [a["at"] for a in want]
    dpos = np.abs(np.array([a["pos"] for a in got])
                  - np.array([a["pos"] for a in want]))
    record_property("max_pos_delta", int(dpos.max()))
    assert dpos.max() <= 2, dpos


def test_auto_without_pump_decodes_through_cv2(clip, monkeypatch):
    """Default decode where the pump cannot be built: cv2, the reason
    logged, and the bytes of ``use_native_decode="off"``."""
    _, want, _ = _run(trun.process_video, clip,
                      Params(use_native_decode="off", **KW), device="cpu")
    reason = "no libav headers: (a machine without libav's development files)"
    monkeypatch.setattr(trt, "available", lambda: False)
    monkeypatch.setattr(trt, "unavailable_reason", lambda: reason)
    _, got, logs = _run(trun.process_video, clip, Params(**KW), device="cpu")
    assert [m for m in logs if m.startswith("Decode: ")] == [
        f"Decode: OpenCV (cv2); native pump not taken: {reason}"], logs
    assert got == want
