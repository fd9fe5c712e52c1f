"""The port's checkpoint/resume: sidecar roundtrip and fingerprint, a
cancelled and resumed clip byte-identical to an uninterrupted run, stale
sidecars and sidecars written by the JAX package ignored."""

import os

import numpy as np
import pytest
import torch

import reference_cv as ref
from funscript_flow_tpu.io import checkpoint as jck
from funscript_flow_tpu.io import decode as jdec
from funscript_flow_tpu.utils.params import Params as JParams
from funscript_flow_tpu_torch import runner as trun
from funscript_flow_tpu_torch.io import checkpoint as ck
from funscript_flow_tpu_torch.io.decode import VideoMeta, probe
from funscript_flow_tpu_torch.utils.params import Params

# the tests run in several worker processes at once: one torch thread
# each keeps them from oversubscribing the cores
torch.set_num_threads(1)

CPU = "cpu"
N_FRAMES = 70


class ListSource:
    def __init__(self, frames):
        self._frames = list(frames)
        self._i = 0

    def get_batch(self, n):
        out = self._frames[self._i : self._i + n]
        self._i += len(out)
        return out

    def close(self):
        self._i = len(self._frames)


@pytest.fixture
def fake_clip(tmp_path, monkeypatch):
    """A placeholder clip of ``N_FRAMES`` 64x64 gray frames that
    ``runner._open_video`` serves from memory, from ``start_sample`` on;
    returns (video path, its funscript path, opened start samples)."""
    frames = [ref.rgb_to_gray(f) for f in ref.make_synthetic_frames(
        N_FRAMES, h=64, w=64, period=11, seed=7)]
    video = tmp_path / "clip.mp4"
    video.write_bytes(b"placeholder")
    starts = []

    def fake_open(video_path, params, cancel_flag, start_sample=0):
        starts.append(start_sample)
        return (VideoMeta(N_FRAMES, 30.0, 64, 64),
                ListSource(frames[start_sample:]))

    monkeypatch.setattr(trun, "_open_video", fake_open)
    return str(video), str(tmp_path / "clip.funscript"), starts


def _cancel_after_polls(k):
    """(cancel_flag, progress_callback): the flag fires once the runner's
    loop has reported progress ``k`` times."""
    state = {"n": 0}

    def progress(_pct):
        state["n"] += 1

    return (lambda: state["n"] >= k), progress


def test_checkpoint_roundtrip_and_invalidation(tmp_path):
    """tests/test_aux.py:192-215."""
    path = str(tmp_path / "x.funscript.ckpt.npz")
    dots = np.arange(10, dtype=np.float32)
    cuts = np.zeros(10, bool)
    cuts[3] = True
    ck.save(path, dots, cuts, "fp-a")
    got = ck.load(path, "fp-a")
    np.testing.assert_array_equal(got[0], dots)
    np.testing.assert_array_equal(got[1], cuts)
    assert ck.load(path, "fp-b") is None
    with open(path, "wb") as f:
        f.write(b"not an npz")
    assert ck.load(path, "fp-a") is None
    ck.clear(path)
    assert ck.load(path, "fp-a") is None
    ck.clear(path)  # idempotent
    assert ck.sidecar_path("/x/y.funscript") == \
        jck.sidecar_path("/x/y.funscript")


def test_checkpoint_fingerprint_sensitivity(tmp_path):
    """tests/test_aux.py:218-250, with the port's numeric regime: the
    device type and the route (CUDA kernels or plain twins)."""
    video = tmp_path / "v.mp4"
    video.write_bytes(b"0" * 100)
    meta = VideoMeta(total_frames=60, fps=30.0, width=64, height=64)
    base = ck.fingerprint(str(video), meta, Params(), CPU)
    assert ck.fingerprint(str(video), meta, Params(), CPU) == base
    for changed in (Params(cut_threshold=9), Params(vr_mode=True),
                    Params(pov_mode=True), Params(backend="DIS"),
                    Params(backend="DIS", dis_preset="medium")):
        assert ck.fingerprint(str(video), meta, changed, CPU) != base
    for same in (Params(pair_batch=32), Params(threads=2), Params(mesh=2),
                 Params(clip_workers=3), Params(checkpoint=True)):
        assert ck.fingerprint(str(video), meta, same, CPU) == base
    # a sidecar written on the card never resumes on the CPU, nor back
    assert ck.fingerprint(str(video), meta, Params(), "cuda") != base
    assert ck.flow_regime("cuda:1") == "torch/cuda/kernels"
    assert ck.flow_regime(CPU) == "torch/cpu/plain"
    video.write_bytes(b"1" * 101)
    assert ck.fingerprint(str(video), meta, Params(), CPU) != base


@pytest.mark.parametrize("backend,mesh", [("CUDA", 0), ("DIS", 0),
                                          ("CUDA", 2)])
def test_checkpoint_resume_byte_identical(fake_clip, monkeypatch, backend,
                                          mesh):
    """tests/test_runner.py:309-359 (exact engine): a run cancelled after
    its third poll keeps a sidecar; the resumed run recomputes only the
    6-pair halo and writes the uninterrupted run's bytes, then clears the
    sidecar. The mesh case resumes a one-device sidecar on two devices
    (per-pair results do not depend on the mesh)."""
    video, out, starts = fake_clip
    params = Params(overwrite=True, pair_batch=8, backend=backend,
                    checkpoint=True)
    assert not trun.process_video(video, params, lambda m: None, device=CPU)
    baseline = open(out, "rb").read()
    sidecar = ck.sidecar_path(out)
    assert not os.path.exists(sidecar)  # cleared on success
    os.remove(out)

    monkeypatch.setattr(ck, "CHECKPOINT_EVERY_PAIRS", 8)
    cancel, progress = _cancel_after_polls(3)
    logs = []
    err = trun.process_video(video, params, logs.append, device=CPU,
                             cancel_flag=cancel, progress_callback=progress)
    assert not err  # cancel is not an error
    assert any("cancelled" in m for m in logs)
    assert not os.path.exists(out) and os.path.exists(sidecar)
    saved = ck.load(sidecar, ck.fingerprint(video, VideoMeta(
        N_FRAMES, 30.0, 64, 64), params, CPU))
    assert saved is not None and 8 < len(saved[0]) < N_FRAMES - 1

    logs = []
    del starts[:]
    err = trun.process_video(video, Params(**{**params.to_dict(),
                                              "mesh": mesh}),
                             logs.append, device=CPU)
    assert not err, logs
    assert any("Resuming from checkpoint: " f"{len(saved[0])}/"
               f"{N_FRAMES - 1} pairs done (recomputing 6-pair halo)" in m
               for m in logs), logs
    assert starts == [0, len(saved[0]) - 6]  # reopened 6 pairs early
    assert open(out, "rb").read() == baseline
    assert not os.path.exists(sidecar)


def test_checkpoint_stale_sidecar_ignored(fake_clip):
    """tests/test_runner.py:395-: a sidecar whose fingerprint does not
    match (another cut_threshold) is ignored; the run starts at frame 0."""
    video, out, starts = fake_clip
    base = Params(overwrite=True, pair_batch=8)
    assert not trun.process_video(video, base, lambda m: None, device=CPU)
    baseline = open(out, "rb").read()
    stale = ck.fingerprint(video, VideoMeta(N_FRAMES, 30.0, 64, 64),
                           Params(cut_threshold=99), CPU)
    ck.save(ck.sidecar_path(out), np.full(30, 1e9, np.float32),
            np.zeros(30, bool), stale)
    logs = []
    del starts[:]
    assert not trun.process_video(video, Params(**{**base.to_dict(),
                                                   "checkpoint": True}),
                                  logs.append, device=CPU)
    assert not any("Resuming" in m for m in logs)
    assert starts == [0]
    assert open(out, "rb").read() == baseline
    assert not os.path.exists(ck.sidecar_path(out))


def test_jax_sidecar_not_resumed(fake_clip):
    """A sidecar that the JAX package's checkpoint module wrote for the
    same clip is not resumed by the port (its fingerprint names the JAX
    backend and TPU numerics), and a port sidecar does not load under the
    JAX fingerprint."""
    video, out, starts = fake_clip
    base = Params(overwrite=True, pair_batch=8)
    assert not trun.process_video(video, base, lambda m: None, device=CPU)
    baseline = open(out, "rb").read()
    jmeta = jdec.VideoMeta(N_FRAMES, 30.0, 64, 64)
    jfp = jck.fingerprint(video, jmeta, JParams(), engine="exact")
    sidecar = jck.sidecar_path(out)
    jck.save(sidecar, np.full(40, 1e9, np.float32), np.zeros(40, bool), jfp)
    tfp = ck.fingerprint(video, VideoMeta(N_FRAMES, 30.0, 64, 64),
                         Params(), CPU)
    assert tfp != jfp and ck.load(sidecar, tfp) is None

    logs = []
    del starts[:]
    params = Params(**{**base.to_dict(), "checkpoint": True})
    assert not trun.process_video(video, params, logs.append, device=CPU)
    assert not any("Resuming" in m for m in logs)
    assert starts == [0]
    assert open(out, "rb").read() == baseline
    assert not os.path.exists(sidecar)

    ck.save(sidecar, np.zeros(40, np.float32), np.zeros(40, bool), tfp)
    assert ck.load(sidecar, tfp) is not None
    assert jck.load(sidecar, jfp) is None


def test_checkpoint_resume_through_cv2(tmp_path, monkeypatch):
    """The real decode path: the resumed run reopens the file through
    ``runner._open_video(start_sample=...)`` (one cv2 seek) and still
    writes the uninterrupted run's bytes."""
    import cv2

    frames = ref.make_synthetic_frames(30, h=64, w=64, period=8, seed=3)
    video = str(tmp_path / "real.mp4")
    vw = cv2.VideoWriter(video, cv2.VideoWriter_fourcc(*"mp4v"), 30,
                         (64, 64))
    for f in frames:
        vw.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
    vw.release()
    out = video.replace(".mp4", ".funscript")
    params = Params(overwrite=True, pair_batch=8, threads=1, backend="DIS",
                    checkpoint=True)
    assert not trun.process_video(video, params, lambda m: None, device=CPU)
    baseline = open(out, "rb").read()
    os.remove(out)

    monkeypatch.setattr(ck, "CHECKPOINT_EVERY_PAIRS", 8)
    cancel, progress = _cancel_after_polls(2)
    assert not trun.process_video(video, params, lambda m: None, device=CPU,
                                  cancel_flag=cancel,
                                  progress_callback=progress)
    monkeypatch.undo()
    saved = ck.load(ck.sidecar_path(out),
                    ck.fingerprint(video, probe(video), params, CPU))
    assert saved is not None and 0 < len(saved[0]) < 29
    logs = []
    assert not trun.process_video(video, params, logs.append, device=CPU)
    assert any("Resuming from checkpoint" in m for m in logs), logs
    assert open(out, "rb").read() == baseline
    assert not os.path.exists(ck.sidecar_path(out))
