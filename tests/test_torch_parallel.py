"""The port's parallel paths on the CPU: one clip's windows over a device
list (bitwise equal to one device, the same windows, and the same
funscript on the long-clip route), the folder workers and the thread-safe
launch counts.

A "mesh" here is ``make_mesh(k, device="cpu")``: k entries of the CPU
device, the port's counterpart of the JAX package's virtual CPU mesh.
"""

import json
import os
import sys
import threading

import numpy as np
import pytest
import torch

import reference_cv as ref
from funscript_flow_tpu_torch import runner as trun
from funscript_flow_tpu_torch.io.decode import VideoMeta
from funscript_flow_tpu_torch.models.pipeline import (FlowAnalyzer,
                                                      PipelineConfig,
                                                      StreamingFlowAnalyzer)
from funscript_flow_tpu_torch.ops import cuda as kcuda
from funscript_flow_tpu_torch.ops.cuda import _build
from funscript_flow_tpu_torch.parallel.mesh import make_mesh
from funscript_flow_tpu_torch.utils.params import Params

# the tests run in several worker processes at once: one torch thread
# each keeps them from oversubscribing the cores
torch.set_num_threads(1)

CPU = "cpu"


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
def fake_folder(tmp_path, monkeypatch):
    """Three placeholder clips (40, 48 and 56 frames of 64x64 gray) that
    ``runner._open_video`` serves from memory; it refuses any other file,
    as cv2 would an unreadable one. Returns (folder, clip names)."""
    clips = {}
    for i, n in enumerate((40, 48, 56)):
        name = f"clip{i}.mp4"
        (tmp_path / name).write_bytes(b"placeholder")
        clips[name] = [ref.rgb_to_gray(f) for f in ref.make_synthetic_frames(
            n, h=64, w=64, period=10 + i, seed=20 + i)]

    def fake_open(video_path, params, cancel_flag, start_sample=0):
        frames = clips.get(os.path.basename(video_path))
        if frames is None:
            raise IOError(f"Cannot open video: {video_path}")
        return (VideoMeta(len(frames), 30.0, 64, 64),
                ListSource(frames[start_sample:]))

    monkeypatch.setattr(trun, "_open_video", fake_open)
    return tmp_path, sorted(clips)


def _outputs(folder, names):
    out = {}
    for name in names:
        p = folder / name.replace(".mp4", ".funscript")
        out[name] = p.read_bytes()
        p.unlink()
    return out


# ------------------------------------------------------------------ mesh

def test_make_mesh():
    assert make_mesh(3, device=CPU) == [torch.device("cpu")] * 3
    with pytest.raises(ValueError):
        make_mesh(0, device=CPU)
    if not torch.cuda.is_available():
        # the port never falls back to CPU devices for a CUDA mesh
        with pytest.raises(RuntimeError, match="only 0 available"):
            make_mesh(2)


@pytest.mark.parametrize("n_pairs_total", [60, None])
@pytest.mark.parametrize("n_devices", [1, 2, 3, 4, 8])
def test_streaming_analyzer_mesh_bitwise_identical(n_devices, n_pairs_total):
    """The contract of tests/test_mesh_feature.py:35-51: a mesh gives the
    single-device results bit for bit, through the same windows (the ramp
    window and, with a known total, the tail ramp-down); ``make_mesh(1)``
    is the device as a mesh of one."""
    frames = np.random.default_rng(0).integers(0, 256, (61, 64, 64, 3),
                                               dtype=np.uint8)
    cfg = PipelineConfig(pair_batch=8)

    def run(**kw):
        an = StreamingFlowAnalyzer(cfg, n_pairs_total=n_pairs_total, **kw)
        res = []
        for s in range(0, len(frames), 13):
            res.extend(an.push(list(frames[s:s + 13])))
        res.extend(an.flush())
        return an, {k: np.concatenate([r[k] for r in res]) for k in an.KEYS}

    one, single = run(device=CPU)
    an, sharded = run(mesh=make_mesh(n_devices, device=CPU))
    assert an.n_devices == n_devices and an.pairs_emitted == 60
    assert an.windows_dispatched == one.windows_dispatched
    assert single["dots"].shape == sharded["dots"].shape == (60,)
    for k in single:
        np.testing.assert_array_equal(single[k], sharded[k])


def test_analyzer_mesh_and_device_exclusive():
    with pytest.raises(ValueError):
        StreamingFlowAnalyzer(PipelineConfig(), device=CPU,
                              mesh=make_mesh(2, device=CPU))


@pytest.mark.parametrize("n_devices", [2, 8])
def test_clip_shorter_than_mesh(n_devices):
    """tests/test_parallel.py:34-39: 5 pairs, flushed in windows of one
    pair: more windows than a mesh of 2 and fewer than a mesh of 8, equal
    bit for bit to the whole-clip driver."""
    frames = np.stack(ref.make_synthetic_frames(6, h=48, w=48, period=4,
                                                seed=1))
    an = StreamingFlowAnalyzer(PipelineConfig(pair_batch=1),
                               mesh=make_mesh(n_devices, device=CPU))
    res = an.push(list(frames)) + an.flush()
    want = FlowAnalyzer(PipelineConfig(pair_batch=8),
                        device=CPU).analyze_video_pairs(frames)
    assert an.windows_dispatched == 5
    for k in want:
        np.testing.assert_array_equal(
            np.concatenate([r[k] for r in res]), want[k], err_msg=k)


@pytest.mark.parametrize("n_devices", [2, 4, 8])
def test_process_video_mesh(fake_folder, monkeypatch, n_devices):
    """tests/test_parallel.py:107-146: process_video with --mesh N writes
    the one-device funscript byte for byte, on the host chain and on the
    long-clip route, where a mesh takes the one-device float64 chain; that
    route stays within a position unit of the host chain."""
    folder, names = fake_folder
    video = str(folder / names[2])
    out = video.replace(".mp4", ".funscript")
    outs = {}
    monkeypatch.setattr(trun, "AUTO_DEVICE_MIN_SAMPLES", 32)
    for label, kw in (("one", dict(signal_backend="host")),
                      ("mesh", dict(mesh=n_devices, signal_backend="host")),
                      ("auto", {}),
                      ("auto_mesh", dict(mesh=n_devices))):
        logs = []
        # a 1 s detrend window (30 samples) is shorter than the clip's 55
        assert not trun.process_video(video, Params(overwrite=True,
                                                    pair_batch=8,
                                                    detrend_window=1.0, **kw),
                                      logs.append, device=CPU), logs
        outs[label] = open(out, "rb").read()
        if "mesh" in label:
            assert any(f"Mesh: {n_devices} devices (cpu)" in m
                       for m in logs), logs
        if label.startswith("auto"):
            assert any("Signal chain: device" in m for m in logs), logs
    assert outs["mesh"] == outs["one"]
    assert outs["auto_mesh"] == outs["auto"]
    want = {a["at"]: a["pos"] for a in json.loads(outs["one"])["actions"]}
    got = {a["at"]: a["pos"] for a in json.loads(outs["auto_mesh"])["actions"]}
    shared = set(want) & set(got)
    assert len(shared) / len(want) > 0.9
    assert all(abs(want[t] - got[t]) <= 1 for t in shared)


# -------------------------------------------------------- folder workers

def test_resolve_clip_workers():
    """tests/test_aux.py:270-306 with the port's semantics: auto is one
    clip per device with a mesh, and sequential on one device (the port
    has no native decode pump)."""
    assert trun.resolve_clip_workers(Params(clip_workers=1), 5) == (1, 1)
    assert trun.resolve_clip_workers(Params(clip_workers=3), 5) == (3, 1)
    assert trun.resolve_clip_workers(Params(clip_workers=9), 5) == (5, 1)
    assert trun.resolve_clip_workers(
        Params(clip_workers=4, mesh=2), 5) == (4, 2)
    assert trun.resolve_clip_workers(Params(mesh=3), 5) == (3, 3)
    assert trun.resolve_clip_workers(Params(mesh=3), 2) == (2, 2)
    assert trun.resolve_clip_workers(Params(), 5) == (1, 1)
    assert trun.resolve_clip_workers(Params(), 1) == (1, 1)


def test_folder_clip_workers_identical(fake_folder):
    """tests/test_mesh_feature.py:134-162: 1, 2 and 3 clips in flight on
    one device write byte-identical funscripts; worker-tagged lines."""
    folder, names = fake_folder
    outs = {}
    for w in (1, 2, 3):
        log = folder / f"w{w}.log"
        err = trun.run_headless(str(folder), Params(pair_batch=8, threads=1,
                                                    clip_workers=w),
                                log_path=str(log), device=CPU)
        assert not err
        outs[w] = _outputs(folder, names)
        text = log.read_text()
        assert text.count("Funscript saved") == 3
        if w > 1:
            assert "[w0] " in text and "[w1] " in text
    assert outs[1] == outs[2] == outs[3]
    assert all(json.loads(b)["actions"] for b in outs[1].values())


def test_folder_mesh_matches_sequential_and_isolates_errors(fake_folder):
    """tests/test_mesh_feature.py:92-131: --mesh 2 on a folder runs one
    clip per device, dev-tagged, with the sequential run's funscripts; an
    unreadable file fails alone."""
    folder, names = fake_folder
    (folder / "bad.mp4").write_bytes(b"not a video")
    base = dict(pair_batch=8, threads=1)
    assert trun.run_headless(str(folder), Params(clip_workers=1, **base),
                             log_path=str(folder / "seq.log"), device=CPU)
    seq = _outputs(folder, names)
    assert trun.run_headless(str(folder), Params(mesh=2, **base),
                             log_path=str(folder / "par.log"), device=CPU)
    assert _outputs(folder, names) == seq
    text = (folder / "par.log").read_text()
    assert "[dev0] " in text and "[dev1] " in text
    assert "Unable to open video" in text and "bad.mp4" in text
    assert text.count("Funscript saved") == 3


def test_folder_cancel_and_progress(fake_folder):
    """tests/test_mesh_feature.py:165-221: a cancel at the first progress
    callback stops the queue (the in-flight clips stop too), and a full
    run reports sub-video progress ending at 100."""
    folder, names = fake_folder
    state = {"video": [], "cancel": False}

    def on_video_progress(video, pct):
        state["video"].append((os.path.basename(video), pct))
        state["cancel"] = True

    params = Params(mesh=2, pair_batch=8, threads=1, overwrite=True)
    err = trun.run_headless(str(folder), params,
                            log_path=str(folder / "cancel.log"),
                            cancel_flag=lambda: state["cancel"],
                            video_progress_callback=on_video_progress,
                            device=CPU)
    assert not err
    assert state["video"]
    assert len(list(folder.glob("*.funscript"))) <= 2
    started = (folder / "cancel.log").read_text().count("Processing file")
    assert started <= 2

    overall, videos = [], []
    err = trun.run_headless(str(folder), params,
                            log_path=str(folder / "full.log"),
                            progress_callback=overall.append,
                            video_progress_callback=lambda v, p:
                            videos.append(p), device=CPU)
    assert not err
    assert overall[-1] == 100
    # sub-video granularity: values between the whole-video steps
    assert any(p not in (0, 33, 66, 100) for p in overall), overall
    assert any(p not in (0, 100) for p in videos)


# ---------------------------------------------------- launch counts

def test_launch_counts_lose_nothing_across_threads():
    """Clip workers launch from several threads at once: the count's
    read-modify-write must not lose an update."""
    kcuda.reset_launches()
    n_threads, per = 8, 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [_build.count_launch("warp_bilinear")
                            for _ in range(per)]) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert kcuda.launch_counts()["warp_bilinear"] == n_threads * per
    kcuda.reset_launches()
    assert kcuda.launch_counts()["warp_bilinear"] == 0


# ----------------------------------------------------------------- cuda

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (worker streams)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_workers_run_on_their_own_streams(cuda_device, fake_folder,
                                          monkeypatch):
    """Each folder worker runs its clips on a CUDA stream of its own, not
    on the default stream; the funscripts and the launch counts equal the
    sequential run's."""
    folder, names = fake_folder
    params = dict(pair_batch=8, threads=1)
    kcuda.reset_launches()
    assert not trun.run_headless(str(folder), Params(clip_workers=1,
                                                     **params),
                                 log_path=str(folder / "seq.log"))
    seq_counts = kcuda.launch_counts()
    seq = _outputs(folder, names)

    seen = set()
    real = trun.process_video

    def spy(*a, **kw):
        seen.add(torch.cuda.current_stream(cuda_device).cuda_stream)
        return real(*a, **kw)

    monkeypatch.setattr(trun, "process_video", spy)
    kcuda.reset_launches()
    assert not trun.run_headless(str(folder), Params(clip_workers=3,
                                                     **params),
                                 log_path=str(folder / "par.log"))
    assert len(seen) == 3
    assert torch.cuda.default_stream(cuda_device).cuda_stream not in seen
    assert kcuda.launch_counts() == seq_counts
    assert seq_counts["poly_exp"] > 0
    assert _outputs(folder, names) == seq
