"""The port's runner, CLI, params and host modules, end to end against the
JAX package on the same preopened frames."""

import json
import os

import numpy as np
import pytest
import torch

import reference_cv as ref
from funscript_flow_tpu import runner as jrun
from funscript_flow_tpu.io import decode as jdec
from funscript_flow_tpu.io import funscript as jfs
from funscript_flow_tpu.ops import signal_host as jsh
from funscript_flow_tpu.utils.params import Params as JParams
from funscript_flow_tpu_torch import cli as tcli
from funscript_flow_tpu_torch import runner as trun
from funscript_flow_tpu_torch.io import decode as tdec
from funscript_flow_tpu_torch.io import funscript as tfs
from funscript_flow_tpu_torch.ops import signal_host as tsh
from funscript_flow_tpu_torch.utils.params import Params, params_from_jax

# the tests run in several worker processes at once: one torch thread
# each keeps them from oversubscribing the cores
torch.set_num_threads(1)


class ListSource:
    def __init__(self, frames):
        self._frames = list(frames)
        self._i = 0
        self.closed = False

    def get_batch(self, n):
        out = self._frames[self._i : self._i + n]
        self._i += len(out)
        return out

    def close(self):
        self.closed = True


@pytest.fixture(scope="module")
def gray40():
    frames = ref.make_synthetic_frames(40, h=64, w=64, period=12, seed=11)
    return [ref.rgb_to_gray(f) for f in frames]


def _run(process_video, meta, frames, params, path, **kw):
    logs = []
    src = ListSource(frames)
    err = process_video(str(path), params, logs.append,
                        preopened=(meta, src), **kw)
    assert not err, logs
    assert src.closed
    with open(str(path).rsplit(".", 1)[0] + ".funscript") as f:
        return json.load(f), logs


def test_process_video_matches_jax(gray40, tmp_path, record_property):
    """40 frames through both packages' process_video on the same
    preopened source. The JAX side runs the exact f32 Pallas warp in
    interpret mode; timestamps must be identical and positions within the
    ±2 of tests/test_runner.py."""
    jmeta = jdec.VideoMeta(total_frames=40, fps=30.0, width=64, height=64)
    tmeta = tdec.VideoMeta(total_frames=40, fps=30.0, width=64, height=64)
    want, _ = _run(jrun.process_video, jmeta, gray40,
                   JParams(overwrite=True, pair_batch=8,
                           warp_backend="pallas"),
                   tmp_path / "jax_clip.mp4")
    got, logs = _run(trun.process_video, tmeta, gray40,
                     Params(overwrite=True, pair_batch=8),
                     tmp_path / "torch_clip.mp4", device="cpu")
    assert got["version"] == "1.0"
    assert [a["at"] for a in got["actions"]] == \
        [a["at"] for a in want["actions"]]
    dpos = np.abs(np.array([a["pos"] for a in got["actions"]])
                  - np.array([a["pos"] for a in want["actions"]]))
    record_property("max_pos_delta", int(dpos.max()))
    assert dpos.max() <= 2, dpos
    assert any("Flow windows dispatched: 5 (39 pairs)" in m for m in logs)


def test_process_video_skip_and_short(gray40, tmp_path):
    meta = tdec.VideoMeta(total_frames=1, fps=30.0, width=64, height=64)
    logs = []
    src = ListSource(gray40[:1])
    err = trun.process_video(str(tmp_path / "one.mp4"), Params(), logs.append,
                             preopened=(meta, src), device="cpu")
    assert err and src.closed
    assert any("too short" in m.lower() for m in logs)
    (tmp_path / "done.funscript").write_text("{}")
    logs = []
    src = ListSource(gray40)
    err = trun.process_video(str(tmp_path / "done.mp4"), Params(), logs.append,
                             preopened=(meta, src), device="cpu")
    assert not err and src.closed
    assert any("Skipping" in m for m in logs)


def test_run_headless_folder(tmp_path):
    import cv2

    d = tmp_path / "lib" / "sub"
    d.mkdir(parents=True)
    frames = ref.make_synthetic_frames(12, h=64, w=64, period=6, seed=2)
    for p in (d / "a.mp4", tmp_path / "lib" / "b.mp4"):
        vw = cv2.VideoWriter(str(p), cv2.VideoWriter_fourcc(*"mp4v"), 30,
                             (64, 64))
        for f in frames:
            vw.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
        vw.release()
    (tmp_path / "lib" / "ignore.txt").write_text("x")
    log = tmp_path / "run.log"
    err = trun.run_headless(str(tmp_path / "lib"),
                            Params(pair_batch=16, threads=1),
                            log_path=str(log), device="cpu")
    assert not err
    for p in (d / "a.funscript", tmp_path / "lib" / "b.funscript"):
        acts = json.loads(p.read_text())["actions"]
        assert acts and all(0 <= a["pos"] <= 100 for a in acts)
    text = log.read_text()
    assert "Found 2 file(s)." in text and "Batch processing complete." in text


def test_profile_trace_writes_a_trace(tmp_path):
    from funscript_flow_tpu_torch.utils.logging import profile_trace

    with profile_trace(""):
        pass  # no directory: no profiler, nothing written
    d = tmp_path / "prof"
    with profile_trace(str(d)):
        torch.ones(64).cumsum(0)
    (trace,) = d.iterdir()
    assert trace.name.startswith("trace_") and trace.suffix == ".json"
    assert "traceEvents" in json.loads(trace.read_text())


def test_second_trace_fails_the_clip_as_in_jax(gray40, tmp_path):
    """The profiler is process-wide in both packages: a clip whose trace
    starts while another runs logs the error and returns True, with
    jax.profiler's message, and does not touch the running trace."""
    import jax

    from funscript_flow_tpu_torch.utils.logging import profile_trace

    outcome = {}
    jax.profiler.start_trace(str(tmp_path / "jax_running"))
    try:
        logs = []
        src = ListSource(gray40)
        outcome["jax"] = (jrun.process_video(
            str(tmp_path / "j.mp4"), JParams(overwrite=True, pair_batch=8,
                                             profile_dir=str(tmp_path / "j")),
            logs.append, preopened=(jdec.VideoMeta(40, 30.0, 64, 64), src)),
            [m for m in logs if m.startswith("ERROR")], src.closed)
    finally:
        jax.profiler.stop_trace()
    with profile_trace(str(tmp_path / "torch_running")):
        logs = []
        src = ListSource(gray40)
        outcome["torch"] = (trun.process_video(
            str(tmp_path / "t.mp4"), Params(overwrite=True, pair_batch=8,
                                            profile_dir=str(tmp_path / "t")),
            logs.append, preopened=(tdec.VideoMeta(40, 30.0, 64, 64), src),
            device="cpu"), [m for m in logs if m.startswith("ERROR")],
            src.closed)
    assert outcome["torch"] == (True, [m.replace("j.mp4", "t.mp4") for m in
                                       outcome["jax"][1]], True)
    assert outcome["jax"][0] is True
    assert "Only one profile may be run at a time" in outcome["jax"][1][0]
    assert not (tmp_path / "t").exists()
    assert len(list((tmp_path / "torch_running").iterdir())) == 1


def test_backends_and_device_profile_on_cpu():
    from funscript_flow_tpu_torch.utils.backends import (
        get_available_backends, get_device_info)
    from funscript_flow_tpu_torch.utils.devprof import device_profile

    from funscript_flow_tpu_torch import runtime

    got = get_available_backends()
    assert got == {"CUDA": torch.cuda.is_available(), "DIS": True,
                   "CPU": True, "native_decode": runtime.available()}
    info = get_device_info()
    if torch.cuda.is_available():
        assert "cuda:0" in info
    else:
        assert "CUDA: not available" in info
        with pytest.raises(RuntimeError, match="CUDA"):
            device_profile(lambda: torch.ones(4))


@pytest.mark.cuda
def test_device_profile_on_card(capsys):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (device time)")
    from funscript_flow_tpu_torch.utils.devprof import device_profile

    x = torch.randn(2048, 2048, device="cuda")
    ms = device_profile(torch.mm, x, x, runs=3, top=2, label="mm")
    assert ms > 0
    assert "mm: " in capsys.readouterr().out


def test_compute_actions_host_chain(rng):
    n = 300
    dots = np.sin(np.arange(n) / 7.0) * 3 + rng.normal(0, 0.1, n)
    cuts = np.zeros(n, bool)
    ts = np.arange(n)
    logs = []
    got, norm = trun.compute_actions(dots, cuts, ts, 30.0, 30.0, Params(),
                                     logs.append)
    want, wnorm = jrun.compute_actions(dots, cuts, ts, 30.0, 30.0,
                                       JParams(signal_backend="host"))
    assert got == want
    np.testing.assert_array_equal(norm, wnorm)
    assert any("host" in m for m in logs)
    # the device chain (tests/test_torch_signal.py) runs on the CPU when
    # asked, and stays within half a position unit of the host chain
    dgot, dnorm = trun.compute_actions(dots, cuts, ts, 30.0, 30.0,
                                       Params(signal_backend="device"),
                                       device="cpu")
    np.testing.assert_allclose(dnorm, wnorm, atol=0.5)
    assert [a["at"] for a in dgot] == [a["at"] for a in want]


@pytest.mark.parametrize("n", [1, 2, 7, 200])
def test_signal_host_copy_matches_jax(rng, n):
    dots = rng.normal(0, 2, n)
    dots[n // 2] += 1500.0  # discontinuity re-anchors the detrend grid
    cuts = rng.random(n) < 0.05
    ts = np.arange(n) * 2
    a = tsh.signal_chain(dots, cuts, ts, 60.0, 60, 90)
    b = jsh.signal_chain(dots, cuts, ts, 60.0, 60, 90)
    assert a[0] == b[0]
    np.testing.assert_array_equal(a[1], b[1])


def test_params_from_jax_round_trip():
    assert params_from_jax(JParams().to_dict()) == Params()
    jd = JParams(threads=3, pair_batch=120, pov_mode=True, cut_threshold=5.5,
                 use_pallas="on", warp_backend="xla").to_dict()
    p = params_from_jax(jd)
    assert p.backend == "CUDA"
    for k, v in p.to_dict().items():
        if k != "backend":
            assert v == jd[k], k
    assert not hasattr(p, "use_pallas") and not hasattr(p, "warp_backend")
    assert params_from_jax(JParams(backend="DNN").to_dict()).backend == "DIS"
    for alias in ("CPU", "CUDA", "OpenCL", "TPU"):
        assert Params(backend=alias).backend == "CUDA"
    with pytest.raises(ValueError):
        Params(backend="METAL")
    # a reference-shaped config: strings, annotated backend, unknown keys
    p = Params.from_dict({"threads": "4", "detrend_window": "1.5",
                          "backend": "CUDA (unavailable)", "overwrite": "true",
                          "use_pallas": "on", "nonsense": 1})
    assert (p.threads, p.detrend_window, p.backend, p.overwrite) == \
        (4, 1.5, "CUDA", True)


def test_decode_and_funscript_copies(tmp_path):
    for fps, total in ((30.0, 100), (59.94, 1000), (120.0, 7)):
        a = tdec.VideoMeta(total, fps, 320, 240)
        b = jdec.VideoMeta(total, fps, 320, 240)
        assert (a.step, a.effective_fps, a.sampled_indices) == \
            (b.step, b.effective_fps, b.sampled_indices)
    (tmp_path / "v").mkdir()
    for name in ("a.mp4", "b.MKV", "c.txt"):
        (tmp_path / "v" / name).write_text("")
    assert sorted(tdec.find_videos(str(tmp_path / "v"))) == \
        sorted(jdec.find_videos(str(tmp_path / "v")))
    acts = [{"at": 0, "pos": 50}, {"at": 33, "pos": 100}]
    tfs.write_funscript(str(tmp_path / "t.funscript"), acts)
    jfs.write_funscript(str(tmp_path / "j.funscript"), acts)
    assert (tmp_path / "t.funscript").read_bytes() == \
        (tmp_path / "j.funscript").read_bytes()
    assert tfs.funscript_path("/x/y.mp4") == jfs.funscript_path("/x/y.mp4")


def test_cli_flags(monkeypatch):
    p = tcli.build_parser()
    opts = {a.dest for a in p._actions}
    assert "device" in opts
    assert "use_pallas" not in opts and "warp_backend" not in opts
    args = p.parse_args(["clip.mp4"])
    assert args.device == "cuda" and args.backend == "CUDA"
    assert p.parse_args(["clip.mp4", "--device", "cpu"]).device == "cpu"
    # no input: the GUI, as in the JAX package (its launch() replaced here)
    from funscript_flow_tpu_torch.gui import app

    launched = []
    monkeypatch.setattr(app, "launch", lambda: launched.append(1) or 7)
    assert tcli.main([]) == 7 and launched == [1]


@pytest.mark.parametrize("flags", [
    ["--clip_workers", "2", "--checkpoint"], ["--mesh", "2"],
    ["--profile_dir", "PROF"]], ids=["workers-checkpoint", "mesh", "profile"])
def test_cli_parallel_flags_on_a_folder(tmp_path, flags):
    """The CLI runs a folder of two clips with each of the flags that
    PRs before this one refused: worker- or device-tagged logs, no
    sidecar left behind, one trace per clip."""
    import cv2

    d = tmp_path / "lib"
    d.mkdir()
    for i in range(2):
        frames = ref.make_synthetic_frames(8, h=64, w=64, period=6, seed=i)
        vw = cv2.VideoWriter(str(d / f"c{i}.mp4"),
                             cv2.VideoWriter_fourcc(*"mp4v"), 30, (64, 64))
        for f in frames:
            vw.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
        vw.release()
    prof = tmp_path / "prof"
    flags = [str(prof) if f == "PROF" else f for f in flags]
    log = tmp_path / "run.log"
    rc = tcli.main([str(d), "--device", "cpu", "--backend", "DIS",
                    "--pair_batch", "8", "--threads", "1", "--log", str(log),
                    *flags])
    assert rc == 0
    assert sorted(p.name for p in d.iterdir()) == [
        "c0.funscript", "c0.mp4", "c1.funscript", "c1.mp4"]
    text = log.read_text()
    if "--clip_workers" in flags:
        assert "[w0] " in text and "[w1] " in text
    if "--mesh" in flags:
        assert "[dev0] " in text and "[dev1] " in text
    if "--profile_dir" in flags:
        assert len(list(prof.iterdir())) == 2


def test_cli_runs_on_cpu(tmp_path):
    import cv2

    frames = ref.make_synthetic_frames(8, h=64, w=64, period=6, seed=4)
    p = tmp_path / "c.mp4"
    vw = cv2.VideoWriter(str(p), cv2.VideoWriter_fourcc(*"mp4v"), 30, (64, 64))
    for f in frames:
        vw.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
    vw.release()
    rc = tcli.main([str(p), "--device", "cpu", "--pair_batch", "16",
                    "--threads", "1", "--log", str(tmp_path / "run.log")])
    assert rc == 0
    assert os.path.exists(tmp_path / "c.funscript")


# ---------------------------------------------------- decode from a file


@pytest.fixture(scope="module")
def decode_clips(tmp_path_factory):
    """Three cv2-written mp4v clips at odd sizes and frame rates (30, 60
    and 59.94 fps: steps 1, 2 and 2)."""
    d = tmp_path_factory.mktemp("decode")
    out = []
    for i, (h, w, fps, n) in enumerate(((120, 120, 30.0, 40),
                                        (90, 160, 60.0, 70),
                                        (60, 80, 59.94, 66))):
        frames = ref.make_synthetic_frames(n, h=h, w=w, period=9, seed=40 + i)
        p = str(d / f"c{i}.mp4")
        import cv2

        vw = cv2.VideoWriter(p, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
        for f in frames:
            vw.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
        vw.release()
        out.append(p)
    return out


def _drain(src):
    out = []
    while True:
        b = src.get_batch(5)
        if not b:
            break
        out.extend(b)
    src.close()
    return np.stack(out)


@pytest.mark.parametrize("gray", [False, True], ids=["rgb", "gray"])
@pytest.mark.parametrize("vr", [False, True], ids=["flat", "vr"])
@pytest.mark.parametrize("kind", ["sampled", "prefetch", "sharded3"])
def test_decode_from_file_matches_jax(decode_clips, kind, vr, gray):
    """The port's cv2 decode of a file, bitwise against JAX's: its
    ``sampled_frames``, ``PrefetchingFrameSource`` and a 3-shard
    ``ShardedFrameSource``, on three clips."""
    for path in decode_clips:
        tmeta, jmeta = tdec.probe(path), jdec.probe(path)
        assert (tmeta.total_frames, tmeta.fps, tmeta.step) == \
            (jmeta.total_frames, jmeta.fps, jmeta.step)
        got = {}
        for name, dec, meta in (("torch", tdec, tmeta), ("jax", jdec, jmeta)):
            if kind == "sampled":
                got[name] = np.stack(list(dec.sampled_frames(
                    path, meta, vr, gray=gray)))
                continue

            def factory(start, count, depth, dec=dec, meta=meta):
                return dec.PrefetchingFrameSource(
                    path, meta, vr, depth=depth, start_sample=start,
                    max_samples=count, gray=gray)

            src = (factory(0, -1, 16) if kind == "prefetch" else
                   dec.ShardedFrameSource(factory,
                                          len(meta.sampled_indices), 3,
                                          depth=16, gray=gray))
            got[name] = _drain(src)
        assert len(got["torch"]) == len(tmeta.sampled_indices)
        np.testing.assert_array_equal(got["torch"], got["jax"])
