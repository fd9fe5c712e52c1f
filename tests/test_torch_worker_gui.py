"""The port's BatchWorker, config persistence and GUI (tkinter), headless,
after tests/test_worker_cli.py, tests/test_player.py and the config,
preview and drop cases of tests/test_aux.py; where the JAX package has the
same function, both are held to the same outputs."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import reference_cv as ref
from funscript_flow_tpu.gui import app as japp
from funscript_flow_tpu.gui import player as jplayer
from funscript_flow_tpu.gui import preview as jpreview
from funscript_flow_tpu.utils.config import save_config as jax_save_config
from funscript_flow_tpu.utils.params import Params as JParams
from funscript_flow_tpu_torch import runner as trun
from funscript_flow_tpu_torch.gui import app as tapp
from funscript_flow_tpu_torch.gui import player as tplayer
from funscript_flow_tpu_torch.gui import preview as tpreview
from funscript_flow_tpu_torch.io.decode import VideoMeta
from funscript_flow_tpu_torch.io.funscript import funscript_path
from funscript_flow_tpu_torch.utils.backends import get_available_backends
from funscript_flow_tpu_torch.utils.config import load_config, save_config
from funscript_flow_tpu_torch.utils.params import Params
from funscript_flow_tpu_torch.worker import BatchWorker

# the tests run in several worker processes at once: one torch thread
# each keeps them from oversubscribing the cores
torch.set_num_threads(1)


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
    """Three placeholder clips (30, 36 and 42 frames of 64x64 gray) that
    ``runner._open_video`` serves from memory. Returns the clip paths."""
    clips = {}
    for i, n in enumerate((30, 36, 42)):
        name = f"clip{i}.mp4"
        (tmp_path / name).write_bytes(b"placeholder")
        clips[name] = [ref.rgb_to_gray(f) for f in ref.make_synthetic_frames(
            n, h=64, w=64, period=8 + i, seed=30 + i)]

    def fake_open(video_path, params, cancel_flag, start_sample=0):
        frames = clips[os.path.basename(video_path)]
        return (VideoMeta(len(frames), 30.0, 64, 64),
                ListSource(frames[start_sample:]))

    monkeypatch.setattr(trun, "_open_video", fake_open)
    return [str(tmp_path / name) for name in sorted(clips)]


def _run_worker(files, params, tmp_path, **kw):
    progress, vprogress, logs, done = [], [], [], []
    w = BatchWorker(files, params, on_progress=progress.append,
                    on_video_progress=vprogress.append, on_log=logs.append,
                    on_finished=lambda e, g: done.append((e, g)),
                    logs_dir=str(tmp_path / "logs"), device="cpu", **kw)
    w.start()
    w.join(timeout=600)
    assert not w.is_alive()
    return w, progress, vprogress, logs, done


# ----------------------------------------------------------- BatchWorker


@pytest.mark.parametrize("workers", [0, 2], ids=["sequential", "2-workers"])
@pytest.mark.parametrize("backend", ["CUDA", "DIS"])
def test_batch_worker_end_to_end(fake_folder, tmp_path, backend, workers):
    """Every clip generated, the log file written, progress at 100, and each
    funscript byte-identical to a direct ``process_video`` of the clip."""
    params = Params(overwrite=True, pair_batch=16, backend=backend,
                    clip_workers=workers)
    w, progress, vprogress, logs, done = _run_worker(fake_folder, params,
                                                     tmp_path)
    err, generated = done[0]
    assert not err and w.device == torch.device("cpu")
    assert sorted(generated) == sorted((f, funscript_path(f))
                                       for f in fake_folder)
    assert progress[-1] == 100 and vprogress[-1] == 100
    assert any("Batch processing complete" in m for m in logs)
    text = open(w.log_path).read()
    assert os.path.dirname(w.log_path) == str(tmp_path / "logs")
    assert "Processing file 1/3" in text and "Found 3 file(s)." in text
    for f in fake_folder:
        got = open(funscript_path(f), "rb").read()
        os.remove(funscript_path(f))
        assert not trun.process_video(f, dataclasses.replace(
            params, clip_workers=0), lambda m: None, device="cpu")
        assert open(funscript_path(f), "rb").read() == got


def test_batch_worker_cancel(fake_folder, tmp_path):
    w = BatchWorker(fake_folder, Params(overwrite=True, pair_batch=16),
                    logs_dir=str(tmp_path / "logs"), device="cpu")
    w.cancel()  # before start: the loop exits at its first check
    w.start()
    w.join(timeout=120)
    assert not w.is_alive() and w.cancelled
    assert w.generated == []
    assert "User bailed." in open(w.log_path).read()


def test_batch_worker_failed_clip_not_generated(fake_folder, tmp_path):
    """A clip that fails to open is logged and left out of ``generated``."""
    bad = str(tmp_path / "unreadable.mp4")
    with open(bad, "wb"):
        pass
    w, progress, _, logs, done = _run_worker(
        [bad] + fake_folder[:1], Params(overwrite=True, pair_batch=16),
        tmp_path)
    err, generated = done[0]
    assert err and generated == [(fake_folder[0],
                                  funscript_path(fake_folder[0]))]
    assert any(m.startswith("ERROR: Unable to open video") for m in logs)
    assert progress[-1] == 100


def test_batch_worker_defaults_to_cuda():
    """Like every entry point: ``cuda`` unless asked for the CPU, and a
    raise without it, not a fallback."""
    if torch.cuda.is_available():
        assert BatchWorker([], Params()).device == torch.device("cuda", 0)
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            BatchWorker([], Params())


def test_batch_worker_on_a_file(tmp_path):
    """A real cv2-written file through the worker: decoded by the native
    pump, the funscript written next to it."""
    import cv2

    frames = ref.make_synthetic_frames(8, h=64, w=64, period=4, seed=8)
    p = str(tmp_path / "f.mp4")
    vw = cv2.VideoWriter(p, cv2.VideoWriter_fourcc(*"mp4v"), 30, (64, 64))
    for f in frames:
        vw.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
    vw.release()
    w, progress, _, logs, done = _run_worker(
        [p], Params(overwrite=True, pair_batch=16, threads=1), tmp_path)
    assert done[0] == (False, [(p, funscript_path(p))])
    assert any(m.startswith("Decode: native pump") for m in logs), logs
    acts = json.load(open(funscript_path(p)))["actions"]
    assert acts and all(0 <= a["pos"] <= 100 for a in acts)


# ---------------------------------------------------------------- config


def test_config_roundtrip(tmp_path):
    p = Params(detrend_window=1.5, vr_mode=True, cut_threshold=5.0,
               backend="DIS", use_native_decode="on")
    cfg = tmp_path / "config.json"
    save_config(p, str(cfg))
    assert load_config(str(cfg)) == p
    assert json.loads(cfg.read_text()) == p.to_dict()


def test_config_missing_and_corrupt(tmp_path):
    assert load_config(str(tmp_path / "absent.json")) == Params()
    bad = tmp_path / "bad.json"
    bad.write_text("{nope")
    assert load_config(str(bad)) == Params()
    extra = tmp_path / "extra.json"
    extra.write_text(json.dumps({"vr_mode": True, "future_knob": 1}))
    assert load_config(str(extra)).vr_mode is True


def test_config_reference_shaped(tmp_path):
    """A config.json of the reference app: numbers as strings, an annotated
    backend (FunscriptFlow.pyw:2266-2281, 2022-2036); one bad value keeps
    its default and the rest loads."""
    cfg = tmp_path / "config.json"
    cfg.write_text(json.dumps({
        "threads": "12", "detrend_window": "1.5", "norm_window": "4",
        "batch_size": "2000", "overwrite": True, "vr_mode": False,
        "pov_mode": True, "backend": "DNN (unavailable)",
        "keyframe_reduction": True}))
    assert load_config(str(cfg)) == Params(
        threads=12, detrend_window=1.5, norm_window=4.0, batch_size=2000,
        overwrite=True, pov_mode=True, backend="DIS")
    part = tmp_path / "partial.json"
    part.write_text(json.dumps({"threads": "lots", "vr_mode": True}))
    q = load_config(str(part))
    assert q.threads == 8 and q.vr_mode is True


@pytest.mark.parametrize("backend", ["TPU", "DIS"])
def test_config_saved_by_jax_loads(tmp_path, backend):
    """A config the JAX package saved (its TPU knobs and backend names
    included) loads into the port's Params: shared keys keep their values,
    TPU becomes CUDA, the TPU-only knobs are dropped."""
    jp = JParams(threads=3, detrend_window=1.25, norm_window=2.5,
                 overwrite=True, vr_mode=True, backend=backend,
                 cut_threshold=6.0, pair_batch=120, use_pallas="off",
                 warp_backend="xla", dis_preset="medium",
                 decode_quality="exact", use_native_decode="off",
                 checkpoint=True)
    cfg = tmp_path / "config.json"
    jax_save_config(jp, str(cfg))
    p = load_config(str(cfg))
    jd = jp.to_dict()
    for k, v in p.to_dict().items():
        if k != "backend":
            assert v == jd[k], k
    assert p.backend == {"TPU": "CUDA", "DIS": "DIS"}[backend]
    # and back: the port's file loads in the JAX package too
    save_config(p, str(cfg))
    from funscript_flow_tpu.utils.config import load_config as jax_load

    assert jax_load(str(cfg)).vr_mode and jax_load(str(cfg)).threads == 3


# ------------------------------------------------------------------- GUI

BASE = {"threads": "8", "detrend_window": "2", "norm_window": "3",
        "batch_size": "3000", "overwrite": False, "vr_mode": False,
        "pov_mode": False, "keyframe_reduction": True}


@pytest.mark.parametrize("display,resolved", [
    ("CUDA (available)", "CUDA"), ("DIS (available)", "DIS"),
    ("CPU (-> CUDA, available)", "CUDA"), ("TPU (-> CUDA, no device!)",
                                           "CUDA"),
    ("OpenCL (-> CUDA, no device!)", "CUDA"), ("DNN (-> DIS, available)",
                                               "DIS")])
def test_gui_backend_dropdown_covers_cli_choices(display, resolved):
    """Every --backend name the CLI accepts survives the dropdown's
    annotated display string (reference :2008-2013)."""
    assert tapp.collect_settings({**BASE, "backend": display}).backend \
        == resolved


def test_collect_settings_full_params_surface():
    """Every Params field driven to a non-default value round-trips, so a
    field the GUI forgets fails; the TPU knobs are gone."""
    non_default = {
        "threads": "4", "detrend_window": "1.5", "norm_window": "4",
        "batch_size": "100", "cut_threshold": "6", "mesh": "4",
        "clip_workers": "3", "pair_batch": "64", "overwrite": True,
        "vr_mode": True, "pov_mode": True, "keyframe_reduction": False,
        "backend": "DIS (available)", "dis_preset": "medium",
        "decode_quality": "exact", "use_native_decode": "on",
        "signal_backend": "device", "profile_dir": "/tmp/prof",
        "checkpoint": True,
    }
    assert set(non_default) == {f.name for f in dataclasses.fields(Params)}
    p = tapp.collect_settings(non_default)
    defaults = Params()
    for f in dataclasses.fields(Params):
        assert getattr(p, f.name) != getattr(defaults, f.name), f.name
    # the JAX GUI maps the same widgets to the same shared fields
    jp = japp.collect_settings(non_default)
    for k, v in p.to_dict().items():
        assert getattr(jp, k) == v, k


def test_gui_source_has_device_selector_and_no_tpu_knobs():
    import inspect

    src = inspect.getsource(tapp)
    assert "use_pallas" not in src and "warp_backend" not in src
    assert tapp.DEVICES[0] == "cuda" and "cpu" in tapp.DEVICES
    assert "device=v_device.get()" in src


def test_expand_dropped_paths_nonrecursive_quirk(tmp_path):
    (tmp_path / "a.mp4").touch()
    (tmp_path / "b.txt").touch()
    sub = tmp_path / "sub"
    sub.mkdir()
    (sub / "c.mkv").touch()
    args = [str(tmp_path), str(sub / "c.mkv"), str(tmp_path / "b.txt")]
    got = tapp.expand_dropped_paths(args)
    assert got == [str(tmp_path / "a.mp4"), str(sub / "c.mkv")]
    assert got == japp.expand_dropped_paths(args)


def test_paths_from_clipboard_text(tmp_path):
    (tmp_path / "a.mp4").touch()
    sub = tmp_path / "sub"
    sub.mkdir()
    (sub / "c.mkv").touch()
    text = (f"file://{sub / 'c.mkv'}\r\n{tmp_path}\n\n"
            f"{tmp_path / 'missing.mp4'}\n")
    got = tapp.paths_from_clipboard_text(text)
    assert got == [str(sub / "c.mkv"), str(tmp_path / "a.mp4")]
    assert got == japp.paths_from_clipboard_text(text)


def test_preview_html(tmp_path):
    actions = [{"at": 0, "pos": 10}, {"at": 500, "pos": 90}]
    html = tpreview.render_preview_html("clip.mp4", actions)
    assert html == jpreview.render_preview_html("clip.mp4", actions)
    assert "canvas" in html and json.dumps(actions) in html
    video = tmp_path / "clip.mp4"
    video.write_bytes(b"")
    with open(tmp_path / "clip.funscript", "w") as f:
        json.dump({"version": "1.0", "actions": actions}, f)
    out = tpreview.write_preview(str(video))
    assert out.endswith(".preview.html") and os.path.exists(out)


ACTIONS = [{"at": 0, "pos": 10}, {"at": 1000, "pos": 90},
           {"at": 2000, "pos": 30}]


def test_player_math_matches_jax():
    """fit_box, frame_to_ppm and the PreviewModel's timeline math (value
    interpolation, zoom, pan, follow, polyline, grid) equal JAX's."""
    for args in ((1920, 1080, 640, 640), (1080, 1920, 640, 640),
                 (0, 0, 640, 360)):
        assert tplayer.fit_box(*args) == jplayer.fit_box(*args)
    rgb = np.random.default_rng(0).integers(0, 256, (7, 5, 3), np.uint8)
    assert tplayer.frame_to_ppm(rgb) == jplayer.frame_to_ppm(rgb)
    models = [m.PreviewModel(ACTIONS, 2000) for m in (tplayer, jplayer)]
    for m in models:
        m.zoom_at(300, 640, 4.0)
        m.pan_by(-120, 640)
        m.follow(1900)
    t, j = models
    for ms in (-50, 0, 500, 1000, 1500, 5000):
        assert t.script_value(ms) == j.script_value(ms)
    assert t.polyline(640, 200) == j.polyline(640, 200)
    assert t.grid_columns(640) == j.grid_columns(640)
    assert t.x_to_ms(123, 640) == j.x_to_ms(123, 640)


def test_playback_clock_seek_clamps():
    c = tplayer.PlaybackClock(1000)
    c.seek(5000)
    assert c.position_ms() == 1000
    c.seek(-5)
    assert c.position_ms() == 0


def test_frame_reader_reads_a_clip(tmp_path):
    import cv2

    p = str(tmp_path / "clip.mp4")
    vw = cv2.VideoWriter(p, cv2.VideoWriter_fourcc(*"mp4v"), 30, (64, 48))
    for i in range(10):
        f = np.zeros((48, 64, 3), np.uint8)
        f[..., 2] = i * 16
        vw.write(f)
    vw.release()
    r = tplayer.FrameReader(p)
    assert (r.width, r.height, r.frame_count) == (64, 48, 10)
    assert int(np.round(r.frame_at(10_000)[..., 0].mean() / 16)) == 9
    assert r.seeks == 0
    r.close()


def test_open_preview_window_fallback_without_display(tmp_path):
    """An unopenable video returns None (the app then falls back to the
    browser page) before any tk object is made, so this holds headless."""
    bogus = tmp_path / "not_a_video.mp4"
    bogus.write_bytes(b"plainly not a container")
    assert tplayer.open_preview_window(None, str(bogus)) is None


def test_launch_without_tkinter_points_to_the_cli(monkeypatch, capsys):
    import builtins

    real_import = builtins.__import__

    def no_tk(name, *a, **k):
        if name == "tkinter" or name.startswith("tkinter."):
            raise ImportError("no tkinter")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_tk)
    assert tapp.launch() == 2
    assert "python -m funscript_flow_tpu_torch" in capsys.readouterr().out


def test_tkinter_imports_headless():
    import tkinter  # noqa: F401  (8.6 on this box; no display needed)

    assert tkinter.TkVersion >= 8.6


def test_backends_report_native_decode():
    b = get_available_backends()
    assert b["DIS"] and b["CPU"] and b["native_decode"] is True
    assert b["CUDA"] == torch.cuda.is_available()
