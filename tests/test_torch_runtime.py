"""The port's native decode runtime (``funscript_flow_tpu_torch.runtime``)
against the JAX package's (``funscript_flow_tpu.runtime``), bitwise, on the
same files; its exact engine against the port's own cv2 path; a build with
OpenCV compiled out; the runner's engine choice, with the no-fallback rule
of ``use_native_decode="on"``; the checkpoint's engine; and the default
decode path of both packages' ``process_video`` on a file."""

import functools
import json
import os

import numpy as np
import pytest
import torch

import reference_cv as ref
from funscript_flow_tpu import runner as jrun
from funscript_flow_tpu import runtime as jrt
from funscript_flow_tpu.models import pipeline as jpl
from funscript_flow_tpu.utils.params import Params as JParams
from funscript_flow_tpu_torch import runner as trun
from funscript_flow_tpu_torch import runtime as trt
from funscript_flow_tpu_torch.io import checkpoint as tck
from funscript_flow_tpu_torch.io import decode as tdec
from funscript_flow_tpu_torch.runtime import _build as tbuild
from funscript_flow_tpu_torch.utils.params import Params

# the tests run in several worker processes at once: one torch thread
# each keeps them from oversubscribing the cores
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def write_cv2(path, frames, fps):
    import cv2

    h, w = frames[0].shape[:2]
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    for f in frames:
        vw.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
    vw.release()
    return path


def collect(source, n=7):
    """Every frame of ``source`` in batches of ``n`` (odd: batches straddle
    the direct-write slabs), then close it."""
    out = []
    while True:
        batch = source.get_batch(n)
        if not batch:
            break
        out.extend(batch)
    source.close()
    return np.stack(out) if out else np.zeros((0,), np.uint8)


@pytest.fixture(scope="module")
def pumps():
    """Both packages' pumps, built once per module (the JAX one with its own
    Makefile, the port's into build/funscript_flow_tpu_torch/)."""
    assert trt.available(), trt.unavailable_reason()
    assert jrt.available()
    return trt, jrt


@pytest.fixture(scope="module")
def mp4v_clip(tmp_path_factory):
    """cv2-written mp4v, 320x200 at 60 fps: step 2."""
    d = tmp_path_factory.mktemp("mp4v")
    frames = ref.make_synthetic_frames(40, h=200, w=320, period=10, seed=4)
    return write_cv2(str(d / "clip.mp4"), frames, 60)


@pytest.fixture(scope="module")
def h264_clip(tmp_path_factory, pumps):
    """Long-GOP h264 with B-frames written by the port's encoder, 60 fps:
    120 samples, enough for 3 decode shards."""
    assert trt.encoder_available("libx264")
    d = tmp_path_factory.mktemp("h264")
    frames = ref.make_synthetic_frames(240, h=200, w=320, period=12, seed=9)
    p = str(d / "clip264.mp4")
    with trt.VideoEncoder(p, 320, 200, 60.0, codec="libx264", gop=250,
                          bframes=3) as enc:
        for f in frames:
            enc.write(np.ascontiguousarray(f[..., ::-1]))  # RGB -> BGR
    return p


@pytest.fixture(params=["mp4v", "h264"])
def clip(request, mp4v_clip, h264_clip):
    return mp4v_clip if request.param == "mp4v" else h264_clip


# ---------------------------------------------------------------- the pump


@pytest.mark.parametrize("vr", [False, True], ids=["flat", "vr"])
@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
def test_pump_matches_jax_pump(pumps, clip, fast, vr):
    """Self-probed gray decode, both engines: the same frames, bitwise."""
    got = trt.NativeFrameSource(clip, None, vr, gray=True, fast=fast)
    want = jrt.NativeFrameSource(clip, None, vr, gray=True, fast=fast)
    assert got.is_fast == want.is_fast == fast
    assert got.meta.step == want.meta.step == 2
    n = len(got.meta.sampled_indices)
    a, b = collect(got), collect(want)
    assert a.shape == b.shape == (n, 256, 256)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("vr", [False, True], ids=["flat", "vr"])
def test_pump_rgb_matches_jax_pump(pumps, mp4v_clip, vr):
    """The exact engine's RGB output (gray=False; fast asks are ignored)."""
    a = collect(trt.NativeFrameSource(mp4v_clip, None, vr, fast=True))
    b = collect(jrt.NativeFrameSource(mp4v_clip, None, vr, fast=True))
    assert a.shape == (20, 256, 256, 3)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
def test_range_decode_matches_jax_and_full_read(pumps, clip, fast):
    """start_sample/max_samples: the slice of a full read, and JAX's."""
    meta = tdec.probe(clip)
    full = collect(trt.NativeFrameSource(clip, meta, gray=True, fast=fast))
    got = collect(trt.NativeFrameSource(clip, meta, gray=True, fast=fast,
                                        start_sample=7, max_samples=9))
    want = collect(jrt.NativeFrameSource(clip, meta, gray=True, fast=fast,
                                         start_sample=7, max_samples=9))
    np.testing.assert_array_equal(got, full[7:16])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("vr", [False, True], ids=["flat", "vr"])
def test_direct_slabs_match_classic_queue(pumps, h264_clip, vr):
    """Direct-write slabs against the pump's bounded queue, and JAX's."""
    meta = tdec.probe(h264_clip)
    direct = collect(trt.NativeFrameSource(h264_clip, meta, vr, gray=True,
                                           fast=True, direct=True))
    classic = collect(trt.NativeFrameSource(h264_clip, meta, vr, gray=True,
                                            fast=True, direct=False))
    want = collect(jrt.NativeFrameSource(h264_clip, meta, vr, gray=True,
                                         fast=True, direct=False))
    assert len(direct) == len(meta.sampled_indices) == 120
    np.testing.assert_array_equal(direct, classic)
    np.testing.assert_array_equal(direct, want)


def test_direct_slab_boundaries(pumps, tmp_path):
    """Streams exactly one slab long and one frame longer end cleanly."""
    n_slab = trt.NativeFrameSource.SLAB_FRAMES
    frames = ref.make_synthetic_frames(n_slab + 1, h=32, w=32, period=9,
                                       seed=2)
    for n in (n_slab, n_slab + 1):
        p = write_cv2(str(tmp_path / f"c{n}.mp4"), frames[:n], 30)
        got = collect(trt.NativeFrameSource(p, None, gray=True, fast=True))
        assert len(got) == n


@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
def test_self_probed_meta_and_step(pumps, clip, fast):
    """``.meta`` and ``step`` from the pump's own open: JAX's, and the
    port's cv2 probe."""
    src = trt.NativeFrameSource(clip, None, gray=True, fast=fast)
    jsrc = jrt.NativeFrameSource(clip, None, gray=True, fast=fast)
    got, want, probed = src.meta, jsrc.meta, tdec.probe(clip)
    src.close()
    jsrc.close()
    assert type(got) is tdec.VideoMeta
    for m in (want, probed):
        assert (got.fps, got.total_frames, got.width, got.height, got.step) \
            == (m.fps, m.total_frames, m.width, m.height, m.step)
    assert got.step == 2


@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
def test_bad_file_fails_the_open(pumps, tmp_path, fast):
    bad = tmp_path / "bad.mp4"
    bad.write_bytes(b"junk")
    with pytest.raises(IOError, match="Cannot open video"):
        trt.NativeFrameSource(str(bad), None, gray=True, fast=fast)
    with pytest.raises(IOError):
        jrt.NativeFrameSource(str(bad), None, gray=True, fast=fast)


def test_cancel(pumps, h264_clip):
    flag = {"c": False}
    src = trt.NativeFrameSource(h264_clip, None, gray=True, fast=True,
                                cancel_flag=lambda: flag["c"])
    assert len(src.get_batch(4)) == 4
    flag["c"] = True
    assert src.get_batch(4) == []
    src.close()
    assert src.is_fast  # the engine still reads once the handle is freed


@pytest.mark.parametrize("codec", ["libx264", "mpeg4"])
def test_port_encoder_output_decodes_identically(pumps, tmp_path, codec):
    """A clip written by the port's encoder decodes to the same frames
    through both pumps, in both engines."""
    frames = ref.make_synthetic_frames(30, h=120, w=160, period=8, seed=3)
    p = str(tmp_path / f"e_{codec}.mp4")
    with trt.VideoEncoder(p, 160, 120, 30.0, codec=codec) as enc:
        for f in frames:
            enc.write(np.ascontiguousarray(f[..., ::-1]))
    for fast in (False, True):
        a = collect(trt.NativeFrameSource(p, None, gray=True, fast=fast))
        b = collect(jrt.NativeFrameSource(p, None, gray=True, fast=fast))
        assert len(a) == 30
        np.testing.assert_array_equal(a, b)


# the clip kinds of the JAX package's runtime fixtures
# (tests/test_native_runtime.py): id -> (container, codec, B-frames, the
# encoder's other arguments). The mpegvideo family is written at 640x544,
# where the fast engine decodes at half resolution (lowres 1).
_KINDS = {
    "hevc": ("mp4", "libx265", 3, {}),
    "vp9": ("webm", "libvpx-vp9", 0, {}),
    "av1": ("webm", "libaom-av1", 0, {}),
    "avi_mpeg4": ("avi", "mpeg4", 2, {}),
    "mov_h264": ("mov", "libx264", 3, {}),
    "mkv_h264": ("mkv", "libx264", 3, {}),
    "wmv_wmv2": ("wmv", "wmv2", 0, {}),
    "flv_flv1": ("flv", "flv", 0, {}),
    "mpg_mpeg2": ("mpg", "mpeg2video", 2, {}),
    "ts_mpeg2": ("ts", "mpeg2video", 2, {}),
    "h264_10bit": ("mp4", "libx264", 2, {"pix_fmt": "yuv420p10le"}),
    "hevc_10bit": ("mp4", "libx265", 2, {"pix_fmt": "yuv420p10le"}),
    "rot90": ("mp4", "libx264", 2, {"rotation": 90}),
    "rot180": ("mp4", "libx264", 2, {"rotation": 180}),
    "rot270": ("mp4", "libx264", 2, {"rotation": 270}),
    "h264_mbaff": ("mp4", "libx264", 2, {"interlaced": True}),
    "mpeg2_ilace": ("mpg", "mpeg2video", 2, {"interlaced": True}),
    "vfr": ("mp4", "libx264", 2, {}),
    "cover_art": ("mp4", "libx264", 2, {}),
}
_MPEGVIDEO = ("mpeg4", "wmv2", "flv", "mpeg2video")


@pytest.mark.parametrize("kind", list(_KINDS))
def test_pump_matches_jax_across_codecs(pumps, tmp_path, kind):
    """Clips the port's encoder writes in each codec, container and stream
    layout the JAX package's runtime tests cover (10-bit, display rotation,
    interlaced, variable frame rate with dropped frames, a cover-art
    stream): both pumps self-probe the same metadata and decode the same
    frames, bitwise, in both engines, from the start and from a range."""
    import cv2

    ext, codec, bframes, kw = _KINDS[kind]
    if not trt.encoder_available(codec, ext=ext,
                                 pix_fmt=kw.get("pix_fmt", "")):
        pytest.skip(f"{codec} in .{ext} cannot be encoded here")
    h, w = (544, 640) if codec in _MPEGVIDEO else (144, 176)
    frames = ref.make_synthetic_frames(60, h=h, w=w, period=12, seed=13)
    p = str(tmp_path / f"clip.{ext}")
    with trt.VideoEncoder(p, w, h, 30.0, codec=codec, gop=25,
                          bframes=bframes, **kw) as enc:
        for i, f in enumerate(frames):
            if kind == "vfr" and i % 7 == 3:
                continue  # a dropped frame: a gap in the timestamps
            enc.write(np.ascontiguousarray(f[..., ::-1]),
                      pts=i if kind == "vfr" else None)
    if kind == "cover_art":  # an attached picture larger than the video
        cover = str(tmp_path / "cover.jpg")
        cv2.imwrite(cover, np.full((512, 512, 3), 200, np.uint8))
        dst = str(tmp_path / "with_cover.mkv")
        assert trt.add_cover_art(p, dst, cover, 512, 512)
        p = dst
    display = (h, w) if kind in ("rot90", "rot270") else (w, h)
    for fast in (False, True):
        got = trt.NativeFrameSource(p, None, gray=True, fast=fast)
        want = jrt.NativeFrameSource(p, None, gray=True, fast=fast)
        assert got.is_fast == want.is_fast == fast
        gm, wm = got.meta, want.meta
        assert (gm.fps, gm.total_frames, gm.width, gm.height, gm.step) == \
            (wm.fps, wm.total_frames, wm.width, wm.height, wm.step)
        assert (gm.width, gm.height) == display
        a = collect(got)
        np.testing.assert_array_equal(a, collect(want))
        assert len(a) == len(gm.sampled_indices)
        part = [collect(rt.NativeFrameSource(p, m, gray=True, fast=fast,
                                             start_sample=31, max_samples=20))
                for rt, m in ((trt, gm), (jrt, wm))]
        np.testing.assert_array_equal(part[0], part[1])
        if fast:  # the sharded-decode invariant of the fast engine
            np.testing.assert_array_equal(part[0], a[31:51])


@pytest.mark.parametrize("gray", [False, True], ids=["rgb", "gray"])
@pytest.mark.parametrize("vr", [False, True], ids=["flat", "vr"])
def test_exact_engine_matches_port_cv2_path(pumps, clip, vr, gray):
    """The pump's exact engine equals the port's own cv2 decode, bitwise."""
    meta = tdec.probe(clip)
    want = np.stack(list(tdec.sampled_frames(clip, meta, vr, gray=gray)))
    got = collect(trt.NativeFrameSource(clip, meta, vr, gray=gray))
    np.testing.assert_array_equal(got, want)


def test_library_is_built_outside_the_package(pumps):
    """The .so is built into build/funscript_flow_tpu_torch/, named by the
    sources' hash; nothing is written into either package's directory."""
    path = trt.library_path()
    assert os.path.dirname(path) == os.path.join(
        ROOT, "build", "funscript_flow_tpu_torch")
    assert os.path.basename(path).startswith("libframe_pump-")
    pkg = os.path.join(ROOT, "funscript_flow_tpu_torch", "runtime")
    assert not [f for f in os.listdir(pkg) if f.endswith(".so")]
    assert trt.has_exact()  # this machine has OpenCV's headers


# ------------------------------------------------ OpenCV compiled out


@pytest.fixture(scope="module")
def fast_only(tmp_path_factory, pumps):
    """The runtime built without the exact engine (the builder's macro
    forced off), in a build directory of its own."""
    import ctypes

    path = tbuild.build(tmp_path_factory.mktemp("fast_only"), exact=False)
    assert path != tbuild.build()
    return trt._bind(ctypes.CDLL(str(path)))


def test_fast_only_build_fast_engine_bitwise(fast_only, clip, monkeypatch):
    monkeypatch.setattr(trt, "_lib", fast_only)
    assert not trt.has_exact()
    for vr in (False, True):
        src = trt.NativeFrameSource(clip, None, vr, gray=True, fast=True)
        assert src.is_fast
        got = collect(src)
        monkeypatch.undo()
        want = collect(trt.NativeFrameSource(clip, None, vr, gray=True,
                                             fast=True))
        monkeypatch.setattr(trt, "_lib", fast_only)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("ask", [{"gray": True, "fast": False},
                                 {"gray": False, "fast": True}],
                         ids=["exact", "rgb"])
def test_fast_only_build_refuses_exact(fast_only, mp4v_clip, monkeypatch,
                                       ask):
    """An open the fast engine cannot serve fails with the pump's reason;
    it does not switch engines."""
    monkeypatch.setattr(trt, "_lib", fast_only)
    with pytest.raises(IOError, match="exact engine is not built"):
        trt.NativeFrameSource(mp4v_clip, None, **ask)


def test_fast_only_build_bad_file_reason(fast_only, tmp_path, monkeypatch):
    bad = tmp_path / "bad.mp4"
    bad.write_bytes(b"junk")
    monkeypatch.setattr(trt, "_lib", fast_only)
    with pytest.raises(IOError, match="libav cannot open the file"):
        trt.NativeFrameSource(str(bad), None, gray=True, fast=True)


# ------------------------------------------ the runner's engine choice


@pytest.fixture
def no_pump(monkeypatch, tmp_path):
    """Point the builder at an empty build directory and forget the loaded
    library, so that the next use builds again; restore both after."""
    monkeypatch.setattr(tbuild, "BUILD_DIR", tmp_path / "build")
    trt._reset()
    yield monkeypatch
    monkeypatch.undo()
    trt._reset()


@pytest.fixture(scope="module")
def small_clip(tmp_path_factory):
    d = tmp_path_factory.mktemp("small")
    frames = ref.make_synthetic_frames(8, h=64, w=64, period=6, seed=5)
    return write_cv2(str(d / "s.mp4"), frames, 30)


def _no_cv2(monkeypatch):
    """Make every entry of the port's cv2 decode path fail the test."""
    def boom(*a, **k):
        raise AssertionError("the port decoded through cv2")

    monkeypatch.setattr(tdec, "probe", boom)
    monkeypatch.setattr(tdec, "sampled_frames", boom)
    monkeypatch.setattr(tdec, "PrefetchingFrameSource", boom)


@pytest.mark.parametrize("cause", ["compiler", "headers", "build"])
def test_native_on_without_pump_fails_the_clip(no_pump, small_clip, tmp_path,
                                               cause):
    """use_native_decode="on" without a buildable pump: the clip fails with
    an ERROR line naming the cause, and nothing decodes through cv2."""
    if cause == "compiler":
        no_pump.setattr(tbuild, "CXX", str(tmp_path / "no-such-g++"))
        why = "no C++ compiler"
    elif cause == "headers":
        no_pump.setattr(tbuild, "find_libav", lambda: None)
        why = "no libav headers"
    else:
        no_pump.setattr(tbuild, "CXXFLAGS", ("-fPIC", "-shared", "-include",
                                             "no-such-header.h"))
        why = "build error"
    _no_cv2(no_pump)
    logs = []
    err = trun.process_video(small_clip, Params(use_native_decode="on",
                                                overwrite=True),
                             logs.append, device="cpu")
    assert err
    errors = [m for m in logs if m.startswith("ERROR")]
    assert len(errors) == 1 and "native decode requested but unavailable" \
        in errors[0] and why in errors[0], logs
    assert not os.path.exists(small_clip.rsplit(".", 1)[0] + ".funscript")


def test_native_auto_without_pump_logs_why(no_pump, small_clip, tmp_path):
    """``auto`` decodes through cv2 when the pump cannot build, and the
    clip's log says so and why."""
    no_pump.setattr(tbuild, "CXX", str(tmp_path / "no-such-g++"))
    logs = []
    err = trun.process_video(small_clip, Params(overwrite=True, pair_batch=8,
                                                threads=1),
                             logs.append, device="cpu")
    assert not err, logs
    assert any(m.startswith("Decode: OpenCV (cv2); native pump not taken: "
                            "no C++ compiler") for m in logs), logs


@pytest.mark.parametrize("kw,engine", [
    ({"threads": 1}, "native pump, fast engine"),
    ({"threads": 1, "decode_quality": "exact"}, "native pump, exact engine"),
    ({"threads": 1, "norm_window": 60.0}, "native pump, exact engine"),
    ({"threads": 3}, "native pump, fast engine, 3 shards"),
    ({"threads": 1, "use_native_decode": "off"}, "OpenCV (cv2)"),
], ids=["default", "exact", "sub-window", "sharded", "off"])
def test_open_video_engine(pumps, h264_clip, kw, engine, monkeypatch):
    """The runner's engine for each setting, as JAX ``runner.py:186-259``
    picks it; the sharded pump probes without cv2."""
    if kw.get("use_native_decode") != "off":
        _no_cv2(monkeypatch)
    monkeypatch.setattr(os, "cpu_count", lambda: 8)
    meta, src = trun._open_video(h264_clip, Params(**kw), None)
    try:
        assert src.decode_engine == engine
        assert src.is_fast == ("fast" in engine)
        assert meta.step == 2 and meta.total_frames == 240
        assert len(collect(src, 64)) == 120
    finally:
        src.close()


# ------------------------------------------------- checkpoint engine


@pytest.mark.parametrize("kw,meta_kw,want", [
    ({}, None, "fast"),
    ({"decode_quality": "exact"}, None, "exact"),
    ({"use_native_decode": "off"}, None, "exact"),
    ({}, (30, 30.0), "exact"),       # 29 pairs < the 3 s norm window
    ({}, (300, 30.0), "fast"),
], ids=["default", "exact", "off", "sub-window", "long"])
def test_default_engine(pumps, kw, meta_kw, want):
    meta = None if meta_kw is None else tdec.VideoMeta(meta_kw[0],
                                                       meta_kw[1], 64, 64)
    assert tck.default_engine(Params(**kw), meta) == want


def test_sidecar_engine_not_crossed(pumps, tmp_path, monkeypatch):
    """A sidecar written while the fast engine decoded records ``fast``: an
    exact-engine run of the same clip starts over, and a fast-engine run
    resumes it."""
    import shutil

    # 5 fps: the 1 s norm window is 5 samples, so 11 pairs take the fast
    # engine
    frames = ref.make_synthetic_frames(12, h=64, w=64, period=4, seed=6)
    video = write_cv2(str(tmp_path / "long.mp4"), frames, 5)
    out = video.rsplit(".", 1)[0] + ".funscript"
    sidecar = tck.sidecar_path(out)
    monkeypatch.setattr(tck, "CHECKPOINT_EVERY_PAIRS", 4)
    kw = dict(overwrite=True, checkpoint=True, pair_batch=16, threads=1,
              norm_window=1.0)
    polls = {"n": 0}

    def cancel():
        polls["n"] += 1
        return polls["n"] > 2

    assert not trun.process_video(video, Params(**kw), lambda m: None,
                                  cancel_flag=cancel, device="cpu")
    assert os.path.exists(sidecar) and not os.path.exists(out)
    with np.load(sidecar) as z:
        assert json.loads(str(z["fingerprint"]))["engine"] == "fast"
    shutil.copy(sidecar, str(tmp_path / "saved.npz"))
    for quality, resumed in (("exact", False), ("fast", True)):
        shutil.copy(str(tmp_path / "saved.npz"), sidecar)
        logs = []
        assert not trun.process_video(
            video, Params(decode_quality=quality, **kw), logs.append,
            device="cpu")
        assert any(f"native pump, {quality} engine" in m for m in logs)
        assert resumed == any(m.startswith("Resuming") for m in logs), logs
        assert os.path.exists(out) and not os.path.exists(sidecar)


# ------------------------------- default decode, both packages, on a file


@pytest.mark.parametrize("vr", [False, True], ids=["flat", "vr"])
def test_default_decode_matches_jax_process_video(pumps, tmp_path, vr,
                                                  monkeypatch,
                                                  record_property):
    """A cv2-written clip longer than the rolling-norm window through both
    packages' ``process_video`` with default decode settings: both decode
    through their pump's fast engine, the timestamps are identical and the
    positions within the ±2 of tests/test_runner.py.

    The JAX side runs the f32 XLA warp (its pipeline's ``warp_dtype``
    pinned here; the default is bfloat16) and skips its tail-bucket
    prewarm. Its frames are 256x256 after decode whatever the clip's size,
    so the clip is short (12 frames at 5 fps, a 1 s norm window of 5
    samples) and fits one window of 16 pairs: one compile, shared by both
    cases."""
    frames = ref.make_synthetic_frames(12, h=180, w=320, period=4, seed=7)
    video = write_cv2(str(tmp_path / "clip.mp4"), frames, 5)
    monkeypatch.setattr(jrun, "PipelineConfig", functools.partial(
        jpl.PipelineConfig, warp_dtype="float32"))
    monkeypatch.setattr(jrun, "_prewarm_tail_async", lambda *a, **k: None)
    engines, out = {}, {}
    for name, rt, run, params, kw in (
            ("jax", jrt, jrun.process_video,
             JParams(overwrite=True, pair_batch=16, norm_window=1.0,
                     vr_mode=vr), {}),
            ("torch", trt, trun.process_video,
             Params(overwrite=True, pair_batch=16, norm_window=1.0,
                    vr_mode=vr), {"device": "cpu"})):
        opened = []

        class Spy(rt.NativeFrameSource):
            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                opened.append(self.is_fast)  # JAX's asks the open handle

        with monkeypatch.context() as m:
            m.setattr(rt, "NativeFrameSource", Spy)
            logs = []
            assert not run(video, params, logs.append, **kw), logs
        engines[name] = opened
        with open(video.rsplit(".", 1)[0] + ".funscript") as f:
            out[name] = json.load(f)["actions"]
    assert engines["jax"] and all(engines["jax"]), engines
    assert engines["torch"] and all(engines["torch"]), engines
    assert [a["at"] for a in out["torch"]] == [a["at"] for a in out["jax"]]
    dpos = np.abs(np.array([a["pos"] for a in out["torch"]])
                  - np.array([a["pos"] for a in out["jax"]]))
    record_property("max_pos_delta", int(dpos.max()))
    assert dpos.max() <= 2, dpos
