"""Embedded in-app preview: synced video player + funscript visualizer (the
port's copy of the JAX package's ``gui/player.py``).

Closes the last preview-surface delta vs the reference: its preview lives
INSIDE the app window (QMediaPlayer video tab FunscriptFlow.pyw:1871-1992,
custom-painted FunScriptVisualizer :398-665, detached motion-indicator bar
:1675-1719, 50 ms sync timer :1985-1987 driving linear interpolation of the
current script value :2563-2592). ``gui.preview`` renders those interactions
as a self-contained browser page; this module brings them inside the tk app.

Without Qt, and with tk shipping no video codecs, playback rides the
framework's own decode substrate: cv2.VideoCapture frames (the exact
engine's oracle path) pushed into a tk.Canvas as PPM-encoded PhotoImages.
Everything with logic in it — timeline math, zoom/pan, interpolation,
aspect fit, the playback clock, PPM encoding — is display-independent and
tested headless; the tk shell is a thin event loop, the same policy the
rest of gui.app follows.

Audio: tk has no audio sink (QMediaPlayer does, the reference's
:1871-1992). When ``ffplay`` exists on PATH, ``AudioSidecar`` plays the
clip's audio track in a windowless subprocess restarted from the playback
clock's position on every play/seek; when it doesn't, playback is silent
and "Open in browser" serves the HTML page whose ``<video>`` plays audio
natively.
"""

from __future__ import annotations

import bisect
import os
import time

import numpy as np

__all__ = [
    "fit_box",
    "frame_to_ppm",
    "PreviewModel",
    "PlaybackClock",
    "FrameReader",
    "AudioSidecar",
    "open_preview_window",
]


def fit_box(src_w: int, src_h: int, box_w: int, box_h: int) -> tuple:
    """Largest (w, h) with ``src``'s aspect ratio that fits inside the box."""
    if src_w <= 0 or src_h <= 0 or box_w <= 0 or box_h <= 0:
        return 1, 1
    scale = min(box_w / src_w, box_h / src_h)
    return max(1, int(round(src_w * scale))), max(1, int(round(src_h * scale)))


def frame_to_ppm(rgb: np.ndarray) -> bytes:
    """Binary PPM (P6) encoding of an HxWx3 uint8 RGB frame.

    tk.PhotoImage parses PPM natively, making this the zero-dependency
    bridge from the decode path's ndarrays onto a tk canvas.
    """
    if rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"expected HxWx3 RGB, got {rgb.shape}")
    h, w = rgb.shape[:2]
    header = f"P6 {w} {h} 255\n".encode("ascii")
    return header + np.ascontiguousarray(rgb, dtype=np.uint8).tobytes()


class PreviewModel:
    """Timeline math for the visualizer: zoom/pan, layout, interpolation.

    Mirrors the reference visualizer's behavior (FunscriptFlow.pyw:398-665):
    wheel zoom 1-50x anchored at the cursor (:486-520), drag pan, click to
    seek (:482-484), polyline of actions over a grid, and the linearly
    interpolated current script value that drives the motion bar
    (:2563-2592). Pure math — no toolkit imports — so the suite covers it.
    """

    MIN_ZOOM = 1.0
    MAX_ZOOM = 50.0
    V_PAD = 10  # px kept clear above pos=100 and below pos=0

    def __init__(self, actions, duration_ms: float):
        acts = sorted(
            ({"at": float(a["at"]), "pos": float(a["pos"])} for a in actions),
            key=lambda a: a["at"],
        )
        self.actions = acts
        self._ats = [a["at"] for a in acts]
        last_at = self._ats[-1] if acts else 0.0
        self.duration_ms = float(max(duration_ms, last_at, 1.0))
        self.zoom = 1.0
        self.pan_ms = 0.0

    # -- view transform -----------------------------------------------------
    def view_span(self) -> float:
        return self.duration_ms / self.zoom

    def ms_to_x(self, ms: float, width: int) -> float:
        return (ms - self.pan_ms) / self.view_span() * width

    def x_to_ms(self, x: float, width: int) -> float:
        return self.pan_ms + x / width * self.view_span()

    @staticmethod
    def pos_to_y(pos: float, height: int) -> float:
        usable = height - 2 * PreviewModel.V_PAD
        return (100.0 - pos) / 100.0 * usable + PreviewModel.V_PAD

    def _clamp_pan(self) -> None:
        self.pan_ms = min(max(self.pan_ms, 0.0), self.duration_ms - self.view_span())

    def zoom_at(self, x: float, width: int, factor: float) -> None:
        """Scale zoom by ``factor`` keeping the time under pixel ``x`` fixed."""
        anchor = self.x_to_ms(x, width)
        self.zoom = min(max(self.zoom * factor, self.MIN_ZOOM), self.MAX_ZOOM)
        self.pan_ms = anchor - x / width * self.view_span()
        self._clamp_pan()

    def pan_by(self, dx_px: float, width: int) -> None:
        self.pan_ms -= dx_px / width * self.view_span()
        self._clamp_pan()

    def follow(self, ms: float) -> bool:
        """Scroll so the playhead re-enters the view when playback carries
        it past the RIGHT edge; True if the view moved. A playhead left of
        (or inside) the view is never touched — the user panned there on
        purpose, and snapping back would make drag-pan unusable (ADVICE r4;
        the reference visualizer never auto-scrolls at all,
        FunscriptFlow.pyw:629,663 — ours follows only during playback, and
        the caller additionally gates on playing-and-not-dragging)."""
        span = self.view_span()
        if ms <= self.pan_ms + span:
            return False
        self.pan_ms = ms - 0.1 * span
        self._clamp_pan()
        return True

    # -- data ---------------------------------------------------------------
    def script_value(self, ms: float) -> float:
        """Linearly interpolated script position at ``ms`` (reference
        :2563-2592); endpoints clamp. Deliberate delta: with NO actions the
        reference returns 0 (empty motion bar); both this player and the
        HTML preview return 50 (centered bar) so a script-less video reads
        as "no signal", not "bottom position" — recorded in PARITY.md."""
        acts = self.actions
        if not acts:
            return 50.0
        if ms <= acts[0]["at"]:
            return acts[0]["pos"]
        if ms >= acts[-1]["at"]:
            return acts[-1]["pos"]
        i = bisect.bisect_right(self._ats, ms)
        a, b = acts[i - 1], acts[i]
        if b["at"] == a["at"]:
            return b["pos"]
        t = (ms - a["at"]) / (b["at"] - a["at"])
        return a["pos"] + t * (b["pos"] - a["pos"])

    def polyline(self, width: int, height: int) -> list:
        """[(x, y)] for the actions inside the view, plus one neighbor on
        each side so the line enters/exits the canvas cleanly."""
        lo, hi = self.pan_ms, self.pan_ms + self.view_span()
        i0 = max(0, bisect.bisect_left(self._ats, lo) - 1)
        i1 = min(len(self.actions), bisect.bisect_right(self._ats, hi) + 1)
        return [
            (self.ms_to_x(a["at"], width), self.pos_to_y(a["pos"], height))
            for a in self.actions[i0:i1]
        ]

    def grid_columns(self, width: int, divisions: int = 10) -> list:
        """[(x, time_ms)] vertical gridline positions across the view."""
        span = self.view_span()
        return [
            (width * k / divisions, self.pan_ms + span * k / divisions)
            for k in range(divisions + 1)
        ]


class PlaybackClock:
    """Wall-clock playback position with play/pause/seek; injectable ``now``
    makes it deterministic under test. With a known duration it clamps to
    [0, duration] and auto-pauses at the end (the reference's player stops
    at EOF). ``duration_ms <= 0`` means UNKNOWN (live/odd containers whose
    header reports no frame count, ADVICE r4): the clock then runs
    unclamped and never auto-pauses — the shell pauses it when the frame
    reader actually hits EOF."""

    def __init__(self, duration_ms: float, now=time.monotonic):
        self.duration_ms = float(max(duration_ms, 0.0))
        self._now = now
        self._base_ms = 0.0
        self._started_at = None  # wall time of last play(); None = paused

    @property
    def playing(self) -> bool:
        return self._started_at is not None

    def position_ms(self) -> float:
        pos = self._base_ms
        if self._started_at is not None:
            pos += (self._now() - self._started_at) * 1000.0
            if self.duration_ms > 0 and pos >= self.duration_ms:
                self._base_ms = self.duration_ms
                self._started_at = None
                return self.duration_ms
        if self.duration_ms <= 0:
            return max(pos, 0.0)
        return min(max(pos, 0.0), self.duration_ms)

    def play(self) -> None:
        if self._started_at is None:
            if self.duration_ms > 0 and self._base_ms >= self.duration_ms:
                self._base_ms = 0.0  # replay from the top
            self._started_at = self._now()

    def pause(self) -> None:
        if self._started_at is not None:
            self._base_ms = self.position_ms()
            self._started_at = None

    def toggle(self) -> bool:
        (self.pause if self.playing else self.play)()
        return self.playing

    def seek(self, ms: float) -> None:
        ms = max(float(ms), 0.0)
        if self.duration_ms > 0:
            ms = min(ms, self.duration_ms)
        self._base_ms = ms
        if self._started_at is not None:
            self._started_at = self._now()


class FrameReader:
    """Drop-don't-seek RGB frame access over cv2.VideoCapture.

    Linear playback NEVER repositions the demuxer: ``frame_at`` reads
    forward sequentially with a bounded per-call decode budget and, when
    the clock has outrun decode, displays the newest decoded frame (frames
    are DROPPED from display, not chased). The round-4 policy seeked
    whenever playback lagged by more than a small lookahead — on
    long-GOP content (bench clips: GOP 250) each ``cap.set(POS_FRAMES)``
    re-enters the GOP from its keyframe, decoding up to 250 frames per
    33 ms tick, which guaranteed falling further behind (VERDICT r4 #4 —
    the seek-storm). Only explicit user seeks (``seek_to``: click-to-seek,
    replay) may reposition; ``seeks``/``frames_decoded`` counters make the
    zero-seeks-during-linear-playback property measurable.
    """

    BURN_BUDGET = 30  # max frames decoded per frame_at call (~1 GOP/s at 30 Hz)

    def __init__(self, path: str):
        import cv2

        self._cv2 = cv2
        self.cap = cv2.VideoCapture(path)
        if not self.cap.isOpened():
            raise OSError(f"cannot open video: {path}")
        self.fps = float(self.cap.get(cv2.CAP_PROP_FPS)) or 30.0
        self.frame_count = int(self.cap.get(cv2.CAP_PROP_FRAME_COUNT))
        self.width = int(self.cap.get(cv2.CAP_PROP_FRAME_WIDTH))
        self.height = int(self.cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
        # frame_count <= 0 (live/odd containers) -> duration UNKNOWN (0.0):
        # the clock runs unclamped and the shell pauses on real EOF
        self.duration_ms = (
            self.frame_count / self.fps * 1000.0 if self.frame_count > 0 else 0.0
        )
        self._cursor = 0  # index of the NEXT frame read() returns
        self._last = None  # (index, rgb) of the newest decoded frame
        self.eof = False
        self.seeks = 0          # demuxer repositions issued (user seeks only)
        self.frames_decoded = 0

    @property
    def last_index(self) -> int:
        """Index of the newest decoded frame (-1 before the first read)."""
        return self._last[0] if self._last is not None else -1

    def frame_index(self, ms: float) -> int:
        idx = int(ms / 1000.0 * self.fps)
        hi = self.frame_count - 1 if self.frame_count > 0 else idx
        return min(max(idx, 0), max(hi, 0))

    def _read(self):
        ok, bgr = self.cap.read()
        if not ok:
            self.eof = True
            return None
        self.frames_decoded += 1
        self._cursor += 1
        return bgr

    def frame_at(self, ms: float):
        """Newest displayable RGB frame for ``ms``; never seeks.

        Reads forward up to BURN_BUDGET frames toward the requested index
        and returns the newest decoded frame — which is the requested one
        when decode keeps up, or an older one while it catches up (the
        drop policy). A request BEHIND the newest decoded frame returns
        that frame unchanged (going back requires ``seek_to``). None only
        before anything has decoded on an exhausted container."""
        want = self.frame_index(ms)
        if self._last is not None and want <= self._last[0]:
            return self._last[1]
        frame, idx = None, -1
        budget = min(want - self._cursor + 1, self.BURN_BUDGET)
        for _ in range(max(budget, 0)):
            bgr = self._read()
            if bgr is None:
                break
            frame, idx = bgr, self._cursor - 1
        if frame is None:
            return self._last[1] if self._last is not None else None
        rgb = self._cv2.cvtColor(frame, self._cv2.COLOR_BGR2RGB)
        self._last = (idx, rgb)
        return rgb

    def seek_to(self, ms: float) -> None:
        """Explicit USER seek: reposition the demuxer (the only place that
        does). Small forward hops within the decode budget stay sequential
        — repositioning would re-enter the GOP for frames a few reads
        away."""
        want = self.frame_index(ms)
        if self._last is not None and want == self._last[0]:
            return
        if 0 <= want - self._cursor < self.BURN_BUDGET:
            return  # frame_at will reach it sequentially
        self.cap.set(self._cv2.CAP_PROP_POS_FRAMES, want)
        self._cursor = want
        self._last = None
        self.eof = False
        self.seeks += 1

    def scaled_frame_at(self, ms: float, box_w: int, box_h: int):
        """(rgb, w, h) aspect-fit into the box; None only with nothing
        decodable."""
        rgb = self.frame_at(ms)
        if rgb is None:
            return None
        w, h = fit_box(rgb.shape[1], rgb.shape[0], box_w, box_h)
        if (w, h) != (rgb.shape[1], rgb.shape[0]):
            rgb = self._cv2.resize(rgb, (w, h), interpolation=self._cv2.INTER_AREA)
        return rgb, w, h

    def close(self) -> None:
        try:
            self.cap.release()
        except Exception:
            pass


class AudioSidecar:
    """Optional audio for the embedded preview via an external player.

    tk has no audio sink (the reference's QMediaPlayer does, FunscriptFlow
    .pyw:1871-1992). When ``ffplay`` is on PATH this plays the clip's audio
    track in a windowless ``-nodisp -vn`` subprocess started at the playback
    clock's position — restarted on every play and user seek, terminated on
    pause/close. When no player binary exists (a typical GPU server),
    ``available`` is False and every call is a silent no-op: sound on hosts
    that have a sink, clean silence otherwise."""

    def __init__(self, path: str, player: str | None = None):
        import shutil

        self.path = path
        self.cmd = player if player is not None else shutil.which("ffplay")
        self.proc = None

    @property
    def available(self) -> bool:
        return bool(self.cmd)

    def start(self, pos_ms: float) -> None:
        """(Re)start audio at ``pos_ms``; no-op without a player binary."""
        self.stop()
        if not self.cmd:
            return
        import subprocess

        try:
            self.proc = subprocess.Popen(
                [self.cmd, "-nodisp", "-vn", "-autoexit", "-loglevel",
                 "quiet", "-ss", f"{max(pos_ms, 0.0) / 1000.0:.3f}",
                 self.path],
                stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        except Exception:
            self.proc = None  # degraded to silence, never to an error

    def stop(self) -> None:
        if self.proc is not None:
            try:
                self.proc.terminate()
            except Exception:
                pass
            self.proc = None


# ---------------------------------------------------------------------------
# tk shell
# ---------------------------------------------------------------------------

_TICK_MS = 33  # ~30 Hz; the reference syncs at 50 ms (:1985-1987)


def open_preview_window(root, video_path: str, funscript: str | None = None):
    """Open the embedded preview as a child window of the running app.

    Layout mirrors the reference's preview tab top-to-bottom: video surface,
    motion-indicator bar, visualizer canvas, transport row. Returns the
    Toplevel (None if the video cannot be opened — caller falls back to the
    browser preview).
    """
    import tkinter as tk
    from tkinter import ttk

    from ..io.funscript import funscript_path, load_funscript

    fs_path = funscript or funscript_path(video_path)
    try:
        actions = load_funscript(fs_path)["actions"] if os.path.exists(fs_path) else []
    except Exception:
        actions = []
    try:
        reader = FrameReader(video_path)
    except OSError:
        return None

    model = PreviewModel(actions, reader.duration_ms)
    clock = PlaybackClock(reader.duration_ms)
    audio = AudioSidecar(video_path)

    win = tk.Toplevel(root)
    win.title(f"Preview — {os.path.basename(video_path)}")

    vid_canvas = tk.Canvas(win, width=640, height=360, bg="#000",
                           highlightthickness=0)
    vid_canvas.pack(fill="both", expand=True)
    bar = tk.Canvas(win, height=18, bg="#222", highlightthickness=0)
    bar.pack(fill="x")
    vis = tk.Canvas(win, height=170, bg="#181c22", highlightthickness=0,
                    cursor="crosshair")
    vis.pack(fill="x")

    transport = ttk.Frame(win)
    transport.pack(fill="x", padx=4, pady=2)
    btn_play = ttk.Button(transport, text="Play")
    btn_play.pack(side="left")
    lbl_time = ttk.Label(transport, text="0:00 / 0:00")
    lbl_time.pack(side="left", padx=8)
    lbl_zoom = ttk.Label(transport, text="zoom 1.0x — wheel zoom, drag pan, "
                                         "click seek")
    lbl_zoom.pack(side="left", padx=8)

    def open_browser():
        from .preview import write_preview
        import webbrowser

        webbrowser.open("file://" + os.path.abspath(write_preview(video_path)))

    ttk.Button(transport, text="Open in browser", command=open_browser).pack(
        side="right")

    state = {"img": None, "last_draw": None, "drag_x": None, "closed": False}

    def fmt(ms):
        s = int(ms / 1000)
        return f"{s // 60}:{s % 60:02d}"

    def draw_video(pos_ms):
        # keyed on (frame index, box size): a canvas resize re-renders even
        # while paused, and the first tick's 32x32 fallback box doesn't
        # stick once the window maps (ADVICE r4)
        box_w = max(vid_canvas.winfo_width(), 32)
        box_h = max(vid_canvas.winfo_height(), 32)
        want = reader.frame_index(pos_ms)
        if state["last_draw"] == (want, box_w, box_h):
            return
        got = reader.scaled_frame_at(pos_ms, box_w, box_h)
        if got is None:
            return
        rgb, w, h = got
        img = tk.PhotoImage(data=frame_to_ppm(rgb))
        state["img"] = img  # hold a reference: tk only keeps a weak link
        vid_canvas.delete("all")
        vid_canvas.create_image(box_w // 2, box_h // 2, image=img)
        # record the DECODED index: while decode catches up (drop policy)
        # it differs from `want`, so the next tick keeps pulling frames
        state["last_draw"] = (reader.last_index, box_w, box_h)

    def draw_bar(pos_ms):
        val = model.script_value(pos_ms)
        w = max(bar.winfo_width(), 1)
        bar.delete("all")
        bar.create_rectangle(0, 0, w * val / 100.0, 18, fill="#4a9", width=0)

    def draw_vis(pos_ms):
        w = max(vis.winfo_width(), 32)
        h = int(vis.cget("height"))
        vis.delete("all")
        for x, _ms in model.grid_columns(w):
            vis.create_line(x, 0, x, h, fill="#26303a")
        for pos in (0, 25, 50, 75, 100):
            y = model.pos_to_y(pos, h)
            vis.create_line(0, y, w, y, fill="#26303a")
        pts = model.polyline(w, h)
        if len(pts) >= 2:
            vis.create_line(*[c for p in pts for c in p], fill="#e66", width=2)
        for x, y in pts:
            vis.create_oval(x - 2, y - 2, x + 2, y + 2, fill="#fa8", width=0)
        px = model.ms_to_x(pos_ms, w)
        vis.create_line(px, 0, px, h, fill="#9cf")
        lbl_zoom.configure(text=f"zoom {model.zoom:.1f}x — wheel zoom, "
                                f"drag pan, click seek")

    def tick():
        if state["closed"]:
            return
        pos = clock.position_ms()
        # auto-scroll only while actually playing and not mid-drag — a
        # paused or drag-panned view is the user's to keep (ADVICE r4)
        if clock.playing and state["drag_x"] is None:
            model.follow(pos)
        draw_video(pos)
        draw_bar(pos)
        draw_vis(pos)
        if reader.eof and clock.playing and clock.duration_ms <= 0:
            clock.pause()  # unknown-duration container hit real EOF
            audio.stop()
        btn_play.configure(text="Pause" if clock.playing else "Play")
        lbl_time.configure(text=f"{fmt(pos)} / {fmt(reader.duration_ms)}")
        win.after(_TICK_MS, tick)

    def on_toggle():
        at_end = (clock.duration_ms > 0
                  and clock.position_ms() >= clock.duration_ms)
        clock.toggle()
        if clock.playing:
            if at_end:
                reader.seek_to(0)  # replay: the one non-click user seek
            audio.start(clock.position_ms())
        else:
            audio.stop()

    def on_click(ev):
        if state["drag_x"] is not None:
            return
        ms = model.x_to_ms(ev.x, max(vis.winfo_width(), 1))
        clock.seek(ms)
        reader.seek_to(ms)
        if clock.playing:
            audio.start(clock.position_ms())

    def on_press(ev):
        state["drag_x"] = None  # becomes a drag only if motion follows

    def on_motion(ev):
        w = max(vis.winfo_width(), 1)
        if state["drag_x"] is not None:
            model.pan_by(ev.x - state["drag_x"], w)
        state["drag_x"] = ev.x

    def on_release(ev):
        if state["drag_x"] is None:
            on_click(ev)
        state["drag_x"] = None

    def on_wheel(ev):
        # X11 reports Button-4/5; Windows/macOS report <MouseWheel> delta
        up = getattr(ev, "num", 0) == 4 or getattr(ev, "delta", 0) > 0
        model.zoom_at(ev.x, max(vis.winfo_width(), 1), 1.25 if up else 0.8)

    def on_close():
        state["closed"] = True
        audio.stop()
        reader.close()
        win.destroy()

    btn_play.configure(command=on_toggle)
    vis.bind("<ButtonPress-1>", on_press)
    vis.bind("<B1-Motion>", on_motion)
    vis.bind("<ButtonRelease-1>", on_release)
    vis.bind("<MouseWheel>", on_wheel)
    vis.bind("<Button-4>", on_wheel)
    vis.bind("<Button-5>", on_wheel)
    win.bind("<space>", lambda _e: on_toggle())
    win.protocol("WM_DELETE_WINDOW", on_close)

    # map the window before the first tick so the video canvas reports its
    # real size instead of the 1x1 pre-map geometry (ADVICE r4)
    win.update_idletasks()
    tick()
    return win
