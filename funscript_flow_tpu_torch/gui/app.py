"""Desktop GUI (tkinter) — the reference's Generation tab, Qt-free (the
port's copy of the JAX package's ``gui/app.py``).

The reference ships a PySide6 two-tab window (App, FunscriptFlow.pyw
:1721-2603). tkinter ships with CPython, so the GUI is built on it with the
same surface:

* file/folder pickers feeding a batch list (recursive folder scan with the
  extension whitelist, reference :2064-2070)
* VR / POV checkboxes, keyframe-reduction + overwrite checkboxes
* backend dropdown annotated with availability (reference :2008-2013),
  and a device selector (``cuda``, the default, or ``cpu``)
* advanced settings: threads, detrend window, norm window, batch size —
  defaults follow the CLI (the reference GUI had *different* defaults,
  SURVEY.md §2.1 #22; we use one set)
* Run/Cancel, overall + per-video progress bars, live log pane
* completion dialog offering View Log / Open in Preview — reference
  :2426-2444; preview is embedded in-app (gui.player, the reference's
  preview-tab parity) with gui.preview's browser page as fallback, plus a
  Preview button for any listed/selected video
* working config save/load buttons (the reference's save was unreachable
  from its UI, :2266-2281)
* hover tooltips on the mode checkboxes (reference ToolTip, :391-395,
  :2004-2018), an in-app Readme dialog (reference shows readme.txt), and
  drag-and-drop of files/folders when the tkdnd extension is present
  (reference :2511-2516 — dropped folders are scanned NON-recursively,
  unlike the folder button; quirk kept).
"""

from __future__ import annotations

import glob
import os
import threading
import webbrowser

from ..io.decode import SUPPORTED_VIDEO_EXTENSIONS, find_videos
from ..utils.backends import get_available_backends, get_device_info
from ..utils.config import load_config, save_config
from ..utils.params import Params
from ..utils.strings import STRINGS
from ..worker import BatchWorker

__all__ = ["collect_settings", "expand_dropped_paths", "launch",
           "paths_from_clipboard_text", "DEVICES"]

#: the device selector's choices; the first is the default
DEVICES = ("cuda", "cpu")


def paths_from_clipboard_text(text: str) -> list:
    """Clipboard text -> existing paths, for the Ctrl+V fallback when the
    optional tkdnd extension is absent (the reference's Qt DnD always
    works, FunscriptFlow.pyw:2511; tkinter needs tkdnd for true drops).
    Accepts newline-separated paths and file:// URIs (what most file
    managers put on the clipboard for copied files)."""
    raw = [ln.strip() for ln in text.replace("\r", "\n").split("\n")]
    paths = [p[7:] if p.startswith("file://") else p for p in raw if p]
    return expand_dropped_paths([p for p in paths if os.path.exists(p)])


def expand_dropped_paths(paths) -> list:
    """Dropped files/folders -> video list (reference :2511-2516 semantics:
    folders are scanned one level deep via glob, NOT recursively)."""
    out = []
    for p in paths:
        if os.path.isdir(p):
            for q in sorted(glob.glob(os.path.join(p, "*"))):
                if os.path.splitext(q)[1].lower() in SUPPORTED_VIDEO_EXTENSIONS:
                    out.append(q)
        elif os.path.splitext(p)[1].lower() in SUPPORTED_VIDEO_EXTENSIONS:
            out.append(p)
    return out


def _add_tooltip(widget, text: str) -> None:
    """Hover tooltip (the reference wrapped Qt's setToolTip, :391-395;
    tkinter needs the classic Toplevel-on-hover pattern)."""
    import tkinter as tk

    state = {"tip": None}

    def show(_event=None):
        if state["tip"] is not None:
            return
        x = widget.winfo_rootx() + 16
        y = widget.winfo_rooty() + widget.winfo_height() + 4
        tip = tk.Toplevel(widget)
        tip.wm_overrideredirect(True)
        tip.wm_geometry(f"+{x}+{y}")
        tk.Label(tip, text=text, justify="left", relief="solid",
                 borderwidth=1, padx=4, pady=2).pack()
        state["tip"] = tip

    def hide(_event=None):
        if state["tip"] is not None:
            state["tip"].destroy()
            state["tip"] = None

    widget.bind("<Enter>", show)
    widget.bind("<Leave>", hide)


def collect_settings(widgets: dict) -> Params:
    """Map GUI widget values -> Params (testable without a display).

    Covers the full Params surface (the reference GUI exposed its whole
    settings dict, :2004-2018). The device is not a Params field: the GUI
    passes its selector's value to the worker."""
    return Params(
        threads=int(widgets["threads"]),
        detrend_window=float(widgets["detrend_window"]),
        norm_window=float(widgets["norm_window"]),
        batch_size=int(widgets["batch_size"]),
        overwrite=bool(widgets["overwrite"]),
        vr_mode=bool(widgets["vr_mode"]),
        pov_mode=bool(widgets["pov_mode"]),
        keyframe_reduction=bool(widgets["keyframe_reduction"]),
        backend=str(widgets["backend"]).split(" ")[0],
        cut_threshold=float(widgets.get("cut_threshold", 7.0)),
        mesh=int(widgets.get("mesh", 0)),
        clip_workers=int(widgets.get("clip_workers", 0)),
        pair_batch=int(widgets.get("pair_batch", 240)),
        dis_preset=str(widgets.get("dis_preset", "fast")),
        decode_quality=str(widgets.get("decode_quality", "fast")),
        use_native_decode=str(widgets.get("use_native_decode", "auto")),
        signal_backend=str(widgets.get("signal_backend", "auto")),
        profile_dir=str(widgets.get("profile_dir", "")).strip(),
        checkpoint=bool(widgets.get("checkpoint", False)),
    )


def launch() -> int:
    try:
        import tkinter as tk
        from tkinter import filedialog, messagebox, ttk
    except Exception as e:  # no tkinter in this environment
        print(f"GUI unavailable ({e}); use the CLI: "
              f"python -m funscript_flow_tpu_torch <video-or-folder>")
        return 2

    backends = get_available_backends()

    root = tk.Tk()
    root.title(STRINGS["app_title"])
    root.geometry("760x640")

    files: list = []
    worker_box = {"w": None}

    # --- file list -----------------------------------------------------------
    frm_files = ttk.LabelFrame(root, text="Videos")
    frm_files.pack(fill="both", expand=False, padx=8, pady=4)
    listbox = tk.Listbox(frm_files, height=6)
    listbox.pack(fill="x", padx=4, pady=4)

    def add_files():
        for p in filedialog.askopenfilenames(title="Select videos"):
            files.append(p)
            listbox.insert("end", p)

    def add_folder():
        d = filedialog.askdirectory(title="Select folder")
        if d:
            for p in find_videos(d):
                files.append(p)
                listbox.insert("end", p)

    def clear_files():
        files.clear()
        listbox.delete(0, "end")

    bar = ttk.Frame(frm_files)
    bar.pack(fill="x", padx=4, pady=2)
    ttk.Button(bar, text=STRINGS["select_videos"], command=add_files).pack(side="left")
    ttk.Button(bar, text=STRINGS["select_folder"], command=add_folder).pack(side="left", padx=4)
    ttk.Button(bar, text="Clear", command=clear_files).pack(side="left")

    def show_readme():
        from .manual import MANUAL

        win = tk.Toplevel(root)
        win.title(STRINGS["readme"])
        txt = tk.Text(win, width=76, height=32, wrap="word")
        txt.insert("1.0", MANUAL)
        txt.configure(state="disabled")
        txt.pack(fill="both", expand=True, padx=6, pady=6)

    ttk.Button(bar, text=STRINGS["readme"], command=show_readme).pack(side="right")

    def open_preview(video: str) -> None:
        """Embedded in-app preview (reference tab :1871-1992); falls back to
        the browser page when the video cannot be opened via cv2. The
        fallback itself is guarded: an unwritable page/odd path must show
        an error dialog, not die silently inside a Tk callback (ADVICE r4)."""
        from .player import open_preview_window

        if open_preview_window(root, video) is None:
            try:
                from .preview import write_preview

                page = write_preview(video)
                webbrowser.open(f"file://{os.path.abspath(page)}")
            except Exception as e:
                messagebox.showerror(
                    STRINGS["show_preview"],
                    f"Cannot preview {os.path.basename(video)}: {e}")

    def preview_selected():
        sel = listbox.curselection()
        if sel:
            open_preview(files[sel[0]])
        else:
            p = filedialog.askopenfilename(title="Select a video to preview")
            if p:
                open_preview(p)

    ttk.Button(bar, text=STRINGS["show_preview"], command=preview_selected).pack(
        side="right", padx=4)

    # drag-and-drop via the tkdnd Tk extension when present (reference
    # :2511-2516); silently unavailable otherwise — the pickers cover it
    def _on_drop(event):
        for p in expand_dropped_paths(root.tk.splitlist(event.data)):
            files.append(p)
            listbox.insert("end", p)

    try:
        root.tk.call("package", "require", "tkdnd")
        root.tk.call("tkdnd::drop_target", "register", listbox._w, ("DND_Files",))
        listbox.bind("<<Drop>>", _on_drop)
    except Exception:
        pass

    # guaranteed fallback when tkdnd is absent: Ctrl+V pastes newline- or
    # file://-separated paths from the clipboard through the same
    # folder-expansion logic the drop handler uses
    def _on_paste(_event=None):
        try:
            text = root.clipboard_get()
        except Exception:
            return
        for p in paths_from_clipboard_text(text):
            files.append(p)
            listbox.insert("end", p)

    root.bind("<Control-v>", _on_paste)

    # --- options -------------------------------------------------------------
    frm_opt = ttk.LabelFrame(root, text="Options")
    frm_opt.pack(fill="x", padx=8, pady=4)
    v_vr = tk.BooleanVar(value=False)
    v_pov = tk.BooleanVar(value=False)
    v_kr = tk.BooleanVar(value=True)
    v_ow = tk.BooleanVar(value=False)
    cb_vr = ttk.Checkbutton(frm_opt, text=STRINGS["vr_mode"], variable=v_vr)
    cb_vr.grid(row=0, column=0, sticky="w")
    cb_pov = ttk.Checkbutton(frm_opt, text="POV Mode", variable=v_pov)
    cb_pov.grid(row=0, column=1, sticky="w")
    _add_tooltip(cb_vr, STRINGS["vr_mode_tooltip"])
    _add_tooltip(cb_pov, STRINGS["pov_mode_tooltip"])
    ttk.Checkbutton(frm_opt, text="Keyframe reduction", variable=v_kr).grid(row=0, column=2, sticky="w")
    ttk.Checkbutton(frm_opt, text=STRINGS["overwrite_files"], variable=v_ow).grid(row=0, column=3, sticky="w")
    v_ckpt = tk.BooleanVar(value=False)
    cb_ckpt = ttk.Checkbutton(frm_opt, text="Checkpoint", variable=v_ckpt)
    cb_ckpt.grid(row=0, column=4, sticky="w")
    _add_tooltip(cb_ckpt, "Write intra-video resume sidecars so a killed run "
                          "restarts long videos from the last checkpoint "
                          "instead of frame 0 (removed on completion).")
    ttk.Label(frm_opt, text=STRINGS["backend"]).grid(row=1, column=0, sticky="e")
    v_backend = tk.StringVar(value="CUDA")
    # Every name the CLI's --backend accepts, annotated with availability
    # from get_available_backends() and, for the reference's names, the
    # flow path they map to (reference dropdown :2008-2013): a user
    # migrating a reference config keeps their muscle memory.
    # collect_settings takes the first token, Params normalizes aliases.
    alias_to = {"CPU": "CUDA", "TPU": "CUDA", "OpenCL": "CUDA", "DNN": "DIS"}
    choices = []
    for name in ("CUDA", "DIS", "CPU", "TPU", "OpenCL", "DNN"):
        target = alias_to.get(name, name)
        tag = "available" if backends.get(target) else "no device!"
        choices.append(f"{name} (-> {target}, {tag})" if name in alias_to
                       else f"{name} ({tag})")
    ttk.Combobox(frm_opt, textvariable=v_backend, values=choices,
                 state="readonly", width=24).grid(row=1, column=1, columnspan=2, sticky="w")
    ttk.Label(frm_opt, text="Device").grid(row=1, column=3, sticky="e")
    v_device = tk.StringVar(value=DEVICES[0])
    cmb_dev = ttk.Combobox(frm_opt, textvariable=v_device, values=DEVICES,
                           state="readonly", width=6)
    cmb_dev.grid(row=1, column=4, sticky="w")
    _add_tooltip(cmb_dev, "Where the flow runs: cuda (the first NVIDIA "
                          "GPU; the run fails without one) or cpu.")

    # --- advanced ------------------------------------------------------------
    frm_adv = ttk.LabelFrame(root, text=STRINGS["advanced_settings"])
    frm_adv.pack(fill="x", padx=8, pady=4)
    entries = {}
    for i, (label, key, default) in enumerate([
        (STRINGS["threads"], "threads", 8),
        (STRINGS["detrend_window"], "detrend_window", 2.0),
        (STRINGS["norm_window"], "norm_window", 3.0),
        (STRINGS["batch_size"], "batch_size", 3000),
        ("Cut threshold", "cut_threshold", 7.0),
        ("Mesh devices", "mesh", 0),
        ("Pair batch", "pair_batch", 240),
        ("Clip workers", "clip_workers", 0),
    ]):
        ttk.Label(frm_adv, text=label).grid(row=i // 3, column=(i % 3) * 2, sticky="e")
        var = tk.StringVar(value=str(default))
        entries[key] = var
        ttk.Entry(frm_adv, textvariable=var, width=8).grid(
            row=i // 3, column=(i % 3) * 2 + 1, sticky="w", padx=4)

    # choice knobs (full Params parity with the CLI surface)
    for j, (label, key, default, values, tip) in enumerate([
        ("Decode quality", "decode_quality", "fast", ("fast", "exact"),
         "fast: libav luma-only decode (validated at the funscript level); "
         "exact: bit-identical to the cv2 decode chain."),
        ("DIS preset", "dis_preset", "fast", ("ultrafast", "fast", "medium"),
         "Speed/accuracy preset for the DIS backend (cv2 preset parity)."),
        ("Signal chain", "signal_backend", "auto", ("auto", "host", "device"),
         "Where the integration/detrend/normalize chain runs; auto routes "
         "long clean signals to the device."),
        ("Native decode", "use_native_decode", "auto", ("auto", "on", "off"),
         "C++ frame-pump decode runtime: auto uses it when it builds and "
         "OpenCV otherwise; on fails a clip when it does not build."),
    ]):
        ttk.Label(frm_adv, text=label).grid(row=3 + j // 2, column=(j % 2) * 2,
                                            sticky="e")
        var = tk.StringVar(value=default)
        entries[key] = var
        combo = ttk.Combobox(frm_adv, textvariable=var, values=values,
                             state="readonly", width=10)
        combo.grid(row=3 + j // 2, column=(j % 2) * 2 + 1, sticky="w", padx=4)
        _add_tooltip(combo, tip)

    # profile_dir: free-text path (empty = profiling off)
    ttk.Label(frm_adv, text="Profile dir").grid(row=6, column=0, sticky="e")
    v_profile = tk.StringVar(value="")
    entries["profile_dir"] = v_profile
    ent_prof = ttk.Entry(frm_adv, textvariable=v_profile, width=28)
    ent_prof.grid(row=6, column=1, columnspan=3, sticky="w", padx=4)
    _add_tooltip(ent_prof, "Directory for torch.profiler traces of the "
                           "run (empty = profiling off).")

    def current_settings() -> Params:
        return collect_settings({
            **{k: v.get() for k, v in entries.items()},
            "overwrite": v_ow.get(),
            "vr_mode": v_vr.get(),
            "pov_mode": v_pov.get(),
            "keyframe_reduction": v_kr.get(),
            "backend": v_backend.get(),
            "checkpoint": v_ckpt.get(),
        })

    def apply_settings(p: Params):
        for key in entries:
            entries[key].set(str(getattr(p, key)))
        v_ow.set(p.overwrite)
        v_vr.set(p.vr_mode)
        v_pov.set(p.pov_mode)
        v_kr.set(p.keyframe_reduction)
        v_backend.set(p.backend)
        v_ckpt.set(p.checkpoint)

    cfgbar = ttk.Frame(frm_adv)
    cfgbar.grid(row=7, column=0, columnspan=6, sticky="w", pady=2)
    ttk.Button(cfgbar, text="Save config",
               command=lambda: save_config(current_settings())).pack(side="left")
    ttk.Button(cfgbar, text="Load config",
               command=lambda: apply_settings(load_config())).pack(side="left", padx=4)
    ttk.Button(cfgbar, text="Device info",
               command=lambda: messagebox.showinfo("Devices", get_device_info())
               ).pack(side="left")

    # --- progress + log ------------------------------------------------------
    frm_run = ttk.Frame(root)
    frm_run.pack(fill="x", padx=8, pady=4)
    pb_all = ttk.Progressbar(frm_run, maximum=100)
    pb_all.pack(fill="x", pady=2)
    pb_vid = ttk.Progressbar(frm_run, maximum=100)
    pb_vid.pack(fill="x", pady=2)

    frm_log = ttk.LabelFrame(root, text=STRINGS["live_log"])
    frm_log.pack(fill="both", expand=True, padx=8, pady=4)
    log_text = tk.Text(frm_log, height=12, state="disabled")
    log_text.pack(fill="both", expand=True, padx=4, pady=2)

    def clear_log():
        log_text.configure(state="normal")
        log_text.delete("1.0", "end")
        log_text.configure(state="disabled")

    ttk.Button(frm_log, text=STRINGS["clear_log"], command=clear_log).pack(
        anchor="e", padx=4, pady=2)

    def log_line(msg):
        def _append():
            log_text.configure(state="normal")
            log_text.insert("end", msg + "\n")
            log_text.see("end")
            log_text.configure(state="disabled")
        root.after(0, _append)

    def on_finished(error, generated):
        def _done():
            btn_run.configure(state="normal")
            btn_cancel.configure(state="disabled")
            w = worker_box["w"]
            msg = STRINGS["batch_processing_complete"]
            if error:
                msg += " " + STRINGS["processing_completed_with_errors"]
            if generated and messagebox.askyesno(
                    "Done", msg + "\nOpen the last result in the preview?"):
                open_preview(generated[-1][0])
            elif w is not None and w.log_path:
                messagebox.showinfo("Done", f"{msg}\nLog: {w.log_path}")
        root.after(0, _done)

    def run_batch():
        if not files:
            messagebox.showwarning(STRINGS["no_files_selected"],
                                   STRINGS["no_files_warning"])
            return
        btn_run.configure(state="disabled")
        btn_cancel.configure(state="normal")
        w = BatchWorker(
            files, current_settings(),
            on_progress=lambda p: root.after(0, pb_all.configure, {"value": p}),
            on_video_progress=lambda p: root.after(0, pb_vid.configure, {"value": p}),
            on_log=log_line,
            on_finished=on_finished,
            device=v_device.get(),
        )
        worker_box["w"] = w
        w.start()

    def cancel_batch():
        w = worker_box["w"]
        if w is not None:
            w.cancel()

    btns = ttk.Frame(root)
    btns.pack(pady=4)
    btn_run = ttk.Button(btns, text=STRINGS["run"], command=run_batch)
    btn_run.pack(side="left", padx=4)
    btn_cancel = ttk.Button(btns, text=STRINGS["cancel"], command=cancel_batch,
                            state="disabled")
    btn_cancel.pack(side="left", padx=4)

    apply_settings(load_config())
    root.mainloop()
    return 0
