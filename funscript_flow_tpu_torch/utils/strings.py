"""UI/log string table with strings.json override — the reference's
lightweight i18n hook (FunscriptFlow.pyw:345-388).

Key names follow the reference's table exactly, so a ``strings.json``
written for the reference (translations included) applies unchanged here.
Keys the framework adds on top (device/mesh messages, errors the
reference didn't surface) are grouped at the bottom. The PyTorch port's own
copy of the table.

One deliberate delta: the reference *replaces* the whole table when
strings.json parses (:383-386), so a partial override loses every other
string; we merge over the defaults instead — a partial translation stays
usable.
"""

from __future__ import annotations

import json
import os

__all__ = ["STRINGS", "load_strings"]

_DEFAULTS = {
    # --- reference-compatible keys (:346-381) ---
    "app_title": "Funscript Flow (PyTorch)",
    "select_videos": "Select Videos",
    "select_folder": "Select Folder",
    "no_files_selected": "No files selected",
    "vr_mode": "VR Mode",
    "vr_mode_tooltip": "Analyze SBS VR videos (bottom half of the left eye).",
    "overall_progress": "Overall Progress:",
    "current_video_progress": "Current Video Progress:",
    "advanced_settings": "Advanced Settings",
    "threads": "Threads:",
    "detrend_window": "Detrend window (sec):",
    "norm_window": "Norm window (sec):",
    "batch_size": "Batch size (frames):",
    "show_preview": "Show Preview",
    "show_advanced": "Show Advanced Settings",
    "overwrite_files": "Overwrite existing files",
    "run": "Run",
    "cancel": "Cancel",
    "readme": "Readme",
    "config_saved": "Config saved to {config_path}",
    "config_load_error": "Error loading config: {error}",
    "no_files_warning": "Please select one or more video files or a folder.",
    "cancelled_by_user": "Processing cancelled by user.",
    "batch_processing_complete": "Batch processing complete.",
    "funscript_saved": "Funscript saved: {output_path}",
    "skipping_file_exists": "Skipping {video_path}: {output_path} exists.",
    "log_error": "ERROR: Could not write output: {error}",
    "found_files": "Found {n} file(s).",
    "processing_file": "--- Processing file {current}/{total}: {video_path} ---",
    "processing_completed_with_errors":
        "Processing completed with errors. See run.log for details.",
    "pov_mode_tooltip":
        "Fixed bottom-center motion origin; steadier for POV videos.",
    "live_log": "Live Log",
    "clear_log": "Clear Log",
    # --- framework additions ---
    "video_too_short": "ERROR: Video too short to analyze ({n} sampled frames).",
    "processing_video": "Processing video: {video_path}",
    "processing_time": "Processing time: {seconds:.2f} seconds",
    "backend": "Backend:",
    "mesh_devices": "Mesh: {n} devices ({platform})",
    "resuming_checkpoint":
        "Resuming from checkpoint: {done}/{total} pairs done "
        "(recomputing {halo}-pair halo).",
}


def load_strings(path: str = "strings.json") -> dict:
    strings = dict(_DEFAULTS)
    if os.path.exists(path):
        try:
            with open(path, encoding="utf-8") as f:
                strings.update(json.load(f))
        except Exception:
            pass  # unreadable override -> defaults (reference behavior)
    return strings


STRINGS = load_strings()
