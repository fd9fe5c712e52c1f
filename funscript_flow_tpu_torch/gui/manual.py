"""In-app user manual (the reference ships readme.txt and shows it from a
Readme button; this is the port's own manual, same surface)."""

MANUAL = """\
Funscript Flow (PyTorch) — user manual

WHAT IT DOES
  Converts videos into .funscript motion files by analyzing on-screen
  motion with dense optical flow on an NVIDIA GPU. No machine learning,
  no uploads: everything runs on this machine and its GPU.

QUICK START
  1. Add video files (or a whole folder) with the buttons, or drop them
     onto the window if drag-and-drop is available.
  2. Check "VR Mode" for side-by-side VR recordings. Check "POV Mode"
     if the camera viewpoint is one of the participants and results look
     unstable.
  3. Press Run. Each video gets a .funscript next to it. Existing
     funscripts are skipped unless "Overwrite existing files" is checked.

MODES
  VR Mode     Analyzes the bottom half of the left eye of an SBS equirect
              video, where the relevant motion usually lives.
  POV Mode    Anchors the motion origin at the bottom-center of the frame
              instead of detecting it per frame.

ADVANCED SETTINGS
  Threads          Host decode workers per video. Raise it if the log
                   shows the GPU waiting on decode.
  Detrend window   Seconds of context used to remove slow drift. Lower
                   values follow position changes faster but lose long
                   strokes.
  Norm window      Seconds of context for the 0-100 normalization. Lower
                   values exaggerate small motion.
  Batch size       Host read-ahead depth in frames (memory knob).
  Cut threshold    Mean flow magnitude treated as a scene cut.
  Backend          CUDA = Farnebäck dense flow on the GPU (default).
                   DIS = the faster inverse-search algorithm.
  Device           cuda = the first NVIDIA GPU (default; a run fails
                   without one). cpu = the same flow on the processor,
                   much slower.

RESULTS
  The Preview button plays the finished script over the video inside the
  app: polyline timeline (wheel zoom, drag pan, click seek), playhead
  sync, and a motion indicator bar. "Open in browser" serves the same
  page as a standalone HTML preview.

BATCHING
  Point it at a folder and it processes everything recursively. A run
  that stops can be re-launched: finished files are skipped.
"""
