"""Headless CLI — flag-compatible with the reference.

``python -m funscript_flow_tpu_torch <input> [flags]`` mirrors
FunscriptFlow.pyw:2641-2666 and the JAX package's CLI, without its TPU
knobs (``--use_pallas``, ``--warp_backend``) and with ``--device``. A video
file decodes through the native pump (``runtime``, libav) where it builds,
else through OpenCV (``cv2``). With no input it opens the GUI
(``gui.app``), as the reference and the JAX package do.

As in the JAX package, keyframe reduction is on by default and
``--disable_keyframe_reduction`` turns it off (the reference's flag was
inverted, :2651, :2662).
"""

from __future__ import annotations

import argparse

from .runner import run_headless
from .utils.params import Params


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="funscript-flow-tpu-torch",
        description="Optical Flow to Funscript (PyTorch/CUDA)")
    p.add_argument("input", nargs="?", help="Input video file or folder")
    p.add_argument("--threads", type=int, default=8,
                   help="Host decode concurrency (default: 8)")
    p.add_argument("--detrend_window", type=float, default=2.0,
                   help="Detrend window in seconds (default: 2.0)")
    p.add_argument("--norm_window", type=float, default=3.0,
                   help="Normalization window in seconds (default: 3.0)")
    p.add_argument("--batch_size", type=int, default=3000,
                   help="Frames per host bracket (default: 3000)")
    p.add_argument("--overwrite", action="store_true",
                   help="Overwrite existing output files")
    p.add_argument("--vr_mode", action="store_true",
                   help="Enable VR Mode (SBS equirect: analyze bottom half of left eye)")
    p.add_argument("--pov_mode", action="store_true",
                   help="Enable POV Mode (fixed bottom-center motion origin)")
    p.add_argument("--disable_keyframe_reduction", action="store_true",
                   help="Disable keyframe reduction (raw motion export)")
    p.add_argument("--backend",
                   choices=["CUDA", "DIS", "CPU", "TPU", "OpenCL", "DNN"],
                   default="CUDA",
                   help="Flow backend; reference names map to CUDA/DIS "
                        "(default: CUDA)")
    p.add_argument("--cut_threshold", type=float, default=7.0,
                   help="Scene-cut mean-flow-magnitude threshold (default: 7)")
    p.add_argument("--signal_backend", choices=["auto", "host", "device"],
                   default="auto", help="Where the 1-D signal chain runs")
    p.add_argument("--pair_batch", type=int, default=240,
                   help="Device micro-batch of frame pairs (default: 240)")
    p.add_argument("--mesh", type=int, default=0,
                   help="Use N devices: one clip's windows over N devices, "
                        "or a folder's clips one per device (0 = single "
                        "device)")
    p.add_argument("--clip_workers", type=int, default=0,
                   help="Folder mode: concurrent in-flight clips (0 = auto: "
                        "one per --mesh device, else sequential; 1 = "
                        "sequential)")
    p.add_argument("--dis_preset", choices=["ultrafast", "fast", "medium"],
                   default="fast",
                   help="DIS backend preset (cv2 equivalents; default: fast)")
    p.add_argument("--decode_quality", choices=["fast", "exact"],
                   default="fast",
                   help="fast = libav lowres+luma-only decode in the native "
                        "pump; exact = cv2-bit-identical decode")
    p.add_argument("--profile_dir", default="",
                   help="Write a torch.profiler chrome trace of each clip's "
                        "analysis here")
    p.add_argument("--checkpoint", action="store_true",
                   help="Intra-video resume sidecars: a killed or cancelled "
                        "clip resumes where it stopped")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="Where the flow program runs (default: cuda; "
                        "raises when CUDA is absent)")
    p.add_argument("--log", default="run.log", help="Log file path")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if not args.input:
        # no input -> GUI, like the reference (:2665-2668); tkinter-based
        from .gui.app import launch

        return launch()
    params = Params(
        threads=args.threads,
        detrend_window=args.detrend_window,
        norm_window=args.norm_window,
        batch_size=args.batch_size,
        overwrite=args.overwrite,
        vr_mode=args.vr_mode,
        pov_mode=args.pov_mode,
        keyframe_reduction=not args.disable_keyframe_reduction,
        backend=args.backend,
        cut_threshold=args.cut_threshold,
        signal_backend=args.signal_backend,
        pair_batch=args.pair_batch,
        dis_preset=args.dis_preset,
        mesh=args.mesh,
        clip_workers=args.clip_workers,
        decode_quality=args.decode_quality,
        profile_dir=args.profile_dir,
        checkpoint=args.checkpoint,
    )
    any_error = run_headless(args.input, params, log_path=args.log,
                             device=args.device)
    return 1 if any_error else 0


if __name__ == "__main__":
    raise SystemExit(main())
