"""Build the native decode runtime (``frame_pump.cpp``, ``encoder.cpp``)
with the system C++ compiler at first use.

The library goes to ``build/funscript_flow_tpu_torch/`` at the repository
root, never into the package directory. Its file name carries a hash of the
sources, the flags and the libav (and OpenCV) version headers it compiles
against, so a change to any of them builds a new library beside the old
one. The compiler writes into a temporary file in the build directory,
which is renamed into place (atomic on one file system) while an exclusive
file lock is held: several processes (pytest-xdist workers) may ask for the
library at once, and one of them builds it while the others wait for it.

The fast (libav) engine needs libav's headers and libraries only. The exact
engine needs OpenCV as well: it is compiled in (``-DFF_PUMP_EXACT``) when
OpenCV's headers are found, unless the caller asks for a build without it.
A failed build raises :class:`BuildError`, whose message says what is
missing: the compiler, libav's headers, or the compiler's own error.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

__all__ = ["BuildError", "build", "find_libav", "find_opencv", "BUILD_DIR",
           "SOURCES", "CXX", "CXXFLAGS"]

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = SRC_DIR.parents[1] / "build" / "funscript_flow_tpu_torch"
SOURCES = ("frame_pump.cpp", "encoder.cpp")
#: the compiler; a name on PATH or a path
CXX = os.environ.get("CXX") or "g++"
CXXFLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")
LIBAV_LIBS = ("-lavcodec", "-lavformat", "-lswscale", "-lavutil")
OPENCV_LIBS = ("-lopencv_core", "-lopencv_videoio", "-lopencv_imgproc")
# the headers each engine includes (relative to an include directory)
LIBAV_HEADERS = ("libavcodec/avcodec.h", "libavformat/avformat.h",
                 "libswscale/swscale.h", "libavutil/display.h")
OPENCV_HEADER = "opencv2/videoio.hpp"
INCLUDE_DIRS = ("/usr/include", "/usr/local/include",
                "/usr/include/x86_64-linux-gnu",
                "/usr/include/aarch64-linux-gnu")
OPENCV_DIRS = tuple(os.path.join(d, "opencv4") for d in INCLUDE_DIRS[:2])
_BUILD_TIMEOUT_S = 600


class BuildError(RuntimeError):
    """The runtime could not be built; the message says why."""


def _pkg_config_dirs(*packages) -> list:
    """The include directories pkg-config gives for ``packages`` ([] when
    pkg-config or a package is missing)."""
    exe = shutil.which("pkg-config")
    if not exe:
        return []
    try:
        res = subprocess.run([exe, "--cflags-only-I", *packages],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return []
    if res.returncode != 0:
        return []
    return [a[2:] for a in res.stdout.split() if a.startswith("-I")]


def _find(headers, dirs):
    """The first directory of ``dirs`` that holds every one of ``headers``."""
    for d in dirs:
        if all(os.path.isfile(os.path.join(d, h)) for h in headers):
            return d
    return None


def find_libav():
    """The include directory of libav's headers, or None."""
    return _find(LIBAV_HEADERS,
                 _pkg_config_dirs("libavcodec", "libavformat", "libswscale",
                                  "libavutil") + list(INCLUDE_DIRS))


def find_opencv():
    """The include directory of OpenCV's headers, or None."""
    return _find((OPENCV_HEADER,),
                 _pkg_config_dirs("opencv4") + list(OPENCV_DIRS))


def _compiler() -> str:
    found = shutil.which(CXX)
    if not found:
        raise BuildError(f"no C++ compiler: {CXX} not found")
    return found


def _version_headers(include_dir: str) -> bytes:
    """The version headers under ``include_dir`` that pin the ABI the
    library is linked against."""
    out = b""
    for rel in ("libavcodec/version.h", "libavcodec/version_major.h",
                "libavformat/version.h", "libavutil/version.h",
                "libswscale/version.h", "opencv2/core/version.hpp"):
        p = os.path.join(include_dir, rel)
        if os.path.isfile(p):
            out += rel.encode() + Path(p).read_bytes()
    return out


def build(build_dir=None, exact=None) -> Path:
    """The path of the built library, compiling it first if no library of
    the current sources is in ``build_dir`` (default :data:`BUILD_DIR`).

    ``exact``: compile the exact (OpenCV) engine in; ``None`` does so when
    OpenCV's headers are found. Raises :class:`BuildError`.
    """
    build_dir = Path(build_dir or BUILD_DIR)
    av_inc = find_libav()
    if av_inc is None:
        raise BuildError("no libav headers: " + ", ".join(LIBAV_HEADERS)
                         + " not found (pkg-config or "
                         + ", ".join(INCLUDE_DIRS) + ")")
    cv_inc = find_opencv() if exact is not False else None
    if exact and cv_inc is None:
        raise BuildError(f"no OpenCV headers: {OPENCV_HEADER} not found")
    flags = list(CXXFLAGS) + [f"-I{av_inc}"]
    libs = list(LIBAV_LIBS) + ["-lpthread"]
    if cv_inc is not None:
        flags += ["-DFF_PUMP_EXACT", f"-I{cv_inc}"]
        libs = list(OPENCV_LIBS) + libs
    h = hashlib.sha256(" ".join(flags + libs).encode())
    for name in SOURCES:
        h.update(name.encode() + (SRC_DIR / name).read_bytes())
    h.update(_version_headers(av_inc))
    if cv_inc is not None:
        h.update(_version_headers(cv_inc))
    lib = build_dir / f"libframe_pump-{h.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    cxx = _compiler()
    build_dir.mkdir(parents=True, exist_ok=True)
    with open(build_dir / ".libframe_pump.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if lib.exists():  # another process built it while this one waited
            return lib
        fd, tmp = tempfile.mkstemp(dir=build_dir, suffix=".so.tmp")
        os.close(fd)
        try:
            cmd = [cxx, *flags, *(str(SRC_DIR / s) for s in SOURCES),
                   "-o", tmp, *libs]
            try:
                res = subprocess.run(cmd, capture_output=True, text=True,
                                     timeout=_BUILD_TIMEOUT_S)
            except (OSError, subprocess.SubprocessError) as e:
                raise BuildError(f"build error: {e}") from e
            if res.returncode != 0:
                tail = "\n".join((res.stdout + res.stderr).strip()
                                 .splitlines()[-20:])
                raise BuildError(f"build error: {' '.join(cmd)}\n{tail}")
            os.replace(tmp, lib)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return lib
