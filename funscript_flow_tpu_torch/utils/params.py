"""Run parameters — the port's config surface.

Mirrors the reference's settings dict (FunscriptFlow.pyw:2654-2664) plus the
undocumented ``cut_threshold`` config key (:858,876). The JAX package's TPU
knobs (``use_pallas``, ``warp_backend``) have no meaning here and are
dropped; a config file that still carries them loads, because unknown keys
are ignored. CLI defaults match the reference CLI (:2644-2652).
"""

from __future__ import annotations

from dataclasses import asdict, dataclass, fields

__all__ = ["Params", "params_from_jax"]

# reference and JAX-package backend names accepted for drop-in
# compatibility: every dense-Farnebäck name maps to the CUDA path
_BACKEND_ALIASES = {"CPU": "CUDA", "OPENCL": "CUDA", "TPU": "CUDA",
                    "DNN": "DIS"}


@dataclass
class Params:
    threads: int = 8                 # host decode concurrency (reference :2644)
    detrend_window: float = 2.0      # seconds (reference :2645)
    norm_window: float = 3.0         # seconds (reference :2646)
    batch_size: int = 3000           # host decode read-ahead depth in frames
    overwrite: bool = False
    vr_mode: bool = False
    pov_mode: bool = False
    keyframe_reduction: bool = True
    backend: str = "CUDA"            # CUDA | DIS (+ reference aliases)
    cut_threshold: float = 7.0       # config-only key in the reference (:876)
    signal_backend: str = "auto"     # auto | host | device
    pair_batch: int = 240            # device micro-batch of frame pairs
    use_native_decode: str = "auto"  # auto | on | off (native decode runtime)
    decode_quality: str = "fast"     # fast | exact (native decode engines)
    dis_preset: str = "fast"         # ultrafast | fast | medium (DIS backend)
    mesh: int = 0                    # shard pair windows over N devices
    clip_workers: int = 0            # folder mode: concurrent in-flight clips
    profile_dir: str = ""            # profiler trace dir ("" = off)
    checkpoint: bool = False         # intra-video resume sidecars

    def __post_init__(self):
        b = str(self.backend).upper()
        self.backend = _BACKEND_ALIASES.get(b, b)
        if self.backend not in ("CUDA", "DIS"):
            raise ValueError(f"Unknown backend: {self.backend}")
        if self.signal_backend not in ("auto", "host", "device"):
            raise ValueError(f"Unknown signal_backend: {self.signal_backend}")
        if self.use_native_decode not in ("auto", "on", "off"):
            raise ValueError(
                f"Unknown use_native_decode: {self.use_native_decode}")
        if self.dis_preset not in ("ultrafast", "fast", "medium"):
            raise ValueError(f"Unknown dis_preset: {self.dis_preset}")
        if self.decode_quality not in ("fast", "exact"):
            raise ValueError(f"Unknown decode_quality: {self.decode_quality}")

    @classmethod
    def from_dict(cls, d: dict) -> "Params":
        """Tolerant load, accepting a REFERENCE-shaped config.json too.

        The reference persists raw QLineEdit text, so numeric settings
        arrive as strings ("8", "1.5", "3000"), and the saved backend is
        the combo's display text, which may carry an " (unavailable)"
        annotation (FunscriptFlow.pyw:2266-2281, 2022-2036). Values are
        coerced by field type; an unparseable value keeps its default;
        unknown keys (the JAX package's ``use_pallas``/``warp_backend``
        among them) are ignored.
        """
        types = {f.name: f.type for f in fields(cls)}
        out = {}
        for k, v in d.items():
            t = types.get(k)
            if t is None:
                continue  # unknown key (newer/older version): ignore
            try:
                if t in (int, "int"):
                    v = int(float(v))
                elif t in (float, "float"):
                    v = float(v)
                elif t in (bool, "bool") and isinstance(v, str):
                    v = v.strip().lower() in ("1", "true", "yes", "on")
                elif t in (str, "str") and not isinstance(v, (dict, list)):
                    v = str(v)
            except (TypeError, ValueError):
                continue  # unparseable: keep the default
            out[k] = v
        if isinstance(out.get("backend"), str):
            out["backend"] = out["backend"].split(" (")[0].strip()
        return cls(**out)

    def to_dict(self) -> dict:
        return asdict(self)


def params_from_jax(d: dict) -> Params:
    """The JAX package's ``Params.to_dict()`` output as the port's Params.

    The run configuration is the state that crosses from one package to the
    other (the system has no learned weights): every shared key keeps its
    value, ``backend`` "TPU" becomes "CUDA", and the TPU-only knobs are
    dropped.
    """
    return Params.from_dict(d)
