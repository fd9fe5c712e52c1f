"""The port's DIS presets ``medium`` and ``ultrafast`` end to end against
the JAX package's, on the same frames: the flow program on one window
(bars of tests/test_flow.py:134-136) and ``process_video`` on preopened
frames (the same ``at``, ``pos`` within the ±2 of tests/test_runner.py).

``medium`` is the preset with a refinement at every level (K5 three times
per window on 256 px frames) and ``ultrafast`` the one with none. Each
JAX reference is computed once per preset, in a module-scoped fixture (the
JAX DIS costs 12-17 s per new shape here); the flow program's window
shape is the one the JAX runner compiles, so the two share the compile.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import reference_cv as ref
from funscript_flow_tpu import runner as jrun
from funscript_flow_tpu.io import decode as jdec
from funscript_flow_tpu.models import pipeline as jpl
from funscript_flow_tpu.utils.params import Params as JParams
from funscript_flow_tpu_torch import runner as trun
from funscript_flow_tpu_torch.io import decode as tdec
from funscript_flow_tpu_torch.models.pipeline import (PipelineConfig,
                                                      flow_chunk_program)
from funscript_flow_tpu_torch.utils.params import Params

# the tests run in several worker processes at once: one torch thread
# each keeps them from oversubscribing the cores
torch.set_num_threads(1)

N_FRAMES, SIDE, PAIR_BATCH = 40, 64, 8


class _ListSource:
    def __init__(self, frames):
        self._frames = list(frames)
        self._i = 0

    def get_batch(self, n):
        out = self._frames[self._i : self._i + n]
        self._i += len(out)
        return out

    def close(self):
        self._i = len(self._frames)


@pytest.fixture(scope="module")
def clip():
    frames = ref.make_synthetic_frames(N_FRAMES, h=SIDE, w=SIDE, period=12,
                                       seed=11)
    return [ref.rgb_to_gray(f) for f in frames]


def _process(process_video, meta, frames, params, path, **kw):
    logs = []
    err = process_video(str(path), params, logs.append,
                        preopened=(meta, _ListSource(frames)), **kw)
    assert not err, logs
    with open(str(path).rsplit(".", 1)[0] + ".funscript") as f:
        return json.load(f)["actions"], logs


@pytest.fixture(scope="module", params=["medium", "ultrafast"])
def jax_preset(request, clip, tmp_path_factory):
    """(preset, the JAX flow program's outputs on the first window, the
    JAX process_video's actions on the whole clip)."""
    preset = request.param
    cfg = jpl.PipelineConfig(pair_batch=PAIR_BATCH, flow_algorithm="dis",
                             dis_preset=preset)
    n = PAIR_BATCH + 12
    res = jpl.flow_chunk_program(jnp.asarray(np.stack(clip[: n + 1])),
                                 jnp.int32(n), cfg)
    meta = jdec.VideoMeta(total_frames=N_FRAMES, fps=30.0, width=SIDE,
                          height=SIDE)
    acts, _ = _process(jrun.process_video, meta, clip,
                       JParams(overwrite=True, pair_batch=PAIR_BATCH,
                               backend="DIS", dis_preset=preset),
                       tmp_path_factory.mktemp(preset) / "jax_clip.mp4")
    return preset, {k: np.asarray(v) for k, v in res.items()}, acts


@pytest.mark.parametrize("kernels", ["auto", "plain"])
def test_flow_chunk_program_preset_matches_jax(clip, jax_preset, kernels,
                                               record_property):
    """One window of the preset through both flow programs; the bars of
    tests/test_flow.py:134-136."""
    preset, want, _ = jax_preset
    n = PAIR_BATCH + 12
    got = flow_chunk_program(
        torch.from_numpy(np.stack(clip[: n + 1])), n,
        PipelineConfig(pair_batch=PAIR_BATCH, flow_algorithm="dis",
                       dis_preset=preset, kernels=kernels))
    got = {k: v.numpy() for k, v in got.items()}
    for k in ("centers", "dots", "mean_mag"):
        record_property(f"max_abs_err_{k}",
                        float(np.abs(got[k] - want[k]).max()))
    assert np.abs(want["dots"]).max() > 1e-3  # the clip moves
    np.testing.assert_array_equal(got["cuts"], want["cuts"])
    np.testing.assert_allclose(got["centers"], want["centers"], atol=1.0)
    np.testing.assert_allclose(got["dots"], want["dots"], atol=5e-3)
    np.testing.assert_allclose(got["mean_mag"], want["mean_mag"], atol=1e-3)


def test_process_video_preset_matches_jax(clip, jax_preset, tmp_path,
                                          record_property):
    """The clip through both packages' process_video with the preset, on
    the same preopened frames: timestamps equal, positions within ±2."""
    preset, _, want = jax_preset
    meta = tdec.VideoMeta(total_frames=N_FRAMES, fps=30.0, width=SIDE,
                          height=SIDE)
    got, logs = _process(trun.process_video, meta, clip,
                         Params(overwrite=True, pair_batch=PAIR_BATCH,
                                backend="DIS", dis_preset=preset),
                         tmp_path / "torch_clip.mp4", device="cpu")
    assert any(f"Using backend: DIS ({preset})" in m for m in logs)
    assert [a["at"] for a in got] == [a["at"] for a in want]
    dpos = np.abs(np.array([a["pos"] for a in got])
                  - np.array([a["pos"] for a in want]))
    record_property("max_pos_delta", int(dpos.max()))
    assert dpos.max() <= 2, dpos
