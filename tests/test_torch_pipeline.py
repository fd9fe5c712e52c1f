"""The port's flow program and streaming driver: slice-level parity with the
JAX package, batch-size invariance and streaming == batch (bitwise)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import reference_cv as ref
from funscript_flow_tpu.models import pipeline as jpl
from funscript_flow_tpu_torch.models.pipeline import (
    FlowAnalyzer,
    PipelineConfig,
    StreamingFlowAnalyzer,
    flow_chunk_program,
    rgb_to_gray_cv,
)

# the tests run in several worker processes at once: one torch thread
# each keeps them from oversubscribing the cores
torch.set_num_threads(1)

CPU = "cpu"


@pytest.fixture(scope="module")
def clip24():
    frames = ref.make_synthetic_frames(24, h=64, w=64, period=12, seed=5)
    return np.stack([ref.rgb_to_gray(f) for f in frames])


@pytest.fixture(scope="module")
def jax_program_out(clip24):
    """The JAX flow program on the 24-frame clip, f32 XLA warp (the strict
    parity regime; its bf16 default is ~1e-3 px off by design)."""
    cfg = jpl.PipelineConfig(pair_batch=23, warp_dtype="float32",
                             warp_backend="xla", use_pallas="off")
    res = jpl.flow_chunk_program(jnp.asarray(clip24), jnp.int32(23), cfg)
    return {k: np.asarray(v) for k, v in res.items()}


@pytest.mark.parametrize("kernels", ["auto", "plain"])
def test_flow_chunk_program_matches_jax(clip24, jax_program_out, kernels,
                                       record_property):
    """Slice-level parity on the synthetic zoom clip; bars of
    tests/test_flow.py:134-136 (the measured gaps are far smaller)."""
    got = flow_chunk_program(torch.from_numpy(clip24), 23,
                             PipelineConfig(pair_batch=23, kernels=kernels))
    got = {k: v.numpy() for k, v in got.items()}
    want = jax_program_out
    assert set(got) == set(want)
    assert got["dots"].shape == (23,)
    for k in ("centers", "dots", "mean_mag"):
        record_property(f"max_abs_err_{k}",
                        float(np.abs(got[k] - want[k]).max()))
    np.testing.assert_array_equal(got["cuts"], want["cuts"])
    np.testing.assert_allclose(got["centers"], want["centers"], atol=1.0)
    np.testing.assert_allclose(got["raw_centers"], want["raw_centers"],
                               atol=1.0)
    np.testing.assert_allclose(got["dots"], want["dots"], atol=5e-3)
    np.testing.assert_allclose(got["mean_mag"], want["mean_mag"], atol=1e-3)
    np.testing.assert_allclose(got["val_pos"], want["val_pos"], atol=1e-3)


def test_valid_masking(clip24):
    """Pairs at or past n_pairs are padding: zero dots/mean_mag/val_pos,
    no cuts, and smoothing truncated at n_pairs."""
    full = flow_chunk_program(torch.from_numpy(clip24), 23, PipelineConfig())
    part = flow_chunk_program(torch.from_numpy(clip24), 15,
                              PipelineConfig(cut_threshold=0.0))
    assert (part["dots"][15:] == 0).all()
    assert (part["mean_mag"][15:] == 0).all()
    assert not part["cuts"][15:].any() and part["cuts"][:15].all()
    torch.testing.assert_close(part["raw_centers"], full["raw_centers"])


def test_rgb_input_equals_gray(rng):
    rgb = rng.integers(0, 256, (2, 16, 24, 3), dtype=np.uint8)
    got = rgb_to_gray_cv(torch.from_numpy(rgb)).numpy()
    want = np.asarray(jpl.rgb_to_gray_cv(jnp.asarray(rgb)))
    np.testing.assert_array_equal(got, want)
    frames = ref.make_synthetic_frames(6, h=48, w=48, period=6, seed=1)
    gray = np.stack([ref.rgb_to_gray(f) for f in frames])
    a = flow_chunk_program(torch.from_numpy(np.stack(frames)), 5,
                           PipelineConfig())
    b = flow_chunk_program(torch.from_numpy(gray), 5, PipelineConfig())
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)


def test_pipeline_batchsize_invariance():
    """Results do not depend on the micro-batch size (halo correct)."""
    frames = np.stack([ref.rgb_to_gray(f) for f in
                       ref.make_synthetic_frames(20, h=64, w=64, period=10,
                                                 seed=7)])
    outs = [FlowAnalyzer(PipelineConfig(pair_batch=bs), device=CPU)
            .analyze_video_pairs(frames) for bs in (4, 7, 19)]
    for k in ("dots", "centers", "mean_mag"):
        np.testing.assert_allclose(outs[0][k], outs[1][k], atol=1e-5)
        np.testing.assert_allclose(outs[0][k], outs[2][k], atol=1e-5)


@pytest.fixture(scope="module")
def clip32():
    frames = ref.make_synthetic_frames(32, h=48, w=48, period=9, seed=13)
    return np.stack([ref.rgb_to_gray(f) for f in frames])


@pytest.mark.parametrize("push_size", [3, 40])
def test_streaming_equals_batch(clip32, push_size):
    """Streaming push/flush is bitwise identical to the batch analyzer for
    any push granularity (pushes smaller than the halo included)."""
    cfg = PipelineConfig(pair_batch=6)
    want = FlowAnalyzer(cfg, device=CPU).analyze_video_pairs(clip32)
    st = StreamingFlowAnalyzer(cfg, device=CPU)
    results = []
    for i in range(0, len(clip32), push_size):
        results.extend(st.push(list(clip32[i : i + push_size])))
    results.extend(st.flush())
    got = {k: np.concatenate([r[k] for r in results]) for k in st.KEYS}
    assert st.pairs_emitted == 31
    for k in st.KEYS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("n_frames", [120, 87])
def test_streaming_ramp_down_equals_batch(n_frames):
    """First-window ramp and tail ramp-down (total known) change only the
    dispatch schedule: results stay bitwise identical to the batch
    analyzer, and the window count follows the schedule."""
    frames = np.stack([ref.rgb_to_gray(f) for f in ref.make_synthetic_frames(
        n_frames, h=32, w=32, period=9, seed=11)])
    cfg = PipelineConfig(pair_batch=80)
    want = FlowAnalyzer(cfg, device=CPU).analyze_video_pairs(frames)
    st = StreamingFlowAnalyzer(cfg, device=CPU, n_pairs_total=n_frames - 1)
    assert st.ramp_pairs == 20
    results = []
    sent = min(st.ramp_pairs + st.radius + 1, n_frames)
    results.extend(st.push(list(frames[:sent])))
    while sent < n_frames:
        n = min(cfg.pair_batch, n_frames - sent)
        results.extend(st.push(list(frames[sent : sent + n])))
        sent += n
    assert st.pairs_emitted == n_frames - 1  # ramp-down dispatched the tail
    results.extend(st.flush())
    got = {k: np.concatenate([r[k] for r in results]) for k in st.KEYS}
    for k in st.KEYS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert st.windows_dispatched >= 3  # ramp + at least two tail buckets


def test_streaming_truncated_total_falls_back_to_flush(clip32):
    """n_pairs_total is an upper bound: a short container still emits every
    pair that arrived, with real counts."""
    cfg = PipelineConfig(pair_batch=16)
    want = FlowAnalyzer(cfg, device=CPU).analyze_video_pairs(clip32)
    st = StreamingFlowAnalyzer(cfg, device=CPU, n_pairs_total=59)
    results = []
    for i in range(0, len(clip32), 10):
        results.extend(st.push(list(clip32[i : i + 10])))
    results.extend(st.flush())
    assert st.pairs_emitted == 31
    got = {k: np.concatenate([r[k] for r in results]) for k in st.KEYS}
    for k in st.KEYS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
