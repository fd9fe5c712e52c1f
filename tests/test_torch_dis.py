"""Port DIS (models/dis.py, kernel K4 in its two forms sample_patches and
sample_abs, and K5 warp_planes) vs the JAX package: its XLA functions and
its Pallas kernels in interpret mode, on the same numpy inputs, plus the
slice end to end (flow program and process_video with the DIS backend).

Every JAX reference is computed once, in a module-scoped fixture, at three
shapes: 128 px pairs (B=2, whose pyramid levels are 32 and 64 px), the
Pallas kernels' own dims, and 64 px frame windows of the pipeline. Bars
are stated per test and the measured maxima are recorded with
``record_property``. DIS sums patch and window axes in another order than
XLA, and its 16-25 descent steps carry those roundings along, so whole-flow
bars are 1e-3 px (the flow moves by ~2e-4 px under 1e-4 input noise).

The kernel-vs-twin cases need a CUDA device: they carry the ``cuda`` marker
and skip without one.
"""

import dataclasses
import json

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import reference_cv as ref
from funscript_flow_tpu import runner as jrun
from funscript_flow_tpu.io import decode as jdec
from funscript_flow_tpu.models import dis as jdis
from funscript_flow_tpu.models import pipeline as jpl
from funscript_flow_tpu.ops import farneback as jfb
from funscript_flow_tpu.ops.pallas.warp import (sample_abs_pallas,
                                                warp_planes_padded)
from funscript_flow_tpu.utils.params import Params as JParams
from funscript_flow_tpu_torch import runner as trun
from funscript_flow_tpu_torch.io import decode as tdec
from funscript_flow_tpu_torch.models import dis as tdis
from funscript_flow_tpu_torch.models.pipeline import (PipelineConfig,
                                                      flow_chunk_program)
from funscript_flow_tpu_torch.ops import farneback as tfb
from funscript_flow_tpu_torch.ops.cuda import warp
from funscript_flow_tpu_torch.utils.params import Params

# the tests run in several worker processes at once: one torch thread
# each keeps them from oversubscribing the cores
torch.set_num_threads(1)

PRESETS = ("ultrafast", "fast", "medium")
FLOW_BAR = 1e-3  # px, whole DIS flow and its levels


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel vs plain twin)")
    return torch.device("cuda", 0)


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.asarray(x).dtype))


def _smooth_pair(size, dy, dx, B=2, seed=3):
    """B pairs of a smooth texture, f1 the texture moved by (-dx, -dy):
    true flow (u, v) = (-dx, -dy)."""
    rng = np.random.default_rng(seed)
    k = np.exp(-np.arange(-12, 13) ** 2 / 32.0)
    k /= k.sum()
    f0, f1 = [], []
    for _ in range(B):
        base = rng.normal(size=(size + 44, size + 44))
        base = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 0, base)
        base = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 1, base)
        base = (base / base.std() * 40 + 128).astype(np.float32)
        f0.append(base[10:10 + size, 10:10 + size])
        f1.append(base[10 + dy:10 + dy + size, 10 + dx:10 + dx + size])
    return np.stack(f0), np.stack(f1)


# -------------------------------------------------------------- presets

@pytest.mark.parametrize("name", PRESETS)
def test_preset_fields_equal_jax(name):
    want = dataclasses.asdict(jdis.DISConfig.preset(name))
    got = dataclasses.asdict(tdis.DISConfig.preset(name))
    assert got.pop("kernels") == "auto"
    assert got == want


def test_config_validates():
    with pytest.raises(ValueError):
        tdis.DISConfig.preset("slow")
    with pytest.raises(ValueError):
        tdis.DISConfig(kernels="fast")
    with pytest.raises(ValueError):
        PipelineConfig(flow_algorithm="lk")


# -------------------------------------------------------- K4 sample_abs

K4_DIMS = [(64, 64, 120, 120), (32, 32, 56, 56), (40, 48, 72, 88)]


@pytest.fixture(scope="module")
def k4_cases():
    """The dims of tests/test_warp_pallas.py:92-93, B=3, uniform coords."""
    rng = np.random.default_rng(4)
    cases = []
    for h, w, Ho, Wo in K4_DIMS:
        img = rng.random((3, h, w)).astype(np.float32)
        fy = rng.uniform(0, h - 1, (3, Ho, Wo)).astype(np.float32)
        fx = rng.uniform(0, w - 1, (3, Ho, Wo)).astype(np.float32)
        args = [jnp.asarray(a) for a in (img, fy, fx)]
        cases.append((img, fy, fx,
                      np.asarray(jdis._bilinear_abs_packed(*args)),
                      np.asarray(sample_abs_pallas(*args, interpret=True))))
    return cases


@pytest.mark.parametrize("case", range(len(K4_DIMS)))
def test_sample_abs_twin_matches_jax(k4_cases, case, record_property):
    """The twin (and the wrapper's CPU route) equals _bilinear_abs_packed
    bitwise, and sample_abs_pallas within its atol 2e-5
    (tests/test_warp_pallas.py:108)."""
    img, fy, fx, packed, pallas = k4_cases[case]
    got = warp.sample_abs(_t(img), _t(fy), _t(fx)).numpy()
    np.testing.assert_array_equal(
        got, tdis.bilinear_abs(_t(img), _t(fy), _t(fx)).numpy())
    np.testing.assert_array_equal(got, packed)
    record_property("max_abs_err_pallas", float(np.abs(got - pallas).max()))
    np.testing.assert_allclose(got, pallas, atol=2e-5)


# ------------------------------------------------------- K5 warp_planes

@pytest.fixture(scope="module")
def k5_case():
    """3 planes at 16 x 40 (W padded to 128 lanes on the TPU side), flow
    pre-clamped as in variational_refinement (models/dis.py:265-268)."""
    rng = np.random.default_rng(5)
    B, H, W = 2, 16, 40
    planes = [rng.normal(size=(B, H, W)).astype(np.float32) for _ in range(3)]
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    u = (rng.normal(size=(B, H, W)) * 4).astype(np.float32)
    v = (rng.normal(size=(B, H, W)) * 4).astype(np.float32)
    u = np.clip(xs + u, 0, W - 1) - xs
    v = np.clip(ys + v, 0, H - 1) - ys
    jp = tuple(jnp.asarray(p) for p in planes)
    xla, _ = jfb._warp_bilinear(jp, jnp.asarray(u), jnp.asarray(v),
                                warp_dtype=jnp.float32)
    pal = warp_planes_padded(jp, jnp.asarray(u), jnp.asarray(v),
                             interpret=True)
    return (planes, u, v, np.stack([np.asarray(x) for x in xla], 1),
            np.asarray(pal))


@pytest.mark.parametrize("oracle", ["xla", "pallas"])
def test_warp_planes_twin_matches_jax(k5_case, oracle, record_property):
    """K5's CPU route against JAX's f32 _warp_bilinear (the function JAX's
    CPU path calls, models/dis.py:279-280) and warp_planes_padded in
    interpret mode; atol 1e-5."""
    planes, u, v, xla, pal = k5_case
    got = warp.warp_planes([_t(p) for p in planes], _t(u), _t(v)).numpy()
    want = xla if oracle == "xla" else pal
    assert got.shape == want.shape
    record_property("max_abs_err", float(np.abs(got - want).max()))
    np.testing.assert_allclose(got, want, atol=1e-5)


# ---------------------------------------------------------- DIS pieces

@pytest.fixture(scope="module")
def pair128():
    return _smooth_pair(128, 2, -3)  # true flow (3, -2)


@pytest.fixture(scope="module")
def jax_dis(pair128):
    """JAX DIS at 128 px: the two presets' whole flows, and the pieces on
    the inputs of their 32 px level (the same shapes, so eager JAX reuses
    its compiled ops)."""
    f0, f1 = (jnp.asarray(x) for x in pair128)
    out = {}
    for name in ("fast", "medium"):
        u, v = jdis.dis_flow_planes(f0, f1, jdis.DISConfig.preset(name))
        out[name] = (np.asarray(u), np.asarray(v))
    p0 = [f0]
    p1 = [f1]
    for _ in range(2):
        p0.append(jdis._pyr_down(p0[-1]))
        p1.append(jdis._pyr_down(p1[-1]))
    out["pyr0"] = [np.asarray(x) for x in p0]
    out["pyr1"] = [np.asarray(x) for x in p1]
    I0, I1 = p0[2], p1[2]
    out["sobel"] = [np.asarray(x) for x in jdis._sobel(I0)]
    out["d5"] = [np.asarray(x) for x in jdis._d5(I0)]
    out["patches"] = np.asarray(jdis._extract_patches(I0, 7, 7, 8, 4))
    rng = np.random.default_rng(6)
    u0 = (1.5 + rng.normal(size=I0.shape) * 0.3).astype(np.float32)
    v0 = (-1.0 + rng.normal(size=I0.shape) * 0.3).astype(np.float32)
    out["init"] = (u0, v0)
    cfg = jdis.DISConfig()
    out["level"] = [np.asarray(x) for x in jdis._dis_level(
        I0, I1, jnp.asarray(u0), jnp.asarray(v0), cfg)]
    out["refine"] = [np.asarray(x) for x in jdis.variational_refinement(
        I0, I1, jnp.asarray(u0), jnp.asarray(v0), cfg)]
    return out


def test_pyr_down_matches_jax(jax_dis):
    x = _t(jax_dis["pyr0"][0])
    for k in (1, 2):
        x = tdis._pyr_down(x)
        assert x.is_contiguous()
        np.testing.assert_allclose(x.numpy(), jax_dis["pyr0"][k], rtol=0,
                                   atol=1e-4)


def test_sobel_d5_patches_match_jax(jax_dis, record_property):
    I0 = _t(jax_dis["pyr0"][2])
    err = 0.0
    for got, want in zip(tdis._sobel(I0) + tdis._d5(I0),
                         jax_dis["sobel"] + jax_dis["d5"]):
        err = max(err, float(np.abs(got.numpy() - want).max()))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    record_property("max_abs_err", err)
    np.testing.assert_array_equal(
        tdis._extract_patches(I0, 7, 7, 8, 4).numpy(), jax_dis["patches"])


PATCH_DIMS = [(64, 64, 15, 15), (32, 32, 7, 7), (40, 48, 9, 11)]


@pytest.mark.parametrize("dims,st", [
    pytest.param(d, 4, id=f"dims{i}") for i, d in enumerate(PATCH_DIMS)] + [
    pytest.param(d, 3, id=f"dims{i}-stride3")
    for i, d in enumerate(PATCH_DIMS)])
def test_sample_patches_dense_matches_jax(dims, st, record_property):
    """Far out-of-range offsets exercise the patch-corner clamp (dims of
    tests/test_dis.py:109, at the strides of the three presets); bar atol
    5e-5, that test's. The patch sampler's CPU route (K4's twin) equals
    the dense sampler with bilinear_abs bitwise."""
    h, w, ny, nx = dims
    ps, B = 8, 5
    rng = np.random.default_rng(0)
    img = rng.random((B, h, w)).astype(np.float32)
    py = ((np.arange(ny) * st)[:, None] * np.ones((1, nx))).astype(np.float32)
    px = (np.ones((ny, 1)) * (np.arange(nx) * st)[None, :]).astype(np.float32)
    uy = rng.uniform(-h, h, (B, ny, nx)).astype(np.float32)
    ux = rng.uniform(-w, w, (B, ny, nx)).astype(np.float32)
    want = np.asarray(jdis._sample_patches_dense(
        *(jnp.asarray(a) for a in (img, py, px, uy, ux)), ps))
    dense = None
    for sample in (tdis.bilinear_abs, warp.sample_abs):
        got = tdis._sample_patches_dense(_t(img), _t(py), _t(px), _t(uy),
                                         _t(ux), ps, sample).numpy()
        record_property("max_abs_err", float(np.abs(got - want).max()))
        np.testing.assert_allclose(got, want, atol=5e-5)
        dense = got
    got = warp.sample_patches(_t(img), _t(ux), _t(uy), ps, st).numpy()
    assert got.shape == (B, ny, nx, ps * ps)
    np.testing.assert_array_equal(got, dense)
    np.testing.assert_allclose(got, want, atol=5e-5)


@pytest.mark.parametrize("ny,nx,st", [(15, 15, 4), (9, 11, 3), (1, 1, 7)])
def test_patch_origins_exact(ny, nx, st):
    """The patch grid's corners equal the numpy grid the level built
    before (and the JAX module builds), bitwise."""
    py, px = tdis._patch_origins(ny, nx, st, "cpu")
    np.testing.assert_array_equal(
        py.numpy(), ((np.arange(ny) * st)[:, None]
                     * np.ones((1, nx))).astype(np.float32))
    np.testing.assert_array_equal(
        px.numpy(), (np.ones((ny, 1))
                     * (np.arange(nx) * st)[None, :]).astype(np.float32))


@pytest.mark.parametrize("step", ["level", "refine"])
def test_level_and_refinement_match_jax(jax_dis, step, record_property):
    """_dis_level and variational_refinement on fixed inputs (the 32 px
    level of the 128 px pair, a noisy flow around the truth); bar 1e-3 px."""
    I0, I1 = (_t(jax_dis[k][2]) for k in ("pyr0", "pyr1"))
    u0, v0 = (_t(x) for x in jax_dis["init"])
    fn = tdis._dis_level if step == "level" else tdis.variational_refinement
    got = fn(I0, I1, u0, v0, tdis.DISConfig())
    err = max(float(np.abs(g.numpy() - w).max())
              for g, w in zip(got, jax_dis[step]))
    record_property("max_abs_err", err)
    assert err <= FLOW_BAR


@pytest.mark.parametrize("name", ["fast", "medium"])
def test_dis_flow_planes_matches_jax(pair128, jax_dis, name, record_property):
    """The whole flow at 128 px: fast has one level (32 px), medium two
    (32 and 64 px, so the coarse-to-fine upsampling is covered)."""
    f0, f1 = (_t(x) for x in pair128)
    u, v = tdis.dis_flow_planes(f0, f1, tdis.DISConfig.preset(name))
    ju, jv = jax_dis[name]
    assert np.abs(ju[:, 32:-32, 32:-32].mean() - 3.0) < 0.2  # real motion
    err = max(float(np.abs(u.numpy() - ju).max()),
              float(np.abs(v.numpy() - jv).max()))
    record_property("max_abs_err", err)
    assert err <= FLOW_BAR


def test_kernels_auto_equals_plain_on_cpu(pair128):
    """On CPU tensors the K4/K5 wrappers compute exactly the plain twins."""
    f0, f1 = (_t(x) for x in pair128)
    a = tdis.dis_flow(f0, f1, tdis.DISConfig.preset("medium"))
    p = tdis.dis_flow(f0, f1, tdis.DISConfig.preset("medium", "plain"))
    assert torch.equal(a, p)


def _cv_shift_pair(size, shift, seed=7):
    rng = np.random.default_rng(seed)
    base = cv2.GaussianBlur(
        rng.random((size * 2, size * 2)).astype(np.float32) * 255, (0, 0), 4.0)
    M = np.float32([[1, 0, shift[0]], [0, 1, shift[1]]])
    moved = cv2.warpAffine(base, M, (size * 2, size * 2))
    c = slice(size // 2, size // 2 + size)
    return base[c, c].astype(np.uint8), moved[c, c].astype(np.uint8)


@pytest.mark.parametrize("shift", [(3.0, 0.0), (0.0, -2.5), (4.5, 3.0),
                                   (-8.0, 6.0)])
@pytest.mark.parametrize("name", ["fast", "medium"])
def test_dis_recovers_translation(shift, name):
    """Mean end-point error < 1 px in the interior at 128 px, as
    tests/test_dis.py:28-37 asks of the JAX module at 256 px. (ultrafast,
    without refinement, misses this bar at 128 px in both packages alike:
    1.188 px at (4.5, 3.0) and 3.341 px at (-8, 6), port = JAX.)"""
    f0, f1 = _cv_shift_pair(128, shift)
    u, v = tdis.dis_flow_planes(_t(f0[None]), _t(f1[None]),
                                tdis.DISConfig.preset(name))
    ui, vi = u[0, 32:-32, 32:-32].numpy(), v[0, 32:-32, 32:-32].numpy()
    assert np.hypot(ui - shift[0], vi - shift[1]).mean() < 1.0


# ------------------------------------------------------- the slice

@pytest.fixture(scope="module")
def clip40():
    frames = ref.make_synthetic_frames(40, h=64, w=64, period=12, seed=11)
    return [ref.rgb_to_gray(f) for f in frames]


@pytest.fixture(scope="module")
def jax_dis_window(clip40):
    """The JAX flow program with DIS on one 21-frame window (pair_batch 8
    plus the 2 x 6 halo): the window shape the JAX runner compiles below,
    with the runner's own PipelineConfig, so the compile is shared."""
    cfg = jpl.PipelineConfig(pair_batch=8, flow_algorithm="dis")
    win = np.stack(clip40[:21])
    res = jpl.flow_chunk_program(jnp.asarray(win), jnp.int32(20), cfg)
    return win, {k: np.asarray(v) for k, v in res.items()}


@pytest.mark.parametrize("kernels", ["auto", "plain"])
def test_flow_chunk_program_dis_matches_jax(jax_dis_window, kernels,
                                            record_property):
    """Slice-level parity with DIS; bars of tests/test_flow.py:134-136."""
    win, want = jax_dis_window
    got = flow_chunk_program(
        _t(win), 20, PipelineConfig(pair_batch=8, flow_algorithm="dis",
                                    kernels=kernels))
    got = {k: v.numpy() for k, v in got.items()}
    for k in ("centers", "dots", "mean_mag"):
        record_property(f"max_abs_err_{k}",
                        float(np.abs(got[k] - want[k]).max()))
    assert np.abs(want["dots"]).max() > 1e-3  # the clip moves
    np.testing.assert_array_equal(got["cuts"], want["cuts"])
    np.testing.assert_allclose(got["centers"], want["centers"], atol=1.0)
    np.testing.assert_allclose(got["dots"], want["dots"], atol=5e-3)
    np.testing.assert_allclose(got["mean_mag"], want["mean_mag"], atol=1e-3)


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


def _process(process_video, meta, frames, params, path, **kw):
    logs = []
    err = process_video(str(path), params, logs.append,
                        preopened=(meta, _ListSource(frames)), **kw)
    assert not err, logs
    with open(str(path).rsplit(".", 1)[0] + ".funscript") as f:
        return json.load(f), logs


def test_process_video_dis_matches_jax(clip40, jax_dis_window, tmp_path,
                                       record_property):
    """40 frames through both packages' process_video with the DIS
    backend (preset fast) on the same preopened frames: timestamps equal,
    positions within the ±2 of tests/test_runner.py."""
    jmeta = jdec.VideoMeta(total_frames=40, fps=30.0, width=64, height=64)
    tmeta = tdec.VideoMeta(total_frames=40, fps=30.0, width=64, height=64)
    want, _ = _process(jrun.process_video, jmeta, clip40,
                       JParams(overwrite=True, pair_batch=8, backend="DIS"),
                       tmp_path / "jax_clip.mp4")
    got, logs = _process(trun.process_video, tmeta, clip40,
                         Params(overwrite=True, pair_batch=8, backend="DNN"),
                         tmp_path / "torch_clip.mp4", device="cpu")
    assert any("Using backend: DIS (fast)" in m for m in logs)
    assert [a["at"] for a in got["actions"]] == \
        [a["at"] for a in want["actions"]]
    dpos = np.abs(np.array([a["pos"] for a in got["actions"]])
                  - np.array([a["pos"] for a in want["actions"]]))
    record_property("max_pos_delta", int(dpos.max()))
    assert dpos.max() <= 2, dpos


def test_cli_runs_dis_on_cpu(tmp_path):
    from funscript_flow_tpu_torch import cli as tcli

    frames = ref.make_synthetic_frames(8, h=64, w=64, period=6, seed=4)
    p = tmp_path / "c.mp4"
    vw = cv2.VideoWriter(str(p), cv2.VideoWriter_fourcc(*"mp4v"), 30, (64, 64))
    for f in frames:
        vw.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
    vw.release()
    log = tmp_path / "run.log"
    rc = tcli.main([str(p), "--device", "cpu", "--backend", "DIS",
                    "--dis_preset", "ultrafast", "--pair_batch", "16",
                    "--threads", "1", "--log", str(log)])
    assert rc == 0
    assert "Using backend: DIS (ultrafast)" in log.read_text()
    acts = json.loads((tmp_path / "c.funscript").read_text())["actions"]
    assert acts and all(0 <= a["pos"] <= 100 for a in acts)


# -------------------------------------------------------- wrapper checks

def test_wrappers_validate_inputs():
    img = torch.zeros((2, 16, 16))
    c = torch.zeros((2, 8, 8))
    with pytest.raises(TypeError):
        warp.sample_abs(img.double(), c, c)
    with pytest.raises(ValueError):
        warp.sample_abs(img, c[:, :, ::2], c[:, :, ::2])  # not contiguous
    with pytest.raises(ValueError):
        warp.sample_abs(img, c, c[:, :4])
    with pytest.raises(ValueError):
        warp.sample_abs(img[:1], c, c)                    # batch mismatch
    with pytest.raises(ValueError):
        warp.warp_planes([img, img, img], c, c)


def test_sample_patches_validates_inputs():
    img = torch.zeros((2, 16, 16))
    off = torch.zeros((2, 3, 3))
    with pytest.raises(TypeError):
        warp.sample_patches(img, off.double(), off, 8, 4)
    with pytest.raises(ValueError):
        warp.sample_patches(img, off, off[:, :2], 8, 4)    # shape mismatch
    with pytest.raises(ValueError):
        warp.sample_patches(img[:1], off, off, 8, 4)       # batch mismatch
    with pytest.raises(ValueError):
        warp.sample_patches(img, off[:, :, ::2], off[:, :, ::2], 8, 4)
    with pytest.raises(ValueError):
        warp.sample_patches(img, off, off, 17, 4)          # patch > source
    with pytest.raises(ValueError):
        warp.sample_patches(img, off, off, 8, 0)
    got = warp.sample_patches(img, off, off, 8, 4)
    assert got.shape == (2, 3, 3, 64) and not got.any()


# ---------------------------------------------- kernels on the card

@pytest.mark.cuda
@pytest.mark.parametrize("h,Ho", [(32, 56), (64, 120), (32, 72), (64, 152),
                                  (128, 328)])
def test_sample_abs_kernel_matches_twin(cuda_device, h, Ho):
    """The DIS level shapes of the three presets on 256 px frames."""
    from funscript_flow_tpu_torch.ops import cuda as kcuda

    g = torch.Generator(device=cuda_device).manual_seed(4)
    img = torch.rand((4, h, h), generator=g, device=cuda_device) * 255
    fy = torch.rand((4, Ho, Ho), generator=g, device=cuda_device) * (h - 1)
    fx = torch.rand((4, Ho, Ho), generator=g, device=cuda_device) * (h - 1)
    kcuda.reset_launches()
    got = warp.sample_abs(img, fy, fx)
    assert kcuda.launch_counts()["sample_abs"] == 1
    want = tdis.bilinear_abs(img, fy, fx)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,ps,st", [
    (32, 32, 8, 4), (64, 64, 8, 4), (32, 32, 8, 3), (64, 64, 8, 3),
    (128, 128, 8, 3), (40, 48, 8, 4), (40, 48, 8, 3), (200, 232, 8, 4),
    (40, 48, 5, 2)])
def test_sample_patches_kernel_matches_twin(cuda_device, h, w, ps, st):
    """The patch grids of the three presets on 256 px frames, an odd source,
    one too large to stage and another patch size; offsets of a few px, one
    in 16 far out of range (both corner clamps)."""
    from funscript_flow_tpu_torch.ops import cuda as kcuda

    g = torch.Generator(device=cuda_device).manual_seed(6)
    ny, nx = (h - ps) // st + 1, (w - ps) // st + 1
    img = torch.rand((4, h, w), generator=g, device=cuda_device) * 255
    near = torch.randn((2, 4, ny, nx), generator=g, device=cuda_device) * 2
    far = (torch.rand((2, 4, ny, nx), generator=g, device=cuda_device) * 4
           - 2) * max(h, w)
    pick = torch.rand((2, 4, ny, nx), generator=g, device=cuda_device) < 1 / 16
    pu, pv = (x.contiguous() for x in torch.where(pick, far, near))
    kcuda.reset_launches()
    got = warp.sample_patches(img, pu, pv, ps, st)
    assert kcuda.launch_counts()["sample_patches"] == 1
    want = tdis._sample_patches_plain(img, pu, pv, ps, st)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("size", [32, 64, 128])
def test_warp_planes_kernel_matches_twin(cuda_device, size):
    from funscript_flow_tpu_torch.ops import cuda as kcuda

    g = torch.Generator(device=cuda_device).manual_seed(5)
    planes = [torch.randn((3, size, size), generator=g, device=cuda_device)
              for _ in range(3)]
    ys = torch.arange(size, device=cuda_device, dtype=torch.float32)[:, None]
    xs = torch.arange(size, device=cuda_device, dtype=torch.float32)[None]
    u = torch.randn((3, size, size), generator=g, device=cuda_device) * 4
    v = torch.randn((3, size, size), generator=g, device=cuda_device) * 4
    u = (torch.clamp(xs + u, 0, size - 1) - xs).contiguous()
    v = (torch.clamp(ys + v, 0, size - 1) - ys).contiguous()
    kcuda.reset_launches()
    got = warp.warp_planes(planes, u, v)
    assert kcuda.launch_counts()["warp_planes"] == 1
    assert kcuda.launch_counts()["warp_bilinear"] == 0
    want = tfb.warp_bilinear(torch.stack(planes, 1), u, v)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= 1e-5
