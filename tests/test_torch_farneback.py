"""Port Farnebäck (the plain twins of kernels K1-K3 and the full flow) vs the
JAX package: its XLA functions and its Pallas kernels in interpret mode, on
the same numpy inputs. Tolerances are the JAX package's own
(tests/test_pallas.py, tests/test_warp_pallas.py); the measured maxima on
this CPU are far below them (see CHANGES.md).

The kernel-vs-twin cases need a CUDA device: they carry the ``cuda`` marker
and skip without one. They hold each kernel bitwise equal to its twin, at
the odd shapes, winsizes and tap counts too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from funscript_flow_tpu.ops import farneback as jfb
from funscript_flow_tpu.ops.pallas.flow_step import box_blur_solve_pallas
from funscript_flow_tpu.ops.pallas.polyexp import poly_exp_pallas
from funscript_flow_tpu.ops.pallas.warp import (pack_warp_operand,
                                                warp_bilinear_pallas)
from funscript_flow_tpu_torch.ops import farneback as tfb
from funscript_flow_tpu_torch.ops.cuda import flow_step, polyexp, pyramid, warp

# the tests run in several worker processes at once: one torch thread
# each keeps them from oversubscribing the cores
torch.set_num_threads(1)


# Odd shapes (B, H, W): not multiples of any kernel's tile, a single pixel,
# a width under the blur's halo. The JAX references at these shapes run
# under jax.jit: one compile per case instead of one per eager op (XLA
# contracts products into FMAs there, so they differ from the twins by
# rounding, within the tolerances below).
ODD_SOLVE = {f"{h}x{w}-w{win}": ((b, h, w), win) for (b, h, w), win in [
    ((3, 45, 77), 1), ((3, 45, 77), 3), ((3, 45, 77), 15), ((3, 45, 77), 31),
    ((3, 1, 1), 31), ((3, 40, 5), 15)]}
# (shape, planes, amplitude of a uniform displacement field in px)
ODD_WARP = {f"{h}x{w}-p{P}-{amp:g}": ((b, h, w), P, amp)
            for (b, h, w), P, amp in [((3, 45, 77), 5, 60.0),
                                      ((3, 45, 77), 3, 60.0),
                                      ((3, 45, 77), 3, 1.0),
                                      ((3, 40, 5), 5, 60.0)]}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel vs plain twin)")
    return torch.device("cuda", 0)


# ---------------------------------------------------------------- tables

@pytest.mark.parametrize("n,sigma", [(5, 1.2), (7, 1.5)])
def test_poly_exp_tables_equal(n, sigma):
    a, b = tfb._poly_exp_tables(n, sigma), jfb._poly_exp_tables(n, sigma)
    for x, y in zip(a[:3], b[:3]):
        np.testing.assert_array_equal(x, y)
    assert a[3] == b[3]


@pytest.mark.parametrize("h,w", [(256, 256), (32, 32), (7, 12)])
def test_border_scale_map_equal(h, w):
    np.testing.assert_array_equal(tfb._border_scale_map(h, w),
                                  jfb._border_scale_map(h, w))


@pytest.mark.parametrize("h,w", [(256, 256), (64, 64), (48, 48), (100, 150),
                                 (31, 300)])
def test_pyramid_plan_equal(h, w):
    assert tfb.FarnebackConfig().pyramid_plan(h, w) == \
        jfb.FarnebackConfig().pyramid_plan(h, w)


# ------------------------------------------------------- K1 poly_exp twin

# (shape, poly_n, poly_sigma): the two real settings at a pyramid level's
# width, then every tap count the kernel takes at a small odd shape
POLY_CASES = [((2, 64, 128), 5, 1.2), ((1, 64, 128), 7, 1.5)] + [
    ((1, 21, 37), n, 0.3 * n + 0.3) for n in range(1, 9)]


@pytest.fixture(scope="module")
def polyexp_cases():
    rng = np.random.default_rng(0)
    cases = []
    for shape, n, sigma in POLY_CASES:
        img = (rng.random(shape) * 255).astype(np.float32)
        pallas = poly_exp_pallas(jnp.asarray(img), n, sigma)  # interpret
        xla = jfb.poly_exp(jnp.asarray(img), n, sigma)
        cases.append((img, n, sigma, [np.asarray(p) for p in pallas],
                      [np.asarray(p) for p in xla]))
    return cases


@pytest.mark.parametrize("case", range(len(POLY_CASES)))
@pytest.mark.parametrize("oracle", ["pallas", "xla"])
def test_poly_exp_twin_matches_jax(polyexp_cases, case, oracle,
                                   record_property):
    """K1's CPU route is the twin, bitwise; both JAX oracles within 1e-4
    (tests/test_pallas.py's bar)."""
    img, n, sigma, pallas, xla = polyexp_cases[case]
    want = pallas if oracle == "pallas" else xla
    got = polyexp.poly_exp(torch.from_numpy(img), n, sigma)  # CPU: the twin
    assert got.shape == (img.shape[0], 5) + img.shape[1:]
    assert torch.equal(got, torch.stack(tfb.poly_exp(
        torch.from_numpy(img), n, sigma), 1))
    record_property("max_abs_err", max(
        float(np.abs(got[:, p].numpy() - want[p]).max()) for p in range(5)))
    for p in range(5):
        np.testing.assert_allclose(got[:, p].numpy(), want[p], atol=1e-4)


# -------------------------------------------------- K2 warp_bilinear twin

@pytest.fixture(scope="module")
def warp_cases():
    rng = np.random.default_rng(1)
    B, H, W = 2, 16, 256
    cases = {}
    for scale in (0.5, 5.0, 60.0):
        planes = [rng.normal(size=(B, H, W)).astype(np.float32)
                  for _ in range(5)]
        u = (rng.normal(size=(B, H, W)) * scale).astype(np.float32)
        v = (rng.normal(size=(B, H, W)) * scale).astype(np.float32)
        jp = tuple(jnp.asarray(p) for p in planes)
        ref, inb = jfb._warp_bilinear(jp, jnp.asarray(u), jnp.asarray(v),
                                      warp_dtype=jnp.float32)
        r, rx = pack_warp_operand(jp)
        pal = warp_bilinear_pallas(r, rx, jnp.asarray(u), jnp.asarray(v),
                                   interpret=True)
        cases[scale] = (planes, u, v, np.asarray(inb),
                        [np.asarray(x) for x in ref], np.asarray(pal))
    # odd shapes, P=5 and P=3 (the K5 planes): the f32 XLA warp only, the
    # Pallas kernel needs W % 128 == 0
    warp_f32 = jax.jit(lambda p, u, v: jfb._warp_bilinear(
        p, u, v, warp_dtype=jnp.float32))
    for key, (shape, P, amp) in ODD_WARP.items():
        planes = [rng.normal(size=shape).astype(np.float32) for _ in range(P)]
        u = rng.uniform(-amp, amp, shape).astype(np.float32)
        v = rng.uniform(-amp, amp, shape).astype(np.float32)
        ref, inb = warp_f32(tuple(jnp.asarray(p) for p in planes),
                            jnp.asarray(u), jnp.asarray(v))
        cases[key] = (planes, u, v, np.asarray(inb),
                      [np.asarray(x) for x in ref], None)
    return cases


@pytest.mark.parametrize("oracle,scale", [
    pytest.param(o, s, id=f"{o}-{s}")
    for s in (0.5, 5.0, 60.0) for o in ("pallas", "xla")] + [
    pytest.param("xla", key, id=f"xla-{key}") for key in ODD_WARP])
def test_warp_twin_matches_jax(warp_cases, scale, oracle, record_property):
    planes, u, v, inb, xla, pal = warp_cases[scale]
    P = len(planes)
    R = torch.from_numpy(np.stack(planes, axis=1))
    got = warp.warp_bilinear(R, torch.from_numpy(u), torch.from_numpy(v))
    assert got.shape == R.shape and inb.any()
    wants = [pal[:, p] if oracle == "pallas" else xla[p] for p in range(P)]
    record_property("max_abs_err", max(
        float(np.abs(got[:, p].numpy()[inb] - wants[p][inb]).max())
        for p in range(P)))
    for p in range(P):
        want = wants[p]
        np.testing.assert_allclose(got[:, p].numpy()[inb], want[inb],
                                   atol=1e-5)


@pytest.mark.parametrize("scale", [0.5, 5.0, 60.0])
def test_warp_inbounds_mask_equal(warp_cases, scale):
    _, u, v, inb, _, _ = warp_cases[scale]
    got = tfb.warp_inbounds(torch.from_numpy(u), torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(got, inb)


def test_matrices_from_warped_matches_jax(rng):
    B, H, W = 2, 24, 40
    R0 = [rng.normal(size=(B, H, W)).astype(np.float32) for _ in range(5)]
    wp = [rng.normal(size=(B, H, W)).astype(np.float32) for _ in range(5)]
    u = (rng.normal(size=(B, H, W)) * 8).astype(np.float32)
    v = (rng.normal(size=(B, H, W)) * 8).astype(np.float32)
    inb = np.array(jfb.warp_inbounds(jnp.asarray(u), jnp.asarray(v)))
    want = jfb.matrices_from_warped([jnp.asarray(x) for x in R0],
                                    [jnp.asarray(x) for x in wp],
                                    jnp.asarray(inb), jnp.asarray(u),
                                    jnp.asarray(v))
    got = tfb.matrices_from_warped([torch.from_numpy(x) for x in R0],
                                   [torch.from_numpy(x) for x in wp],
                                   torch.from_numpy(inb), torch.from_numpy(u),
                                   torch.from_numpy(v))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-4)


# ------------------------------------------------- K3 box_blur_solve twin

@pytest.fixture(scope="module")
def solve_cases():
    rng = np.random.default_rng(2)
    cases = {}
    for win in (15, 7):
        M = [rng.normal(0, 2, (2, 64, 128)).astype(np.float32)
             for _ in range(5)]
        jM = tuple(jnp.asarray(m) for m in M)
        pal = box_blur_solve_pallas(jM, win)  # interpret
        xla = jfb.solve_flow(jM, win)
        cases[win] = (M, win, [np.asarray(x) for x in pal],
                      [np.asarray(x) for x in xla])
    # odd shapes and every winsize class: the XLA function only, the Pallas
    # kernel needs a vertical halo of at most 8 rows and TPU-sized planes
    solve = jax.jit(jfb.solve_flow, static_argnums=1)
    for key, (shape, win) in ODD_SOLVE.items():
        M = [rng.normal(0, 2, shape).astype(np.float32) for _ in range(5)]
        xla = solve(tuple(jnp.asarray(m) for m in M), win)
        cases[key] = (M, win, None, [np.asarray(x) for x in xla])
    return cases


@pytest.mark.parametrize("oracle,case", [
    pytest.param(o, w, id=f"{o}-{w}") for w in (15, 7)
    for o in ("pallas", "xla")] + [
    pytest.param("xla", key, id=f"xla-{key}") for key in ODD_SOLVE])
def test_blur_solve_twin_matches_jax(solve_cases, case, oracle,
                                     record_property):
    M, win, pal, xla = solve_cases[case]
    want = pal if oracle == "pallas" else xla
    gu, gv = flow_step.box_blur_solve([torch.from_numpy(m) for m in M], win)
    record_property("max_abs_err", max(
        float(np.abs(gu.numpy() - want[0]).max()),
        float(np.abs(gv.numpy() - want[1]).max())))
    # random (unphysical) M makes the 2x2 system near-singular at some
    # pixels, amplifying blur rounding differences (tests/test_pallas.py)
    np.testing.assert_allclose(gu.numpy(), want[0], rtol=2e-2, atol=1e-3)
    np.testing.assert_allclose(gv.numpy(), want[1], rtol=2e-2, atol=1e-3)


# ------------------------------------------------------------ full flow

def _shift_pair(size, dy, dx, seed=3):
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(size + 44, size + 44)).astype(np.float32)
    # smooth texture without cv2: separable Gaussian (sigma 4) via FFT-free taps
    k = np.exp(-np.arange(-12, 13) ** 2 / 32.0)
    k /= k.sum()
    base = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 0, base)
    base = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 1, base)
    base = (base / base.std() * 40 + 128).astype(np.float32)
    f0 = base[10:10 + size, 10:10 + size][None]
    f1 = base[10 + dy:10 + dy + size, 10 + dx:10 + dx + size][None]
    return np.ascontiguousarray(f0), np.ascontiguousarray(f1)


@pytest.fixture(scope="module")
def flow_case():
    f0, f1 = _shift_pair(128, 3, -2)
    ref = np.asarray(jfb.farneback_flow(
        jnp.asarray(f0), jnp.asarray(f1),
        jfb.FarnebackConfig(warp_dtype="float32", warp_backend="xla")))
    return f0, f1, ref


@pytest.mark.parametrize("kernels", ["auto", "plain"])
def test_full_flow_matches_jax_f32(flow_case, kernels, record_property):
    """Whole pyramid, 3 levels at 128 px: the JAX f32-warp XLA flow is the
    oracle; the bar of tests/test_warp_pallas.py:89."""
    f0, f1, ref = flow_case
    got = tfb.farneback_flow(torch.from_numpy(f0), torch.from_numpy(f1),
                             tfb.FarnebackConfig(kernels=kernels)).numpy()
    assert np.abs(ref).max() > 1.0  # a real displacement was recovered
    record_property("max_abs_err", float(np.abs(got - ref).max()))
    np.testing.assert_allclose(got, ref, atol=1e-4)


def test_kernels_auto_equals_plain_on_cpu(flow_case):
    """On CPU tensors the wrappers compute exactly the plain twins."""
    f0, f1, _ = flow_case
    a = tfb.farneback_flow(torch.from_numpy(f0), torch.from_numpy(f1),
                           tfb.FarnebackConfig(kernels="auto"))
    p = tfb.farneback_flow(torch.from_numpy(f0), torch.from_numpy(f1),
                           tfb.FarnebackConfig(kernels="plain"))
    assert torch.equal(a, p)


# -------------------------------------------------------- wrapper checks

def test_wrappers_validate_inputs():
    x = torch.zeros((2, 16, 16))
    with pytest.raises(TypeError):
        polyexp.poly_exp(x.double())
    with pytest.raises(ValueError):
        polyexp.poly_exp(x[:, :, ::2])        # not contiguous
    with pytest.raises(ValueError):
        polyexp.poly_exp(x, poly_n=9)
    with pytest.raises(ValueError):
        warp.warp_bilinear(torch.zeros((2, 5, 16, 16)), x[:, :8], x[:, :8])
    with pytest.raises(ValueError):
        flow_step.box_blur_solve([x] * 5, 14)
    with pytest.raises(ValueError):
        flow_step.box_blur_solve([x] * 4, 15)
    with pytest.raises(ValueError):
        tfb.FarnebackConfig(kernels="fast")


def test_cpu_route_does_not_count_launches():
    from funscript_flow_tpu_torch.ops import cuda as kcuda

    kcuda.reset_launches()
    x = torch.rand((1, 32, 32)) * 255
    R = polyexp.poly_exp(x)
    warp.warp_bilinear(R, x * 0, x * 0)
    flow_step.box_blur_solve(R.unbind(1), 15)
    warp.sample_abs(x, x * 0, x * 0)
    warp.sample_patches(x, x[:, :7, :7] * 0, x[:, :7, :7] * 0, 8, 4)
    warp.warp_planes([x] * 3, x * 0, x * 0)
    pyramid.pyramid_level(x, 3, 0.0, 16, 16)
    assert kcuda.launch_counts() == {"poly_exp": 0, "warp_bilinear": 0,
                                     "box_blur_solve": 0, "sample_abs": 0,
                                     "sample_patches": 0, "warp_planes": 0,
                                     "pyramid_level": 0}


def test_launch_path_rejects_cpu_and_mixed_devices():
    """The launch path raises before it loads anything for a CPU tensor,
    and its checks raise for a wrong dtype or shape or for tensors on two
    devices."""
    from funscript_flow_tpu_torch.ops.cuda import _build

    x = torch.zeros((1, 8, 8))
    with pytest.raises(ValueError, match="expected CUDA tensors"):
        _build.launch("poly_exp", "ff_poly_exp", x)
    _build.same_device(x, x, x)
    with pytest.raises(ValueError, match="one device"):
        _build.same_device(x, x.to("meta"))
    names = ("a", "b", "c")
    _build.check_planes((x, x, x), names, x.shape)
    with pytest.raises(TypeError, match="c: expected float32"):
        _build.check_planes((x, x, x.double()), names, x.shape)
    with pytest.raises(ValueError, match="b: expected shape"):
        _build.check_planes((x, x[:, :4], x), names, x.shape)
    with pytest.raises(ValueError, match="one device"):
        _build.check_planes((x, x, x.to("meta")), names, x.shape)


@pytest.mark.parametrize("n,sigma", [(n, 0.3 * n + 0.3) for n in range(1, 9)])
def test_poly_exp_kernel_tables(n, sigma):
    """The host arguments K1 is launched with: the float32 taps g, xg, xxg
    in order and the four inverse-Gramian entries rounded to float32, as the
    twin multiplies by them."""
    taps, igs, _, _ = polyexp._tables(n, sigma)
    g, xg, xxg, ig = tfb._poly_exp_tables(n, sigma)
    assert taps.dtype == np.float32 and taps.shape == (3 * (2 * n + 1),)
    np.testing.assert_array_equal(taps, np.concatenate([g, xg, xxg]))
    np.testing.assert_array_equal(igs, np.float32(ig))


# ---------------------------------------------- kernels on the card

@pytest.mark.cuda
@pytest.mark.parametrize("n,sigma", [(5, 1.2), (7, 1.5)])
@pytest.mark.parametrize("size", [256, 128, 64, 32])
def test_poly_exp_kernel_matches_twin(cuda_device, size, n, sigma):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    img = torch.rand((6, size, size), generator=g, device=cuda_device) * 255
    got = polyexp.poly_exp(img, n, sigma)
    want = torch.stack(tfb.poly_exp(img, n, sigma), 1)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("n", range(1, 9))
@pytest.mark.parametrize("shape", [(3, 45, 77), (3, 1, 1), (3, 40, 5),
                                   (2, 100, 140)])
def test_poly_exp_kernel_edge_shapes(cuda_device, shape, n):
    g = torch.Generator(device=cuda_device).manual_seed(3)
    img = torch.rand(shape, generator=g, device=cuda_device) * 255
    got = polyexp.poly_exp(img, n, 0.3 * n + 0.3)
    want = torch.stack(tfb.poly_exp(img, n, 0.3 * n + 0.3), 1)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


# K2 (P=5) and K5 (P=3) equal their twin bitwise, in both the staged and
# the direct-gather branch (at 64x96 and 100x140 the sigma-60 px fields
# overflow the staging buffer on most tiles)
@pytest.mark.cuda
@pytest.mark.parametrize("shape,P,scale", [
    pytest.param((3, 64, 96), 5, s, id=f"{s}") for s in (0.5, 5.0, 60.0)] + [
    pytest.param(shape, P, amp, id=f"{shape[1]}x{shape[2]}-p{P}-{amp:g}")
    for shape in ((3, 45, 77), (3, 1, 1), (3, 40, 5), (2, 100, 140))
    for P in (5, 3) for amp in (1.0, 60.0)])
def test_warp_kernel_matches_twin(cuda_device, shape, P, scale):
    g = torch.Generator(device=cuda_device).manual_seed(1)
    B, H, W = shape
    R = torch.randn((B, P, H, W), generator=g, device=cuda_device)
    u = torch.randn(shape, generator=g, device=cuda_device) * scale
    v = torch.randn(shape, generator=g, device=cuda_device) * scale
    got = (warp.warp_bilinear(R, u, v) if P == 5
           else warp.warp_planes([p.contiguous() for p in R.unbind(1)], u, v))
    want = tfb.warp_bilinear(R, u, v)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,win", [
    pytest.param((2, 64, 128), w, id=f"{w}") for w in (15, 7)] + [
    pytest.param(shape, w, id=f"{shape[1]}x{shape[2]}-w{w}")
    for shape in ((3, 45, 77), (3, 1, 1), (3, 40, 5), (2, 100, 140))
    for w in (1, 3, 15, 31)])
def test_blur_solve_kernel_matches_twin(cuda_device, shape, win):
    g = torch.Generator(device=cuda_device).manual_seed(2)
    M = [torch.randn(shape, generator=g, device=cuda_device) * 2
         for _ in range(5)]
    gu, gv = flow_step.box_blur_solve(M, win)
    wu, wv = tfb.solve_flow(M, win)
    torch.cuda.synchronize()
    assert torch.equal(gu, wu) and torch.equal(gv, wv)
