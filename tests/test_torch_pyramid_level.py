"""K6 (``ops/cuda/pyramid.pyramid_level``): one Farnebäck pyramid level, the
Gaussian blur and the bilinear resize fused.

On a CPU tensor the wrapper computes its plain twin, the composition it
replaces (``resize_bilinear(gaussian_blur(...))``); ``kernels="auto"``
routes both frames of every level through it; the wrapper refuses what the
kernel does not take; and the tile geometry it hands the kernel covers
every tile's columns within the kernel's shared memory.
The kernel-vs-twin case needs a CUDA device: it carries the ``cuda``
marker and skips without one. This file imports no JAX, so it also runs
on the card.
"""

import numpy as np
import pytest
import torch

from funscript_flow_tpu_torch.ops import farneback as tfb
from funscript_flow_tpu_torch.ops import image
from funscript_flow_tpu_torch.ops.cuda import pyramid

# the tests run in several worker processes at once: one torch thread
# each keeps them from oversubscribing the cores
torch.set_num_threads(1)

# (H, W): the reference's frame, and two odd, non-square ones (100x75 and
# 47x33, width x height)
SIZES = ((256, 256), (75, 100), (33, 47))
LEVELS = [((H, W), lv) for H, W in SIZES
          for lv in tfb.FarnebackConfig().pyramid_plan(H, W)]


def _frames(n, H, W, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.random((n, H, W)) * 255).astype(np.float32))


def _twin(x, ksize, sigma, lh, lw):
    return image.resize_bilinear(image.gaussian_blur(x, ksize, sigma), lh, lw)


@pytest.mark.parametrize("n", [1, 3])
@pytest.mark.parametrize("size,level", LEVELS,
                         ids=[f"{H}x{W}-{lv[1]}x{lv[2]}-k{lv[4]}"
                              for (H, W), lv in LEVELS])
def test_cpu_wrapper_equals_twin(size, level, n):
    _, lh, lw, sigma, ksize = level
    x = _frames(n, *size)
    got = pyramid.pyramid_level(x, ksize, sigma, lh, lw)
    assert got.shape == (n, lh, lw)
    assert torch.equal(got, _twin(x, ksize, sigma, lh, lw))


def test_wrapper_rejects_what_the_kernel_does_not_take():
    x = torch.zeros((2, 16, 16))
    with pytest.raises(TypeError):
        pyramid.pyramid_level(x.double(), 3, 0.0, 8, 8)
    with pytest.raises(ValueError):
        pyramid.pyramid_level(x[0], 3, 0.0, 8, 8)            # rank 2
    with pytest.raises(ValueError):
        pyramid.pyramid_level(x[:, :, ::2], 3, 0.0, 8, 8)    # not contiguous
    with pytest.raises(ValueError):
        pyramid.pyramid_level(x, pyramid.MAX_KSIZE + 2, 20.0, 8, 8)
    with pytest.raises(ValueError):
        pyramid.pyramid_level(x, 4, 1.0, 8, 8)               # even taps
    with pytest.raises(ValueError):
        pyramid.pyramid_level(x, 3, 0.0, 0, 8)


def test_cap_covers_every_plan_up_to_five_levels():
    """Every plan of up to 5 levels at pyr_scale >= 0.5 fits the cap."""
    worst = max(k for scale in (0.5, 0.6, 0.75, 0.9)
                for levels in range(1, 6)
                for *_, k in tfb.FarnebackConfig(
                    pyr_scale=scale, levels=levels).pyramid_plan(2048, 2048))
    assert worst == pyramid.MAX_KSIZE


def test_auto_routes_every_level_through_the_wrapper(monkeypatch):
    """kernels="auto" builds both frames of every level with K6's wrapper
    (2 x levels calls, each with its level's plan) and stays bitwise equal
    to "plain" on the CPU."""
    H, W = 128, 160
    f0, f1 = _frames(2, H, W, 1), _frames(2, H, W, 2)
    calls = []
    real = pyramid.pyramid_level

    def spy(x, ksize, sigma, lh, lw):
        calls.append((ksize, sigma, lh, lw))
        return real(x, ksize, sigma, lh, lw)

    monkeypatch.setattr(pyramid, "pyramid_level", spy)
    auto = tfb.farneback_flow_planes(f0, f1, tfb.FarnebackConfig())
    plan = tfb.FarnebackConfig().pyramid_plan(H, W)
    assert len(plan) == 3
    assert calls == [(k, sigma, lh, lw) for _, lh, lw, sigma, k in plan
                     for _ in range(2)]
    monkeypatch.setattr(pyramid, "pyramid_level", real)
    plain = tfb.farneback_flow_planes(f0, f1,
                                      tfb.FarnebackConfig(kernels="plain"))
    assert all(torch.equal(a, p) for a, p in zip(auto, plain))
    assert len(calls) == 2 * len(plan)  # plain does not call the wrapper


@pytest.mark.parametrize("H,W,lh,lw,ksize", [
    *[(H, W, lh, lw, k) for (H, W), (_, lh, lw, _, k) in LEVELS],
    (1024, 1024, 32, 32, 79), (1080, 1920, 34, 60, 79),
    (720, 1280, 720, 1280, 3), (5, 3, 9, 11, 3), (40, 5, 21, 2, 9)])
def test_tiles_cover_every_tile(H, W, lh, lw, ksize):
    """The kernel's per-tile arithmetic, mirrored: each tile's column span
    (its first column floored to 32, through the last column its taps
    read) fits the stride ``sw``, and the vertical sums fit 48 KB of
    shared memory."""
    th, tw, sw = pyramid.tiles(H, W, lh, lw, ksize)
    assert 2 * th * sw * 4 <= 48 * 1024
    assert 1 <= th <= min(8, lh) and 1 <= tw <= lw
    r = ksize // 2
    cx0, cx1, _ = (t.numpy() for t in image._resize_tables(W, lw))
    ry0, ry1, _ = (t.numpy() for t in image._resize_tables(H, lh))
    assert set(ry1 - ry0) <= {0, 1} and set(cx1 - cx0) <= {0, 1}
    for ox0 in range(0, lw, tw):
        ncol = min(tw, lw - ox0)
        c_lo = (int(cx0[ox0]) - r) & ~31
        assert int(cx1[ox0 + ncol - 1]) + r - c_lo + 1 <= sw
    assert -(-lh // th) <= 65535


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel vs plain twin)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("size,level", LEVELS,
                         ids=[f"{H}x{W}-{lv[1]}x{lv[2]}-k{lv[4]}"
                              for (H, W), lv in LEVELS])
def test_kernel_equals_twin(cuda_device, size, level):
    _, lh, lw, sigma, ksize = level
    x = _frames(3, *size).to(cuda_device)
    got = pyramid.pyramid_level(x, ksize, sigma, lh, lw)
    torch.cuda.synchronize()
    assert torch.equal(got, _twin(x, ksize, sigma, lh, lw))
