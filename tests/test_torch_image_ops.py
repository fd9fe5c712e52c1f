"""Port image primitives vs the JAX package's, on the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from funscript_flow_tpu.ops import image as jim
from funscript_flow_tpu_torch.ops import image as tim

# the tests run in several worker processes at once: one torch thread
# each keeps them from oversubscribing the cores
torch.set_num_threads(1)


def _both(x):
    return jnp.asarray(x), torch.from_numpy(x)


@pytest.mark.parametrize("ksize,sigma", [(3, 0.0), (5, 0.0), (7, 0.0),
                                         (9, 1.5), (19, 3.5), (3, 0.5),
                                         (11, 0.0)])
def test_gaussian_kernel_table(ksize, sigma):
    np.testing.assert_array_equal(tim.gaussian_kernel_cv(ksize, sigma),
                                  jim.gaussian_kernel_cv(ksize, sigma))


@pytest.mark.parametrize("x", [0.5, 1.5, 2.5, -0.5, 17.5, 3.49])
def test_cv_round(x):
    assert tim.cv_round(x) == jim.cv_round(x)


@pytest.mark.parametrize("border", ["replicate", "reflect101"])
def test_sepconv_matches_jax(rng, border):
    x = (rng.random((2, 24, 40)) * 255).astype(np.float32)
    ty = rng.normal(size=7).astype(np.float32)
    tx = rng.normal(size=5).astype(np.float32)
    jx, tx_ = _both(x)
    want = np.asarray(jim.sepconv(jx, ty, tx, border))
    got = tim.sepconv(tx_, ty, tx, border).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("ksize,sigma", [(3, 0.0), (9, 1.5), (19, 3.5)])
def test_gaussian_blur_matches_jax(rng, ksize, sigma):
    x = (rng.random((2, 64, 48)) * 255).astype(np.float32)
    jx, tx = _both(x)
    want = np.asarray(jim.gaussian_blur(jx, ksize, sigma))
    got = tim.gaussian_blur(tx, ksize, sigma).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("win", [15, 7])
def test_box_blur_matches_jax(rng, win):
    x = rng.normal(0, 3, (2, 32, 40)).astype(np.float32)
    jx, tx = _both(x)
    np.testing.assert_allclose(tim.box_blur(tx, win).numpy(),
                               np.asarray(jim.box_blur(jx, win)), atol=1e-5)


@pytest.mark.parametrize("shape,out", [((64, 64), (32, 32)),
                                       ((256, 256), (64, 64)),
                                       ((32, 48), (64, 96)),
                                       ((50, 70), (25, 35)),
                                       ((64, 64), (64, 64))])
def test_resize_bilinear_matches_jax(rng, shape, out):
    x = (rng.random((2,) + shape) * 255).astype(np.float32)
    jx, tx = _both(x)
    want = np.asarray(jim.resize_bilinear(jx, *out))
    got = tim.resize_bilinear(tx, *out).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4)
