"""Port per-pair reductions vs the JAX package's, on the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from funscript_flow_tpu.ops import reductions as jred
from funscript_flow_tpu_torch.ops import reductions as tred

# the tests run in several worker processes at once: one torch thread
# each keeps them from oversubscribing the cores
torch.set_num_threads(1)


def _flow(rng, shape, scale=2.0):
    f = rng.normal(0, scale, shape + (2,)).astype(np.float32)
    return f[..., 0].copy(), f[..., 1].copy()


def test_divergence_matches_jax(rng):
    u, v = _flow(rng, (3, 32, 40))
    want = np.asarray(jred.divergence(jnp.asarray(u), jnp.asarray(v)))
    got = tred.divergence(torch.from_numpy(u), torch.from_numpy(v)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    # the reference's axis pairing: u along rows, v along columns
    np.testing.assert_allclose(
        got, np.gradient(u, axis=1) + np.gradient(v, axis=2), atol=1e-5)


def test_max_divergence_center_matches_jax(rng):
    u, v = _flow(rng, (4, 32, 40))
    jc, jv = jred.max_divergence_center(jnp.asarray(u), jnp.asarray(v))
    tc, tv = tred.max_divergence_center(torch.from_numpy(u),
                                        torch.from_numpy(v))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6)


def test_argmax_takes_first_occurrence():
    """Ties resolve to the first pixel in row-major order, like np.argmax."""
    u = np.zeros((1, 8, 8), np.float32)
    v = np.zeros((1, 8, 8), np.float32)
    u[0, 3, 2] = 1.0   # equal |divergence| peaks at several pixels
    u[0, 5, 6] = 1.0
    jc, _ = jred.max_divergence_center(jnp.asarray(u), jnp.asarray(v))
    tc, _ = tred.max_divergence_center(torch.from_numpy(u), torch.from_numpy(v))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    div = np.abs(np.gradient(u[0], axis=0))
    y, x = np.unravel_index(np.argmax(div), div.shape)
    assert tuple(tc.numpy()[0]) == (x, y)


def test_mean_flow_magnitude_matches_jax(rng):
    u, v = _flow(rng, (3, 64, 64), 3.0)
    want = np.asarray(jred.mean_flow_magnitude(jnp.asarray(u), jnp.asarray(v)))
    got = tred.mean_flow_magnitude(torch.from_numpy(u),
                                   torch.from_numpy(v)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("n_valid", [20, 13, 7, 1])
def test_smooth_centers_matches_jax(rng, n_valid):
    c = rng.normal(128, 30, (20, 2)).astype(np.float32)
    want = np.asarray(jred.smooth_centers(jnp.asarray(c), jnp.int32(n_valid)))
    got = tred.smooth_centers(torch.from_numpy(c), n_valid).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("pov", [False, True])
def test_radial_motion_weighted_matches_jax(rng, pov):
    u, v = _flow(rng, (5, 48, 56))
    # centers on pixel centres exercise the strict '>' tests
    centers = np.array([[28.0, 24.0], [10.5, 40.2], [0.0, 0.0],
                        [55.0, 47.0], [12.0, 7.0]], np.float32)
    cuts = np.array([False, False, True, False, False])
    want = np.asarray(jred.radial_motion_weighted(
        jnp.asarray(u), jnp.asarray(v), jnp.asarray(centers),
        jnp.asarray(cuts), pov))
    got = tred.radial_motion_weighted(
        torch.from_numpy(u), torch.from_numpy(v), torch.from_numpy(centers),
        torch.from_numpy(cuts), pov).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
    assert got[2] == 0.0  # cut pairs contribute no motion
