"""Port device signal chain (ops/signal.py) vs the JAX package's
(funscript_flow_tpu/ops/signal.py) and the float64 host chain, at the
shapes of tests/test_signal_jax.py, and the runner's routing between the
two chains.

Both packages get the same numpy inputs, padded to the same length with a
valid length ``n``. The port repeats JAX's float32 arithmetic (the same
odd-even scan tree, the same window grid), so its bars against JAX are far
tighter than JAX's own bars against the host chain, which are kept for the
host comparisons. Measured maxima are recorded with ``record_property``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from funscript_flow_tpu import runner as jrun
from funscript_flow_tpu.ops import signal as sj
from funscript_flow_tpu.ops import signal_host as sh
from funscript_flow_tpu.utils.params import Params as JParams
from funscript_flow_tpu_torch import runner as trun
from funscript_flow_tpu_torch.ops import signal as st
from funscript_flow_tpu_torch.utils.params import Params

# the tests run in several worker processes at once: one torch thread
# each keeps them from oversubscribing the cores
torch.set_num_threads(1)


def pad(x, P, fill=0.0):
    out = np.full(P, fill, dtype=np.asarray(x).dtype)
    out[: len(x)] = x
    return out


def make_case(rng, n, cut_p=0.02, scale=3.0):
    return rng.normal(0, scale, n), rng.random(n) < cut_p


def _f32(x, P):
    return pad(np.asarray(x, np.float32), P)


@pytest.mark.parametrize("n,P", [(1, 8), (4, 8), (64, 64), (100, 128),
                                 (731, 1024)])
def test_integrate_matches_jax(rng, n, P, record_property):
    dots, cuts = make_case(rng, n, cut_p=0.1)
    d, c = _f32(dots, P), pad(cuts, P, False)
    got = st.integrate_flow(torch.from_numpy(d), torch.from_numpy(c)).numpy()
    want = np.asarray(sj.integrate_flow(jnp.asarray(d), jnp.asarray(c)))
    record_property("max_abs_err", float(np.abs(got - want).max()))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(got[:n], sh.integrate_flow(dots, cuts),
                               rtol=1e-4, atol=1e-4)


def test_affine_scan_equals_sequential(rng):
    """The odd-even scan composes the maps in order, at every length."""
    for n in range(1, 40):
        a = (rng.random(n) < 0.8).astype(np.float32)
        b = rng.normal(size=n).astype(np.float32)
        got = st._affine_scan(torch.from_numpy(a), torch.from_numpy(b))[1]
        want = np.zeros(n)
        for i in range(n):
            want[i] = (want[i - 1] * a[i] if i else 0.0) + b[i]
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


DETREND_CASES = [
    (3, 16, 20),     # < 5 branch (x1e6 quirk)
    (4, 8, 20),
    (12, 16, 20),    # single-window branch (5 <= n <= win)
    (20, 32, 20),    # boundary n == win
    (21, 32, 20),    # grid branch just past the boundary
    (100, 128, 30),
    (100, 100, 30),  # no padding
    (731, 1024, 60),
    (731, 1024, 61),  # odd window: three slots overlap at some samples
]


@pytest.mark.parametrize("n,P,win", DETREND_CASES)
def test_detrend_matches_jax(rng, n, P, win, record_property):
    dots, cuts = make_case(rng, n)
    cum = sh.integrate_flow(dots, cuts)
    x = _f32(cum, P)
    got = st.detrend_single_segment(torch.from_numpy(x), n, win).numpy()
    want = np.asarray(sj.detrend_single_segment(jnp.asarray(x),
                                                jnp.int32(n), win))
    scale = max(1.0, np.abs(want).max())
    record_property("max_rel_err", float(np.abs(got - want).max() / scale))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-5 * scale)
    host = sh.detrend(cum, win)
    np.testing.assert_allclose(got[:n], host, rtol=2e-4,
                               atol=2e-4 * max(1.0, np.abs(host).max()))


def test_detrend_is_deterministic(rng):
    n = 731
    x = torch.from_numpy(_f32(sh.integrate_flow(*make_case(rng, n)), 1024))
    a = st.detrend_single_segment(x, n, 61)
    b = st.detrend_single_segment(x, n, 61)
    assert torch.equal(a, b)


@pytest.mark.parametrize("n,P", [(10, 16), (97, 128)])
def test_binomial_smooth_matches_jax(rng, n, P, record_property):
    x = rng.normal(0, 1, n)
    xf = _f32(x, P)
    got = st.binomial_smooth(torch.from_numpy(xf), n).numpy()
    want = np.asarray(sj.binomial_smooth(jnp.asarray(xf), jnp.int32(n)))
    record_property("max_abs_err", float(np.abs(got - want).max()))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got[:n], sh.binomial_smooth(x), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("n,P,win", [(1, 8, 5), (10, 16, 4), (200, 256, 31),
                                     (200, 256, 30)])
def test_rolling_normalize_matches_jax(rng, n, P, win, record_property):
    x = rng.normal(0, 1, n)
    xf = _f32(x, P)
    got = st.rolling_normalize(torch.from_numpy(xf), n, win).numpy()
    want = np.asarray(sj.rolling_normalize(jnp.asarray(xf), jnp.int32(n), win))
    record_property("max_abs_err", float(np.abs(got - want).max()))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(got[:n], sh.rolling_normalize(x, win),
                               rtol=1e-4, atol=1e-3)


def test_keyframe_mask_matches_jax(rng):
    n, P = 200, 256
    x = rng.normal(0, 20, n).cumsum()
    norm = _f32(sh.rolling_normalize(sh.binomial_smooth(x), 31), P)
    got = st.keyframe_mask(torch.from_numpy(norm), n).numpy()
    want = np.asarray(sj.keyframe_mask(jnp.asarray(norm), jnp.int32(n)))
    np.testing.assert_array_equal(got, want)
    host = sh.keyframe_indices(sh.rolling_normalize(sh.binomial_smooth(x), 31))
    assert list(np.nonzero(got[:n])[0]) == sorted(set(host))


@pytest.mark.parametrize("P", [731, 1024])
def test_full_chain_matches_jax_and_host(rng, P, record_property):
    """The whole chain, unpadded (as the runner calls it) and padded; bar
    against the host chain: half a position unit
    (tests/test_signal_jax.py:109)."""
    n = 731
    dots, cuts = make_case(rng, n, cut_p=0.03)
    d, c = _f32(dots, P), pad(cuts, P, False)
    norm, mask = st.signal_chain_device(torch.from_numpy(d),
                                        torch.from_numpy(c), n, 60, 91)
    jnorm, jmask = sj.signal_chain_device(jnp.asarray(d), jnp.asarray(c),
                                          jnp.int32(n), 60, 91)
    norm, mask = norm.numpy()[:n], mask.numpy()[:n]
    jnorm, jmask = np.asarray(jnorm)[:n], np.asarray(jmask)[:n]
    _, want = sh.signal_chain(dots, cuts, np.arange(n), 30.0, 60, 91)
    record_property("max_abs_err_jax", float(np.abs(norm - jnorm).max()))
    record_property("max_abs_err_host", float(np.abs(norm - want).max()))
    np.testing.assert_allclose(norm, jnorm, atol=1e-3)
    np.testing.assert_allclose(norm, want, atol=0.5)
    assert mask.any()


def test_padded_length_invariance(rng):
    """Same valid data, different padded lengths: the same valid outputs."""
    n = 150
    dots, cuts = make_case(rng, n)
    outs = [st.signal_chain_device(torch.from_numpy(_f32(dots, P)),
                                   torch.from_numpy(pad(cuts, P, False)),
                                   n, 30, 45)[0].numpy()[:n]
            for P in (150, 256, 512)]
    np.testing.assert_allclose(outs[0], outs[1], rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(outs[0], outs[2], rtol=1e-5, atol=1e-4)


# ------------------------------------------------------------- routing

def _oscillation(n, seed=0, cuts_at=()):
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    dots = np.sin(2 * np.pi * t / 45.0) * 3 + rng.normal(0, 0.2, n)
    cuts = np.zeros(n, bool)
    cuts[list(cuts_at)] = True
    return dots, cuts


@pytest.mark.parametrize("n,disc,want", [
    (trun.AUTO_DEVICE_MIN_SAMPLES, False, "device"),
    (trun.AUTO_DEVICE_MIN_SAMPLES - 1, False, "host"),
    (trun.AUTO_DEVICE_MIN_SAMPLES, True, "host"),
])
def test_auto_routing(n, disc, want, record_property):
    """auto: the device chain at 65,536 samples or more when the signal has
    no discontinuity, else the host chain; either way the curve stays
    within half a position unit of the host chain."""
    dots, cuts = _oscillation(n, cuts_at=(1000, 30000))
    if disc:
        dots[n // 2] += 2500.0  # |diff| of the integrated flow > 1000
    ts = np.arange(n)
    logs = []
    acts, norm = trun.compute_actions(dots, cuts, ts, 30.0, 30.0, Params(),
                                      logs.append, device="cpu")
    assert any(f"Signal chain: {want}" in m for m in logs), logs
    assert trun.AUTO_DEVICE_MIN_SAMPLES == jrun.AUTO_DEVICE_MIN_SAMPLES
    host_acts, host_norm = trun.compute_actions(
        dots, cuts, ts, 30.0, 30.0, Params(signal_backend="host"))
    record_property("max_abs_err_host", float(np.abs(norm - host_norm).max()))
    np.testing.assert_allclose(norm, host_norm, atol=0.5)
    if want == "host":
        assert acts == host_acts
    else:
        assert acts and all(0 <= a["pos"] <= 100 for a in acts)


@pytest.mark.parametrize("n", [1, 3, 3000])
def test_compute_actions_device_matches_jax(n, record_property):
    """signal_backend='device' in both packages (JAX pads to a power of
    two, the port does not): the same keyframes, positions within ±1;
    n == 1 repeats the reference's [0, 0] emission."""
    dots, cuts = _oscillation(n, seed=2, cuts_at=(500,) if n > 500 else ())
    ts = np.arange(n) * 2
    got, norm = trun.compute_actions(dots, cuts, ts, 60.0, 30.0,
                                     Params(signal_backend="device"),
                                     device="cpu")
    want, jnorm = jrun.compute_actions(dots, cuts, ts, 60.0, 30.0,
                                       JParams(signal_backend="device"))
    record_property("max_abs_err_norm", float(np.abs(norm - jnorm).max()))
    assert [a["at"] for a in got] == [a["at"] for a in want]
    assert max(abs(a["pos"] - b["pos"]) for a, b in zip(got, want)) <= 1
    if n == 1:
        assert len(got) == 2 and got[0] == got[1]


def test_has_discontinuity():
    assert st.has_discontinuity([0.0, 10.0, 1200.0])
    assert not st.has_discontinuity([0.0, 999.0, 0.0])
    assert st.DISCONTINUITY_THRESHOLD == sj.DISCONTINUITY_THRESHOLD
