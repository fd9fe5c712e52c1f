"""Device-time measurement on the card (the port's counterpart of the JAX
package's xplane parser).

Wall clock on the host includes the host's cost of issuing each launch,
which for the small eager kernels of a flow window is larger than the
kernels themselves. Device time is not: this helper runs a callable under
``torch.profiler`` and sums the device-side (CUDA kernel and memcpy)
events, as ``chip_smoke.profile_window`` does.
"""

from __future__ import annotations

import torch

__all__ = ["device_profile"]


def _device_us(event) -> float:
    return getattr(event, "self_device_time_total",
                   getattr(event, "self_cuda_time_total", 0.0))


def device_profile(fn, *args, runs: int = 3, top: int = 0, label: str = ""):
    """Return the mean device ms per call of ``fn(*args)`` over ``runs``
    traced calls, after one untraced warm-up call. ``top`` > 0 also prints
    the top-N kernels by device time.

    Raises ``RuntimeError`` without CUDA: a CPU run has no device time.
    """
    if not torch.cuda.is_available():
        raise RuntimeError("device_profile needs a CUDA device")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn(*args)
        torch.cuda.synchronize()
    # device-side rows only: a host op's row repeats its kernels' time
    rows = sorted(((_device_us(e), e.key, e.count) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and _device_us(e) > 0),
                  reverse=True)
    per_run = sum(r[0] for r in rows) / 1e3 / runs
    print(f"{label or getattr(fn, '__name__', 'fn')}: "
          f"{per_run:.3f} ms/run device time", flush=True)
    for us, key, count in rows[:top]:
        print(f"   {us / 1e3 / runs:9.3f} ms {count // runs:5d}x  {key[:120]}",
              flush=True)
    return per_run
