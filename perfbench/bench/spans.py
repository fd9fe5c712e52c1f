"""The program's own spans in the traced slice: the ``ff.*`` host events
that ``funscript_flow_tpu_torch.utils.logging.span`` records while the
profiler runs (``ff.clip`` around a clip; inside it ``ff.clip.setup``,
``ff.decode_wait``, ``ff.window.upload`` / ``.program`` / ``.wait`` per
window, ``ff.signal_chain`` and ``ff.clip.write``). The readers of host
time and host syncs use them; a program that records no such span leaves
each of them with nothing to read (``None``).
"""

from __future__ import annotations

import numpy as np

CLIP = "ff.clip"
WINDOW = "ff.window."
# the spans inside ``ff.clip`` whose time is not the runner's own
CLIP_CHILDREN = ("ff.decode_wait", "ff.window.upload", "ff.window.program",
                 "ff.window.wait", "ff.signal_chain")
# CUDA calls (runtime names and their ``cu*`` twins) that block the host
# until the device catches up: stream, device and event synchronisation,
# and the blocking copies
SYNC_CALLS = frozenset({
    "cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
    "cudaMemcpy", "cuStreamSynchronize", "cuCtxSynchronize",
    "cuEventSynchronize", "cuMemcpy", "cuMemcpyDtoH", "cuMemcpyHtoD",
})


def intervals(trace, match) -> tuple:
    """(starts, ends), sorted by start, of the host events that start in
    the slice's window and whose name ``match`` accepts."""
    lo, hi = trace.window
    keep = [i for i, n in enumerate(trace.cpu_names) if match(n)]
    s = trace.cpu_start[keep]
    e = trace.cpu_end[keep]
    inside = (s >= lo) & (s <= hi)
    s, e = s[inside], e[inside]
    order = np.argsort(s, kind="stable")
    return s[order], e[order]


def named(trace, name: str) -> tuple:
    return intervals(trace, lambda n: n == name)


def merged(starts, ends) -> tuple:
    """The union of the intervals, as sorted disjoint (starts, ends)."""
    if not len(starts):
        return starts, ends
    run_end = np.maximum.accumulate(ends)
    new = np.r_[True, starts[1:] > run_end[:-1]]
    idx = np.flatnonzero(new)
    return starts[new], run_end[np.r_[idx[1:] - 1, len(starts) - 1]]


def self_us(trace, parent: str, children) -> float | None:
    """Summed time of the ``parent`` spans less the part of each that its
    ``children`` spans cover (self time); None without a ``parent``
    span."""
    ps, pe = named(trace, parent)
    if not len(ps):
        return None
    cs, ce = intervals(trace, lambda n: n in children)
    cs, ce = merged(cs, ce)
    covered = sum(float((np.clip(ce, s, e) - np.clip(cs, s, e)).sum())
                  for s, e in zip(ps, pe))
    return float((pe - ps).sum()) - covered


def us_per_pair(ctx, name: str) -> float | None:
    """Summed time of the ``name`` spans over the slice's pairs (us/pair);
    None without such a span."""
    if ctx.trace is None or ctx.pairs <= 0:
        return None
    s, e = named(ctx.trace, name)
    return float((e - s).sum()) / ctx.pairs if len(s) else None


def calls_inside(trace, calls, prefix: str) -> int | None:
    """The host events named in ``calls`` that start inside a span whose
    name starts with ``prefix``; None without such a span."""
    ss, se = merged(*intervals(trace, lambda n: n.startswith(prefix)))
    if not len(ss):
        return None
    t, _ = intervals(trace, lambda n: n in calls)
    i = np.searchsorted(ss, t, side="right") - 1
    return int(((i >= 0) & (t <= se[np.maximum(i, 0)])).sum())
