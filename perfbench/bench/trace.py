"""The traced slice's arithmetic: device time, busy and idle time, launch
calls, idle gaps by what the host was doing, and the hand kernels' share
of their roofline.

A :class:`Trace` holds the profiler's events as plain arrays (times in
microseconds, in the profiler's own time base): the device's kernels and
copies, and the host's operations and runtime calls. The window is the
``perfbench.window`` span that the harness records around the slice.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

WINDOW_SPAN = "perfbench.window"
# CUDA runtime and driver calls that put work on the device
LAUNCH_CALLS = frozenset({
    "cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
    "cuLaunchKernelEx", "cudaLaunchCooperativeKernel", "cudaGraphLaunch",
    "cudaMemcpyAsync", "cudaMemcpy", "cudaMemsetAsync", "cudaMemset",
})
GAPS_NAMED = 500   # the longest idle gaps that are attributed by name
TOP = 10           # entries of each breakdown list


@dataclass
class Trace:
    dev_names: list
    dev_start: np.ndarray
    dev_end: np.ndarray
    cpu_names: list
    cpu_start: np.ndarray
    cpu_end: np.ndarray
    window: tuple = field(default=(0.0, 0.0))

    @classmethod
    def from_events(cls, device, cpu):
        """From ``device`` [(name, start_us, end_us)] and ``cpu``
        [(name, start_us, end_us)]; the window is the ``perfbench.window``
        span among ``cpu`` (else the span of all events)."""
        win = [(s, e) for n, s, e in cpu if n == WINDOW_SPAN]
        dn = [d[0] for d in device]
        ds = np.array([d[1] for d in device], dtype=np.float64)
        de = np.array([d[2] for d in device], dtype=np.float64)
        cn = [c[0] for c in cpu]
        cs = np.array([c[1] for c in cpu], dtype=np.float64)
        ce = np.array([c[2] for c in cpu], dtype=np.float64)
        if win:
            window = win[0]
        else:
            allt = np.concatenate([ds, de, cs, ce])
            window = (float(allt.min()), float(allt.max())) if len(allt) \
                else (0.0, 0.0)
        return cls(dn, ds, de, cn, cs, ce, (float(window[0]), float(window[1])))

    # --- the window and the device's time in it
    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def _clipped(self):
        lo, hi = self.window
        s = np.clip(self.dev_start, lo, hi)
        e = np.clip(self.dev_end, lo, hi)
        keep = e > s
        return s[keep], e[keep], keep

    def device_time_s(self) -> float:
        """Summed duration of every device event in the window."""
        s, e, _ = self._clipped()
        return float((e - s).sum()) / 1e6

    def busy_intervals(self):
        """The union of the device events' intervals in the window, as
        sorted disjoint (start, end) arrays."""
        s, e, _ = self._clipped()
        if not len(s):
            return np.zeros(0), np.zeros(0)
        order = np.argsort(s, kind="stable")
        s, e = s[order], e[order]
        run_end = np.maximum.accumulate(e)
        new = np.empty(len(s), dtype=bool)
        new[0] = True
        new[1:] = s[1:] > run_end[:-1]
        starts = s[new]
        idx = np.flatnonzero(new)
        ends = run_end[np.r_[idx[1:] - 1, len(s) - 1]]
        return starts, ends

    def busy_s(self) -> float:
        a, b = self.busy_intervals()
        return float((b - a).sum()) / 1e6

    def idle_share(self) -> float | None:
        """Idle share of the window, in %; None when the device ran
        nothing in it."""
        if self.window_s <= 0 or not len(self.dev_start):
            return None
        busy = self.busy_s()
        if busy <= 0:
            return None
        return 100.0 * (1.0 - busy / self.window_s)

    def launch_calls(self) -> int:
        lo, hi = self.window
        inside = (self.cpu_start >= lo) & (self.cpu_start <= hi)
        return int(sum(1 for n, k in zip(self.cpu_names, inside)
                       if k and n in LAUNCH_CALLS))

    # --- breakdowns
    def device_ops(self, top: int = TOP) -> list:
        """[[name, seconds]] of the device events with the most summed
        time in the window."""
        s, e, keep = self._clipped()
        names = [n for n, k in zip(self.dev_names, keep) if k]
        total: dict = {}
        for n, d in zip(names, (e - s).tolist()):
            total[n] = total.get(n, 0.0) + d
        rows = sorted(total.items(), key=lambda kv: -kv[1])[:top]
        return [[n[:160], d / 1e6] for n, d in rows]

    def gaps(self):
        """(start, end) arrays of the window's idle gaps."""
        a, b = self.busy_intervals()
        lo, hi = self.window
        starts = np.r_[lo, b]
        ends = np.r_[a, hi]
        keep = ends > starts
        return starts[keep], ends[keep]

    def idle_gaps(self, top: int = TOP, named: int = GAPS_NAMED) -> list:
        """[[what the host was doing, seconds]]: the ``named`` longest
        idle gaps, each named by the innermost host operation (not a
        runtime call) that spans its middle, summed by name."""
        gs, ge = self.gaps()
        if not len(gs):
            return []
        order = np.argsort(gs - ge)[:named]
        ops = np.array([n not in LAUNCH_CALLS and n != WINDOW_SPAN
                        for n in self.cpu_names], dtype=bool)
        cs, ce = self.cpu_start[ops], self.cpu_end[ops]
        cn = [n for n, k in zip(self.cpu_names, ops) if k]
        total: dict = {}
        for i in order:
            mid = (gs[i] + ge[i]) / 2
            hit = np.flatnonzero((cs <= mid) & (ce >= mid))
            name = cn[hit[np.argmax(cs[hit])]] if len(hit) else "no host op"
            total[name] = total.get(name, 0.0) + (ge[i] - gs[i])
        rows = sorted(total.items(), key=lambda kv: -kv[1])[:top]
        return [[n[:160], d / 1e6] for n, d in rows]

    # --- the hand kernels
    def kernel_events(self, pattern: str):
        """Durations (us) of the window's device events whose name holds
        ``pattern``, in the order they ran."""
        s, e, keep = self._clipped()
        names = [n for n, k in zip(self.dev_names, keep) if k]
        order = np.argsort(s, kind="stable")
        return [float(e[i] - s[i]) for i in order if pattern in names[i]]


def launch_cost(spec: dict, args) -> tuple:
    """(bytes, f32 operations) of one launch of the kernel of ``spec``
    (``kernels/<kernel>.json``), from the launch's integer arguments: each
    of ``spec['dims']`` names the position of one argument."""
    dims = {k: int(args[i]) for k, i in spec["dims"].items()}
    env = {"__builtins__": {}}
    return (float(eval(spec["bytes"], env, dims)),
            float(eval(spec["flops"], env, dims)))


def roofline(trace: Trace, specs: list, launches: list, peaks: dict):
    """The hand kernels' share of their roofline, in %: the sum over
    their launches of the least time each could take (its bytes at the
    chip's memory bandwidth or its f32 operations at its f32 rate,
    whichever is longer), over the sum of their device time. ``launches``
    are the recorded launches, (kernel, args), in the order the device
    runs them: a launch captured into a CUDA graph once for every replay
    (``cell.LaunchLog``), so that each pairs with one device event. None
    when the trace shows no hand kernel; ``ValueError`` when a kernel's
    events and its recorded launches do not pair up."""
    bound_us = device_us = 0.0
    for spec in specs:
        events = trace.kernel_events(spec["trace_name"])
        calls = [a for k, a in launches if k == spec["launch"]]
        if len(events) != len(calls):
            raise ValueError(f"{spec['launch']}: {len(events)} device events "
                             f"named {spec['trace_name']!r} against "
                             f"{len(calls)} recorded launches")
        for dur, args in zip(events, calls):
            nbytes, flops = launch_cost(spec, args)
            bound_us += 1e6 * max(nbytes / peaks["hbm_bytes_per_s"],
                                  flops / peaks["f32_ops_per_s"])
            device_us += dur
    if device_us <= 0:
        return None
    return 100.0 * bound_us / device_us


def from_profiler(prof) -> Trace:
    """The events of a finished ``torch.profiler.profile``, read from its
    raw results (parsing them into ``prof.events()`` would take minutes
    for a DIS slice)."""
    from torch.autograd import DeviceType

    device, cpu = [], []
    for e in prof.profiler.kineto_results.events():
        dt = e.device_type()
        row = (e.name(), e.start_ns() / 1e3, e.end_ns() / 1e3)
        if dt == DeviceType.CPU:
            cpu.append(row)
        # a span of the host's (record_function) is mirrored on the
        # device's timeline as an annotation: no device work
        elif dt == DeviceType.CUDA and not e.is_user_annotation():
            device.append(row)
    return Trace.from_events(device, cpu)
