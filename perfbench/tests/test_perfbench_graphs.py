"""The reader of ``flow.graph_replay_share``: the runner's ``Flow
graphs`` lines over every clip of the run's window."""

from types import SimpleNamespace

import pytest

from perfbench.bench import manifest
from perfbench.bench.cell import ClipRun, Ctx


def clip(pairs, windows, replayed=None):
    logs = [f"Flow windows dispatched: {windows} ({pairs} pairs)"]
    if replayed is not None:
        logs.append(f"Flow graphs: {replayed} of {windows} windows replayed "
                    f"({windows - replayed} captured)")
    return ClipRun(spec=SimpleNamespace(index=0), frames=pairs + 1,
                   funscript="", wall=1.0, err=False, logs=logs)


@pytest.mark.parametrize("name", ["flow.graph_replay_share.farneback",
                                  "flow.graph_replay_share.dis"])
def test_graph_replay_share(name):
    read = manifest.reader(name)
    sliced = [clip(899, 6, 6), clip(1101, 7, 5)]
    ctx = Ctx(clips=sliced, trace=None,
              window_clips=sliced + [clip(1000, 4, 4)])
    # the window's clips, traced or not: 15 of 17 windows
    assert read(ctx) == pytest.approx(100.0 * 15 / 17)
    # a program that logs no such line (the parent of the graphs): nothing
    assert read(Ctx(clips=[], trace=None,
                    window_clips=[clip(899, 6), clip(1101, 7)])) is None
    assert read(Ctx(clips=[], trace=None)) is None
