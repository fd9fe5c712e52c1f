"""flow.graph_replay_share (%): the share of flow windows that replayed a
captured CUDA graph of the flow program, over every clip of the run's
window, traced or not (the runner's ``Flow graphs: R of N windows
replayed (C captured)`` line). Every window outside it ran the program
eagerly: the first window of a shape in the process, or a path the
graphs do not take. Nothing to read where the runner logs no such line."""

import re

_GRAPHS = re.compile(r"Flow graphs: (\d+) of (\d+) windows replayed")


def read(ctx):
    replayed = windows = 0
    for clip in ctx.window_clips:
        for line in clip.logs:
            m = _GRAPHS.search(line)
            if m:
                replayed += int(m.group(1))
                windows += int(m.group(2))
    if windows <= 0:
        return None
    return 100.0 * replayed / windows
