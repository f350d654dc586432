"""The model step: the mean device time of a decode step, by CUDA events
around each ``DecodeGraph.replay`` issued in the window."""


def read(ctx):
    replays = ctx["win"].get("replays") or []
    return sum(ms for ms, _ in replays) / len(replays) if replays else None
