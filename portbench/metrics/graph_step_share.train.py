"""graph_step_share.train: the share of the program's ``train.step`` spans
in the traced sub-window that hold a ``train.replay`` (a step replayed as
one captured CUDA graph), in %; None where no ``train.step`` was counted,
0 where the program replays none."""

from portbench.spans import span_stats


def read(run):
    stats = span_stats()
    steps = stats.get("train.step")
    if steps is None or steps.count == 0:
        return None
    replays = stats.get("train.replay")
    return 100.0 * (replays.count if replays is not None else 0) / steps.count
