"""Host seconds per solved path: the window's wall-clock per solved path
(host clock, no profiler) less the card's busy time per solved path (the
traced window's)."""


def read(run):
    if run.trace is None or not run.solved or not run.traced_solved:
        return None
    return run.window_s / run.solved - run.trace.busy_s / run.traced_solved
