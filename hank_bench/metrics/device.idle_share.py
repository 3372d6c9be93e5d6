"""Share of the window in which nothing ran on the card: 1 less the card's
busy time per solved path (the traced window's) times the window's solved
paths per second (host clock, no profiler, whose own host time would
count as idle)."""


def read(run):
    if run.trace is None or not run.solved or not run.traced_solved:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.traced_solved * run.solved / run.window_s)
