"""Paths brought to the request's tolerance per second of the window (from
its start to the last request's completion). An ensemble row counts as one."""


def read(run):
    return run.solved / run.window_s
