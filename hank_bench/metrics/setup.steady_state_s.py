"""Seconds in the program's steady-state solves (`find_ss`), both ends."""


def read(run):
    return run.spans.seconds("setup.steady_state")
