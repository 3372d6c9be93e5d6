"""Seconds in the program's steady-state Jacobian (`get_steady_state_jacobian`)."""


def read(run):
    return run.spans.seconds("setup.jacobian")
