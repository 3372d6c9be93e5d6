"""From the process's start to the window's: imports and CUDA start, the
kernel libraries (built in a checkout's first run), the model, both
steady states, J-bar and one warm-up request."""


def read(run):
    return run.set_up
