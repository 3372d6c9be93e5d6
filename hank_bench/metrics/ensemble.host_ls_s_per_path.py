"""Seconds of the ensemble solver's host least squares (its own clock,
`info["host_ls_seconds"]`) per solved row."""


def read(run):
    ls = [r["info"]["host_ls_seconds"] for r in run.requests
          if "host_ls_seconds" in r["info"]]
    return sum(ls) / run.solved if ls and run.solved else None
