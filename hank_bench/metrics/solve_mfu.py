"""The whole solve's share of the card's peak: the window's solved paths
per second (host clock, no profiler) times the least seconds of one path's solve, where that
least time is the kernels' launches per path (frozen in the cell's data,
`launches_per_path`, keyed by each kernel's roofline metric) times each
launch's least time at the cell's shapes."""

from hank_bench.harness import metric_reader


def read(run):
    work = run.data.get("launches_per_path")
    if not work or not run.solved:
        return None
    least = sum(n * metric_reader(k).least_seconds(run) for k, n in work.items())
    return 100.0 * run.solved / run.window_s * least
