"""Kernel 2 (`household_sweep_ranged_kernel<double, false, false, false>`,
one path's float64 residual F): its launches' least time over their device
time, in %."""

from hank_bench.tracing import kernel_matcher
from hank_bench.yardstick import (least_seconds as least, one_asset_sweep_bytes,
                                  one_asset_sweep_ops, roofline_share, sizes)

MATCH = kernel_matcher("household_sweep_ranged_kernel", ("double", "false", "false", "false"))


def least_seconds(run):
    """The least time of one launch at the cell's shapes."""
    Tm1, n_a, n_e = sizes(run.config)
    paths = 1
    return least(one_asset_sweep_bytes(Tm1, n_a, n_e, False, "f64", paths),
                 one_asset_sweep_ops(Tm1, n_a, n_e, False, paths), "f64")


def read(run):
    return roofline_share(run, MATCH, least_seconds(run))
