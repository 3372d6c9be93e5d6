"""Kernels 3-4 (`household_sweep_ranged_kernel<float, true, true, false>`,
the f32 directions of a batch of paths): its launches' least time over
their device time, in %."""

from hank_bench.tracing import kernel_matcher
from hank_bench.yardstick import (least_seconds as least, one_asset_sweep_bytes,
                                  one_asset_sweep_ops, roofline_share, sizes)

MATCH = kernel_matcher("household_sweep_ranged_kernel", ("float", "true", "true", "false"))


def least_seconds(run):
    """The least time of one launch at the cell's shapes."""
    Tm1, n_a, n_e = sizes(run.config)
    paths = run.mix["batch"]
    return least(one_asset_sweep_bytes(Tm1, n_a, n_e, True, "f32", paths),
                 one_asset_sweep_ops(Tm1, n_a, n_e, True, paths), "f32")


def read(run):
    return roofline_share(run, MATCH, least_seconds(run))
