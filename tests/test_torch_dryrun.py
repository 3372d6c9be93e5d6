"""PyTorch port: the multi-rank dry run (`hank_tpu_torch.parallel.dryrun`, the
port of `__graft_entry__.py:105-233`) on two gloo ranks, and the rank
launcher's failure paths: a failing rank and a rank past the time limit end
the run with an error instead of leaving a rank waiting in a collective.
"""

import time

import pytest
import torch

from hank_tpu_torch.parallel.dryrun import dryrun_multichip, spawn_ranks
from tests import torch_ranks

torch.set_num_threads(1)


def test_dryrun_multichip_on_two_gloo_ranks():
    out = dryrun_multichip(2, device="cpu")
    assert out["ranks"] == 2 and out["sp_ranks"] == 2 and out["device"] == "cpu"
    assert out["sp_max_abs_vs_unsplit"] <= 1e-12
    assert out["tp_max_abs_vs_unsplit"] < 1e-9
    for method in ("boehl", "newton_krylov"):
        assert out[f"dp_{method}"]["residual_norm_max"] < 1e-8
        assert out[f"dp_{method}"]["row0_plain_f64"] < 1e-7


def test_spawn_ranks_reports_a_failing_rank_and_stops_the_others():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        spawn_ranks(torch_ranks.failing_rank, 2, device="cpu", timeout=100)
    assert time.monotonic() - t0 < 60


def test_spawn_ranks_stops_ranks_past_its_time_limit():
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        spawn_ranks(torch_ranks.sleeping_rank, 2, 300.0, device="cpu", timeout=10)
    assert time.monotonic() - t0 < 60
