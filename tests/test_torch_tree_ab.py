"""PyTorch port: `hank_tpu_torch/tools/tree_ab.py`'s offline summary.

The timing turns need the card; `--summarize` reads their output here. On
turns whose times lie on known lines against the host least-squares
seconds, each block's count and median come out as given and the line read
at `--at` recovers the time that line gives there.
"""

import json

import numpy as np

from hank_tpu_torch.tools.tree_ab import main, summarize


def _turn(tree, ls, times, turn, key="ensemble_b64"):
    return {"turn": turn, "tree": tree, "setup_s": 1.0,
            "ks_headline": {"median_s": 0.25, "runs_s": [0.25], "outer_iterations": 5},
            key: {"median_s": float(np.median(times)), "runs_s": list(times),
                  "host_ls_s": list(ls)}}


def test_summarize_reads_each_tree_and_block_at_one_host_speed(tmp_path, capsys):
    ls_old, ls_new = np.array([0.04, 0.05, 0.07]), np.array([0.06, 0.08, 0.09])
    lines = [{"device": "card", "reps": 3},
             _turn("old", ls_old, 0.15 + 2.0 * ls_old, 0),
             _turn("new", ls_new, 0.16 + 2.0 * ls_new, 1),
             _turn("new", ls_new, 0.20 + 2.0 * ls_new, 2, key="ensemble_b64_mesh"),
             {"median_s": {}, "path_max_abs_vs_turn_0": {}}]
    path = tmp_path / "ab.jsonl"
    path.write_text("".join(json.dumps(x) + "\n" for x in lines))

    out = summarize([str(path)], at=0.05)
    blocks = out["blocks"]
    assert out["host_ls_s"] == 0.05
    assert set(blocks) == {"old/ensemble_b64", "new/ensemble_b64", "new/ensemble_b64_mesh"}
    assert blocks["old/ensemble_b64"]["calls"] == 3
    assert abs(blocks["old/ensemble_b64"]["median_s"] - 0.25) < 1e-12
    assert abs(blocks["new/ensemble_b64"]["median_host_ls_s"] - 0.08) < 1e-12
    for key, icpt in (("old/ensemble_b64", 0.15), ("new/ensemble_b64", 0.16),
                      ("new/ensemble_b64_mesh", 0.20)):
        assert abs(blocks[key]["s_at_host_ls"] - (icpt + 0.1)) < 1e-12

    assert main(["--summarize", str(path), "--at", "0.05"]) == 0
    assert json.loads(capsys.readouterr().out) == out
