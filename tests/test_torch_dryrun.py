"""The port's multi-device dry run (``parallel/dryrun.py``) over two CPU ranks."""

import torch_ranks


def test_dryrun_multichip_two_ranks(tmp_path):
    torch_ranks.spawn("torch_ranks:dryrun_checks", 2, tmp_path)
    line = torch_ranks.load(tmp_path, 0)["line"]
    assert line.startswith("dryrun_multichip(2): ok") and "6 sharded paths validated" in line
    assert torch_ranks.load(tmp_path, 1)["line"] == line
