"""The scaling bench (``bufferx_tpu_torch/tools/bench_scaling.py``, the port
of ``scripts/bench_scaling.py``) on gloo ranks at ``--small``: world sizes
1 and 2, one JSON line a size with the JAX script's keys and a summary
line, and world size 2's poses for the pairs of world size 1 equal to them
(within 1e-5: the same pair, draws and weights, registered in a batch of
another size), inlier counts equal."""

import json

import torch

from bufferx_tpu_torch.tools import bench_scaling


def test_two_gloo_ranks(capsys):
    out = bench_scaling.run(["--small", "--cpu-ranks", "2",
                             "--pairs-per-device", "1"])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    assert [ln["mesh"] for ln in lines[:2]] == [1, 2]
    for ln in lines[:2]:
        assert set(ln) == {"mesh", "pairs_per_s", "scaling_efficiency"}
        assert ln["pairs_per_s"] > 0
    assert lines[0]["scaling_efficiency"] == 1.0
    summary = lines[2]
    assert set(summary) == {"metric", "value", "unit", "sizes"}
    assert summary["metric"] == "scaling_efficiency"
    assert summary["unit"] == "ratio" and summary["sizes"] == lines[:2]
    assert summary["value"] == lines[1]["scaling_efficiency"]

    one, two = out
    assert one["pairs"] == 1 and two["pairs"] == 2
    assert tuple(two["pose"].shape) == (2, 4, 4)
    torch.testing.assert_close(two["pose"][:1], one["pose"], rtol=0,
                               atol=1e-5)
    assert torch.equal(two["num_inliers"][:1], one["num_inliers"])
    assert bool(torch.isfinite(two["pose"]).all())
