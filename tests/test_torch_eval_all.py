"""The sweep over every benchmark target (``bufferx_tpu_torch/tools/
eval_all.py``, the port of ``scripts/eval_all.sh`` and
``scripts/eval_all_hetero.sh``): its targets and directories are the shell
scripts', and on a datasets root where only ``ThreeDMatch/`` holds a layout
(``tools/hard_layout.py``: one hardsynth pair) the 3DMatch target runs,
the ten others print ``[skip] <target> failed``, and the exit code is 0."""

import os
import re

from bufferx_tpu_torch.tools import eval_all, hard_layout

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_targets_are_the_shell_scripts():
    with open(os.path.join(ROOT, "scripts", "eval_all.sh")) as f:
        sh = f.read()
    dirs = dict(re.findall(r"\[(\w+)\]=([\w-]+)", sh))
    order = re.search(r"for ds in ([^;]+);", sh).group(1).split()
    assert list(eval_all.TARGETS) == order
    assert eval_all.TARGETS == dirs
    with open(os.path.join(ROOT, "scripts", "eval_all_hetero.sh")) as f:
        specs = re.findall(r'"(\w+:[\w-]+:\w+:\w+)"', f.read())
    assert [":".join(h) for h in eval_all.HETERO] == specs


def test_sweep_one_target_runs_ten_skip(tmp_path, capsys):
    hard_layout.write_test_scene(str(tmp_path / "ThreeDMatch"), pairs=1,
                                 num_points=12000)
    rc = eval_all.main([str(tmp_path), "--cpu", "--fast", "--max-pairs", "1",
                        "--checkpoint-dir",
                        os.path.join(ROOT, "snapshot", "hard_moments_r4ft2"),
                        "--out-dir", str(tmp_path / "results")])
    assert rc == 0
    out = capsys.readouterr().out
    lines = out.splitlines()
    skipped = [ln for ln in lines if ln.startswith("[skip] ")]
    assert sorted(ln.split()[1] for ln in skipped) == sorted(
        t for t in eval_all.TARGETS if t != "3DMatch")
    assert all(ln.endswith(" failed") for ln in skipped)
    assert lines[-1] == "eval_all: 1 ran, 10 skipped"
    assert sum(ln.startswith("=== ") for ln in lines) == 11
    assert os.path.exists(tmp_path / "results" / "bufferx_tpu" /
                          "3DMatch_per_sample.csv")


def test_hetero_sweep_skips_missing_roots(tmp_path, capsys):
    assert eval_all.main(["--hetero", str(tmp_path), "--cpu", "--out-dir",
                          str(tmp_path / "results")]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[-1] == "eval_all: 0 ran, 6 skipped"
    assert "[skip] KAIST_hetero:helipr_kaist05:Aeva:Avia failed" in lines
