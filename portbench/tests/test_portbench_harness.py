"""The benchmark harness on the CPU: a tiny run of each cell's traffic through
the harness and its metric arithmetic, with no device metric written; the
import rules; the operation and byte counts against hand-derived ones."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from tiny import CELLS, ROOT, run_cell, shrink

DEVICE_METRICS = {"device_idle.slam", "device_idle.pretrain",
                  "device_ops_per_frame.slam", "conv_device_ms.pretrain"}


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_dry_run(monkeypatch, cell, trace):
    shrink(monkeypatch)
    line, res = run_cell(cell, trace)
    assert list(line)[-1] == "checks"
    assert set(line) >= {"correct", "attempted", "failed", "metrics", "device"}
    assert line["attempted"] > 0 and line["failed"] == 0
    assert all(c[0] == c[0] for c in line["checks"].values())  # every number compared is read
    from portbench.lib import spec

    c = spec.cell(cell)
    if trace:
        wanted = {m["name"] for m in spec.per_layer(c)}
        assert set(line["metrics"]) == wanted - DEVICE_METRICS
        assert line["device"].get("busy_s", 0.0) == 0.0
    else:
        assert set(line["metrics"]) == {m["name"] for m in spec.end_to_end(c)}
        assert all(m["value"] > 0 for m in line["metrics"].values())
    json.dumps(line)


def test_no_card_no_result():
    """Without a card the command exits with another code than 0 and
    prints no result line."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "adapt-kitti-seq",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout


def test_imports():
    """The harness loads no module whose top-level name is jax, jaxlib, flax or
    tpuslam (compared whole: tpuslam_torch passes); the reference loads
    nothing of tpuslam_torch."""
    code = (
        "import sys, types; sys.path.insert(0, 'portbench/tests'); sys.path.insert(0, '.')\n"
        "import portbench.reference.nets, portbench.reference.loss, "
        "portbench.reference.steps\n"
        "top = {m.split('.')[0] for m in sys.modules}\n"
        "assert not top & {'jax', 'jaxlib', 'flax', 'tpuslam', 'tpuslam_torch'}, top\n"
        "import pytest\n"
        "from tiny import run_cell, shrink\n"
        "mp = pytest.MonkeyPatch(); shrink(mp)\n"
        "run_cell('adapt-kitti-seq', 0, 1.0)\n"
        "from portbench.lib import env\n"
        "print('forbidden', env.loaded_forbidden(), 'torch_port',\n"
        "      'tpuslam_torch' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=600, env={"PATH": "/usr/bin:/bin", "HOME": str(ROOT / "build"),
                                           "TMPDIR": str(ROOT / "build")})
    assert out.returncode == 0, out.stderr[-3000:]
    assert "forbidden [] torch_port True" in out.stdout


def _conv_flops(cin, cout, k, h_out, w_out, batch):
    return 2 * cin * cout * k * k * h_out * w_out * batch


def test_encoder_flops_by_hand():
    """FlopCounterMode over the reference's ResNet-18 encoder at 32x64 equals
    the sum of its convolutions' 2 * Cin * Cout * k^2 * Hout * Wout."""
    from torch.utils.flop_counter import FlopCounterMode

    from portbench.reference.nets import ResNetEncoder

    B, H, W = 2, 32, 64
    want = _conv_flops(3, 64, 7, H // 2, W // 2, B)  # stem, then max pool to H/4
    h, w, cin = H // 4, W // 4, 64
    for stage, cout in enumerate((64, 128, 256, 512)):
        stride = 1 if stage == 0 else 2
        ho, wo = h // stride, w // stride
        want += _conv_flops(cin, cout, 3, ho, wo, B) + _conv_flops(cout, cout, 3, ho, wo, B)
        if stride != 1 or cin != cout:
            want += _conv_flops(cin, cout, 1, ho, wo, B)
        want += 2 * _conv_flops(cout, cout, 3, ho, wo, B)  # the stage's second block
        h, w, cin = ho, wo, cout
    with torch.device("meta"):
        net = ResNetEncoder(18, 1)
        x = torch.zeros(B, H, W, 3)
    with FlopCounterMode(display=False) as count:
        net(x)
    assert count.get_total_flops() == want


def test_busy_union_by_hand():
    from portbench.lib.trace import busy_union

    assert busy_union([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) == pytest.approx(4.0)
