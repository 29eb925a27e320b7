"""The benchmark harness on the CPU: a tiny run of each cell's traffic through
the harness and its metric arithmetic, with no device metric written, also
with the encoders at ResNet-34; the import rules; the operation and byte
counts against hand-derived ones; the reference's encoders against
torchvision's published sizes; and the ResNet-18 weights and FLOP counts
pinned to what the harness gave before encoders followed the
configuration."""
from __future__ import annotations

import hashlib
import json
import math
import subprocess
import sys

import pytest
import torch

from tiny import CELLS, ROOT, run_cell, shrink

DEVICE_METRICS = {"device_idle.slam", "device_idle.pretrain",
                  "device_ops_per_frame.slam", "conv_device_ms.pretrain",
                  "update_device_ms.covio", "overlap_share.covio"}


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


def _encoders_at(monkeypatch, depth: int) -> None:
    """The (shrunk) configurations with both encoders at `depth`."""
    from portbench.lib import spec

    config = spec.config

    def deeper(name):
        c = config(name)
        for section in c["run"].values():
            if "resnet_depth" in section:
                section.update(resnet_depth=depth, resnet_pose=depth)
        return c

    monkeypatch.setattr(spec, "config", deeper)


@pytest.mark.parametrize("cell", CELLS)
def test_dry_run_at_resnet34(monkeypatch, cell):
    """A configuration whose encoders are ResNet-34, which the program runs:
    the program's networks load the seeded weights drawn at that depth, the
    reference builds the same depth, every check is read and holds, and
    `controls.py` reads the control and the faults at that depth too."""
    from portbench import controls
    from portbench.lib import spec, weights
    from portbench.reference import steps

    shrink(monkeypatch)
    _encoders_at(monkeypatch, 34)
    drawn, built = [], []
    seeded, net = weights.seeded_state_dict, steps.DepthPoseNet

    def seeded_at(seed, scales, device, resnet_depth=18, resnet_pose=18):
        drawn.append((resnet_depth, resnet_pose))
        return seeded(seed, scales, device, resnet_depth, resnet_pose)

    def net_at(scales, resnet=18, precision="float32", resnet_pose=None):
        built.append((resnet, resnet_pose))
        return net(scales, resnet, precision, resnet_pose)

    monkeypatch.setattr(weights, "seeded_state_dict", seeded_at)
    monkeypatch.setattr(steps, "DepthPoseNet", net_at)
    line, res = run_cell(cell)
    assert line["attempted"] > 0 and line["failed"] == 0
    assert all(v == v for v, _ in line["checks"].values())  # every number compared is read
    assert line["correct"], line["checks"]
    c = spec.cell(cell)
    readings, _ = controls.readings_for(spec.config(c["config"]), c)
    faults = {"control", "answer_altered", "state_unchanged", "half_batch"}
    if readings is controls.covio_readings:
        faults.add("stale_served")
    assert set(readings(res["kept"])) == faults
    assert drawn and set(drawn) == {(34, 34)}
    assert built and set(built) == {(34, 34)}


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


def _basic_block_flops(cin, planes, stride, h, w, B):
    """3x3 (with the stride), 3x3, and a 1x1 downsample where the shape changes."""
    ho, wo = h // stride, w // stride
    flops = _conv_flops(cin, planes, 3, ho, wo, B) + _conv_flops(planes, planes, 3, ho, wo, B)
    if stride != 1 or cin != planes:
        flops += _conv_flops(cin, planes, 1, ho, wo, B)
    return flops, planes


def _bottleneck_flops(cin, planes, stride, h, w, B):
    """1x1 at the input's size, 3x3 with the stride, 1x1 to 4 * planes, and
    a 1x1 downsample with the stride where the shape changes."""
    ho, wo = h // stride, w // stride
    flops = (_conv_flops(cin, planes, 1, h, w, B) + _conv_flops(planes, planes, 3, ho, wo, B)
             + _conv_flops(planes, 4 * planes, 1, ho, wo, B))
    if stride != 1 or cin != 4 * planes:
        flops += _conv_flops(cin, 4 * planes, 1, ho, wo, B)
    return flops, 4 * planes


HAND = {18: (_basic_block_flops, (2, 2, 2, 2)), 50: (_bottleneck_flops, (3, 4, 6, 3))}


@pytest.mark.parametrize("depth", sorted(HAND))
def test_encoder_flops_by_hand(depth):
    """FlopCounterMode over the reference's encoder at 32x64 equals the sum
    of its convolutions' 2 * Cin * Cout * k^2 * Hout * Wout."""
    from torch.utils.flop_counter import FlopCounterMode

    from portbench.reference.nets import ResNetEncoder

    block, stages = HAND[depth]
    B, H, W = 2, 32, 64
    want = _conv_flops(3, 64, 7, H // 2, W // 2, B)  # stem, then max pool to H/4
    h, w, cin = H // 4, W // 4, 64
    for stage, (blocks, planes) in enumerate(zip(stages, (64, 128, 256, 512))):
        stride = 1 if stage == 0 else 2
        for b in range(blocks):
            flops, cout = block(cin, planes, stride if b == 0 else 1, h, w, B)
            want += flops
            if b == 0:
                h, w = h // stride, w // stride
            cin = cout
    with torch.device("meta"):
        net = ResNetEncoder(depth, 1)
        x = torch.zeros(B, H, W, 3)
    with FlopCounterMode(display=False) as count:
        net(x)
    assert count.get_total_flops() == want


# torchvision's published parameter totals less `fc` (512 or 2048 x 1000 + 1000);
# the pose encoder's stem takes 6 channels, 64 x 3 x 7 x 7 more
@pytest.mark.parametrize("depth,images,params", [(18, 1, 11_176_512), (34, 1, 21_284_672),
                                                 (50, 1, 23_508_032), (50, 2, 23_517_440)])
def test_encoder_parameters_published(depth, images, params):
    from portbench.reference.nets import ResNetEncoder

    with torch.device("meta"):
        net = ResNetEncoder(depth, images)
    assert sum(p.numel() for p in net.parameters()) == params


def test_resnet50_names():
    """torchvision's names for the bottleneck's layers, so that one state
    dict loads into the program and the reference."""
    from portbench.reference.nets import ResNetEncoder

    with torch.device("meta"):
        names = set(ResNetEncoder(50, 1).state_dict())
    block = "resnet.layer2.0."
    want = {block + m + ".weight" for m in ("conv1", "conv2", "conv3", "downsample.0")}
    want |= {block + m + "." + p for m in ("bn1", "bn2", "bn3", "downsample.1")
             for p in ("weight", "bias", "running_mean", "running_var", "num_batches_tracked")}
    assert {n for n in names if n.startswith(block)} == want
    assert {n.split(".")[1] for n in names if n.startswith("resnet.layer")} == {
        "layer1", "layer2", "layer3", "layer4"}
    assert max(int(n.split(".")[2]) for n in names if n.startswith("resnet.layer3.")) == 5


@pytest.mark.parametrize("depth", [18, 34, 50])
def test_decoder_widths(depth):
    """Each decoder takes its encoder's channels: upconv_4_0 the last stage's,
    upconv_i_1 the decoder's own plus the skip's, the pose squeeze the last
    stage's to 256."""
    from portbench.reference.nets import DECODER_CHANNELS, DepthPoseNet

    with torch.device("meta"):
        net = DepthPoseNet((0, 1, 2, 3), depth)
    enc = net.depth_encoder.num_ch_enc
    assert enc == ((64, 256, 512, 1024, 2048) if depth == 50 else (64, 64, 128, 256, 512))
    dec = net.depth_decoder

    def cin(name):
        return getattr(dec, name).conv.conv.weight.shape[1]

    assert cin("upconv_4_0") == enc[-1]
    for i in range(5):
        assert cin(f"upconv_{i}_1") == DECODER_CHANNELS[i] + (enc[i - 1] if i > 0 else 0)
    assert tuple(net.pose_decoder.squeeze.weight.shape[:2]) == (256, enc[-1])


def test_depth_and_pose_encoders_apart():
    """`resnet_pose` builds the pose encoder and its decoder at their own depth."""
    from portbench.reference.nets import DepthPoseNet

    with torch.device("meta"):
        net = DepthPoseNet((0, 1, 2, 3), 50, resnet_pose=18)
    assert net.depth_decoder.upconv_4_0.conv.conv.weight.shape[1] == 2048
    assert net.pose_decoder.squeeze.weight.shape[1] == 512
    assert hasattr(net.depth_encoder.resnet.layer1[0], "conv3")
    assert not hasattr(net.pose_encoder.resnet.layer1[0], "conv3")


@pytest.mark.parametrize("depth", [18, 34, 50])
def test_stage_shapes(depth):
    """The five feature maps at 64x192: halved at the stem and at each stage
    after the first (the max pool halves before the first)."""
    from portbench.reference.nets import ResNetEncoder

    with torch.device("meta"):
        net = ResNetEncoder(depth, 1)
        feats = net(torch.zeros(2, 64, 192, 3))
    sizes = [(32, 96), (16, 48), (8, 24), (4, 12), (2, 6)]
    assert [tuple(f.shape) for f in feats] == [(2, c, h, w)
                                              for c, (h, w) in zip(net.num_ch_enc, sizes)]


def _checksum(t: torch.Tensor) -> float:
    """sum(x_i * (i mod 7 + 1)) in float64, rounded once (math.fsum): each
    product of a float32 and a small integer is exact, so the sum does not
    depend on the order of the additions."""
    x = t.detach().double().flatten()
    return math.fsum((x * (torch.arange(x.numel(), dtype=torch.float64) % 7 + 1)).tolist())


# what `seeded_state_dict(seed, (0, 1, 2, 3), "cpu")` gave before the
# encoders followed the configuration: 276 keys, their order's SHA-256, and
# the SHA-256 of the tensors' checksums in that order with their sum
R18_KEYS = (276, "7259919b9a565c5d1f2a68b3ac66ea12992eae613e484f8d0c878c5ee2dc1cee")
R18_WEIGHTS = {0: ("65b9e99e1853175a809be934a720dc11a85b55bc569fbdba803e38ff64430aaa",
                   75606.78047325609),
               2 ** 40 + 3: ("018c092154ee1ca1111bd58e4aebdbbf897d2489292dce72dbae58578ff252f2",
                             76749.41260653443)}


@pytest.mark.parametrize("seed", sorted(R18_WEIGHTS))
def test_resnet18_weights_pinned(seed):
    from portbench.lib.weights import seeded_state_dict

    sd = seeded_state_dict(seed, (0, 1, 2, 3), "cpu", 18, 18)  # as the cells call it
    keys = list(sd)
    assert (len(keys), hashlib.sha256("\n".join(keys).encode()).hexdigest()) == R18_KEYS
    sums = [_checksum(t) for t in sd.values()]
    digest = hashlib.sha256(" ".join(repr(s) for s in sums).encode()).hexdigest()
    assert (digest, math.fsum(sums)) == R18_WEIGHTS[seed]


# FLOPs each cell's `mfu.*` reader counted before the encoders followed the
# configuration (ResNet-18 at the cell's own settings)
R18_FLOPS = {"adapt-kitti-seq": ("mfu.slam", 436_974_059_520),
             "pretrain-cityscapes-b18": ("mfu.pretrain", 1_869_252_526_080)}


def _flops(metric: str, settings: dict) -> float:
    import importlib.util

    from portbench.lib import spec

    path = spec.BENCH / "metrics" / f"{metric}.py"
    module_spec = importlib.util.spec_from_file_location("flops_" + metric.replace(".", "_"),
                                                         path)
    module = importlib.util.module_from_spec(module_spec)
    module_spec.loader.exec_module(module)
    count = module.frame_flops if metric == "mfu.slam" else module.step_flops
    return count(settings)


def _settings(cell: str) -> dict:
    from portbench.lib import slam_cell, spec

    c = spec.cell(cell)
    return slam_cell.settings(spec.config(c["config"]), c)


@pytest.mark.parametrize("cell", sorted(R18_FLOPS))
def test_resnet18_flops_pinned(cell):
    metric, flops = R18_FLOPS[cell]
    assert _flops(metric, _settings(cell)) == flops


def test_flops_follow_the_configuration():
    """A ResNet-50 pretraining configuration counts its own encoders: the
    step's operations more than double (1.87 to 4.01 TFLOP at batch 18)."""
    settings = _settings("pretrain-cityscapes-b18")
    settings["Pretrainer"].update(resnet_depth=50, resnet_pose=50)
    assert _flops("mfu.pretrain", settings) > 2 * R18_FLOPS["pretrain-cityscapes-b18"][1]


def test_busy_union_by_hand():
    from portbench.lib.trace import busy_union

    assert busy_union([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) == pytest.approx(4.0)
