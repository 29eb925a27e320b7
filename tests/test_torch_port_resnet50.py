"""monodepth2's ResNet-50 depth and pose networks in the port, held to the
benchmark's plain-torch reference (`portbench/reference`), which the JAX
package cannot be: it holds ResNet-18 and 34 only.

One seeded state dict (`portbench.lib.weights.seeded_state_dict`, with the
batch-norm statistics and affine terms drawn as well, so that eval mode
normalises) loads into the port's `DepthPoseNet(50, 50)` and the reference's
`DepthPoseNet(resnet=50)`: their keys, shapes and torchvision's published
parameter counts; the forward at 64 x 192, batch 2, in float64 and float32;
one pretraining `train_step` in float64 against the reference's step (loss,
every leaf's gradient, the batch-norm running statistics); `Slam`,
`cli.pretrain` and the `DepthPosePrediction` facade at ResNet-50; the flax
loader's refusal; torchvision- and monodepth2-named checkpoints with the
Bottleneck's `conv3` / `bn3`, made here from seeds (nothing is downloaded).
"""
import dataclasses

import numpy as np
import pytest
import torch
import yaml

from portbench.lib.weights import seeded_state_dict
from portbench.reference import loss as ref_loss
from portbench.reference import nets as ref_nets
from portbench.reference import steps as ref_steps
from tpuslam_torch.checkpoint.from_jax import load_jax_variables
from tpuslam_torch.checkpoint.torch_import import load_imagenet_encoders
from tpuslam_torch.config import Config
from tpuslam_torch.config.schema import DatasetConfig, DepthPoseConfig, SlamConfig
from tpuslam_torch.data.synthetic import SyntheticDataset
from tpuslam_torch.models.depth_pose import DepthPoseNet
from tpuslam_torch.predictor import DepthPosePrediction
from tpuslam_torch.slam import Slam
from tpuslam_torch.train.batch import make_frame_batch
from tpuslam_torch.train.state import make_pretrain_optimizer, make_train_state
from tpuslam_torch.train.steps import LossConfig, train_step

torch.set_num_threads(2)

H, W, B = 64, 192, 2
SCALES = (0, 1, 2, 3)
# torchvision's resnet50 without `fc`, with a 3- and a 6-channel stem
DEPTH_TRUNK, POSE_TRUNK = 23_508_032, 23_517_440


def _rel(got, want) -> float:
    got, want = torch.as_tensor(got).double(), torch.as_tensor(want).double()
    return float((got - want).norm() / want.norm().clamp_min(1e-300))


@pytest.fixture(scope="module")
def weights():
    """Seeded weights at ResNet-50, batch-norm terms drawn away from the
    identity."""
    sd = seeded_state_dict(11, SCALES, "cpu", 50, 50)
    gen = torch.Generator().manual_seed(12)
    for bn in [k[:-len(".running_var")] for k in sd if k.endswith(".running_var")]:
        for name, lo, scale in (("weight", 0.5, 1.0), ("running_var", 0.5, 1.0),
                                ("bias", None, 0.1), ("running_mean", None, 0.1)):
            shape = sd[f"{bn}.{name}"].shape
            sd[f"{bn}.{name}"] = (lo + torch.rand(shape, generator=gen) if lo is not None
                                  else scale * torch.randn(shape, generator=gen))
    return sd


def _pair(sd, dtype):
    port, ref = DepthPoseNet(50, 50, SCALES), ref_nets.DepthPoseNet(SCALES, 50, resnet_pose=50)
    port.load_state_dict(sd)
    ref.load_state_dict(sd)
    return port.to(dtype).eval(), ref.to(dtype).eval()


def test_keys_shapes_and_published_counts(weights):
    """The port's state dict has the reference's keys, in its order and at
    its shapes (torchvision's names, `conv3` / `bn3` included); each trunk
    has torchvision's published parameter count; the pooled feature and the
    pose squeeze are 2048 wide; the decoders take the encoder's widths."""
    port, ref = _pair(weights, torch.float32)
    got, want = port.state_dict(), ref.state_dict()
    assert list(got) == list(want)
    assert all(got[k].shape == want[k].shape for k in got)
    assert "depth_encoder.resnet.layer4.2.conv3.weight" in got
    assert "pose_encoder.resnet.layer1.0.bn3.running_var" in got
    counts = {net: sum(p.numel() for p in getattr(port, net).parameters())
              for net in ("depth_encoder", "pose_encoder")}
    assert counts == {"depth_encoder": DEPTH_TRUNK, "pose_encoder": POSE_TRUNK}
    assert port.depth_encoder.num_ch_encoder == (64, 256, 512, 1024, 2048)
    assert port.pose_decoder.squeeze.in_channels == 2048
    assert port.depth_decoder.upconv_4_0.conv.conv.in_channels == 2048
    assert port.depth_decoder.upconv_2_1.conv.conv.in_channels == 64 + 256
    # ResNet-18 keeps its widths, and a mixed pair takes each encoder's own
    mixed = DepthPoseNet(18, 50)
    assert mixed.depth_decoder.upconv_4_0.conv.conv.in_channels == 512
    assert mixed.pose_decoder.squeeze.in_channels == 2048


# float32: the same operations in the same order as the reference on this
# CPU, so equal up to the order that a library may pick for a reduction;
# 1e-5 is the float32 budget of a 50-layer forward (about 100 rounding steps
# of 6e-8, amplified by the decoder's sigmoid and the pose head's 0.01)
FORWARD_TOL = {torch.float64: 1e-10, torch.float32: 1e-5}


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_forward_matches_reference(weights, dtype):
    """Disparities at every scale, the pose of the first pair and the pooled
    2048-d feature, eval mode, within `FORWARD_TOL` relative."""
    port, ref = _pair(weights, dtype)
    gen = torch.Generator().manual_seed(13)
    image = torch.rand(B, H, W, 3, generator=gen, dtype=dtype)
    pairs = torch.rand(B, H, W, 6, generator=gen, dtype=dtype)
    with torch.no_grad():
        disps, feat = port.depth_forward(image)
        feats = ref.depth_encoder(image)
        ref_disps = ref.depth_decoder(feats)
        aa, tr = port.pose_forward(pairs)
        ref_aa, ref_tr = ref.pose_decoder(ref.pose_encoder(pairs)[-1])
    assert feat.shape == (B, 2048) and feat.dtype == dtype
    tol = FORWARD_TOL[dtype]
    for s in SCALES:
        assert _rel(disps[("disp", s)], ref_disps[s]) < tol, s
    assert _rel(feat, feats[-1].mean((2, 3))) < tol
    assert _rel(aa, ref_aa) < tol and _rel(tr, ref_tr) < tol
    # not saturated: the comparison is of numbers that move
    assert 0.05 < float(disps[("disp", 0)].min()) < float(disps[("disp", 0)].max()) < 0.95


def _batch():
    """Frame triplets of the synthetic world, jittered, at 64 x 192."""
    ds = SyntheticDataset(num_frames=B + 1, height=H, width=W, do_augmentation=True)
    samples = [ds[i] for i in range(B)]
    return make_frame_batch(np.stack([s.rgb for s in samples]), ds.K,
                            np.stack([s.rel_dist for s in samples]),
                            rgb_aug=np.stack([s.aug for s in samples]), device="cpu")


def test_train_step_matches_reference_in_float64(weights, monkeypatch):
    """One pretraining `train_step` (batch norm in train mode, the pose
    encoder's statistics over the 2B pairs, Adam over every leaf) against
    the reference's step, both in float64 from the same weights, images and
    tie-break generator.  Measured on this CPU: the losses 1.3e-15 apart
    (relative), each leaf's gradient at most 4.4e-12 of its norm, the
    running statistics 8.5e-14; the bounds are 1e-12, 1e-10 and 1e-11, far
    below a float32 step's (about 1e-7 on the loss).  Every leaf has a
    gradient above 1e-3 of the median leaf's, so each comparison reads
    one."""
    b = _batch()
    to64 = {f.name: getattr(b, f.name).double() for f in dataclasses.fields(b)
            if getattr(b, f.name) is not None and getattr(b, f.name).is_floating_point()}
    batch = dataclasses.replace(b, rgb=b.rgb.double() / 255, rgb_aug=b.rgb_aug.double() / 255,
                                **{k: v for k, v in to64.items() if k not in ("rgb", "rgb_aug")})
    # the inverse intrinsics in float64, as the reference takes them (the
    # batch's were inverted in float32)
    batch = dataclasses.replace(batch, inv_K=torch.linalg.inv(batch.K))
    port, ref = _pair(weights, torch.float64)
    state = make_train_state(port, make_pretrain_optimizer(port, 1e-4), seed=42)
    cfg = LossConfig(scales=SCALES, use_pallas_warp=False, pallas_bf16_out=False,
                     bf16_networks=False)
    losses = train_step(state, cfg, batch)

    # the reference's frame() reads images as float32: here it keeps float64
    def frame64(rgb, frame_id):
        return rgb[:, ref_loss.FRAMES.index(frame_id)]

    monkeypatch.setattr(ref_loss, "frame", frame64)
    monkeypatch.setattr(ref_steps, "frame", frame64)
    params = dict(ref.named_parameters())
    opt = ref_steps.Adam(list(params.values()), 1e-4)
    want = ref_steps.train_step(ref, opt, {"rgb": batch.rgb, "rgb_aug": batch.rgb_aug,
                                           "K": batch.K, "rel_dist": batch.rel_dist,
                                           "weights": batch.weights},
                                {"scales": SCALES, "min_depth": 0.1, "max_depth": None,
                                 "disparity_smoothness": 1e-3, "velocity_loss_scaling": 0.05},
                                torch.Generator().manual_seed(42))
    for k in ("loss", "depth_loss", "velocity_loss"):
        assert _rel(losses[k], want[k]) < 1e-12, k
    # the reference's Adam starts from zero moments: m = 0.1 g after a step
    ref_grads = {n: m / 0.1 for n, m in zip(params, opt.m)}
    median = float(np.median([float(g.norm()) for g in ref_grads.values()]))
    got = dict(port.named_parameters())
    assert set(got) == set(ref_grads)
    for n, g in ref_grads.items():
        assert float(g.norm()) > 1e-3 * median, n
        assert float((got[n].grad - g).norm()) <= 1e-10 * float(g.norm()), n
    stats = [n for n in ref.state_dict() if n.endswith(("running_mean", "running_var"))]
    assert len(stats) == 2 * 2 * 53  # two encoders, 53 batch norms each in ResNet-50
    ref_state, port_state = ref.state_dict(), port.state_dict()
    for n in stats:
        assert float((port_state[n] - ref_state[n]).abs().max()) < 1e-11, n
        assert not torch.equal(port_state[n], weights[n].double()), n


def test_slam_adapts_with_a_2048_wide_index(tmp_path):
    """`Slam` with `resnet_depth: 50`, loop closure on and `pipeline_depth:
    1` adapts 3 frames; the loop-closure index, the replay embeddings and
    the packed read-back are 2048 wide."""
    cfg = Config()
    cfg.dataset = DatasetConfig(dataset="Synthetic", height=H, width=W, num_frames=6)
    cfg.depth_pose = DepthPoseConfig(log_path=str(tmp_path), batch_size=3, dtype="float32",
                                     resnet_depth=50, resnet_pose=50)
    cfg.slam = SlamConfig(adaptation=True, adaptation_epochs=1, pipeline_depth=1,
                          do_loop_closures=True, plot_frequency=0)
    slam = Slam(cfg, device="cpu")
    assert slam.model.depth_encoder.num_layers == 50
    for _ in range(3):
        slam.step()
    slam.flush_pipeline()
    index = slam.loop_closure_detection.index
    assert index.dim == 2048 and index.ntotal == 3
    assert len(slam.depth_loss) == 3 and np.all(np.isfinite(slam.depth_loss))
    assert np.all(np.isfinite(np.stack(slam.pose_graph.get_all_poses())))


def test_cli_pretrain_trains_resnet50(tmp_path, capsys):
    """`cli.pretrain` with `resnet_depth: 50` and `resnet_pose: 50` trains an
    epoch at 32 x 64 and writes a checkpoint that loads into a
    `DepthPoseNet(50, 50)` and moves its encoders."""
    from tpuslam_torch.checkpoint.io import load_checkpoint
    from tpuslam_torch.cli import pretrain

    cfg = {
        "Dataset": {"dataset": "Synthetic", "height": 32, "width": 64, "num_frames": 4},
        "DepthPosePrediction": {"batch_size": 2, "scales": [0, 1], "dtype": "float32",
                                "log_path": str(tmp_path / "log"), "num_epochs": 1,
                                "resnet_depth": 50, "resnet_pose": 50},
    }
    path = tmp_path / "pretrain.yaml"
    path.write_text(yaml.safe_dump(cfg))
    assert pretrain.main(["--config", str(path), "--epochs", "1", "--device", "cpu"]) == 0
    assert "epoch=1" in capsys.readouterr().out
    model = DepthPoseNet(50, 50, (0, 1))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    load_checkpoint(tmp_path / "log" / "models" / "weights_001", model)
    after = model.state_dict()
    for k in ("depth_encoder.resnet.layer4.2.conv3.weight",
              "pose_encoder.resnet.layer1.0.bn3.running_var"):
        assert not torch.equal(after[k], before[k]), k


def test_flax_loader_refuses_resnet50():
    """The JAX package has no ResNet-50: `load_jax_variables` refuses a
    model with such an encoder, naming it, before it reads a variable."""
    with pytest.raises(ValueError, match="depth_encoder is a ResNet-50"):
        load_jax_variables(DepthPoseNet(50, 50), {}, {})
    with pytest.raises(ValueError, match="pose_encoder is a ResNet-50"):
        load_jax_variables(DepthPoseNet(18, 50), {}, {})


def _torchvision_resnet50(seed: int) -> dict:
    """A state dict with torchvision's `resnet50` keys and shapes (`fc`
    included), drawn from `seed`."""
    gen = torch.Generator().manual_seed(seed)
    trunk = ref_nets.ResNetEncoder(50, 1).resnet.state_dict()
    state = {k: (torch.rand(v.shape, generator=gen) + 0.5 if "running_var" in k
                 else torch.randn(v.shape, generator=gen)) if v.is_floating_point() else v
             for k, v in trunk.items()}
    state["fc.weight"] = torch.randn(1000, 2048, generator=gen)
    state["fc.bias"] = torch.randn(1000, generator=gen)
    return state


def test_imagenet_resnet50_loads(tmp_path):
    """A torchvision-named `resnet50` `.pth` initialises both encoders, the
    Bottleneck's `conv3` / `bn3` included, the pose stem repeated over the
    two images and halved; a ResNet-18 file on ResNet-50 encoders raises
    ValueError naming the depth."""
    state = _torchvision_resnet50(14)
    torch.save(state, tmp_path / "resnet50.pth")
    model = DepthPoseNet(50, 50)
    load_imagenet_encoders(model, tmp_path / "resnet50.pth")
    got = model.state_dict()
    for k, v in state.items():
        if k.startswith("fc.") or k == "conv1.weight":
            continue
        for net in ("depth_encoder", "pose_encoder"):
            assert torch.equal(got[f"{net}.resnet.{k}"], v), (net, k)
    assert torch.equal(got["depth_encoder.resnet.conv1.weight"], state["conv1.weight"])
    assert torch.equal(got["pose_encoder.resnet.conv1.weight"],
                       torch.cat([state["conv1.weight"]] * 2, 1) / 2)
    r18 = {k[len("resnet."):]: v for k, v in DepthPoseNet(18, 18).depth_encoder.state_dict().items()}
    torch.save(r18, tmp_path / "resnet18.pth")
    with pytest.raises(ValueError, match="ResNet-50"):
        load_imagenet_encoders(model, tmp_path / "resnet18.pth")


def test_predictor_loads_a_monodepth2_resnet50_checkpoint(tmp_path):
    """`DepthPosePrediction` with `resnet_depth: 50` builds its networks at
    that depth and loads the four monodepth2 `.pth` files of a ResNet-50
    model (the pose encoder's keys without `resnet.`, options beside the
    weights); depth and pose then come from those weights."""
    other = DepthPoseNet(50, 50, (0, 1))
    other.load_state_dict(_drawn(other.state_dict(), 15))
    for net in ("depth_encoder", "pose_encoder", "depth_decoder", "pose_decoder"):
        state = getattr(other, net).state_dict()
        if net == "pose_encoder":
            state = {k[len("resnet."):]: v for k, v in state.items()}
        if net == "depth_encoder":
            state = dict(state, height=32, width=64, use_stereo=False)
        torch.save(state, tmp_path / f"{net}.pth")
    cfg = DepthPoseConfig(batch_size=2, scales=[0, 1], dtype="float32",
                          log_path=str(tmp_path / "log"), resnet_depth=50, resnet_pose=50)
    pred = DepthPosePrediction(DatasetConfig(dataset="Synthetic", height=32, width=64), cfg,
                               device="cpu")
    pred.load_reference_checkpoint(tmp_path)
    assert pred.is_trained
    torch.testing.assert_close(pred.model.state_dict(), other.state_dict(), rtol=0, atol=0)
    image = np.random.default_rng(16).random((32, 64, 3), dtype=np.float32)
    depth = pred.predict_from_image(image)
    assert np.all(np.isfinite(depth)) and np.ptp(depth) > 0
    T = pred.predict_pose(image, image[::-1].copy())[0]
    assert np.all(np.isfinite(T)) and not np.allclose(T, np.eye(4))


def _drawn(state: dict, seed: int) -> dict:
    gen = torch.Generator().manual_seed(seed)
    return {k: (torch.rand(v.shape, generator=gen) + 0.5 if "running_var" in k
                else 0.05 * torch.randn(v.shape, generator=gen)) if v.is_floating_point() else v
            for k, v in state.items()}
