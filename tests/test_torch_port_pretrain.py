"""The pretraining loop of the PyTorch port (`train/pretrain.py`, ImageNet
encoders, `DepthPosePrediction.train` / `validate`, `cli.pretrain`) against
the JAX package.

Both `Pretrainer`s start from the same weights: the port draws them, and the
JAX pretrainer's `init_depth_pose` is patched (test-side) to return them as
flax trees, read by the JAX package's importer of monodepth2 state dicts
(flax's own init costs ~30 s of op-by-op compiles on the CPU).  32 x 64,
scales (0, 1), batch 2, float32 networks, the plain sampler (the pretrainers'
default).  The tie-break noise is off on both sides (the JAX package's
`total_loss` is called with `rng=None`, a test-side patch).
"""
import json

import numpy as np
import pytest
import torch
import yaml

import jax

import tpuslam.train.pretrain as jax_pretrain
import tpuslam.train.steps as jax_steps
from tpuslam.checkpoint.torch_import import (_import_depth_decoder, _import_pose_decoder,
                                             _import_resnet)
from tpuslam.checkpoint.torch_import import init_encoders_from_imagenet as jax_imagenet_init
from tpuslam.checkpoint.torch_import import load_imagenet_encoders as jax_imagenet
from tpuslam.data import SyntheticDataset as JaxSynthetic
from tpuslam.models import DepthPoseNet as JaxNet
from tpuslam_torch.checkpoint.from_jax import _resnet_keys, jax_to_state_dict, load_jax_variables
from tpuslam_torch.checkpoint.io import OPTIMIZER_MISMATCH
from tpuslam_torch.checkpoint.torch_import import MISSING_WEIGHTS, load_imagenet_encoders
from tpuslam_torch.config.schema import DatasetConfig, DepthPoseConfig
from tpuslam_torch.data.synthetic import SyntheticDataset
from tpuslam_torch.models.depth_pose import init_depth_pose
from tpuslam_torch.predictor import DepthPosePrediction
from tpuslam_torch.train.pretrain import Pretrainer, batches_from

torch.set_num_threads(1)

H, W, B, SCALES = 32, 64, 2, (0, 1)
# lr 1e-5: Adam's first steps move each weight by about lr times the sign of
# its gradient, so weights whose gradient is within rounding of 0 move by lr
# either way, and the two packages' losses drift apart in proportion to lr
KW = dict(height=H, width=W, scales=SCALES, batch_size=B, scheduler_step_size=2, seed=3,
          learning_rate=1e-5)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / (np.linalg.norm(want) + 1e-12)


def _flax_variables(net):
    params, stats = {}, {}
    for enc in ("depth_encoder", "pose_encoder"):
        params[enc], stats[enc] = _import_resnet(getattr(net, enc).state_dict())
    params["depth_decoder"] = _import_depth_decoder(net.depth_decoder.state_dict())
    params["pose_decoder"] = _import_pose_decoder(net.pose_decoder.state_dict())
    return {"params": params, "batch_stats": stats}


def _port_state(trainer):
    return {k: v.detach().numpy() for k, v in trainer.state.model.state_dict().items()
            if not k.endswith("num_batches_tracked")}


def _record_steps(trainer, losses, jax_side):
    """Wrap `trainer._step` so that each step's loss is kept."""
    step = trainer._step

    def recorded(batch):
        out = step(batch)
        losses.append(float((out[1] if jax_side else out)["loss"]))
        return out

    trainer._step = recorded


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Two epochs of both pretrainers on the same 6-frame synthetic world,
    from the same weights, with each step's loss and the learning rate of
    each epoch."""
    root = tmp_path_factory.mktemp("pretrain")
    port = Pretrainer(**KW, log_path=root / "port", device="cpu")
    port.state.rng = None
    variables = _flax_variables(port.state.model)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_pretrain, "init_depth_pose",
                   lambda rng, **kw: (JaxNet(resnet_depth=kw["resnet_depth"],
                                             resnet_pose=kw["resnet_pose"],
                                             scales=kw["scales"], dtype=kw["dtype"]),
                                      variables))
        jtr = jax_pretrain.Pretrainer(**KW, log_path=root / "jax")
    # the JAX steps without their tie-break noise, as the port's
    total_loss = jax_steps.total_loss
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_steps, "total_loss", lambda *a, **k: total_loss(*a, **{**k, "rng": None}))
    losses = {"port": [], "jax": []}
    _record_steps(port, losses["port"], False)
    _record_steps(jtr, losses["jax"], True)
    lrs = {"port": [], "jax": []}
    for _ in range(2):
        port.train_epoch(SyntheticDataset(num_frames=6, height=H, width=W,
                                          do_augmentation=True), progress=False)
        jtr.train_epoch(JaxSynthetic(num_frames=6, height=H, width=W, do_augmentation=True),
                        progress=False)
        lrs["port"].append(port.state.optimizer.param_groups[0]["lr"])
        lrs["jax"].append(float(jtr.state.opt_state.hyperparams["learning_rate"]))
    yield dict(port=port, jax=jtr, losses=losses, lrs=lrs, root=root)
    mp.undo()


def test_batches_from_gives_the_same_order():
    """The same seed gives the same shuffled batches, bit for bit (the
    augmented network input and the quantised frames)."""
    kw = dict(num_frames=7, height=H, width=W, do_augmentation=True)
    got = list(batches_from(SyntheticDataset(**kw), 3, np.random.default_rng(4), device="cpu"))
    want = list(jax_pretrain.batches_from(JaxSynthetic(**kw), 3, np.random.default_rng(4)))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.rgb.numpy(), np.asarray(w.rgb))
        np.testing.assert_array_equal(g.rgb_aug.numpy(), np.asarray(w.rgb_aug))
        np.testing.assert_array_equal(g.rel_dist.numpy(), np.asarray(w.rel_dist))


def test_train_epochs_match(trained):
    """Each step's loss of two epochs (3 steps each) within 1e-4 relative,
    the parameters afterwards within 1e-3 (Adam's sign-like first steps,
    `test_torch_port_train.py`), the BN running statistics within 2e-4 (as
    one vector, after six steps of drifting weights; one step is held to
    1e-5 per element there), and the StepLR rate of each epoch: 1e-5, then
    1e-6 at step size 2.

    The statistics' bound is their measured gap: against a float64 run of
    the port's pretrainer over the same two epochs, the port's are 8.1e-5
    off and the JAX package's 1.52e-4, so the two sit 1.55e-4 apart on
    float32 rounding through Adam's steps (the parameters: 1.6e-5 and
    2.9e-5 off float64; measured on the CPU, one thread, as
    `test_pretrainers_against_float64` computes them)."""
    losses = trained["losses"]
    assert len(losses["port"]) == len(losses["jax"]) == 6
    assert _rel(losses["port"], losses["jax"]) < 1e-4
    jstate = trained["jax"].state
    want = jax_to_state_dict(jax.tree_util.tree_map(np.asarray, jstate.params),
                             jax.tree_util.tree_map(np.asarray, jstate.batch_stats))
    got = _port_state(trained["port"])
    params = [k for k in want if "running" not in k]
    assert _rel(np.concatenate([got[k].ravel() for k in params]),
                np.concatenate([want[k].ravel() for k in params])) < 1e-3
    stats = [k for k in want if "running" in k]
    assert _rel(np.concatenate([got[k].ravel() for k in stats]),
                np.concatenate([want[k].ravel() for k in stats])) < 2e-4
    assert trained["lrs"]["port"] == pytest.approx(trained["lrs"]["jax"], rel=1e-6)
    assert trained["lrs"]["port"] == pytest.approx([1e-5, 1e-6])
    assert trained["port"].epoch == 2 and trained["port"].state.step == 6


def test_validate_matches(trained, capsys):
    """`validate` over a split of two batches within 1e-4 relative; a split
    smaller than one batch is padded by cycling, with the JAX package's
    WARNING; an empty split prints its own WARNING and gives NaN."""
    port, jtr = trained["port"], trained["jax"]
    val = SyntheticDataset(num_frames=4, height=H, width=W, seed=1)
    jval = JaxSynthetic(num_frames=4, height=H, width=W, seed=1)
    assert _rel(port.validate(val), jtr.validate(jval)) < 1e-4
    capsys.readouterr()
    got = port.validate([val[0]])
    port_out = capsys.readouterr().out
    want = jtr.validate([jval[0]])
    assert port_out == capsys.readouterr().out
    assert "smaller than batch_size (2)" in port_out
    assert _rel(got, want) < 1e-4
    assert np.isnan(port.validate([]))
    assert "empty val dataset" in capsys.readouterr().out


def test_compute_depth_error_matches(trained):
    """Median-scaled depth metrics over the synthetic world's ground truth,
    computed by both packages on the same weights (the JAX pretrainer's
    after its two epochs, loaded into a port pretrainer), within 1e-4
    relative.

    Not on each package's own trained weights: after Adam's six steps those
    are 2.8e-5 apart (the port's 1.6e-5 and the JAX package's 2.9e-5 from a
    float64 run of the port's pretrainer), and the metrics amplify that:
    abs_rel moves by 1.4e-4 and sq_rel by 2.7e-4 between the packages, the
    port 4.8e-5 / 9.0e-5 above the float64 run's values and the JAX package
    9.0e-5 / 1.8e-4 below them (measured on the CPU, one thread, as
    `test_pretrainers_against_float64` computes them)."""
    jtr = trained["jax"]
    port = Pretrainer(**KW, log_path=trained["root"] / "depth_error", device="cpu")
    load_jax_variables(port.state.model, jtr.state.params, jtr.state.batch_stats)
    got = port.compute_depth_error(SyntheticDataset(num_frames=3, height=H, width=W, seed=1))
    want = jtr.compute_depth_error(JaxSynthetic(num_frames=3, height=H, width=W, seed=1))
    assert set(got) == set(want) and got
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-4, abs=1e-6), k


def test_pretrainers_against_float64(trained, tmp_path, monkeypatch):
    """Both pretrainers' two epochs against the port's pretrainer run in
    float64 over the same batches (networks, batches and images to predict
    depth on; the tie-break noise off): the parameters within 1e-4 relative
    (as one vector), the BN statistics within 1.5e-4 for the port (measured
    8.1e-5) and 3e-4 for the JAX package (measured 1.52e-4), and abs_rel
    and sq_rel within 3e-4 relative.  This is the measurement behind the
    bounds of `test_train_epochs_match` and
    `test_compute_depth_error_matches`."""
    import dataclasses

    import tpuslam_torch.train.pretrain as port_pretrain
    from tpuslam_torch.train.steps import predict_depth_step

    make_batch = port_pretrain.make_frame_batch

    def make_batch64(*args, **kwargs):
        b = make_batch(*args, **kwargs)
        rgb = {k: getattr(b, k).double() / 255 for k in ("rgb", "rgb_aug")}
        rest = {f.name: getattr(b, f.name).double() for f in dataclasses.fields(b)
                if f.name not in rgb and getattr(b, f.name) is not None}
        return dataclasses.replace(b, **rgb, **rest)

    monkeypatch.setattr(port_pretrain, "make_frame_batch", make_batch64)
    ref = Pretrainer(**KW, log_path=tmp_path, device="cpu")
    ref.state.rng = None
    ref.state.model.double()
    ref._depth = lambda image: predict_depth_step(
        ref.state.model, torch.from_numpy(np.asarray(image[None], np.float64)),
        ref.cfg.min_depth, ref.cfg.max_depth)[0]
    for _ in range(2):
        ref.train_epoch(SyntheticDataset(num_frames=6, height=H, width=W, do_augmentation=True),
                        progress=False)
    want = _port_state(ref)
    jstate = trained["jax"].state
    sides = {"port": _port_state(trained["port"]),
             "jax": jax_to_state_dict(jax.tree_util.tree_map(np.asarray, jstate.params),
                                      jax.tree_util.tree_map(np.asarray, jstate.batch_stats))}
    params = [k for k in want if "running" not in k]
    stats = [k for k in want if "running" in k]
    for name, got in sides.items():
        for keys, limit in ((params, 1e-4), (stats, 1.5e-4 if name == "port" else 3e-4)):
            err = _rel(np.concatenate([got[k].ravel() for k in keys]),
                       np.concatenate([want[k].ravel() for k in keys]))
            assert err < limit, (name, keys[0], err)
    depth64 = ref.compute_depth_error(SyntheticDataset(num_frames=3, height=H, width=W, seed=1))
    depth = {"port": trained["port"].compute_depth_error(
                 SyntheticDataset(num_frames=3, height=H, width=W, seed=1)),
             "jax": trained["jax"].compute_depth_error(
                 JaxSynthetic(num_frames=3, height=H, width=W, seed=1))}
    for name, got in depth.items():
        for k in ("abs_rel", "sq_rel"):
            assert got[k] == pytest.approx(depth64[k], rel=3e-4), (name, k)


def test_save_load_resume(trained, tmp_path):
    """save -> load restores the networks, Adam's state, the epoch and the
    step into a fresh pretrainer, which trains on from there."""
    port = trained["port"]
    port.log_path = tmp_path
    folder = port.save()
    assert yaml.safe_load((folder / "meta.yaml").read_text()) == {"epoch": 2, "step": 6}
    fresh = Pretrainer(**KW, log_path=tmp_path, device="cpu").load()
    assert fresh.epoch == 2 and fresh.state.step == 6
    want = _port_state(port)
    got = _port_state(fresh)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    opt_w, opt_g = port.state.optimizer.state_dict(), fresh.state.optimizer.state_dict()
    for i, st in opt_w["state"].items():
        for name in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(opt_g["state"][i][name], st[name]), (i, name)
    loss = fresh.train_epoch(SyntheticDataset(num_frames=4, height=H, width=W), progress=False)
    assert np.isfinite(loss) and fresh.epoch == 3 and fresh.state.step == 8


def test_fit_marks_the_best_epoch(tmp_path):
    """`fit` saves each improving epoch and records it in models/best.yaml,
    and saves the final model."""
    trainer = Pretrainer(**KW, log_path=tmp_path, device="cpu")
    data = SyntheticDataset(num_frames=4, height=H, width=W)
    trainer.fit(data, SyntheticDataset(num_frames=2, height=H, width=W, seed=1),
                num_epochs=1, depth_error=True)
    best = yaml.safe_load((tmp_path / "models" / "best.yaml").read_text())
    assert best["epoch"] == 1 and best["monitor"] == "abs_rel" and np.isfinite(best["value"])
    assert (tmp_path / "models" / "weights_001" / "model.pt").exists()


def test_jax_written_checkpoint_loads(trained, capsys):
    """A checkpoint the JAX pretrainer wrote: its params and BN statistics
    load bit for bit, its epoch too; its optax state does not become Adam
    state (a fresh optimizer, with the JAX package's mismatch line)."""
    jtr = trained["jax"]
    folder = jtr.save()
    fresh = Pretrainer(**KW, log_path=trained["root"] / "resume", device="cpu")
    capsys.readouterr()
    fresh.load(folder)
    assert OPTIMIZER_MISMATCH in capsys.readouterr().out
    assert fresh.epoch == 2 and not fresh.state.optimizer.state
    want = jax_to_state_dict(jax.tree_util.tree_map(np.asarray, jtr.state.params),
                             jax.tree_util.tree_map(np.asarray, jtr.state.batch_stats))
    got = _port_state(fresh)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_data_parallel_is_refused():
    """`dp_devices=2` outside a process group of two ranks raises a clear
    error, as the JAX package's `make_mesh` does without the devices
    (`tests/test_torch_port_parallel.py` trains inside one)."""
    with pytest.raises(ValueError, match="needs a process group of 2 ranks.*have 1"):
        Pretrainer(**KW, dp_devices=2, device="cpu")


def test_imagenet_encoders_match_jax(tmp_path):
    """A torchvision-keyed ResNet-18 state dict (random values, with its
    `fc.*` classifier) initialises both encoders as the JAX package's
    `load_imagenet_encoders` does, the pose stem repeated over the two images
    and halved; no file with `resnet_pretrained` raises FileNotFoundError
    with the JAX package's message; a stem of another shape, ValueError."""
    gen = torch.Generator().manual_seed(0)
    ref = init_depth_pose(0, device="cpu").depth_encoder.resnet.state_dict()
    state = {k: (torch.rand(v.shape, generator=gen) + 0.5 if "running_var" in k
                 else torch.randn(v.shape, generator=gen)) if v.is_floating_point() else v
             for k, v in ref.items()}
    state["fc.weight"] = torch.randn(1000, 512, generator=gen)
    state["fc.bias"] = torch.randn(1000, generator=gen)
    path = tmp_path / "resnet18.pth"
    torch.save(state, path)

    model = init_depth_pose(1, device="cpu")
    load_imagenet_encoders(model, path)
    params, stats = jax_imagenet(path)
    got = model.state_dict()
    for net in ("depth_encoder", "pose_encoder"):
        want = _resnet_keys(params[net], stats[net], f"{net}.resnet.")
        assert len(want) == sum(not k.endswith("num_batches_tracked") for k in ref)
        for k, v in want.items():
            np.testing.assert_allclose(got[k].numpy(), np.asarray(v), rtol=1e-7, atol=0,
                                       err_msg=k)
    assert torch.equal(got["pose_encoder.resnet.conv1.weight"][:, 3:],
                       got["depth_encoder.resnet.conv1.weight"] / 2)

    with pytest.raises(FileNotFoundError) as port_err:
        Pretrainer(**KW, resnet_pretrained=True, device="cpu")
    with pytest.raises(FileNotFoundError) as jax_err:
        jax_imagenet_init({}, None, required=True)
    assert str(port_err.value) == str(jax_err.value) == MISSING_WEIGHTS
    state["conv1.weight"] = torch.randn(32, 3, 7, 7, generator=gen)
    torch.save(state, path)
    with pytest.raises(ValueError, match="conv1 shape mismatch"):
        load_imagenet_encoders(model, path)


def test_predictor_train_and_validate(tmp_path, capsys):
    """`DepthPosePrediction.train` pretrains the facade's networks, encoders
    included (one epoch, its checkpoint written), and adaptation then starts
    from them; `validate` gives a finite mean loss, NaN on a split without a
    full batch; `use_wandb=True` logs each epoch's record to
    `log_path/metrics.jsonl` (wandb is not installed here: the JAX
    package's line says so).  (The JAX package's train() fails at its first epoch:
    ROADMAP Queue 3, reference traps.)"""
    cfg = DepthPoseConfig(batch_size=B, scales=SCALES, dtype="float32", log_path=tmp_path,
                          num_epochs=1, scheduler_step_size=1)
    pred = DepthPosePrediction(DatasetConfig(dataset="Synthetic", height=H, width=W), cfg,
                               device="cpu")
    before = {k: v.clone() for k, v in pred.model.state_dict().items()}
    data = SyntheticDataset(num_frames=4, height=H, width=W)
    pred.train(data, num_epochs=1)
    after = pred.model.state_dict()
    for k in ("depth_encoder.resnet.conv1.weight", "pose_encoder.resnet.layer4.1.bn2.weight",
              "depth_encoder.resnet.bn1.running_var", "pose_decoder.pose_2.weight"):
        assert not torch.equal(after[k], before[k]), k
    assert pred.epoch == 1 and pred.is_trained
    assert (tmp_path / "models" / "weights_001" / "model.pt").exists()
    assert not pred.model.depth_encoder.resnet.conv1.weight.requires_grad
    assert pred.model.depth_decoder.dispconv_0.conv.weight.requires_grad
    val = pred.validate(SyntheticDataset(num_frames=4, height=H, width=W, seed=1))
    assert np.isfinite(val)
    assert np.isnan(pred.validate([data[0]]))
    capsys.readouterr()
    pred.train(data, num_epochs=1, use_wandb=True)
    assert "metrics: wandb requested but not installed; JSONL only" in capsys.readouterr().out
    records = [json.loads(line) for line in
               (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [r["epoch"] for r in records] == [1] and np.isfinite(records[0]["training_loss"])


def test_cli_pretrain_writes_checkpoints(tmp_path, capsys):
    """`python -m tpuslam_torch.cli.pretrain --device cpu` on a 32 x 64
    synthetic YAML for one epoch writes its checkpoint folder and
    models/best.yaml."""
    from tpuslam_torch.cli import pretrain

    cfg = {
        "Dataset": {"dataset": "Synthetic", "height": H, "width": W, "num_frames": 4},
        "DepthPosePrediction": {"batch_size": B, "scales": list(SCALES), "dtype": "float32",
                                "log_path": str(tmp_path / "log"), "num_epochs": 3},
    }
    path = tmp_path / "pretrain.yaml"
    path.write_text(yaml.safe_dump(cfg))
    assert pretrain.main(["--config", str(path), "--epochs", "1", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "pretrain: 4 train samples, dp=1" in out and "epoch=1" in out
    models = tmp_path / "log" / "models"
    assert (models / "weights_001" / "model.pt").exists()
    assert yaml.safe_load((models / "best.yaml").read_text())["epoch"] == 1
