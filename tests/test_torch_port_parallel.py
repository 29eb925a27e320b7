"""Data-parallel pretraining of the PyTorch port (`tpuslam_torch.parallel`,
`Pretrainer(dp_devices=2)`, `cli.pretrain --dp 2`) against the port's own
single-process `train_step` on the whole batch, as `tests/test_parallel.py`
holds the JAX package's sharded step against its single-device one.

Two ranks of a gloo process group, each a process started with
`torch.multiprocessing` on the CPU, at 32 x 64, scales (0, 1), a global
batch of 4 (2 a rank), float32 networks.  The ranks write what they saw to
`.npz` files; the single-process references run in the test process.
"""
import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
import yaml

from tpuslam_torch.data.synthetic import SyntheticDataset
from tpuslam_torch.losses import photometric
from tpuslam_torch.models.depth_pose import init_depth_pose
from tpuslam_torch.models.resnet import BatchNorm
from tpuslam_torch.parallel import (local_init_method, make_dp_train_step, make_process_group,
                                    shard_batch)
from tpuslam_torch.train.batch import make_frame_batch
from tpuslam_torch.train.pretrain import Pretrainer
from tpuslam_torch.train.state import make_pretrain_optimizer, make_train_state
from tpuslam_torch.train.steps import LossConfig, train_step

torch.set_num_threads(1)

WORLD, H, W, B = 2, 32, 64, 4
CFG = LossConfig(scales=(0, 1), pallas_bf16_out=False, bf16_networks=False)
LR = 1e-5  # Adam's first steps move a weight by ~lr whatever its gradient
KW = dict(height=H, width=W, scales=(0, 1), batch_size=B, scheduler_step_size=2, seed=3,
          learning_rate=LR)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / (np.linalg.norm(want) + 1e-12)


def _batch():
    ds = SyntheticDataset(num_frames=B + 1, height=H, width=W, do_augmentation=True)
    samples = [ds[i] for i in range(B)]
    return make_frame_batch(np.stack([s.rgb for s in samples]), ds.K,
                            np.stack([s.rel_dist for s in samples]),
                            rgb_aug=np.stack([s.aug for s in samples]), device="cpu")


def _bn_inputs():
    rng = np.random.default_rng(7)
    x = rng.normal(1.0, 2.0, size=(B, 8, 6, 10)).astype(np.float32)
    dy = rng.normal(size=x.shape).astype(np.float32)
    weight, bias = rng.uniform(0.5, 1.5, 8), rng.normal(size=8)
    bn = BatchNorm(8)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(weight))
        bn.bias.copy_(torch.from_numpy(bias))
    return torch.from_numpy(x), torch.from_numpy(dy), bn.train()


def _bn_pass(bn, x, dy):
    x = x.clone().requires_grad_(True)
    y = bn(x)
    y.backward(dy)
    return dict(y=y.detach().numpy(), dx=x.grad.numpy(), dweight=bn.weight.grad.numpy(),
                dbias=bn.bias.grad.numpy(), mean=bn.running_mean.numpy(),
                var=bn.running_var.numpy())


def _state(seed):
    model = init_depth_pose(0, scales=(0, 1), device="cpu")
    # a pose head bias of a few px of motion: at random init the poses are
    # ~0 and every warp coordinate sits on a tap boundary
    bias = model.pose_decoder.pose_2.bias
    with torch.no_grad():
        bias.copy_(torch.from_numpy(
            np.random.default_rng(5).normal(scale=0.5, size=bias.shape).astype(np.float32)))
    model.requires_grad_(True)
    return make_train_state(model, make_pretrain_optimizer(model, LR), seed=seed)


def _two_steps(step, state, batch):
    """Losses, gradients and BN statistics after one step; parameters after two."""
    losses = step(state, batch)
    out = {f"loss/{k}": v.numpy() for k, v in losses.items()}
    for k, p in state.model.named_parameters():
        out[f"grad/{k}"] = (torch.zeros_like(p) if p.grad is None else p.grad).numpy().copy()
    for k, v in state.model.state_dict().items():
        if "running" in k:
            out[f"stat/{k}"] = v.numpy().copy()
    step(state, batch)
    for k, p in state.model.named_parameters():
        out[f"param/{k}"] = p.detach().numpy().copy()
    return out


def _patched_identity(identity):
    """`identity_reprojection` replaced by a decisive candidate, as in
    `test_torch_port_train.py`: -1 where a rounding difference could flip
    the per-pixel min (a near-tie or a tap boundary), 10 elsewhere."""
    mp_ = pytest.MonkeyPatch()
    mp_.setattr(photometric, "identity_reprojection",
                lambda inputs, frame_ids=(0, -1, 1): torch.from_numpy(identity))
    return mp_


def _rank(rank, init_method, out_dir, identity):
    """One rank: the sync-BN layer on its half of a batch, two data-parallel
    steps with the tie-break noise on and off, and one epoch of a
    `Pretrainer(dp_devices=2)`; then, with the group destroyed, one epoch
    of a `Pretrainer(dp_devices=1)` on the same networks."""
    torch.set_num_threads(1)
    make_process_group(WORLD, rank, "cpu", init_method)
    try:
        x, dy, bn = _bn_inputs()
        bn.process_group = dist.group.WORLD
        half = slice(rank * B // WORLD, (rank + 1) * B // WORLD)
        out = {f"bn/{k}": v for k, v in _bn_pass(bn, x[half], dy[half]).items()}
        shard = shard_batch(_batch(), rank, WORLD)
        patch = _patched_identity(np.ascontiguousarray(identity[half]))
        for name, seed in (("noise", 3), ("plain", None)):
            state = _state(seed)
            step = make_dp_train_step(state.model, CFG)
            out.update({f"{name}/{k}": v for k, v in _two_steps(step, state, shard).items()})
        patch.undo()
        trainer = Pretrainer(**KW, dp_devices=WORLD, log_path=out_dir / f"log{rank}",
                             device="cpu")
        out["pretrainer/losses"] = np.asarray(_epoch_losses(trainer))
        out["pretrainer/saved"] = np.asarray(trainer.save() is not None)
    finally:
        dist.destroy_process_group()
    model = trainer.state.model
    out["alone/synced"] = np.asarray([m.process_group is not None for m in model.modules()
                                      if isinstance(m, BatchNorm)])
    out.update({f"trained/{k}": v.numpy().copy() for k, v in model.state_dict().items()})
    alone = Pretrainer(**KW, log_path=out_dir / f"alone{rank}", device="cpu", model=model)
    out["alone/losses"] = np.asarray(_epoch_losses(alone))
    np.savez(out_dir / f"rank{rank}.npz", **out)


def _epoch_losses(trainer):
    losses, step = [], trainer._step

    def recorded(batch):
        out = step(batch)
        losses.append(float(out["loss"]))
        return out

    trainer._step = recorded
    trainer.train_epoch(SyntheticDataset(num_frames=3 * B, height=H, width=W,
                                         do_augmentation=True), progress=False)
    return losses


@pytest.fixture(scope="module")
def identity():
    from test_torch_port_train import _decisive_identity

    return _decisive_identity(_state(None).model, _batch(), CFG)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, identity):
    out_dir = tmp_path_factory.mktemp("dp")
    mp.spawn(_rank, args=(local_init_method(), out_dir, identity), nprocs=WORLD)
    return [dict(np.load(out_dir / f"rank{r}.npz")) for r in range(WORLD)]


@pytest.fixture(scope="module")
def single(identity):
    """The single-process `train_step` on the whole batch, noise on and off."""
    batch = _batch()
    patch = _patched_identity(identity)
    try:
        return {name: _two_steps(lambda st, b: train_step(st, CFG, b), _state(seed), batch)
                for name, seed in (("noise", 3), ("plain", None))}
    finally:
        patch.undo()


def _nets(d, prefix):
    nets = {}
    for k, v in d.items():
        if k.startswith(prefix):
            nets.setdefault(k[len(prefix):].split(".")[0], []).append(v.ravel())
    return {net: np.concatenate(v) for net, v in nets.items()}


def test_sync_batch_norm_matches_batch_norm(ranks):
    """The sync-BN forward and backward on two halves of a batch against one
    `BatchNorm` on the whole batch: outputs and input gradients within 1e-6,
    the scale and bias gradients summed over the ranks within 1e-5 relative,
    and the running statistics (flax's rule, biased variance) within 1e-6 on
    both ranks."""
    x, dy, bn = _bn_inputs()
    want = _bn_pass(bn, x, dy)
    for k in ("y", "dx"):
        got = np.concatenate([r[f"bn/{k}"] for r in ranks])
        np.testing.assert_allclose(got, want[k], rtol=0, atol=1e-6, err_msg=k)
    for k in ("dweight", "dbias"):
        assert _rel(sum(r[f"bn/{k}"] for r in ranks), want[k]) < 1e-5, k
    for r in ranks:
        for k in ("mean", "var"):
            np.testing.assert_allclose(r[f"bn/{k}"], want[k], rtol=0, atol=1e-6, err_msg=k)


def test_dp_step_matches_train_step(ranks, single):
    """Two ranks against the single-process step on the whole batch, the
    tie-break noise on (both ranks draw it from generators in one state):
    every loss within 1e-6 relative, each network's gradient within
    `GRAD_TOL`, the BN running statistics (as one vector) within 1e-6, the
    parameters after two Adam steps within `PARAMS_TOL`; both ranks hold the
    same gradients, statistics and parameters, bit for bit."""
    want = single["noise"]
    for r in ranks:
        got = {k[len("noise/"):]: v for k, v in r.items() if k.startswith("noise/")}
        assert set(got) == set(want)
        for k in want:
            if k.startswith("loss/"):
                assert _rel(got[k], want[k]) < 1e-6, k
        stats = sorted(k for k in want if k.startswith("stat/"))
        assert _rel(np.concatenate([got[k].ravel() for k in stats]),
                    np.concatenate([want[k].ravel() for k in stats])) < 1e-6
        g, w = _nets(got, "grad/"), _nets(want, "grad/")
        for net, limit in GRAD_TOL.items():
            assert _rel(g[net], w[net]) < limit, (net, _rel(g[net], w[net]))
        p, q = _nets(got, "param/"), _nets(want, "param/")
        for net in p:
            assert _rel(p[net], q[net]) < PARAMS_TOL, (net, _rel(p[net], q[net]))
    for k, v in ranks[0].items():
        if k.startswith(("noise/grad", "noise/stat", "noise/param")):
            np.testing.assert_array_equal(ranks[1][k], v, err_msg=k)


# Relative error allowed for each network's gradient (all its parameters as
# one vector), between the data-parallel and the single-process step and
# between either and the float64 step (`test_dp_gradients_against_float64`).
# Sync-BN sums in another order than one process's batch norm, and its
# rounding is amplified through the network (most in the deep encoder
# layers, over a few values per channel): measured from float64
# (data-parallel / single-process) 7.5e-6 / 2.9e-6 for the depth decoder,
# 7.7e-6 / 8.8e-6 for the pose decoder, 1.1e-5 / 1.4e-5 for the depth
# encoder and 1.4e-5 / 2.2e-5 for the pose encoder, so that the two steps
# differ by up to 1.16e-5 (the pose decoder) on rounding alone.
GRAD_TOL = {"depth_decoder": 3e-5, "pose_decoder": 3e-5, "depth_encoder": 1e-4,
            "pose_encoder": 1e-4}
# Parameters after two Adam steps at lr 1e-5 (each network as one vector): a
# weight whose gradient is within rounding of 0 moves by ~lr either way,
# which the decisive identity candidate keeps rare; measured <= 2.7e-7.
PARAMS_TOL = 1e-5


def test_dp_gradients_against_float64(ranks, single, identity):
    """Both float32 steps, data-parallel and single-process, the noise off,
    against the single-process step run in float64 end to end: each
    network's gradient within the bound the two float32 steps are held to,
    so that the bound is float32 rounding and not a difference of the
    data-parallel step."""
    batch = _batch()
    to64 = {f.name: getattr(batch, f.name).double() for f in dataclasses.fields(batch)
            if getattr(batch, f.name) is not None and getattr(batch, f.name).is_floating_point()}
    batch = dataclasses.replace(batch, rgb=batch.rgb.double() / 255,
                                rgb_aug=batch.rgb_aug.double() / 255,
                                **{k: v for k, v in to64.items() if k not in ("rgb", "rgb_aug")})
    state = _state(None)
    state.model.double()
    patch = _patched_identity(identity.astype(np.float64))
    try:
        train_step(state, CFG._replace(use_pallas_warp=False), batch)  # K1 takes float32 only
    finally:
        patch.undo()
    want = _nets({f"grad/{k}": (torch.zeros_like(p) if p.grad is None else p.grad).numpy()
                  for k, p in state.model.named_parameters()}, "grad/")
    for name, side in (("dp", {k[len("plain/"):]: v for k, v in ranks[0].items()
                               if k.startswith("plain/")}),
                       ("single", single["plain"])):
        got = _nets(side, "grad/")
        for net, limit in GRAD_TOL.items():
            assert _rel(got[net], want[net]) < limit, (name, net, _rel(got[net], want[net]))


def test_pretrainer_dp_matches_single_process(ranks, tmp_path):
    """`Pretrainer(dp_devices=2)` trains one epoch (3 steps) with the same
    step losses as `dp_devices=1` within 1e-5 relative, on both ranks; only
    rank 0 saves."""
    trainer = Pretrainer(**KW, log_path=tmp_path, device="cpu")
    want = _epoch_losses(trainer)
    assert len(want) == 3
    for r in ranks:
        assert _rel(r["pretrainer/losses"], want) < 1e-5
    assert ranks[0]["pretrainer/saved"] and not ranks[1]["pretrainer/saved"]


def test_networks_train_alone_after_dp(ranks, tmp_path):
    """Once the process group is destroyed, the networks a
    `Pretrainer(dp_devices=2)` trained carry no process group in any batch
    norm, and a `Pretrainer(dp_devices=1)` trains them on (one epoch) with
    the step losses of a pretrainer in this process given the same
    weights, within 1e-6 relative, on both ranks."""
    for r in ranks:
        assert r["alone/synced"].size and not r["alone/synced"].any()
        model = init_depth_pose(0, scales=(0, 1), device="cpu")
        model.load_state_dict({k[len("trained/"):]: torch.from_numpy(v)
                               for k, v in r.items() if k.startswith("trained/")})
        want = _epoch_losses(Pretrainer(**KW, log_path=tmp_path, device="cpu", model=model))
        assert _rel(r["alone/losses"], want) < 1e-6, _rel(r["alone/losses"], want)


def test_cli_pretrain_dp_writes_from_rank_zero(tmp_path, capfd):
    """`cli.pretrain --dp 2 --device cpu` starts two ranks over gloo; one
    rank prints the JAX package's `dp=` line and the epoch's record, and
    the checkpoint and models/best.yaml are written."""
    from tpuslam_torch.cli import pretrain

    cfg = {
        "Dataset": {"dataset": "Synthetic", "height": H, "width": W, "num_frames": 4},
        "DepthPosePrediction": {"batch_size": B, "scales": [0, 1], "dtype": "float32",
                                "log_path": str(tmp_path / "log"), "num_epochs": 3},
    }
    path = tmp_path / "pretrain.yaml"
    path.write_text(yaml.safe_dump(cfg))
    assert pretrain.main(["--config", str(path), "--epochs", "1", "--dp", "2",
                          "--device", "cpu"]) == 0
    out = capfd.readouterr().out
    assert out.count("pretrain: 4 train samples, dp=2") == 1
    assert out.count("epoch=1 training_loss=") == 1
    assert (tmp_path / "log" / "models" / "weights_001" / "model.pt").exists()
    assert yaml.safe_load((tmp_path / "log" / "models" / "best.yaml").read_text())["epoch"] == 1
