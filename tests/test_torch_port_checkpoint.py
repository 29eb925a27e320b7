"""Checkpoints of the PyTorch port against the JAX package's.

A folder that the JAX package's `save_checkpoint` wrote (flax msgpack) loads
into the port bit for bit; the port's msgpack reader decodes what the
`msgpack` package and flax encode; the port's own checkpoints (model and
Adam state) round-trip exactly; and the folder helpers (`latest_checkpoint`,
`best.yaml`) and the messages for a missing folder are the JAX package's.
The JAX variables are made from the port's random networks through the JAX
package's import of reference `.pth` files, which avoids a flax init.
"""
import msgpack
import numpy as np
import optax
import pytest
import torch
import yaml
from flax import serialization
from hypothesis import given, settings
from hypothesis import strategies as st

from tpuslam.checkpoint.io import save_checkpoint as jax_save_checkpoint
from tpuslam.checkpoint.torch_import import import_reference_checkpoint
from tpuslam_torch.checkpoint import io
from tpuslam_torch.checkpoint.from_jax import jax_to_state_dict
from tpuslam_torch.checkpoint.msgpack_reader import loads
from tpuslam_torch.config import Config
from tpuslam_torch.config.schema import DatasetConfig, DepthPoseConfig, SlamConfig
from tpuslam_torch.models.depth_pose import init_depth_pose
from tpuslam_torch.predictor import DepthPosePrediction
from tpuslam_torch.slam import Slam
from tpuslam_torch.train.state import make_adapt_optimizer

torch.set_num_threads(1)

NETS = ("depth_encoder", "pose_encoder", "depth_decoder", "pose_decoder")


def _jax_variables(tmp_path, seed=3):
    """Flax (params, batch_stats) of the port's networks drawn from `seed`."""
    model = init_depth_pose(seed, device="cpu")
    folder = tmp_path / f"reference_{seed}"
    folder.mkdir()
    for net in NETS:
        torch.save(getattr(model, net).state_dict(), folder / f"{net}.pth")
    return import_reference_checkpoint(folder)


def _fresh():
    model = init_depth_pose(0, device="cpu")
    model.requires_grad_(False)
    model.depth_decoder.requires_grad_(True)
    model.pose_decoder.requires_grad_(True)
    return model, make_adapt_optimizer(model, 1e-4, 0.5)


def _adam_steps(model, opt, n=2):
    gen = torch.Generator().manual_seed(0)
    for _ in range(n):
        for p in model.parameters():
            if p.requires_grad:
                p.grad = torch.randn(p.shape, generator=gen)
        opt.step()


def test_jax_checkpoint_loads_bit_for_bit(tmp_path, capsys):
    """The state dict loaded from a JAX-written folder equals
    `jax_to_state_dict` of the same arrays bit for bit, in place (the
    optimizer keeps its parameters); the meta comes back; the folder's optax
    `opt_state.msgpack` is not turned into Adam state: the JAX package's
    mismatch line is printed and the fresh optimizer is kept."""
    params, stats = _jax_variables(tmp_path)
    adam = optax.adam(1e-4)
    folder = jax_save_checkpoint(tmp_path / "log", 4, params, stats, opt_state=adam.init(params),
                                 meta={"step": 9}, config_yaml="Dataset: {}\n")
    assert sorted(p.name for p in folder.iterdir()) == [
        "batch_stats.msgpack", "meta.yaml", "opt_state.msgpack", "params.msgpack"]
    model, opt = _fresh()
    ids = [id(p) for p in model.parameters()]
    meta = io.load_checkpoint(folder, model, opt)
    assert meta == {"epoch": 4, "step": 9}
    assert io.OPTIMIZER_MISMATCH in capsys.readouterr().out
    assert not opt.state and [id(p) for p in model.parameters()] == ids
    want = jax_to_state_dict(params, stats)
    got = {k: v for k, v in model.state_dict().items() if not k.endswith("num_batches_tracked")}
    assert got.keys() == want.keys() and len(want) == 236
    for k, v in want.items():
        assert got[k].dtype == torch.float32 and np.array_equal(got[k].numpy(), v), k
    assert (tmp_path / "log" / "config.yaml").read_text() == "Dataset: {}\n"


def test_port_checkpoint_round_trip(tmp_path, capsys):
    """The port's own folder: model and Adam state saved and loaded exactly,
    `latest_checkpoint` finds the highest epoch, `best.yaml` names the epoch
    marked best, and an optimizer with other groups refuses the stored
    state with the mismatch line."""
    model, opt = _fresh()
    _adam_steps(model, opt)
    for epoch in (1, 3):
        folder = io.save_checkpoint(tmp_path, epoch, model, opt, meta={"loss": 0.5})
    assert sorted(p.name for p in folder.iterdir()) == ["meta.yaml", "model.pt", "optimizer.pt"]
    assert io.latest_checkpoint(tmp_path) == folder
    assert io.latest_checkpoint(tmp_path / "nowhere") is None
    io.mark_best_checkpoint(tmp_path, 1, "val_loss", 0.25)
    with open(tmp_path / "models" / "best.yaml") as f:
        assert yaml.safe_load(f) == {"epoch": 1, "monitor": "val_loss", "value": 0.25}

    model2, opt2 = _fresh()
    assert io.load_checkpoint(folder, model2, opt2) == {"epoch": 3, "loss": 0.5}
    torch.testing.assert_close(model2.state_dict(), model.state_dict(), rtol=0, atol=0)
    torch.testing.assert_close(opt2.state_dict(), opt.state_dict(), rtol=0, atol=0)
    _adam_steps(model, opt, 1)
    _adam_steps(model2, opt2, 1)
    torch.testing.assert_close(model2.state_dict(), model.state_dict(), rtol=0, atol=0)

    model3 = init_depth_pose(0, device="cpu")
    opt3 = make_adapt_optimizer(model3, 1e-4, 0.0)  # no depth-decoder group
    io.load_checkpoint(folder, model3, opt3)
    assert io.OPTIMIZER_MISMATCH in capsys.readouterr().out and not opt3.state


_leaves = st.one_of(
    st.integers(-2 ** 63, 2 ** 64 - 1), st.floats(allow_nan=False), st.booleans(), st.none(),
    st.text(max_size=40), st.binary(max_size=300),
)
_keys = st.text(min_size=1, max_size=12)


@st.composite
def _arrays(draw):
    dtype = draw(st.sampled_from(["float32", "float64", "int32", "int64", "uint8", "float16",
                                  "bool"]))
    shape = tuple(draw(st.lists(st.integers(0, 5), max_size=3)))
    data = draw(st.binary(min_size=int(np.prod(shape)) * np.dtype(dtype).itemsize,
                          max_size=int(np.prod(shape)) * np.dtype(dtype).itemsize))
    arr = np.frombuffer(data, dtype=dtype).reshape(shape)
    if dtype == "bool":
        arr = arr.view(np.uint8).astype(bool)
    if arr.size == 0 or draw(st.booleans()):
        return arr
    return arr.flat[0]  # a numpy scalar


_trees = st.recursive(
    st.one_of(_leaves, _arrays()),
    lambda inner: st.one_of(st.lists(inner, max_size=4),
                            st.dictionaries(_keys, inner, max_size=4)),
    max_leaves=20,
)


def _same(a, b):
    if isinstance(a, np.ndarray) or isinstance(a, np.generic):
        return (type(a) is type(b) and a.dtype == b.dtype and np.shape(a) == np.shape(b)
                and np.asarray(a).tobytes() == np.asarray(b).tobytes())
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return isinstance(b, list) and len(a) == len(b) and all(map(_same, a, b))
    return type(a) is type(b) and a == b


@settings(max_examples=150, deadline=None)
@given(tree=_trees)
def test_msgpack_reader_matches_the_msgpack_package(tree):
    """Nested dicts and lists of arrays, numpy scalars, ints (every width,
    both signs), floats, str, bin, nil and bool, encoded the way flax
    encodes them (`msgpack_serialize`), decode to what the `msgpack`
    package with flax's extension hook decodes."""
    data = serialization.msgpack_serialize({"tree": tree})
    want = msgpack.unpackb(data, raw=False, ext_hook=serialization._msgpack_ext_unpack)
    assert _same(loads(data), want)


def test_msgpack_reader_refuses_what_it_does_not_read():
    """Other extension types, flax's chunked arrays, bfloat16, trailing
    bytes and truncated data raise ValueError."""
    cases = [
        msgpack.packb(msgpack.ExtType(2, msgpack.packb((1.0, 2.0)))),
        msgpack.packb({"x": {"__msgpack_chunked_array__": True, "shape": {}, "chunks": {}}}),
        msgpack.packb(msgpack.ExtType(1, msgpack.packb(((2,), "bfloat16", b"\0" * 4),
                                                       use_bin_type=True))),
        msgpack.packb(1) + b"\0",
        msgpack.packb("truncated")[:-2],
    ]
    for data in cases:
        with pytest.raises(ValueError, match="msgpack"):
            loads(data)


def test_predictor_and_slam_checkpoints(tmp_path, capsys):
    """`DepthPosePrediction.save_model` / `load_model` / `load_online_model`
    on the port's folders and on a JAX-written one, and `Slam.save_model`
    then `load_weights_folder`; a missing folder prints the JAX package's
    line and leaves the weights as they were."""
    dc = DatasetConfig(height=64, width=192)
    pc = DepthPoseConfig(log_path=str(tmp_path / "a"), batch_size=2)
    a = DepthPosePrediction(dc, pc, use_online=True, device="cpu")
    _adam_steps(a.state.model, a.state.optimizer)
    a.epoch = 2
    folder = a.save_model()
    assert folder == tmp_path / "a" / "models" / "weights_002"

    b = DepthPosePrediction(dc, DepthPoseConfig(log_path=str(tmp_path / "a"), batch_size=2),
                            use_online=True, device="cpu")
    before = {k: v.clone() for k, v in b.model.state_dict().items()}
    b.load_model(folder=tmp_path / "missing")
    assert "Cannot find weights folder" in capsys.readouterr().out and not b.is_trained
    torch.testing.assert_close(b.model.state_dict(), before, rtol=0, atol=0)
    b.load_model()  # the latest checkpoint under log_path
    assert b.epoch == 2 and b.is_trained
    torch.testing.assert_close(b.model.state_dict(), a.model.state_dict(), rtol=0, atol=0)
    torch.testing.assert_close(b.state.optimizer.state_dict(), a.state.optimizer.state_dict(),
                               rtol=0, atol=0)
    b.load_online_model(folder=folder, load_optimizer=False)
    torch.testing.assert_close(b.online_state.model.state_dict(), a.model.state_dict(),
                               rtol=0, atol=0)
    assert not b.online_state.optimizer.state

    params, stats = _jax_variables(tmp_path, seed=5)
    jfolder = jax_save_checkpoint(tmp_path / "j", 0, params, stats)
    b.load_model(folder=jfolder)
    want = jax_to_state_dict(params, stats)
    assert all(np.array_equal(b.model.state_dict()[k].numpy(), v) for k, v in want.items())

    cfg = Config()
    cfg.dataset = DatasetConfig(dataset="Synthetic", height=64, width=192, num_frames=4)
    cfg.depth_pose = DepthPoseConfig(log_path=str(tmp_path / "s"),
                                     load_weights_folder=str(tmp_path / "missing"))
    cfg.slam = SlamConfig(do_loop_closures=False, plot_frequency=0)
    slam = Slam(cfg, device="cpu")
    assert "slam: weights folder not found, using random init" in capsys.readouterr().out
    slam.save_model()
    saved = tmp_path / "s" / "models" / "weights_000"
    assert sorted(p.name for p in saved.iterdir()) == ["meta.yaml", "model.pt"]
    cfg.depth_pose.load_weights_folder = str(jfolder)
    loaded = Slam(cfg, device="cpu")
    assert f"slam: loaded weights from {jfolder}" in capsys.readouterr().out
    assert all(np.array_equal(loaded.model.state_dict()[k].numpy(), v) for k, v in want.items())
    cfg.depth_pose.load_weights_folder = str(saved)
    torch.testing.assert_close(Slam(cfg, device="cpu").model.state_dict(),
                               slam.model.state_dict(), rtol=0, atol=0)
