"""Import hygiene of the PyTorch port.

`tpuslam_torch` and `chip_smoke.py` import nothing of JAX and nothing of the
JAX package `tpuslam`, not even its JAX-free modules (the port keeps copies),
and neither `msgpack` nor `flax` (the port reads flax checkpoints itself);
a short CPU run of the port leaves `jax` out of `sys.modules`; and the entry
points refuse to run without CUDA unless the caller asks for the CPU.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "msgpack", "tpuslam")


def _imported_roots(path: Path):
    """Top-level package of every import statement in a source file."""
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0], node.lineno


def test_port_sources_import_no_jax_and_no_reference_package():
    files = sorted((ROOT / "tpuslam_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    names = {str(f.relative_to(ROOT)) for f in files}
    assert {"tpuslam_torch/ops/warp.py", "tpuslam_torch/ops/reproj.py",
            "tpuslam_torch/ops/build.py", "tpuslam_torch/posegraph/lm.py",
            "tpuslam_torch/posegraph/native.py",
            "tpuslam_torch/loopclosure/detection.py", "tpuslam_torch/cli/adapt.py",
            "tpuslam_torch/cli/rungs.py", "tpuslam_torch/viz/plots.py",
            "tpuslam_torch/viz/meshlab.py", "tpuslam_torch/viz/pointcloud.py",
            "tpuslam_torch/checkpoint/io.py",
            "tpuslam_torch/checkpoint/msgpack_reader.py",
            "tpuslam_torch/checkpoint/torch_import.py", "tpuslam_torch/train/pretrain.py",
            "tpuslam_torch/cli/pretrain.py", "tpuslam_torch/cli/make_buffer.py",
            "tpuslam_torch/cli/undistort.py", "tpuslam_torch/cli/extract_kitti.py",
            "tpuslam_torch/data/kitti.py", "tpuslam_torch/data/cityscapes.py",
            "tpuslam_torch/data/robotcar.py", "tpuslam_torch/geometry/transforms.py",
            "tpuslam_torch/models/embedder.py", "tpuslam_torch/parallel/__init__.py",
            "tpuslam_torch/parallel/mesh.py", "tpuslam_torch/utils/__init__.py",
            "tpuslam_torch/utils/profiling.py", "tpuslam_torch/utils/calibration.py"} <= names
    bad = [f"{f.relative_to(ROOT)}:{line} imports {mod}"
           for f in files for mod, line in _imported_roots(f) if mod in FORBIDDEN]
    assert not bad, "\n".join(bad)


_RUN = """
import sys
import torch
torch.set_num_threads(1)
import tpuslam_torch
from tpuslam_torch.config import Config
from tpuslam_torch.config.schema import DatasetConfig, DepthPoseConfig, SlamConfig
from tpuslam_torch.slam import Slam

cfg = Config()
cfg.dataset = DatasetConfig(dataset="Synthetic", height=64, width=192, num_frames=5)
cfg.depth_pose = DepthPoseConfig(batch_size=3, log_path=sys.argv[1])
cfg.slam = SlamConfig(adaptation=True, adaptation_epochs=1, do_loop_closures=True,
                      pipeline_depth=1, plot_frequency=0)
slam = Slam(cfg, device="cpu")
slam.run(max_steps=3, progress=False)
assert all(l == l for l in slam.depth_loss), slam.depth_loss
assert slam.pose_graph.vertex_ids == [0, 1, 2, 3], slam.pose_graph.vertex_ids
slam.pose_graph.optimize(backend="auto", device="cpu")
slam.pose_graph.optimize(backend="torch", device="cpu")
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "msgpack", "tpuslam"))
print("LEAKED", leaked)
"""


def test_cpu_slam_run_leaves_jax_unimported(tmp_path):
    """A fresh interpreter imports the port, runs three frames of
    adaptation with loop closure and the pipelined retire through
    `Slam.run` on the CPU, and solves the pose graph with both backends,
    without loading jax or the JAX package."""
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    proc = subprocess.run([sys.executable, "-c", _RUN, str(tmp_path)], cwd=tmp_path,
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "LEAKED []" in proc.stdout, proc.stdout


_PRETRAIN = """
import sys
import torch
torch.set_num_threads(1)
from tpuslam_torch.cli import pretrain
from tpuslam_torch.data import Cityscapes, KittiOdometry, RobotCar, undistort_robotcar
from tpuslam_torch.geometry import transforms

assert pretrain.main(["--config", sys.argv[1], "--epochs", "1", "--device", "cpu"]) == 0
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "msgpack", "tpuslam"))
print("LEAKED", leaked)
"""


def test_cpu_pretrain_and_loaders_leave_jax_unimported(tmp_path):
    """A fresh interpreter imports the KITTI, Cityscapes and RobotCar loaders
    and runs one epoch of `cli.pretrain` (32 x 64, synthetic, batch 2) on the
    CPU, without loading jax or the JAX package."""
    cfg = tmp_path / "pretrain.yaml"
    cfg.write_text(
        "Dataset:\n  dataset: Synthetic\n  height: 32\n  width: 64\n  num_frames: 4\n"
        f"DepthPosePrediction:\n  batch_size: 2\n  scales: [0, 1]\n  dtype: float32\n"
        f"  log_path: {tmp_path / 'log'}\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    proc = subprocess.run([sys.executable, "-c", _PRETRAIN, str(cfg)], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "LEAKED []" in proc.stdout, proc.stdout
    assert (tmp_path / "log" / "models" / "weights_001" / "model.pt").exists()


def test_entry_points_refuse_to_run_without_cuda(tmp_path):
    """Without `device=`, the entry points ask for the card and raise when
    there is none; there is no silent CPU fallback."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    from tpuslam_torch.config import Config
    from tpuslam_torch.config.schema import DepthPoseConfig, SlamConfig
    from tpuslam_torch.models.depth_pose import init_depth_pose
    from tpuslam_torch.slam import Slam

    cfg = Config()
    cfg.depth_pose = DepthPoseConfig(log_path=str(tmp_path))
    cfg.slam = SlamConfig(do_loop_closures=False, plot_frequency=0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Slam(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_depth_pose(0)
    from tpuslam_torch.cli import pretrain
    from tpuslam_torch.train.pretrain import Pretrainer

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Pretrainer(height=32, width=64, log_path=tmp_path)
    path = tmp_path / "pretrain.yaml"
    path.write_text("Dataset:\n  dataset: Synthetic\n  height: 32\n  width: 64\n"
                    f"DepthPosePrediction:\n  log_path: {tmp_path / 'log'}\n")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pretrain.main(["--config", str(path), "--epochs", "1"])


def test_entry_points_turn_tf32_off_and_restore_it():
    """`adapt_step`, `eval_step` and `embed` run their networks and geometry
    with TF32 off, whatever the caller set, and leave the caller's flags as
    they were; building a `Slam` sets no process-wide flag."""
    from tpuslam_torch.data.synthetic import SyntheticDataset
    from tpuslam_torch.models.depth_pose import init_depth_pose
    from tpuslam_torch.train.batch import make_frame_batch, pad_batch
    from tpuslam_torch.train.state import make_adapt_optimizer, make_train_state
    from tpuslam_torch.train.steps import LossConfig, adapt_step, embed, eval_step

    flags = (torch.backends.cuda.matmul, torch.backends.cudnn)
    saved = [f.allow_tf32 for f in flags]
    seen = []
    model = init_depth_pose(0, device="cpu")
    model.depth_encoder.register_forward_pre_hook(
        lambda *_: seen.append(tuple(f.allow_tf32 for f in flags)))
    sample = SyntheticDataset(num_frames=3, height=64, width=192)[1]
    batch = make_frame_batch(sample.rgb[None], sample.K, sample.rel_dist[None], device="cpu")
    cfg = LossConfig(bf16_networks=False, pallas_bf16_out=False)
    try:
        for f in flags:
            f.allow_tf32 = True
        eval_step(model, cfg, batch)
        embed(model, batch.frame(0), cfg)
        state = make_train_state(model, make_adapt_optimizer(model, 1e-4), seed=None)
        adapt_step(state, cfg, pad_batch(batch, 3), num_steps=1, with_lc_embedding=True)
        after = [f.allow_tf32 for f in flags]
    finally:
        for f, v in zip(flags, saved):
            f.allow_tf32 = v
    assert len(seen) == 4 and all(s == (False, False) for s in seen), seen
    assert after == [True, True]


def test_unported_options_are_refused(tmp_path, capsys):
    """No option is refused any more: the last three work, the MobileNet
    embedder (`Slam` builds it, with the JAX package's WARNING when it has
    no weights), data-parallel pretraining (`dp_devices > 1` asks for a
    process group of that size, and says so without one) and the
    predictor's `train(use_wandb=True)` (JSONL without wandb).  The others
    construct: loop closure, `pipeline_depth > 0`, the dual-network and async modes,
    periodic plots, `load_weights_folder` and the Kitti / RobotCar datasets
    in `Slam`, the predictor's checkpoints, `train` and `validate`, and
    ImageNet encoders; every `pallas_*` flag and `mask_dynamic` are mapped,
    the two-kernel variants (K2) and the fused stack (K4-K8) alike."""
    from tpuslam_torch.checkpoint.torch_import import MISSING_WEIGHTS
    from tpuslam_torch.config import Config
    from tpuslam_torch.config.schema import DatasetConfig, DepthPoseConfig, SlamConfig
    from tpuslam_torch.data.synthetic import SyntheticDataset
    from tpuslam_torch.predictor import DepthPosePrediction
    from tpuslam_torch.slam import Slam
    from tpuslam_torch.train.pretrain import Pretrainer
    from tpuslam_torch.train.steps import loss_config

    flags = ("pallas_packed", "pallas_seg_skip", "pallas_tall", "pallas_proj",
             "pallas_fused_loss", "pallas_fused_bwd")
    for flag in flags:
        cfg = loss_config(DepthPoseConfig(**{flag: True}))
        assert [getattr(cfg, f) for f in flags] == [f == flag for f in flags], flag
    cfg = loss_config(DepthPoseConfig(pallas_fused_grad=False, pallas_extra_tiles=1,
                                      pallas_group_skip=False))
    assert (cfg.pallas_fused_grad, cfg.pallas_extra_tiles) == (False, 1)
    assert loss_config(DepthPoseConfig(mask_dynamic=True)).mask_dynamic
    pc = DepthPoseConfig(log_path=str(tmp_path), batch_size=2, dtype="float32")
    predictor = DepthPosePrediction(DatasetConfig(height=32, width=64), pc, device="cpu")
    assert not predictor.loss_cfg.mask_dynamic
    predictor.train(SyntheticDataset(num_frames=2, height=32, width=64), use_wandb=True,
                    num_epochs=1)
    assert "wandb requested but not installed" in capsys.readouterr().out
    assert (tmp_path / "metrics.jsonl").exists()
    folder = predictor.save_model()
    predictor.load_model(folder=folder)
    assert predictor.is_trained
    with pytest.raises(FileNotFoundError, match="encoder_weights"):
        DepthPosePrediction(DatasetConfig(), DepthPoseConfig(resnet_pretrained=True), device="cpu")
    with pytest.raises(ValueError, match="needs a process group of 2 ranks"):
        Pretrainer(height=32, width=64, dp_devices=2, device="cpu")
    assert "egress" in MISSING_WEIGHTS

    def config(**slam_cfg):
        cfg = Config()
        cfg.dataset = DatasetConfig(dataset="Synthetic", height=64, width=192, num_frames=4)
        cfg.depth_pose = DepthPoseConfig(log_path=str(tmp_path))
        cfg.slam = SlamConfig(**{"do_loop_closures": False, "plot_frequency": 0, **slam_cfg})
        return cfg

    for slam_cfg in (dict(do_loop_closures=True), dict(pipeline_depth=1), dict(use_expert=True),
                     dict(async_adaptation=True), dict(plot_frequency=100, logging=True)):
        slam = Slam(config(**slam_cfg), device="cpu")
        for key, value in slam_cfg.items():
            assert getattr(slam, key) == value, key
    assert Slam(config(use_expert=True), device="cpu").generalist_state is not None
    cfg = config()
    cfg.depth_pose.load_weights_folder = str(folder)
    Slam(cfg, device="cpu")
    for dataset in ("Kitti", "RobotCar"):  # built, and missing here (no data in the repo)
        cfg = config()
        cfg.dataset.dataset = dataset
        cfg.dataset.dataset_path = str(tmp_path / "missing")
        with pytest.raises(Exception) as err:
            Slam(cfg, device="cpu")
        assert not isinstance(err.value, NotImplementedError), err.value
    cfg = config()
    cfg.depth_pose.mask_dynamic = True
    assert not Slam(cfg, device="cpu").loss_cfg.mask_dynamic
    cfg = config()
    cfg.loop_closure.embedder = "mobilenet"
    capsys.readouterr()
    slam = Slam(cfg, device="cpu")
    assert "mobilenet LC embedder is randomly initialised" in capsys.readouterr().out
    assert slam.loop_closure_detection.index.dim == 576
