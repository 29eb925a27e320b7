"""The dataset loaders of the PyTorch port (KITTI, Cityscapes, RobotCar), the
host-side transforms, `cli.undistort`, `cli.extract_kitti` and
`cli.make_buffer`, and the port's `Slam` on KITTI, against the JAX package.

The on-disk fixtures are generated here, in the layouts of
`tests/test_kitti_fixture.py`, `tests/test_cityscapes_fixture.py` and
`tests/test_robotcar.py` (no download).  The loaders are numpy copies, so
their samples must be bit-identical, augmentation included (same seed).
"""
import dataclasses
import json
import pickle
import shutil
from datetime import datetime, timedelta

import numpy as np
import pytest
import torch
from PIL import Image

import tpuslam.models as jax_models
import tpuslam.slam.slam as jax_slam_module
from tpuslam.checkpoint.io import save_checkpoint as jax_save_checkpoint
from tpuslam.checkpoint.torch_import import (_import_depth_decoder, _import_pose_decoder,
                                             _import_resnet)
from tpuslam.cli import extract_kitti as jax_extract
from tpuslam.cli import make_buffer as jax_make_buffer
from tpuslam.cli import undistort as jax_undistort
from tpuslam.config import parse_config as jax_parse_config
from tpuslam.data import Cityscapes as JaxCityscapes
from tpuslam.data import KittiOdometry as JaxKitti
from tpuslam.data import RobotCar as JaxRobotCar
from tpuslam.geometry import transforms as jax_transforms
from tpuslam.models import DepthPoseNet as JaxNet
from tpuslam.slam import Slam as JaxSlam
from tpuslam_torch.checkpoint.from_jax import load_jax_variables
from tpuslam_torch.cli import extract_kitti, make_buffer, undistort
from tpuslam_torch.config import parse_config
from tpuslam_torch.data import Cityscapes, KittiOdometry, RobotCar
from tpuslam_torch.geometry import transforms
from tpuslam_torch.models.depth_pose import init_depth_pose
from tpuslam_torch.slam import Slam

torch.set_num_threads(1)


def _flax_variables(net):
    """Flax variables of a port `DepthPoseNet`, through the JAX package's
    importer of monodepth2 state dicts (flax's own init costs ~30 s of
    op-by-op compiles on the CPU)."""
    params, stats = {}, {}
    for enc in ("depth_encoder", "pose_encoder"):
        params[enc], stats[enc] = _import_resnet(getattr(net, enc).state_dict())
    params["depth_decoder"] = _import_depth_decoder(net.depth_decoder.state_dict())
    params["pose_decoder"] = _import_pose_decoder(net.pose_decoder.state_dict())
    return {"params": params, "batch_stats": stats}


def _fast_jax_init(variables):
    """A stand-in for the JAX package's `init_depth_pose` that returns
    `variables` (test-side patch)."""
    def init(rng, *, height, width, resnet_depth=18, resnet_pose=18, scales=(0, 1, 2, 3),
             dtype=np.float32):
        return JaxNet(resnet_depth=resnet_depth, resnet_pose=resnet_pose, scales=scales,
                      dtype=dtype), variables
    return init


def _assert_same_samples(got, want, n=None):
    assert len(got) == len(want)
    for i in range(len(want) if n is None else n):
        g, w = got[i], want[i]
        for field in dataclasses.fields(w):
            a, b = getattr(g, field.name), getattr(w, field.name)
            if isinstance(b, np.ndarray):
                np.testing.assert_array_equal(a, b, err_msg=f"{i}: {field.name}")
                assert a.dtype == b.dtype, field.name
            else:
                assert a == b, (i, field.name)


# ---------------------------------------------------------------------------
# Fixtures
# ---------------------------------------------------------------------------

KITTI_W0, KITTI_H0 = 82, 25  # odd raw sizes exercise the resize path


def _kitti(root, rng, n=10):
    seq_dir = root / "sequences" / "04"
    for sub in ("image_2", "image_3", "oxts/data", "segm_mask/image_2", "gt_depth/image_02"):
        (seq_dir / sub).mkdir(parents=True)
    (root / "poses").mkdir()
    base = datetime(2011, 9, 30, 12, 0, 0)
    ts_lines, poses, T = [], [], np.eye(4)
    for i in range(n):
        img = (rng.uniform(size=(KITTI_H0, KITTI_W0, 3)) * 255).astype(np.uint8)
        Image.fromarray(img).save(seq_dir / "image_2" / f"{i:06d}.png")
        Image.fromarray(255 - img).save(seq_dir / "image_3" / f"{i:06d}.png")
        fields = np.zeros(30)
        fields[8:11] = [3.0, 4.0, 0.0]  # 5 m/s
        np.savetxt(seq_dir / "oxts" / "data" / f"{i:010d}.txt", fields[None])
        ts_lines.append((base + timedelta(milliseconds=100 * i)).strftime(
            "%Y-%m-%d %H:%M:%S.%f") + "000")
        poses.append(T[:3].reshape(-1).copy())
        step = np.eye(4)
        step[:3, 3] = [0.02 * np.sin(i), 0.0, 0.5]
        T = T @ step
        m = np.zeros((KITTI_H0, KITTI_W0), np.uint8)
        m[:, : KITTI_W0 // 2 + i] = 255
        Image.fromarray(m).save(seq_dir / "segm_mask" / "image_2" / f"{i:06d}.png")
        d = rng.uniform(500, 2000, size=(KITTI_H0, KITTI_W0)).astype(np.uint16)
        Image.fromarray(d, mode="I;16").save(seq_dir / "gt_depth" / "image_02" / f"{i:06d}.png")
    (seq_dir / "oxts" / "timestamps.txt").write_text("\n".join(ts_lines) + "\n")
    np.savetxt(root / "poses" / "04.txt", np.stack(poses))
    return root


@pytest.fixture
def kitti_root(tmp_path):
    return _kitti(tmp_path / "kitti", np.random.default_rng(11))


@pytest.fixture
def cityscapes_root(tmp_path):
    rng = np.random.default_rng(12)
    root = tmp_path / "cityscapes"
    dirs = {k: root / k / "train" / "aachen" for k in
            ("leftImg8bit_sequence", "camera", "vehicle_sequence", "segm_mask")}
    for d in dirs.values():
        d.mkdir(parents=True)
    t0 = 1_000_000_000
    for i in list(range(5)) + list(range(10, 13)):  # two recordings (a gap)
        stem = f"aachen_000000_{i:06d}"
        arr = (rng.uniform(size=(32, 64, 3)) * 255).astype(np.uint8)
        Image.fromarray(arr).save(dirs["leftImg8bit_sequence"] / f"{stem}_leftImg8bit.png")
        mask = np.zeros((32, 64), np.uint8)
        mask[8:20, 10 + i:30 + i] = 255
        Image.fromarray(mask).save(dirs["segm_mask"] / f"{stem}_leftImg8bit.png")
        (dirs["camera"] / f"{stem}_camera.json").write_text(json.dumps(
            {"intrinsic": {"fx": 2262.52, "fy": 1096.98, "u0": 1096.98, "v0": 513.137}}))
        (dirs["vehicle_sequence"] / f"{stem}_vehicle.json").write_text(json.dumps(
            {"speed": 8.0 + i, "timestamp": t0 + i * 59_000_000}))
    return root


ROBOTCAR_SEQ = "2015-08-12-15-04-18"


def _robotcar(root, rng, n):
    img_dir = root / ROBOTCAR_SEQ / "stereo" / "center"
    img_dir.mkdir(parents=True)
    t0 = 1_439_000_000_000_000
    for i in range(n):
        arr = (rng.uniform(size=(48, 64, 3)) * 255).astype(np.uint8)
        Image.fromarray(arr).save(img_dir / f"{t0 + i * 100_000}.png")
    gps_dir = root / ROBOTCAR_SEQ / "gps"
    gps_dir.mkdir(parents=True)
    ins_ts = np.arange(t0 - 1_000_000, t0 + (n + 12) * 100_000, 20_000)
    with open(gps_dir / "ins.csv", "w") as f:
        f.write("timestamp,ins_status,velocity_north,velocity_east,velocity_down\n")
        for ts in ins_ts:
            f.write(f"{ts},GOOD,3.0,4.0,0.0\n")
    rtk_dir = root / "rtk" / ROBOTCAR_SEQ
    rtk_dir.mkdir(parents=True)
    with open(rtk_dir / "rtk.csv", "w") as f:
        f.write("timestamp,latitude,longitude,altitude,northing,easting,down,velocity_north,"
                "velocity_east,velocity_down,roll,pitch,yaw\n")
        for i, ts in enumerate(ins_ts):
            f.write(f"{ts},57,-1,100,{5_735_000.0 + 0.5 * i},{620000.0 + 0.01 * i},-10.0,"
                    f"0,0,0,0.0,0.0,{0.01 + 1e-4 * i}\n")
    cam_dir = root / "camera_models"
    cam_dir.mkdir()
    (cam_dir / "stereo_narrow_left.txt").write_text("400.0 400.0 320.0 240.0\n0 0 0 0\n")
    return root


@pytest.fixture
def robotcar_root(tmp_path):
    return _robotcar(tmp_path / "robotcar", np.random.default_rng(13), 12)


# ---------------------------------------------------------------------------
# Loaders
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(with_depth=True, with_mask=True),
    dict(do_augmentation=True, with_mask=True, seed=5),
    dict(views=("left", "right"), min_distance=0.9),
])
def test_kitti_samples_match(kitti_root, kw):
    got = KittiOdometry(kitti_root, 4, height=24, width=80, **kw)
    want = JaxKitti(kitti_root, 4, height=24, width=80, **kw)
    np.testing.assert_array_equal(got.global_poses, want.global_poses)
    _assert_same_samples(got, want)


@pytest.mark.parametrize("kw", [dict(), dict(do_augmentation=True, with_mask=True, seed=6)])
def test_cityscapes_samples_match(cityscapes_root, kw):
    got = Cityscapes(cityscapes_root, "train", height=32, width=64, **kw)
    want = JaxCityscapes(cityscapes_root, "train", height=32, width=64, **kw)
    _assert_same_samples(got, want)


@pytest.mark.parametrize("kw", [dict(), dict(do_augmentation=True, every_n_frame=2, seed=7),
                                dict(min_distance=0.9, end_frame=10)])
def test_robotcar_samples_match(robotcar_root, kw):
    got = RobotCar(robotcar_root, ROBOTCAR_SEQ, height=48, width=160, start_frame=0, **kw)
    want = JaxRobotCar(robotcar_root, ROBOTCAR_SEQ, height=48, width=160, start_frame=0, **kw)
    _assert_same_samples(got, want)


def test_transforms_match(rng):
    """`geometry/transforms.py` against the JAX package's copy."""
    six = rng.normal(scale=[1, 1, 1, 0.3, 0.3, 0.3], size=(5, 6))
    for s in six:
        T = transforms.sixdof_to_tmat(s)
        np.testing.assert_array_equal(T, jax_transforms.sixdof_to_tmat(s))
        np.testing.assert_array_equal(transforms.tmat_to_sixdof(T),
                                      jax_transforms.tmat_to_sixdof(T))
        assert transforms.string_tmat(T) == jax_transforms.string_tmat(T)
        assert transforms.string_tmat(T, False) == jax_transforms.string_tmat(T, False)
    pts = rng.normal(size=(7, 3))
    Ts = np.stack([transforms.sixdof_to_tmat(s) for s in six])
    for T in (Ts[0], Ts):
        np.testing.assert_array_equal(transforms.apply_transformation(T, pts),
                                      jax_transforms.apply_transformation(T, pts))


# ---------------------------------------------------------------------------
# Command-line tools
# ---------------------------------------------------------------------------


def test_cli_undistort_matches(robotcar_root, tmp_path):
    """Bayer raw -> demosaiced, undistorted PNGs: both packages' CLIs write
    the same files, bit for bit."""
    rng = np.random.default_rng(14)
    H, W = 8, 16
    raw_dir = robotcar_root / ROBOTCAR_SEQ / "stereo" / "centre"
    raw_dir.mkdir(parents=True)
    for i in range(3):
        raw = (rng.uniform(size=(H, W)) * 255).astype(np.uint8)
        Image.fromarray(raw).save(raw_dir / f"{i}.png")
    cam = robotcar_root / "camera_models"
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    lut = np.concatenate([(xx - 0.5 + 0.1 * yy).ravel(), (yy + 0.25).ravel()])
    lut.tofile(cam / "stereo_narrow_left_distortion_lut.bin")
    (cam / "stereo_narrow_left.txt").write_text("400.0 400.0 8.0 4.0\n" + "\n".join(
        " ".join(str(v) for v in row) for row in np.eye(4)) + "\n")
    other = tmp_path / "other"
    shutil.copytree(robotcar_root, other)
    args = ["--sequence", ROBOTCAR_SEQ, "--workers", "0"]
    assert undistort.main(["--data", str(robotcar_root)] + args) == 0
    assert jax_undistort.main(["--data", str(other)] + args) == 0
    for i in range(3):
        rel = f"{ROBOTCAR_SEQ}/stereo/center/{i}.png"
        got = np.asarray(Image.open(robotcar_root / rel))
        np.testing.assert_array_equal(got, np.asarray(Image.open(other / rel)))
        assert got.shape == (H, W, 3) and got.std() > 0


def test_cli_extract_kitti_matches(tmp_path):
    """Raw-drive oxts copied into the odometry layout: the same files from
    both packages' CLIs."""
    date, drive = "2011_09_30", "2011_09_30_drive_0016_sync"
    oxts = tmp_path / "raw" / date / drive / "oxts"
    (oxts / "data").mkdir(parents=True)
    for i in range(6):
        np.savetxt(oxts / "data" / f"{i:010d}.txt", np.full((1, 30), float(i)))
    (oxts / "timestamps.txt").write_text("".join(f"2011-09-30 12:00:0{i}.000000000\n"
                                                 for i in range(6)))
    for pkg, out in ((extract_kitti, "port"), (jax_extract, "jax")):
        assert pkg.main(["--raw", str(tmp_path / "raw"), "--odometry", str(tmp_path / out),
                         "--sequences", "4"]) == 0
    files = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*.txt"))
    assert len(files) == 7
    for f in files:
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes()


def test_cli_make_buffer_matches(tmp_path, monkeypatch):
    """Both packages' `cli.make_buffer` from one JAX-written checkpoint
    admit the same frames to the same buffer."""
    net = init_depth_pose(2, device="cpu")
    variables = _flax_variables(net)
    weights = jax_save_checkpoint(tmp_path / "ckpt", 0, variables["params"],
                                  variables["batch_stats"])
    monkeypatch.setattr(jax_models, "init_depth_pose", _fast_jax_init(_flax_variables(
        init_depth_pose(3, device="cpu"))))
    yaml_text = (
        "Dataset:\n  dataset: Synthetic\n  height: 32\n  width: 64\n  num_frames: 12\n"
        f"DepthPosePrediction:\n  load_weights_folder: {weights}\n"
        "ReplayBuffer:\n  max_buffer_size: 5\n  similarity_threshold: 0.998\n")
    path = tmp_path / "buffer.yaml"
    path.write_text(yaml_text)
    states = {}
    for pkg, out, extra in ((make_buffer, "port", ["--device", "cpu"]),
                            (jax_make_buffer, "jax", [])):
        assert pkg.main(["--config", str(path), "--out", str(tmp_path / out)] + extra) == 0
        with open(tmp_path / out / "buffer_state.pkl", "rb") as f:
            states[out] = pickle.load(f)
    got, want = states["port"], states["jax"]
    assert sorted(got["records"]) == sorted(want["records"])
    assert 1 < len(want["records"]) < 12  # the similarity gate admitted some, not all
    np.testing.assert_array_equal(got["index"]["ids"], want["index"]["ids"])
    np.testing.assert_allclose(got["index"]["vectors"], want["index"]["vectors"], atol=1e-4)


# ---------------------------------------------------------------------------
# Slam on KITTI
# ---------------------------------------------------------------------------

SLAM_YAML = """
Dataset:
  dataset: Kitti
  dataset_path: {data}
  height: 64
  width: 192
DepthPosePrediction:
  batch_size: 3
  dtype: float32
  pallas_bf16_out: false
  log_path: {log}
ReplayBuffer:
  max_buffer_size: 8
  similarity_threshold: 0.999
Slam:
  dataset_sequence: 4
  adaptation: true
  adaptation_epochs: 2
  min_distance: 0.0
  do_loop_closures: false
  plot_frequency: 0
"""


def test_slam_on_kitti_matches(kitti_root, tmp_path, monkeypatch):
    """`Dataset: Kitti` builds the loader as the JAX Slam does (poses, the
    min-distance filter); three adapted frames on the fixture, from the same
    weights, within `test_torch_port_slam.py`'s tolerances (1e-3: the JAX
    step's tie-break noise comes from jax.random)."""
    path = tmp_path / "slam.yaml"
    path.write_text(SLAM_YAML.format(data=kitti_root, log=tmp_path / "log"))
    slam = Slam(parse_config(path), device="cpu")
    monkeypatch.setattr(jax_slam_module, "init_depth_pose",
                        _fast_jax_init(_flax_variables(init_depth_pose(4, device="cpu"))))
    jslam = JaxSlam(jax_parse_config(path))
    load_jax_variables(slam.model, jslam.state.params, jslam.state.batch_stats)
    assert isinstance(slam.dataset, KittiOdometry) and len(slam) == len(jslam.dataset) == 8
    np.testing.assert_array_equal(slam.dataset.global_poses, jslam.dataset.global_poses)
    packed = {}
    for name, s in (("port", slam), ("jax", jslam)):
        rows = []
        for _ in range(3):
            s.current_step += 1
            entry = s._dispatch(s.dataset[s.current_step - 1])
            v = entry["outputs"][("retire_packed",)]
            rows.append(np.asarray(v.detach().cpu() if isinstance(v, torch.Tensor) else v,
                                   np.float64))
            s._retire(entry)
        packed[name] = np.stack(rows)
    assert np.isfinite(packed["port"]).all()
    np.testing.assert_allclose(packed["port"], packed["jax"], atol=1e-3, rtol=1e-3)
    assert slam.replay_buffer.index.ids.tolist() == jslam.replay_buffer.index.ids.tolist()
    np.testing.assert_allclose(np.stack(slam.pose_graph.get_all_poses()),
                               np.stack(jslam.pose_graph.get_all_poses()), atol=1e-3)


def test_slam_on_robotcar_builds_its_window(tmp_path):
    """`Dataset: RobotCar` builds the reference's evaluation window of the
    configured sequence (frames 750-4750 of sequence 1) with every second
    frame, as the JAX Slam does: the same samples as the JAX package's
    loader with those arguments, on a 760-frame fixture."""
    root = _robotcar(tmp_path / "robotcar", np.random.default_rng(15), 760)
    text = SLAM_YAML.format(data=root, log=tmp_path / "log").replace(
        "dataset: Kitti", "dataset: RobotCar").replace("dataset_sequence: 4",
                                                        "dataset_sequence: 1")
    path = tmp_path / "slam.yaml"
    path.write_text(text)
    slam = Slam(parse_config(path), device="cpu")
    want = JaxRobotCar(root, ROBOTCAR_SEQ, height=64, width=192, with_poses=True,
                       min_distance=0.0, start_frame=750, end_frame=4750, every_n_frame=2)
    assert isinstance(slam.dataset, RobotCar) and len(slam) == len(want) == 3
    _assert_same_samples(slam.dataset, want)
