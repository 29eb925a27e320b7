"""The entry point `cli.rungs` of the PyTorch port against the JAX package's.

Both packages run the rungs from one checkpoint that the JAX package wrote,
with float32 networks, at 32 x 96 (the JAX package's frames at 64 x 192
take ~2.5 s each on the CPU, which would put this file over ~90 s); the
port runs with `--device cpu`.  The identity tie-break noise is off on both
sides (the port's `make_train_state` without a seed, the JAX step's
`total_loss` with `rng=None`; patches in this file), and the JAX package's
async adoption is pinned to the next frame (`_tree_ready`), the schedule
the port gives on the CPU.
"""
import functools
import importlib
import re

import jax
import numpy as np
import pytest
import torch

import tpuslam_torch.slam.slam as port_slam
from tpuslam.checkpoint.io import save_checkpoint as jax_save_checkpoint
from tpuslam.cli import rungs as jax_rungs
from tpuslam.train import make_adapt_optimizer
from tpuslam_torch.cli import rungs

torch.set_num_threads(1)

_TXS = {}


def _shared_tx(params, learning_rate=1e-4, depth_lr_scale=1.0):
    """The JAX package's `make_adapt_optimizer`, one transform per learning
    rates and parameter-tree structure."""
    key = (learning_rate, depth_lr_scale, jax.tree_util.tree_structure(params))
    if key not in _TXS:
        _TXS[key] = make_adapt_optimizer(params, learning_rate, depth_lr_scale=depth_lr_scale)
    return _TXS[key]


@pytest.fixture(autouse=True)
def _same_schedule_no_noise(monkeypatch):
    """No tie-break noise in either package; the JAX async update adopted
    at the next frame.  The JAX `Slam`s of one configuration share one optax transform (it
    depends only on the parameter tree's structure), so that they share
    their jit compiles, which key on it."""
    jax_steps = importlib.import_module("tpuslam.train.steps")
    total_loss = jax_steps.total_loss
    monkeypatch.setattr(jax_steps, "total_loss",
                        lambda *args, **kwargs: total_loss(*args, **{**kwargs, "rng": None}))
    jax_slam = importlib.import_module("tpuslam.slam.slam")
    monkeypatch.setattr(jax_slam, "_tree_ready", lambda state: True)
    monkeypatch.setattr(jax_slam, "make_adapt_optimizer", _shared_tx)
    monkeypatch.setattr(port_slam, "make_train_state",
                        functools.partial(port_slam.make_train_state, seed=None))


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """A checkpoint folder written by the JAX package's `save_checkpoint`."""
    from tpuslam.models import init_depth_pose as jax_init

    _, variables = jax_init(jax.random.PRNGKey(3), height=32, width=96)
    return jax_save_checkpoint(tmp_path_factory.mktemp("ckpt"), 0, variables["params"],
                               variables["batch_stats"])


def _table(out):
    return {line.split("ATE=")[0].strip(): line for line in out.splitlines() if "ATE=" in line}


def test_cli_rungs_match(tmp_path, weights, capsys):
    """`cli.rungs --rungs 3,5 --frames 6 --dtype float32` with `--weights`
    set to the checkpoint: the same table rows (rung 3, the async rung 5
    and its sync ablation), ATE, rel_trans, abs_rel and loops within the
    printed precision (one unit in the last printed digit)."""
    argv = ["--rungs", "3,5", "--frames", "6", "--height", "32", "--width", "96",
            "--dtype", "float32", "--weights", str(weights)]
    assert jax_rungs.main(argv + ["--log", str(tmp_path / "jax")]) == 0
    want = _table(capsys.readouterr().out)
    assert rungs.main(argv + ["--log", str(tmp_path / "port"), "--device", "cpu"]) == 0
    got = _table(capsys.readouterr().out)
    assert list(got) == list(want) == ["rung 3: dual-network + replay",
                                       "rung 5: CoVIO async, 2-domain chain",
                                       "rung 5 sync ablation (same config)"]
    for name in want:
        g, w = got[name], want[name]
        print(f"port: {g}\njax:  {w}")
        for key, unit in (("ATE", 0.01), ("rel_trans", 1e-3), ("abs_rel", 1e-3)):
            gv = float(re.search(rf"{key}=\s*(-?[\d.]+|nan)", g).group(1))
            wv = float(re.search(rf"{key}=\s*(-?[\d.]+|nan)", w).group(1))
            assert (np.isnan(gv) and np.isnan(wv)) or abs(gv - wv) <= unit * 1.0001, (key, g, w)
        assert re.search(r"loops=(\d+)", g).group(1) == re.search(r"loops=(\d+)", w).group(1)
