"""`adapt_step` of the PyTorch port against the JAX package.

One K = 2 adapt_step at 64 x 192 on each side, from the same weights and
batch of synthetic frames; the JAX side runs its plain sampler (the XLA
gather computes K1's function).  Compared: updated decoder parameters,
last-iteration losses and the packed readback.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpuslam.data import SyntheticDataset
from tpuslam.models import init_depth_pose as jax_init
from tpuslam.train import LossConfig as JaxLossConfig
from tpuslam.train import adapt_step as jax_adapt_step
from tpuslam.train import make_adapt_optimizer as jax_optimizer
from tpuslam.train import make_frame_batch as jax_batch
from tpuslam.train import make_train_state as jax_state
from tpuslam_torch.checkpoint.from_jax import jax_to_state_dict, load_jax_variables
from tpuslam_torch.models.depth_pose import init_depth_pose
from tpuslam_torch.train.batch import make_frame_batch
from tpuslam_torch.train.state import make_adapt_optimizer, make_train_state
from tpuslam_torch.train.steps import LossConfig, adapt_step

torch.set_num_threads(1)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / (np.linalg.norm(want) + 1e-12)


def _frames(H, W, n):
    """n consecutive synthetic frame triplets (the same world for both sides)."""
    ds = SyntheticDataset(num_frames=n + 1, height=H, width=W)
    samples = [ds[i] for i in range(n)]
    return np.stack([s.rgb for s in samples]), ds.K, np.stack([s.rel_dist for s in samples])


@pytest.fixture(scope="module")
def adapted():
    """One K = 2 adapt_step on each side from the same weights and batch."""
    H, W, K_ITERS = 64, 192, 2
    rgb, K, rel = _frames(H, W, 3)
    model, variables = jax_init(jax.random.PRNGKey(0), height=H, width=W,
                                dtype=jnp.float32)
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    stats = jax.tree_util.tree_map(np.asarray, variables["batch_stats"])
    tx = jax_optimizer(params, 1e-4)
    jcfg = JaxLossConfig(scales=(0, 1, 2, 3), use_pallas_warp=False)
    jstate = jax_state(params, stats, tx)
    jstate, jlosses, jout = jax_adapt_step(
        model, tx, jcfg, jstate, None, jax_batch(rgb, K, rel), num_steps=K_ITERS,
        with_lc_embedding=True)

    port = init_depth_pose(0, device="cpu")
    load_jax_variables(port, params, stats)
    state = make_train_state(port, make_adapt_optimizer(port, 1e-4), seed=None)
    tcfg = LossConfig(scales=(0, 1, 2, 3), pallas_bf16_out=False, bf16_networks=False)
    tlosses, tout = adapt_step(state, tcfg, make_frame_batch(rgb, K, rel, device="cpu"),
                               num_steps=K_ITERS, with_lc_embedding=True)
    return dict(params=params, jstate=jstate, jlosses=jlosses, jout=jout,
                port=port, tlosses=tlosses, tout=tout)


def test_adapt_step_losses_and_readback(adapted):
    """Last-iteration losses and the packed readback (pose, embedding,
    losses, loop-closure embedding) within 1e-4 relative.  The JAX step
    always adds its 1e-5 identity tie-break noise, which the port cannot
    reproduce (jax.random); it moves the losses by far less than 1e-4."""
    jl, tl = adapted["jlosses"], adapted["tlosses"]
    for k in ("loss", "depth_loss", "velocity_loss"):
        assert _rel(tl[k], jl[k]) < 1e-4, k
    assert _rel(tl["iter_losses"], jl["iter_losses"]) < 1e-4
    assert _rel(adapted["tout"][("retire_packed",)],
                adapted["jout"][("retire_packed",)]) < 1e-4


def test_adapt_step_updates_decoders_only(adapted):
    """Updated decoder parameters (all of them as one vector) within 1e-4
    relative; the updates themselves (2 Adam steps of ~lr per weight, sign-sensitive where a
    gradient is near zero) within 2e-2 relative; encoders unchanged."""
    before = jax_to_state_dict(adapted["params"], adapted["jstate"].batch_stats)
    want = jax_to_state_dict(jax.tree_util.tree_map(np.asarray, adapted["jstate"].params),
                             adapted["jstate"].batch_stats)
    got = {k: v.numpy() for k, v in adapted["port"].state_dict().items()
           if not k.endswith("num_batches_tracked")}
    for k, w in want.items():
        if "encoder" in k:
            np.testing.assert_array_equal(got[k], w, err_msg=k)
        else:
            assert not np.array_equal(w, before[k]), k
    dec = [k for k in want if "decoder" in k]
    assert _rel(np.concatenate([got[k].ravel() for k in dec]),
                np.concatenate([want[k].ravel() for k in dec])) < 1e-4
    dec = [k for k in want if "decoder" in k]
    upd_got = np.concatenate([(got[k] - before[k]).ravel() for k in dec])
    upd_want = np.concatenate([(want[k] - before[k]).ravel() for k in dec])
    assert _rel(upd_got, upd_want) < 2e-2
