"""`warp_and_loss` of the PyTorch port against the JAX package.

At 48 x 384 the JAX function runs its Pallas warp in interpret mode (float32
storage); the port runs K1's plain version.  Losses and their gradients.
"""
import numpy as np
import torch

import jax
import jax.numpy as jnp

from tpuslam.data import SyntheticDataset
from tpuslam.train import LossConfig as JaxLossConfig
from tpuslam.train import make_frame_batch as jax_batch
from tpuslam.train.steps import warp_and_loss as jax_warp_and_loss
from tpuslam_torch.train.batch import make_frame_batch
from tpuslam_torch.train.steps import LossConfig, warp_and_loss

torch.set_num_threads(1)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / (np.linalg.norm(want) + 1e-12)


def _frames(H, W, n):
    """n consecutive synthetic frame triplets (the same world for both sides)."""
    ds = SyntheticDataset(num_frames=n + 1, height=H, width=W)
    samples = [ds[i] for i in range(n)]
    rgb = np.stack([s.rgb for s in samples])
    rel = np.stack([s.rel_dist for s in samples])
    return rgb, ds.K, rel


def _near_ties(batch, outputs, scales, tol=1e-4):
    """Full-resolution pixels where the min-reprojection's two smallest
    candidates are within `tol`, dilated by 2 px (the 3x3 SSIM pool and the
    bilinear taps).  There a ~1e-7 difference in the error maps picks the
    other branch, which moves the gradient by O(1): a property of the min,
    not of either implementation."""
    from scipy.ndimage import binary_dilation

    from tpuslam_torch.losses.photometric import identity_reprojection, reprojection_loss

    target = batch.frame(0)
    ident = identity_reprojection({("rgb", 0, 0): target, ("rgb", -1, 0): batch.frame(-1),
                                   ("rgb", 1, 0): batch.frame(1)})
    tie = np.zeros(target.shape[:3], bool)
    with torch.no_grad():
        for s in scales:
            reproj = torch.stack([reprojection_loss(outputs[("rgb", f, s)].float(), target)
                                  for f in (-1, 1)], dim=1)
            srt = torch.sort(torch.cat([ident, reproj], 1), dim=1).values.numpy()
            tie |= (srt[:, 1] - srt[:, 0]) < tol
    return np.stack([binary_dilation(m, iterations=2) for m in tie])


def test_warp_and_loss_matches_pallas_path(rng):
    """48 x 384, B = 2, scales (0, 1): the JAX side runs its Pallas warp in
    interpret mode (in-window flow, bf16 storage off).  Losses agree within
    1e-5 relative.  Away from min-reprojection near-ties (`_near_ties`, < 5%
    of the pixels after dilation) the disparity gradients agree within 2e-3:
    each scale-1 value sums the upsampling transpose of 16 full-resolution
    gradients of mixed sign, and the disparity normalisation subtracts a
    per-image mean, so float32 rounding shows at ~7e-4 there (~2e-5 at
    scale 0).  The pose gradients, which sum over every pixel, near-ties
    included, agree within 1e-2."""
    H, W, B, scales = 48, 384, 2, (0, 1)
    # textured frames: on the synthetic world's flat sky identity and warp
    # both cost ~0 and half the pixels are near-ties
    _, K, rel = _frames(H, W, B)
    rgb = rng.uniform(size=(B, 3, H, W, 3)).astype(np.float32)
    disps = {s: rng.uniform(0.3, 0.6, (B, H >> s, W >> s, 1)).astype(np.float32)
             for s in scales}
    aa = rng.normal(scale=1e-3, size=(2 * B, 3)).astype(np.float32)
    tr = rng.normal(scale=2e-2, size=(2 * B, 3)).astype(np.float32)
    jcfg = JaxLossConfig(scales=scales, use_pallas_warp=True, pallas_bf16_out=False)
    jb = jax_batch(rgb, K, rel)

    def jfn(d, a, t):
        losses, _ = jax_warp_and_loss({("disp", s): d[s] for s in scales}, a, t, jb, jcfg)
        return losses["loss"], losses

    (_, want), jg = jax.value_and_grad(jfn, argnums=(0, 1, 2), has_aux=True)(
        {s: jnp.asarray(v) for s, v in disps.items()}, jnp.asarray(aa), jnp.asarray(tr))

    tcfg = LossConfig(scales=scales, use_pallas_warp=True, pallas_bf16_out=False,
                      bf16_networks=False)
    td = {s: torch.from_numpy(v).requires_grad_() for s, v in disps.items()}
    ta, tt = (torch.from_numpy(x).requires_grad_() for x in (aa, tr))
    tb = make_frame_batch(rgb, K, rel, device="cpu")
    got, outputs = warp_and_loss({("disp", s): td[s] for s in scales}, ta, tt, tb, tcfg)
    got["loss"].backward()
    for k in want:
        assert _rel(got[k].detach(), want[k]) < 1e-5, k
    ties = _near_ties(tb, outputs, scales)
    assert ties.mean() < 0.05
    for s in scales:
        f = 2 ** s
        keep = ~ties.reshape(B, H // f, f, W // f, f).any(axis=(2, 4))
        g, w = td[s].grad.numpy()[..., 0], np.asarray(jg[0][s])[..., 0]
        assert _rel(g[keep], w[keep]) < 2e-3, f"d/d disp_{s}"
    assert _rel(ta.grad, jg[1]) < 1e-2 and _rel(tt.grad, jg[2]) < 1e-2
