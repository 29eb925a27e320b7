"""Trajectory / metric plots (reference slam/slam.py:318-391 equivalents).

Counterpart of `tpuslam/viz/plots.py`: numpy, with matplotlib and PIL
imported when a figure is drawn."""
from __future__ import annotations

from pathlib import Path

import numpy as np


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_trajectory(slam, filename: Path) -> Path:
    plt = _plt()
    pred = slam.trajectory()
    gt = slam.trajectory(slam.gt_pose_graph)
    fig = plt.figure()
    plt.plot(pred[:, 0], pred[:, 2], "--.", label="pred")
    plt.plot(gt[:, 0], gt[:, 2], "--.", label="gt")
    plt.axis("equal")
    plt.legend()
    plt.title(f"Step = {slam.current_step}")
    plt.savefig(filename)
    plt.close(fig)
    np.save(Path(filename).with_suffix(".npy"), pred[:, [0, 2]])
    np.save(Path(filename).parent / "gt_trajectory.npy", gt[:, [0, 2]])
    return Path(filename)


def plot_metrics(slam, filename: Path) -> Path:
    plt = _plt()
    has_depth = bool(slam.depth_error)
    ncols = 4 if has_depth else 2
    fig, axs = plt.subplots(nrows=2, ncols=ncols, figsize=(3 * ncols, 6))
    panels = [
        (axs[0, 0], slam.depth_loss, "Depth loss"),
        (axs[1, 0], slam.velocity_loss, "Velocity loss"),
        (axs[0, 1], slam.rel_trans_error, "Relative trans. error"),
        (axs[1, 1], slam.rel_rot_error, "Relative rot. error"),
    ]
    if has_depth:
        panels += [
            (axs[0, 2], [d["abs_rel"] for d in slam.depth_error], "Abs rel"),
            (axs[1, 2], [d["sq_rel"] for d in slam.depth_error], "Sq rel"),
            (axs[0, 3], [d["rmse"] for d in slam.depth_error], "RMSE"),
            (axs[1, 3], [d["a1"] for d in slam.depth_error], "A1"),
        ]
    for ax, series, title in panels:
        ax.plot(series)
        ax.set_xlabel("Step")
        ax.set_title(title)
        if series:
            ax.set_ylim(bottom=0)
    fig.tight_layout()
    plt.savefig(filename, bbox_inches="tight")
    plt.close(fig)
    return Path(filename)


def save_depth_panel(image: np.ndarray, depth: np.ndarray, filename: Path) -> Path:
    """Side-by-side RGB + colored depth (reference save_prediction analog)."""
    plt = _plt()
    Path(filename).parent.mkdir(parents=True, exist_ok=True)
    fig, (ax1, ax2) = plt.subplots(2, 1, figsize=(8, 5))
    ax1.imshow(image)
    ax1.axis("off")
    ax1.set_title("input")
    vmax = np.percentile(depth, 95)
    ax2.imshow(depth, cmap="magma_r", vmax=vmax)
    ax2.axis("off")
    ax2.set_title(f"depth (vmax={vmax:.1f}m)")
    fig.tight_layout()
    plt.savefig(filename, bbox_inches="tight")
    plt.close(fig)
    return Path(filename)


def save_prediction_panels(
    rgbs,
    depths,
    indices,
    folder: Path,
    disps=None,
    gt_depths=None,
    max_strip_width: int = 3200,
):
    """Per-sample prediction panels + a horizontal review strip.

    Reference `save_prediction` (depth_pose_prediction.py:1197-1244): for
    each validation sample, a figure with the input RGB on top and the
    magma_r-colored depth (vmax = 95th percentile) below, written to
    `<folder>/{index:05}.png`; the first few figures are horizontally
    concatenated into one PIL strip (the reference caps it at 5x the image
    width) which the caller can wandb-log as 'pred_depth'.

    Beyond the reference: optional sigmoid-disparity and GT/abs-rel-error
    rows when `disps` / `gt_depths` are given.

    Returns (list of saved paths, PIL strip image).
    """
    from PIL import Image

    plt = _plt()
    folder = Path(folder)
    folder.mkdir(parents=True, exist_ok=True)
    paths = []
    strip = None
    for i, index in enumerate(indices):
        rows = 2 + (disps is not None) + 2 * (gt_depths is not None)
        fig, axs = plt.subplots(rows, 1, figsize=(6.4, 2.4 * rows))
        axs = np.atleast_1d(axs)
        r = 0
        axs[r].imshow(np.asarray(rgbs[i]))
        axs[r].set_title("Input")
        r += 1
        if disps is not None:
            axs[r].imshow(np.asarray(disps[i]), cmap="magma")
            axs[r].set_title("Disparity (sigmoid)")
            r += 1
        depth = np.asarray(depths[i])
        vmax = np.percentile(depth, 95)
        axs[r].imshow(depth, cmap="magma_r", vmax=vmax)
        axs[r].set_title(f"Depth prediction  |  vmax={vmax:.3f}")
        r += 1
        if gt_depths is not None:
            gt = np.asarray(gt_depths[i], np.float32)
            if gt.shape != depth.shape:  # GT often at source resolution
                gy = (np.arange(depth.shape[0]) * gt.shape[0] / depth.shape[0]).astype(int)
                gx = (np.arange(depth.shape[1]) * gt.shape[1] / depth.shape[1]).astype(int)
                gt = gt[np.ix_(gy, gx)]
            valid = gt > 0
            axs[r].imshow(np.where(valid, gt, np.nan), cmap="magma_r", vmax=vmax)
            axs[r].set_title("GT depth")
            r += 1
            err = np.where(valid, np.abs(depth - gt) / np.maximum(gt, 1e-6), np.nan)
            axs[r].imshow(err, cmap="viridis", vmax=1.0)
            mean_err = float(np.nanmean(err)) if valid.any() else float("nan")
            axs[r].set_title(f"abs-rel error  |  mean={mean_err:.3f}")
        for ax in axs:
            ax.axis("off")
        fig.tight_layout()
        path = folder / f"{int(index):05d}.png"
        fig.savefig(path, bbox_inches="tight")
        plt.close(fig)
        paths.append(path)
        panel = Image.open(path).convert("RGB")
        if strip is None:
            strip = panel
        elif strip.size[0] < max_strip_width:
            strip = h_concat_images(strip, panel)
    return paths, strip


def show_images(batch, filename=None, augmented: bool = False):
    """Debug panel of a FrameBatch: samples x frames grid
    (reference datasets/utils.py:287-307 analog; saves instead of plt.show)."""
    plt = _plt()
    rgb = (batch.rgb_aug if augmented else batch.rgb).cpu().numpy()
    B, F = rgb.shape[:2]
    fig, axs = plt.subplots(nrows=B, ncols=F, figsize=(3 * F, 1.2 * B))
    axs = np.atleast_2d(axs)
    rel = batch.rel_dist.cpu().numpy()
    for b in range(B):
        for f in range(F):
            axs[b, f].imshow(rgb[b, f])
            axs[b, f].axis("off")
            if f > 0:
                axs[b, f].set_title(f"{rel[b, f - 1]:.2f}m", fontsize=8)
    fig.tight_layout()
    out = filename or "batch_debug.png"
    plt.savefig(out, bbox_inches="tight")
    plt.close(fig)
    return out


def plot_image_matches(
    image_0,
    image_1,
    image_id_0=None,
    image_id_1=None,
    cosine_similarity=None,
    filename=None,
):
    """Loop-closure match debug figure (reference
    loop_closure_detection/utils.py:6-32 and display_matches)."""
    plt = _plt()
    fig = plt.figure()
    for i, (img, iid) in enumerate(((image_0, image_id_0), (image_1, image_id_1))):
        ax = plt.subplot(2, 1, i + 1)
        ax.imshow(img)
        ax.axis("off")
        if iid is not None:
            ax.set_title(str(iid))
    if cosine_similarity is not None:
        plt.suptitle(f"cos_sim = {cosine_similarity:.4f}")
    out = filename or f"match_{image_id_0}_{image_id_1}.png"
    plt.savefig(out, bbox_inches="tight")
    plt.close(fig)
    return out


def h_concat_images(im1, im2):
    """Horizontally concatenate two PIL images (reference
    depth_pose_prediction/utils.py:150-156)."""
    from PIL import Image

    dst = Image.new("RGB", (im1.width + im2.width, im1.height))
    dst.paste(im1, (0, 0))
    dst.paste(im2, (im1.width, 0))
    return dst
