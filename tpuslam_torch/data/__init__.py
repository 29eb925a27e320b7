from tpuslam_torch.data.base import (
    KITTI_NORMALIZED_K,
    Prefetcher,
    Sample,
    adjust_brightness,
    adjust_contrast,
    adjust_hue,
    adjust_saturation,
    load_image,
    random_color_jitter,
    scale_intrinsics,
)
from tpuslam_torch.data.cityscapes import Cityscapes
from tpuslam_torch.data.kitti import KITTI_RAW_SEQ_MAPPING, KittiOdometry
from tpuslam_torch.data.multi import ChainedDataset
from tpuslam_torch.data.robotcar import RobotCar, undistort_robotcar
from tpuslam_torch.data.synthetic import SyntheticDataset, make_trajectory

__all__ = [
    "KITTI_NORMALIZED_K",
    "ChainedDataset",
    "Cityscapes",
    "KITTI_RAW_SEQ_MAPPING",
    "KittiOdometry",
    "RobotCar",
    "Prefetcher",
    "Sample",
    "SyntheticDataset",
    "undistort_robotcar",
    "adjust_brightness",
    "adjust_contrast",
    "adjust_hue",
    "adjust_saturation",
    "load_image",
    "make_trajectory",
    "random_color_jitter",
    "sample_to_batch",
    "scale_intrinsics",
]


def sample_to_batch(sample: Sample, device="cuda"):
    """Sample -> single-item FrameBatch on `device`."""
    from tpuslam_torch.train.batch import make_frame_batch

    return make_frame_batch(
        sample.rgb[None],
        sample.K,
        sample.rel_dist[None],
        rgb_aug=None if sample.rgb_aug is None else sample.rgb_aug[None],
        mask=None if sample.mask is None else sample.mask[None],
        device=device,
    )
