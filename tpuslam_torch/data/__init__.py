from tpuslam_torch.data.base import Sample
from tpuslam_torch.data.multi import ChainedDataset
from tpuslam_torch.data.synthetic import SyntheticDataset

__all__ = ["ChainedDataset", "Sample", "SyntheticDataset", "sample_to_batch"]


def sample_to_batch(sample: Sample, device="cuda"):
    """Sample -> single-item FrameBatch on `device`."""
    from tpuslam_torch.train.batch import make_frame_batch

    return make_frame_batch(
        sample.rgb[None],
        sample.K,
        sample.rel_dist[None],
        rgb_aug=None if sample.rgb_aug is None else sample.rgb_aug[None],
        device=device,
    )
