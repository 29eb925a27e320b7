from tpuslam_torch.slam.slam import Slam

__all__ = ["Slam"]
