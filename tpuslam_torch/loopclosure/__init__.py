from tpuslam_torch.loopclosure.detection import LoopClosureDetection

__all__ = ["LoopClosureDetection"]
