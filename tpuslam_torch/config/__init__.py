from tpuslam_torch.config.parser import dump_config, parse_config, save_config
from tpuslam_torch.config.schema import (
    Config,
    DatasetConfig,
    DepthPoseConfig,
    LoopClosureConfig,
    ReplayBufferConfig,
    SlamConfig,
)

__all__ = [
    "Config",
    "DatasetConfig",
    "DepthPoseConfig",
    "LoopClosureConfig",
    "ReplayBufferConfig",
    "SlamConfig",
    "dump_config",
    "parse_config",
    "save_config",
]
