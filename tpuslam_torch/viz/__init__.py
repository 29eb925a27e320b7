from tpuslam_torch.viz.meshlab import MeshlabExporter, false_color, norm_range_01
from tpuslam_torch.viz.plots import (
    plot_image_matches,
    plot_metrics,
    plot_trajectory,
    save_depth_panel,
    show_images,
)
from tpuslam_torch.viz.pointcloud import (
    accumulate_pcl,
    depth_to_pcl,
    pcl_to_image,
    save_point_cloud,
)

__all__ = [
    "MeshlabExporter",
    "accumulate_pcl",
    "depth_to_pcl",
    "pcl_to_image",
    "save_point_cloud",
    "false_color",
    "norm_range_01",
    "plot_image_matches",
    "plot_metrics",
    "plot_trajectory",
    "save_depth_panel",
    "show_images",
]
