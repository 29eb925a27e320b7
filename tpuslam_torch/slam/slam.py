"""Online continual-SLAM loop.

Counterpart of `tpuslam/slam/slam.py` with `pipeline_depth=0`: per frame one
`adapt_step` (or `eval_step` with `adaptation: false`) on the device, then
host bookkeeping -- replay-buffer admission, pose-graph vertex and edge,
metrics -- from one packed readback.

Kept reference behaviours: frames whose signed relative distance is below
`min_distance` are skipped (zero losses, no vertex) but still offered to the
replay buffer; the odometry edge uses inv(cam_T_cam(0, 1)) unless the rig is
reversing; odometry covariance diag(1, 1, .1, 1, 1, .1); the first vertex is
pinned to dataset.global_poses[1]; `start_frame` gates the mapping.

Not ported yet, and refused with NotImplementedError rather than ignored:
loop closure (and its MobileNet embedder), the expert/generalist and CoVIO
async modes, `pipeline_depth > 0`, periodic plots, checkpoint loading, and
the Kitti / RobotCar datasets.
"""
from __future__ import annotations

import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from tpuslam_torch import resolve_device
from tpuslam_torch.config.schema import Config
from tpuslam_torch.data.base import Sample
from tpuslam_torch.data.synthetic import SyntheticDataset
from tpuslam_torch.eval.depth import calc_depth_error
from tpuslam_torch.eval.trajectory import rotation_error, translation_error
from tpuslam_torch.memory.replay_buffer import ReplayBuffer
from tpuslam_torch.models.depth_pose import init_depth_pose
from tpuslam_torch.posegraph.graph import PoseGraph
from tpuslam_torch.train.batch import FrameBatch, concat_batches, make_frame_batch, pad_batch
from tpuslam_torch.train.state import make_adapt_optimizer, make_train_state
from tpuslam_torch.train.steps import embed, adapt_step, eval_step, loss_config


def _refuse_unported(config: Config, dataset) -> None:
    sc, pc = config.slam, config.depth_pose
    refused = {
        "slam.do_loop_closures": sc.do_loop_closures,
        "slam.use_expert": sc.use_expert,
        "slam.async_adaptation": sc.async_adaptation,
        "slam.pipeline_depth > 0": sc.pipeline_depth > 0,
        "slam.plot_frequency > 0 with logging": sc.logging and sc.plot_frequency > 0,
        "loop_closure.embedder: mobilenet": config.loop_closure.embedder == "mobilenet",
        "depth_pose.load_weights_folder": pc.load_weights_folder is not None,
        f"dataset {config.dataset.dataset}": (
            dataset is None and config.dataset.dataset in ("Kitti", "RobotCar")),
    }
    on = [name for name, value in refused.items() if value]
    if on:
        raise NotImplementedError(
            f"not ported to tpuslam_torch yet (ROADMAP.md Queue 1): {', '.join(on)}"
        )


class Slam:
    def __init__(self, config: Config, dataset=None, device="cuda"):
        _refuse_unported(config, dataset)
        self.device = resolve_device(device)
        self.config = config
        sc, dc, pc = config.slam, config.dataset, config.depth_pose
        self.do_adaptation = sc.adaptation
        self.adaptation_epochs = sc.adaptation_epochs
        self.min_distance = sc.min_distance
        self.start_frame = sc.start_frame
        self.logging = sc.logging
        self.batch_size = pc.batch_size if self.do_adaptation else 1
        self.log_path = Path(pc.log_path)
        self.log_path.mkdir(parents=True, exist_ok=True)

        if dataset is not None:
            self.dataset = dataset
        elif dc.dataset == "Synthetic":
            self.dataset = SyntheticDataset(
                num_frames=dc.num_frames, height=dc.height, width=dc.width,
                trajectory=dc.trajectory, speed=dc.speed, sparse_depth=dc.sparse_depth,
            )
        else:
            raise ValueError(f"unsupported dataset type {dc.dataset}")

        self.loss_cfg = loss_config(pc)
        self.model = init_depth_pose(
            0, resnet_depth=pc.resnet_depth, resnet_pose=pc.resnet_pose,
            scales=pc.scales, device=self.device,
        )
        self.model.requires_grad_(False)
        self.model.depth_decoder.requires_grad_(True)
        self.model.pose_decoder.requires_grad_(True)
        self.state = make_train_state(
            self.model,
            make_adapt_optimizer(self.model, pc.learning_rate, pc.adapt_depth_lr_scale),
        )
        self.replay_composition: List[List[int]] = []

        if self.do_adaptation and self.batch_size > 1:
            rb = config.replay_buffer
            state_path = buffer_dir = None
            if rb.load_path is not None:
                buffer_dir = Path(rb.load_path)
                buffer_dir.mkdir(parents=True, exist_ok=True)
                candidate = buffer_dir / "buffer_state.pkl"
                state_path = candidate if candidate.exists() else None
            self.replay_buffer = ReplayBuffer(
                storage_dir=buffer_dir,
                state_path=state_path,
                height=dc.height,
                width=dc.width,
                batch_size=self.batch_size - 1,
                max_buffer_size=rb.max_buffer_size,
                maximize_diversity=rb.maximize_diversity,
                similarity_threshold=rb.similarity_threshold,
                similarity_sampling=rb.similarity_sampling,
            )
        else:
            self.replay_buffer = None

        self.pose_graph = PoseGraph()
        self.gt_pose_graph = PoseGraph()
        if self.start_frame == 0:
            # reference quirk: the first vertex is global_poses[1]
            self.pose_graph.add_vertex(0, self.dataset.global_poses[1], fixed=True)
        self.gt_pose_graph.add_vertex(0, self.dataset.global_poses[1], fixed=True)

        self.current_step = 0
        self.rel_trans_error: List[float] = []
        self.rel_rot_error: List[float] = []
        self.depth_loss: List[float] = []
        self.velocity_loss: List[float] = []
        self.depth_error: List[Dict[str, float]] = []
        self.step_times: List[float] = []

    def __len__(self) -> int:
        return len(self.dataset)

    def _sample_to_batch(self, sample: Sample) -> FrameBatch:
        return make_frame_batch(
            sample.rgb[None], sample.K, sample.rel_dist[None],
            rgb_aug=None if sample.rgb_aug is None else sample.rgb_aug[None],
            device=self.device,
        )

    def _embed_frame(self, image: np.ndarray) -> torch.Tensor:
        """Pooled stage-4 depth-encoder embedding of one (H, W, 3) image."""
        x = torch.from_numpy(np.ascontiguousarray(image[None], np.float32)).to(self.device)
        return embed(self.model, x, self.loss_cfg)

    def _training_batch(self, online: FrameBatch, sample: Sample) -> FrameBatch:
        if self.replay_buffer is None or len(self.replay_buffer) == 0:
            return pad_batch(online, self.batch_size)
        embedding = None
        if self.replay_buffer.similarity_sampling:
            embedding = self._embed_frame(sample.rgb[1])[0].cpu().numpy()
        draws = self.replay_buffer.get(current_index=sample.index, embedding=embedding)
        self.replay_composition.append([int(d.index) for d in draws])
        if not draws:
            return pad_batch(online, self.batch_size)
        replay = make_frame_batch(
            np.stack([d.rgb for d in draws]),
            np.stack([d.K for d in draws]),
            np.stack([d.rel_dist for d in draws]),
            rgb_aug=np.stack([d.aug for d in draws]),
            device=self.device,
        )
        return pad_batch(concat_batches(online, replay), self.batch_size)

    def step(self, sample: Optional[Sample] = None) -> Dict[str, float]:
        """One SLAM frame: device dispatch, then host bookkeeping."""
        self.current_step += 1
        t_start = time.perf_counter()
        if sample is None:
            sample = self.dataset[self.current_step - 1]
        entry = self._dispatch(sample)
        out = self._retire(entry)
        if entry["kind"] == "full":
            self.step_times.append(time.perf_counter() - t_start)
        return out

    def _dispatch(self, sample: Sample) -> Dict:
        """Device phase of one frame; returns an entry for `_retire`."""
        step_id = self.current_step
        online = self._sample_to_batch(sample)
        if step_id > 1 and float(sample.rel_dist[1]) < self.min_distance:
            # skipped frames are still offered to the replay buffer with the
            # pre-adaptation embedding, like the reference
            embedding = None
            if self.replay_buffer is not None:
                embedding = self._embed_frame(sample.rgb[1])
            return {"kind": "skip", "step_id": step_id, "sample": sample,
                    "embedding": embedding}
        if self.do_adaptation:
            training = self._training_batch(online, sample)
            losses, outputs = adapt_step(
                self.state, self.loss_cfg, training,
                num_steps=self.adaptation_epochs, with_lc_embedding=False,
            )
        else:
            losses, outputs = eval_step(self.model, self.loss_cfg, online)
        return {"kind": "full", "step_id": step_id, "sample": sample,
                "losses": losses, "outputs": outputs}

    def _retire(self, entry: Dict) -> Dict[str, float]:
        """Host phase of one frame: one readback, then replay-buffer
        admission, pose-graph vertex and edge, and metrics."""
        sample: Sample = entry["sample"]
        step_id: int = entry["step_id"]
        if entry["kind"] == "skip":
            if entry["embedding"] is not None:
                self.replay_buffer.add(sample, entry["embedding"][0].cpu().numpy())
            return {"depth_loss": 0.0, "velocity_loss": 0.0}
        outputs = entry["outputs"]
        flat = outputs[("retire_packed",)].cpu().numpy()
        D = int(outputs[("embedding",)].shape[-1])
        T01 = np.asarray(flat[:16].reshape(4, 4), np.float64)
        embedding = flat[16:16 + D]
        dl, vl, tl = (float(x) for x in flat[16 + D:19 + D])
        losses_out = {"depth_loss": dl, "velocity_loss": vl, "loss": tl}
        if self.replay_buffer is not None:
            self.replay_buffer.add(sample, embedding)

        if float(np.sign(sample.rel_dist[1])) < 0:
            transformation = T01  # reversing
        else:
            transformation = np.linalg.inv(T01)
        if not np.isfinite(tl):
            raise RuntimeError(f"NaN loss at step {step_id}: {losses_out}")

        gt_transformation = np.asarray(sample.rel_pose, np.float64)
        gt_pose = np.asarray(sample.abs_pose, np.float64)
        self.gt_pose_graph.add_vertex(step_id, gt_pose)
        self.gt_pose_graph.add_edge(
            (self.gt_pose_graph.vertex_ids[-2], step_id), gt_transformation
        )
        if step_id == self.start_frame:
            self.pose_graph.add_vertex(step_id, gt_pose, fixed=True)
        elif step_id > self.start_frame:
            prev_id = self.pose_graph.vertex_ids[-1]
            self.pose_graph.add_vertex(step_id, self.pose_graph.get_pose(prev_id) @ transformation)
            cov = np.eye(6)
            cov[2, 2] = cov[5, 5] = 0.1
            self.pose_graph.add_edge((prev_id, step_id), transformation,
                                     information=np.linalg.inv(cov))

        if self.logging:
            rel_err = np.linalg.inv(gt_transformation) @ transformation
            self.rel_trans_error.append(translation_error(rel_err))
            self.rel_rot_error.append(rotation_error(rel_err))
            self.depth_loss.append(dl)
            self.velocity_loss.append(vl)
            if sample.depth is not None:
                pred_depth = outputs[("depth", 0)][0, ..., 0].cpu().numpy()
                self.depth_error.append(calc_depth_error(
                    pred_depth, sample.depth,
                    min_depth=self.loss_cfg.min_depth, max_depth=self.loss_cfg.max_depth,
                ))
        return losses_out
