"""Online continual-SLAM loop.

Counterpart of `tpuslam/slam/slam.py`: per frame one `adapt_step` (or
`eval_step` with `adaptation: false`) on the device, whose readback is one
packed vector, then host bookkeeping -- replay-buffer admission, pose-graph
vertex and edge, loop-closure search and pose-graph solve, metrics.

With `pipeline_depth` N > 0 the bookkeeping of frame t runs while frames
t+1..t+N are dispatched: `_dispatch` starts non-blocking copies of
everything `_retire` reads into pinned host memory and records an event,
and `_retire` waits on that event alone.  Retire reads only tensors made
at the frame's own dispatch; the loop-closure pose prediction uses the
newest weights, as the JAX package documents.  `run` drives the loop with a
thread pool that prepares the next frames on the host.

Dual-network mode (`use_expert`): `state` is the expert, adapted every
frame; a generalist, a clone of the initial state with its own Adam and
generator, consolidates on replay-only batches every `generalist_interval`
frames, and `reset_expert_from_generalist` starts the expert anew from it.

CoVIO async mode (`async_adaptation`): each frame is served by `eval_step`
with the newest finished weights, and the update runs behind it on a clone
(`consolidate_step_async`), on a second CUDA stream that `Slam` owns.  An
update is adopted at the first frame that finds it done (`event.query()`):
the current stream waits on its event and `state` becomes the clone.  While
one update is in flight no other is launched.  On the CPU the update runs
synchronously and is adopted at the next frame.  `run` ends in
`finish_async`, which adopts the last update.

Kept reference behaviours: frames whose signed relative distance is below
`min_distance` are skipped (zero losses, no vertex) but still offered to the
replay buffer; the odometry edge uses inv(cam_T_cam(0, 1)) unless the rig is
reversing; odometry covariance diag(1, 1, .1, 1, 1, .1), loop edges weighted
0.5x; the first vertex is pinned to dataset.global_poses[1]; loop closures
every `keyframe_frequency` steps while step < 4000, with a cooldown of
`lc_distance_poses`; `start_frame` gates the mapping.

Loop closures search the depth encoder's pooled stage-4 feature of the frame
+1 image, which the step packs into its readback, or, with `embedder:
mobilenet`, the MobileNetV3-small embedding of that image: one more forward
per frame, made at the frame's dispatch and copied back with its readback.
"""
from __future__ import annotations

import pickle
import time
from collections import OrderedDict, deque
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from tpuslam_torch import resolve_device, tracing
from tpuslam_torch.checkpoint.io import load_checkpoint, save_checkpoint
from tpuslam_torch.checkpoint.torch_import import load_mobilenet_embedder
from tpuslam_torch.config.schema import Config
from tpuslam_torch.data.base import Sample
from tpuslam_torch.data.kitti import KittiOdometry
from tpuslam_torch.data.robotcar import DEFAULT_SEQUENCE, EVAL_WINDOWS, RobotCar
from tpuslam_torch.data.synthetic import SyntheticDataset
from tpuslam_torch.eval.depth import calc_depth_error
from tpuslam_torch.eval.trajectory import calc_error, rotation_error, translation_error
from tpuslam_torch.loopclosure import LoopClosureDetection
from tpuslam_torch.memory.replay_buffer import ReplayBuffer
from tpuslam_torch.models.depth_pose import DepthPoseNet, init_depth_pose
from tpuslam_torch.models.embedder import init_mobilenet_embedder
from tpuslam_torch.posegraph.graph import PoseGraph
from tpuslam_torch.train.batch import FrameBatch, concat_batches, make_frame_batch, pad_batch
from tpuslam_torch.train.state import (
    TrainState,
    clone_train_state,
    make_adapt_optimizer,
    make_train_state,
    train_state_tensors,
)
from tpuslam_torch.train.steps import (
    adapt_step,
    consolidate_step,
    consolidate_step_async,
    embed,
    eval_step,
    loss_config,
    predict_pose_step,
)

LC_MAX_STEP = 4000  # reference hard cap on loop-closure searches


def _odometry_information() -> np.ndarray:
    cov = np.eye(6)
    cov[2, 2] = cov[5, 5] = 0.1
    return np.linalg.inv(cov)


class Slam:
    def __init__(self, config: Config, dataset=None, device="cuda"):
        self.device = resolve_device(device)
        self.config = config
        sc, dc, pc = config.slam, config.dataset, config.depth_pose
        self.do_adaptation = sc.adaptation
        self.adaptation_epochs = sc.adaptation_epochs
        self.min_distance = sc.min_distance
        self.start_frame = sc.start_frame
        self.logging = sc.logging
        self.plot_frequency = sc.plot_frequency
        self.do_loop_closures = sc.do_loop_closures
        self.keyframe_frequency = sc.keyframe_frequency
        self.lc_distance_poses = sc.lc_distance_poses
        self.pipeline_depth = sc.pipeline_depth
        self.batch_size = pc.batch_size if self.do_adaptation else 1
        self.log_path = Path(pc.log_path)
        self.log_path.mkdir(parents=True, exist_ok=True)

        if dataset is not None:
            self.dataset = dataset
        elif dc.dataset == "Kitti":
            self.dataset = KittiOdometry(
                dc.dataset_path, int(sc.dataset_sequence), height=dc.height, width=dc.width,
                with_poses=True, min_distance=sc.min_distance,
            )
        elif dc.dataset == "RobotCar":
            # the reference's evaluation windows
            window = EVAL_WINDOWS.get(int(sc.dataset_sequence), (750, 4750))
            self.dataset = RobotCar(
                dc.dataset_path, DEFAULT_SEQUENCE, height=dc.height, width=dc.width,
                with_poses=True, min_distance=sc.min_distance, start_frame=window[0],
                end_frame=window[1], every_n_frame=2,
            )
        elif dc.dataset == "Synthetic":
            self.dataset = SyntheticDataset(
                num_frames=dc.num_frames, height=dc.height, width=dc.width,
                trajectory=dc.trajectory, speed=dc.speed, sparse_depth=dc.sparse_depth,
            )
        else:
            raise ValueError(f"unsupported dataset type {dc.dataset}")

        # online frames carry no dynamic-object mask; `mask_dynamic` is a
        # pretraining option, which the JAX package's Slam does not read
        self.loss_cfg = loss_config(pc)._replace(mask_dynamic=False)
        model = init_depth_pose(
            0, resnet_depth=pc.resnet_depth, resnet_pose=pc.resnet_pose,
            scales=pc.scales, device=self.device,
        )
        model.requires_grad_(False)
        model.depth_decoder.requires_grad_(True)
        model.pose_decoder.requires_grad_(True)
        if pc.load_weights_folder is not None and Path(pc.load_weights_folder).exists():
            load_checkpoint(pc.load_weights_folder, model)
            print(f"slam: loaded weights from {pc.load_weights_folder}")
        elif pc.load_weights_folder is not None:
            print(f"slam: weights folder not found, using random init: "
                  f"{pc.load_weights_folder}")
        self.state = self._fresh_state(model)
        # dual-network mode: `state` is the expert, the generalist
        # consolidates on replay every `generalist_interval` frames
        self.use_expert = sc.use_expert
        self.generalist_interval = sc.generalist_interval
        self.generalist_steps = sc.generalist_steps
        self.generalist_state = clone_train_state(self.state) if self.use_expert else None
        # CoVIO async mode: the update in flight as (state, event), None
        # when there is none; the counters show updates lag or are skipped
        # rather than hold the frame back
        self.async_adaptation = sc.async_adaptation
        self._pending = None
        self._side_stream = None
        if self.async_adaptation and self.device.type == "cuda":
            self._side_stream = torch.cuda.Stream(self.device)
        self.async_updates_launched = 0
        self.async_updates_adopted = 0
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

        # loop closures on the depth encoder's pooled stage-4 feature (512-d
        # at ResNet-18/34, 2048-d at 50), or on the 576-d MobileNetV3-small
        # embedding
        lc = config.loop_closure
        self._mobilenet = None
        if lc.embedder == "mobilenet":
            if lc.embedder_weights is not None and Path(lc.embedder_weights).exists():
                self._mobilenet = load_mobilenet_embedder(lc.embedder_weights, self.device)
                print(f"slam: loaded mobilenet embedder from {lc.embedder_weights}")
            else:
                self._mobilenet = init_mobilenet_embedder(1, self.device)
                print(
                    "slam: WARNING — mobilenet LC embedder is randomly initialised "
                    "(no embedder_weights); detection_threshold "
                    f"{lc.detection_threshold} is calibrated for ImageNet features "
                    "(reference loop_closure_detection/encoder.py:28-33)"
                )
        # the step packs the depth-encoder loop-closure embedding only when
        # it is the one searched
        self._lc_in_step = self.do_loop_closures and self._mobilenet is None
        self.loop_closure_detection = LoopClosureDetection(
            detection_threshold=lc.detection_threshold,
            id_threshold=lc.id_threshold,
            num_matches=lc.num_matches,
            num_features=(self.model.depth_encoder.num_ch_encoder[-1] if self._mobilenet is None
                          else self._mobilenet.num_features),
        )
        self.lc_edge_diagnostics: List[dict] = []
        # frame +1 images of loop-closure candidates, least recently used first
        self._lc_cache: "OrderedDict[int, np.ndarray]" = OrderedDict()
        self._lc_cache_size = 32
        # dispatched frames whose host bookkeeping has not run yet
        self._retire_queue: "deque[Dict]" = deque()

        self.pose_graph = PoseGraph()
        self.gt_pose_graph = PoseGraph()
        if self.start_frame == 0:
            # reference quirk: the first vertex is global_poses[1]
            self.pose_graph.add_vertex(0, self.dataset.global_poses[1], fixed=True)
        self.gt_pose_graph.add_vertex(0, self.dataset.global_poses[1], fixed=True)

        self.current_step = 0
        self.since_last_loop_closures = self.lc_distance_poses
        self.rel_trans_error: List[float] = []
        self.rel_rot_error: List[float] = []
        self.depth_loss: List[float] = []
        self.velocity_loss: List[float] = []
        self.depth_error: List[Dict[str, float]] = []
        self.step_times: List[float] = []

    def __len__(self) -> int:
        return len(self.dataset)

    @property
    def model(self) -> DepthPoseNet:
        """The networks that serve the frames: the (expert) state's."""
        return self.state.model

    def _fresh_state(self, model: DepthPoseNet) -> TrainState:
        pc = self.config.depth_pose
        return make_train_state(
            model, make_adapt_optimizer(model, pc.learning_rate, pc.adapt_depth_lr_scale))

    def _to_device(self, images: np.ndarray) -> torch.Tensor:
        images = np.ascontiguousarray(images, np.float32)
        if tracing.on:
            tracing.count("h2d_bytes", images.nbytes)
        return torch.from_numpy(images).to(self.device)

    def _sample_to_batch(self, sample: Sample) -> FrameBatch:
        return make_frame_batch(
            sample.rgb[None], sample.K, sample.rel_dist[None],
            rgb_aug=None if sample.rgb_aug is None else sample.rgb_aug[None],
            device=self.device,
        )

    def _embed_frame(self, image: np.ndarray) -> torch.Tensor:
        """Pooled stage-4 depth-encoder embedding of one (H, W, 3) image."""
        return embed(self.model, self._to_device(image[None]), self.loss_cfg)

    def _training_batch(self, online: FrameBatch, sample: Sample) -> FrameBatch:
        if self.replay_buffer is None or len(self.replay_buffer) == 0:
            return pad_batch(online, self.batch_size)
        with tracing.span("data.replay"):
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
        """One SLAM frame: device dispatch, then host bookkeeping.

        With `pipeline_depth` N > 0 this dispatches frame t and retires
        frame t-N: the losses returned are frame t-N's (zeros while the
        queue fills), and `flush_pipeline` retires the rest."""
        self.current_step += 1
        with tracing.span("slam.step", self.current_step):
            t_start = time.perf_counter()
            if sample is None:
                sample = self.dataset[self.current_step - 1]
            entry = self._dispatch(sample)
            self._retire_queue.append(entry)
            out = {"depth_loss": 0.0, "velocity_loss": 0.0}
            while len(self._retire_queue) > self.pipeline_depth:
                out = self._retire(self._retire_queue.popleft())
            if entry["kind"] == "full":
                self.step_times.append(time.perf_counter() - t_start)
        return out

    @tracing.traced("slam.dispatch")
    def _dispatch(self, sample: Sample) -> Dict:
        """Device phase of one frame, ending with the copies of what
        `_retire` reads; returns the entry for `_retire`."""
        step_id = self.current_step
        online = self._sample_to_batch(sample)
        if step_id > 1 and float(sample.rel_dist[1]) < self.min_distance:
            # skipped frames are still offered to the replay buffer with the
            # pre-adaptation embedding, like the reference
            entry = {"kind": "skip", "step_id": step_id, "sample": sample, "outputs": {}}
            if self.replay_buffer is not None:
                entry["outputs"][("embedding",)] = self._embed_frame(sample.rgb[1])
            self._start_host_copies(entry)
            return entry
        if self.do_adaptation and self.async_adaptation:
            # serve the frame with the newest finished weights; launch the
            # next update only when none is in flight
            if self._pending is not None and self._update_done():
                self._adopt()
            losses, outputs = eval_step(self.model, self.loss_cfg, online,
                                        with_lc_embedding=self._lc_in_step)
            if self._pending is None:
                training = self._training_batch(online, sample)
                self._pending = consolidate_step_async(
                    self.state, self.loss_cfg, training, num_steps=self.adaptation_epochs,
                    stream=self._side_stream)
                self.async_updates_launched += 1
        elif self.do_adaptation:
            training = self._training_batch(online, sample)
            losses, outputs = adapt_step(
                self.state, self.loss_cfg, training,
                num_steps=self.adaptation_epochs, with_lc_embedding=self._lc_in_step,
            )
        else:
            losses, outputs = eval_step(self.model, self.loss_cfg, online,
                                        with_lc_embedding=self._lc_in_step)
        if (self.use_expert and self.replay_buffer is not None
                and len(self.replay_buffer) > 0 and step_id % self.generalist_interval == 0):
            self._consolidate_generalist()
        if (self._mobilenet is not None and self.do_loop_closures
                and step_id >= self.start_frame):
            outputs[("mobilenet_embedding",)] = self._mobilenet.embed(
                self._to_device(sample.rgb[2][None]))
        entry = {"kind": "full", "step_id": step_id, "sample": sample,
                 "losses": losses, "outputs": outputs}
        self._start_host_copies(entry)
        return entry

    def _consolidate_generalist(self) -> None:
        """The generalist's update on a replay-only batch, drawn after the
        frame's own draws and padded to `batch_size`."""
        draws = self.replay_buffer.get(current_index=None)
        if not draws:
            return
        replay = make_frame_batch(
            np.stack([d.rgb for d in draws]),
            np.stack([d.K for d in draws]),
            np.stack([d.rel_dist for d in draws]),
            rgb_aug=np.stack([d.aug for d in draws]),
            device=self.device,
        )
        consolidate_step(self.generalist_state, self.loss_cfg,
                         pad_batch(replay, self.batch_size), num_steps=self.generalist_steps)

    def _update_done(self) -> bool:
        event = self._pending[1]
        return event is None or event.query()

    def _adopt(self) -> None:
        """Serve with the pending update's state from here on.  The current
        stream waits on the update's event; the new state's own tensors were
        made on the side stream and are recorded on the current one, so
        that the allocator keeps their memory until the current stream's
        work on them is done once the state is dropped (its encoders are
        the shared ones)."""
        state, event = self._pending
        if event is not None:
            current = torch.cuda.current_stream(self.device)
            current.wait_event(event)
            for t in train_state_tensors(state):
                if t.is_cuda:
                    t.record_stream(current)
        self.state = state
        self._pending = None
        self.async_updates_adopted += 1

    def finish_async(self) -> None:
        """Retire every queued frame, then wait for the update in flight and
        adopt it."""
        self.flush_pipeline()
        if self._pending is not None:
            if self._pending[1] is not None:
                self._pending[1].synchronize()
            self._adopt()

    def reset_expert_from_generalist(self) -> None:
        """Start the expert anew from the generalist's weights, with a fresh
        optimizer and generator: the CL-SLAM move when entering a
        (re)visited environment."""
        if self.generalist_state is None:
            raise RuntimeError("dual-network mode is not enabled (use_expert)")
        self.state = self._fresh_state(clone_train_state(self.generalist_state).model)

    @tracing.traced("slam.host_copies")
    def _start_host_copies(self, entry: Dict) -> None:
        """Copy every tensor `_retire` reads to the host, without blocking
        on the card: into pinned memory on the current stream, then an
        event that `_retire` waits on.  On the CPU the tensors are read in
        place: they are made by this frame's dispatch and never written
        again.  Their bytes add to the tracer's counter `d2h_bytes` (on
        the CPU too, where nothing is copied)."""
        outputs = entry["outputs"]
        if entry["kind"] == "skip":
            reads = {"embedding": outputs.get(("embedding",))}
        else:
            reads = {"packed": outputs[("retire_packed",)],
                     "mobilenet": outputs.get(("mobilenet_embedding",))}
            if self.logging and entry["sample"].depth is not None:
                reads["depth"] = outputs[("depth", 0)][0, ..., 0]
        host = {}
        for name, t in reads.items():
            if tracing.on and t is not None:
                tracing.count("d2h_bytes", t.numel() * t.element_size())
            if t is None or t.device.type == "cpu":
                host[name] = t
                continue
            host[name] = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host[name].copy_(t, non_blocking=True)
        entry["host"] = host
        entry["event"] = None
        if self.device.type == "cuda":
            entry["event"] = torch.cuda.Event()
            entry["event"].record()

    def _retire(self, entry: Dict) -> Dict[str, float]:
        """Host phase of one frame: replay-buffer admission, pose-graph
        vertex and edge, loop-closure search and solve, metrics."""
        with tracing.span("slam.retire", entry["step_id"]):
            sample: Sample = entry["sample"]
            step_id: int = entry["step_id"]
            if entry["event"] is not None:
                with tracing.span("slam.retire.wait"):
                    entry["event"].synchronize()
            host = entry["host"]
            if entry["kind"] == "skip":
                if host["embedding"] is not None:
                    self.replay_buffer.add(sample, host["embedding"][0].numpy())
                return {"depth_loss": 0.0, "velocity_loss": 0.0}
            flat = host["packed"].numpy()
            D = int(entry["outputs"][("embedding",)].shape[-1])
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
                self.pose_graph.add_vertex(step_id,
                                           self.pose_graph.get_pose(prev_id) @ transformation)
                self.pose_graph.add_edge((prev_id, step_id), transformation,
                                         information=_odometry_information())

            if self.do_loop_closures and step_id >= self.start_frame:
                # the frame +1 loop-closure embedding: the end of the packed
                # vector, or the MobileNet one copied beside it
                lc_embedding = flat[19 + D:] if host["mobilenet"] is None else \
                    host["mobilenet"][0].numpy()
                self.loop_closure_detection.add(step_id, lc_embedding)
                optimized = False
                if (step_id % self.keyframe_frequency == 0 and step_id < LC_MAX_STEP
                        and self.since_last_loop_closures > self.lc_distance_poses):
                    optimized = self._close_loops(step_id, sample)
                if optimized:
                    self.since_last_loop_closures = 0
                else:
                    self.since_last_loop_closures += 1

            if self.logging:
                rel_err = np.linalg.inv(gt_transformation) @ transformation
                self.rel_trans_error.append(translation_error(rel_err))
                self.rel_rot_error.append(rotation_error(rel_err))
                self.depth_loss.append(dl)
                self.velocity_loss.append(vl)
                if sample.depth is not None:
                    self.depth_error.append(calc_depth_error(
                        host["depth"].numpy(), sample.depth,
                        min_depth=self.loss_cfg.min_depth, max_depth=self.loss_cfg.max_depth,
                    ))
            # periodic visual checkpoints, as the reference draws them
            if self.logging and self.plot_frequency > 0 and step_id % self.plot_frequency == 0:
                try:
                    self.plot_trajectory(self.log_path / f"trajectory_{step_id}.png")
                    self.plot_metrics(self.log_path / f"metrics_{step_id}.png")
                    self.pose_graph.visualize_in_meshlab(
                        self.log_path / f"pose_graph_{step_id}.obj", verbose=False)
                except Exception as e:  # plotting must never kill the run
                    print(f"periodic plotting skipped: {e}")
            return losses_out

    def _close_loops(self, step_id: int, sample: Sample) -> bool:
        """Search the index for keyframe `step_id`, add a loop edge for each
        match from the pose network on (frame +1, candidate), and solve the
        graph; True when it was solved."""
        lc_ids, sims = self.loop_closure_detection.search(step_id)
        for lc_id, sim in zip(lc_ids, sims):
            lc_image = self._lc_image(lc_id)
            if lc_image is None:
                continue
            T_lc, _ = predict_pose_step(
                self.model, self._to_device(sample.rgb[2][None]),
                self._to_device(lc_image[None]), bf16_networks=self.loss_cfg.bf16_networks,
            )
            lc_transformation = T_lc[0].cpu().numpy().astype(np.float64)
            self.pose_graph.add_edge((step_id, lc_id), lc_transformation,
                                     information=0.5 * _odometry_information(),
                                     is_loop_closure=True)
            # how good was the predicted loop pose? (a wrong one makes the
            # solve pull the trajectory off)
            gt_rel = self.gt_pose_graph.get_transform(step_id, lc_id)
            diag = {
                "step": step_id,
                "lc_id": int(lc_id),
                "sim": float(sim),
                "pred_dist": float(np.linalg.norm(lc_transformation[:3, 3])),
                "gt_dist": float(np.linalg.norm(gt_rel[:3, 3])),
                "trans_err": float(np.linalg.norm(lc_transformation[:3, 3] - gt_rel[:3, 3])),
            }
            self.lc_edge_diagnostics.append(diag)
            if self.logging:
                print(f"loop closure {step_id} -> {lc_id} [sim={sim:.3f}, "
                      f"pred_dist={diag['pred_dist']:.1f}m, gt_dist={diag['gt_dist']:.1f}m]")
        if not lc_ids:
            return False
        self.pose_graph.optimize(max_iterations=10000, backend="auto", device=self.device)
        return True

    def _lc_image(self, lc_id: int) -> Optional[np.ndarray]:
        """Frame +1 image of the step that registered `lc_id`, served by the
        dataset behind a bounded LRU: one candidate can be probed on several
        later frames."""
        idx = lc_id - 1
        if not 0 <= idx < len(self.dataset):
            return None
        cached = self._lc_cache.get(idx)
        if cached is not None:
            self._lc_cache.move_to_end(idx)
            return cached
        image = self.dataset[idx].rgb[2]
        self._lc_cache[idx] = image
        if len(self._lc_cache) > self._lc_cache_size:
            self._lc_cache.popitem(last=False)
        return image

    def run(
        self,
        max_steps: Optional[int] = None,
        progress: bool = True,
        prefetch_depth: int = 3,
        prefetch_workers: int = 1,
    ) -> "Slam":
        """Drive the loop with worker threads that prepare up to
        `prefetch_depth` frames ahead of the device, consumed in order.
        The workers only make numpy samples; every tensor is made in this
        thread.  Ends with `finish_async`."""
        n = len(self) if max_steps is None else min(max_steps, len(self))
        depth = max(1, prefetch_depth)
        with ThreadPoolExecutor(max_workers=max(1, prefetch_workers)) as pool:
            pending = deque(
                pool.submit(self.dataset.__getitem__, self.current_step + k)
                for k in range(min(depth, n))
            )
            for k in range(n):
                sample = pending.popleft().result()
                if k + depth < n:
                    pending.append(
                        pool.submit(self.dataset.__getitem__, self.current_step + depth))
                losses = self.step(sample=sample)
                if progress and self.current_step % 25 == 0:
                    print(f"step {self.current_step}/{n} loss={losses.get('loss', 0):.4f} "
                          f"({1.0 / max(np.mean(self.step_times[-25:]), 1e-9):.1f} fps)")
        self.finish_async()
        return self

    @tracing.traced("slam.flush")
    def flush_pipeline(self) -> None:
        """Retire every queued frame: after this the pose graph, replay
        buffer, loop-closure index and metrics cover every dispatched frame."""
        while self._retire_queue:
            self._retire(self._retire_queue.popleft())

    def trajectory(self, graph: Optional[PoseGraph] = None) -> np.ndarray:
        self.flush_pipeline()
        g = graph if graph is not None else self.pose_graph
        return np.stack([p[:3, 3] for p in g.get_all_poses()])

    def save_metrics(self) -> Path:
        self.flush_pipeline()
        data = {
            "rel_trans_error": self.rel_trans_error,
            "rel_rot_error": self.rel_rot_error,
            "depth_loss": self.depth_loss,
            "velocity_loss": self.velocity_loss,
            "depth_error": self.depth_error,
            "step_times": self.step_times,
        }
        path = self.log_path / "metrics.pkl"
        with open(path, "wb") as f:
            pickle.dump(data, f)
        return path

    def plot_trajectory(self, filename=None):
        """Top-down predicted-vs-ground-truth trajectory PNG (+ .npy dumps)."""
        from tpuslam_torch.viz.plots import plot_trajectory

        return plot_trajectory(
            self, filename or self.log_path / f"trajectory_{self.current_step}.png")

    def plot_metrics(self, filename=None):
        """Metric panel PNG (losses, relative errors, depth metrics)."""
        from tpuslam_torch.viz.plots import plot_metrics

        return plot_metrics(self, filename or self.log_path / f"metrics_{self.current_step}.png")

    def save_model(self) -> None:
        """The serving networks as checkpoint epoch 0 under `log_path`, and
        the replay buffer's state where it has a folder."""
        save_checkpoint(self.log_path, epoch=0, model=self.state.model,
                        meta={"step": int(self.state.step)})
        if self.replay_buffer is not None and self.replay_buffer.storage_dir:
            self.replay_buffer.save_state()

    def final_report(self) -> str:
        self.flush_pipeline()
        pred = self.pose_graph.get_all_poses()
        gt = self.gt_pose_graph.get_all_poses()
        n = min(len(pred), len(gt))
        return calc_error(pred[:n], gt[:n])
