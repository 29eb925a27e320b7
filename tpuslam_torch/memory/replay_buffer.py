"""Diversity-maximising experience replay buffer.

Semantics from the reference buffer (reference slam/replay_buffer.py):

* `add` (:82-184): L2-normalise the frame embedding; in diversity mode admit
  only if max cosine similarity to the buffer < `similarity_threshold`
  (:104-116); on overflow evict the sample with the largest summed
  similarity to the rest (:118-152).  Non-diversity mode admits everything
  and evicts uniformly at random (:154-162).
* `get` (:186-235): sample `batch_size` stored items (excluding the current
  frame), uniformly or proportional to similarity (:207-227 — note the
  reference deliberately weights by *similarity*, not dissimilarity, despite
  its comment; we reproduce that), with replacement iff the buffer is
  smaller than the batch; re-jitter images on every draw (:263-291).
* `save_state`/`load_state` (:237-255): resumable across runs with an id
  offset so indices keep growing.
* deterministic sampling rng seeded with 42 (:65).

TPU-first design differences (documented, not silent):
* samples can be stored as in-memory arrays ('array' mode — zero decode cost,
  used by synthetic/bench) or as image paths re-decoded lazily ('path' mode,
  the reference's disk-backed behaviour).
* the similarity bookkeeping uses the exact dense cosine matrix from
  `CosineIndex` instead of faiss's incrementally-patched matrix — identical
  eviction decisions without the slot-reuse bookkeeping.
"""
from __future__ import annotations

import pickle
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from tpuslam_torch import tracing
from tpuslam_torch.data.base import Sample, load_image, random_color_jitter
from tpuslam_torch.memory.index import CosineIndex, normalize_l2


class ReplayBuffer:
    def __init__(
        self,
        storage_dir: Optional[Path] = None,
        state_path: Optional[Path] = None,
        *,
        height: int = 192,
        width: int = 640,
        batch_size: int = 2,
        max_buffer_size: int = 100,
        maximize_diversity: bool = True,
        similarity_threshold: float = 0.95,
        similarity_sampling: bool = False,
        do_augmentation: bool = True,
        seed: int = 42,
    ):
        self.storage_dir = Path(storage_dir) if storage_dir is not None else None
        if self.storage_dir is not None:
            self.storage_dir.mkdir(parents=True, exist_ok=True)
        self.height = height
        self.width = width
        self.batch_size = batch_size
        self.max_buffer_size = max_buffer_size
        self.maximize_diversity = maximize_diversity
        self.similarity_threshold = similarity_threshold
        self.similarity_sampling = similarity_sampling
        self.do_augmentation = do_augmentation

        self.rng = np.random.default_rng(seed=seed)
        self.index: Optional[CosineIndex] = None
        self.index_offset = 0
        # id -> metadata record; arrays or paths depending on storage mode
        self.records: Dict[int, dict] = {}

        if state_path is not None:
            self.load_state(state_path)

    def __len__(self) -> int:
        return 0 if self.index is None else self.index.ntotal

    # ------------------------------------------------------------------ add
    @tracing.traced("data.replay.add")
    def add(
        self,
        sample: Sample,
        embedding: np.ndarray,
        verbose: bool = False,
    ) -> Optional[int]:
        """Consider the frame for admission.  Returns the evicted id or None.

        `embedding` is the frame descriptor from the fused step (already or
        not yet normalised — normalised here defensively)."""
        emb = normalize_l2(np.asarray(embedding, np.float32).reshape(1, -1))
        if self.index is None:
            self.index = CosineIndex(emb.shape[1])

        buffer_id = sample.index + self.index_offset
        evicted: Optional[int] = None

        if self.maximize_diversity:
            if self.index.ntotal:
                top_sim = float(self.index.search(emb, 1)[0][0, 0])
            else:
                top_sim = 0.0
            if top_sim >= self.similarity_threshold:
                return None  # too similar — not admitted
            self.index.add_with_ids(emb, [buffer_id])
            self._store(buffer_id, sample)
            if verbose:
                print(f"replay: added {buffer_id} (sim={top_sim:.3f})")
            if self.index.ntotal > self.max_buffer_size:
                scores = self.index.total_similarity()
                evicted = int(self.index.ids[int(np.argmax(scores))])
        else:
            self.index.add_with_ids(emb, [buffer_id])
            self._store(buffer_id, sample)
            if self.index.ntotal > self.max_buffer_size:
                evicted = int(self.rng.choice(self.index.ids, 1)[0])

        if evicted is not None:
            self.index.remove_ids([evicted])
            self.records.pop(evicted, None)
            if self.storage_dir is not None:
                f = self.storage_dir / f"sample_{evicted:06d}.pkl"
                f.unlink(missing_ok=True)
            if verbose:
                print(f"replay: evicted {evicted}")
        return evicted

    def _store(self, buffer_id: int, sample: Sample) -> None:
        if sample.filenames is not None:
            record = {
                "mode": "path",
                "paths": [str(p) for p in sample.filenames],
                "K": sample.K.copy(),
                "rel_dist": sample.rel_dist.copy(),
            }
        else:
            record = {
                "mode": "array",
                "rgb": sample.rgb.copy(),
                "K": sample.K.copy(),
                "rel_dist": sample.rel_dist.copy(),
            }
        self.records[buffer_id] = record
        if self.storage_dir is not None:
            with open(self.storage_dir / f"sample_{buffer_id:06d}.pkl", "wb") as f:
                pickle.dump(record, f, pickle.HIGHEST_PROTOCOL)

    # ------------------------------------------------------------------ get
    @tracing.traced("data.replay.draw")
    def get(
        self,
        current_index: Optional[int] = None,
        embedding: Optional[np.ndarray] = None,
    ) -> List[Sample]:
        """Draw `batch_size` replay samples (never the current frame)."""
        if self.index is None or self.index.ntotal == 0 or self.batch_size == 0:
            return []
        current_id = (
            None if current_index is None else current_index + self.index_offset
        )
        ids = [i for i in self.index.ids if i != current_id]
        if not ids:
            ids = list(self.index.ids)  # only the current frame is stored
        replace = self.batch_size > len(ids)

        p = None
        if self.similarity_sampling and embedding is not None and len(ids) > 1:
            emb = normalize_l2(np.asarray(embedding, np.float32).reshape(1, -1))
            sims, sim_ids = self.index.search(emb, self.index.ntotal)
            order = {int(i): float(s) for s, i in zip(sims[0], sim_ids[0]) if i >= 0}
            raw = np.array([max(order.get(i, 0.0), 0.0) for i in ids], np.float64)
            if raw.sum() > 0:
                p = raw / raw.sum()

        chosen = self.rng.choice(len(ids), self.batch_size, replace=replace, p=p)
        return [self._load(ids[int(c)]) for c in chosen]

    def _load(self, buffer_id: int) -> Sample:
        record = self.records[buffer_id]
        if record["mode"] == "array":
            rgb = record["rgb"]
        else:
            rgb = np.stack(
                [load_image(Path(p), self.height, self.width) for p in record["paths"]]
            )
        rgb_aug = None
        if self.do_augmentation:
            jitter = random_color_jitter(self.rng)
            rgb_aug = np.stack([jitter(f) for f in rgb])
        return Sample(
            index=buffer_id,
            rgb=rgb,
            rgb_aug=rgb_aug,
            K=record["K"],
            rel_dist=record["rel_dist"],
        )

    # -------------------------------------------------------- persistence
    def save_state(self, path: Optional[Path] = None) -> Path:
        if path is None:
            if self.storage_dir is None:
                raise ValueError("no storage_dir and no explicit path")
            path = self.storage_dir / "buffer_state.pkl"
        state = {
            "index": None if self.index is None else self.index.state_dict(),
            "records": self.records,
        }
        with open(path, "wb") as f:
            pickle.dump(state, f, pickle.HIGHEST_PROTOCOL)
        return path

    def load_state(self, path: Path) -> None:
        with open(path, "rb") as f:
            state = pickle.load(f)
        if state["index"] is not None:
            self.index = CosineIndex.from_state_dict(state["index"])
            # resume with an id offset so new indices never collide
            self.index_offset = int(self.index.ids.max()) + 1 if self.index.ntotal else 0
        self.records = dict(state["records"])
