"""Loop-closure detection by embedding retrieval.

Counterpart of `tpuslam/loopclosure/detection.py` (numpy only, on the port's
`memory/index.py`).  Search semantics of the reference: query with the
stored embedding of a keyframe, take the top-100 matches, drop the self
match, keep matches above `detection_threshold`, reject neighbours within
`id_threshold` frame ids, and return the best `num_matches` as sorted frame
ids.  The embedding is supplied by the caller: the depth encoder's pooled
stage-4 feature, which the frame's step already computes.
"""
from __future__ import annotations

from pathlib import Path
from typing import List, Tuple

import numpy as np

from tpuslam_torch.memory.index import CosineIndex, normalize_l2


class LoopClosureDetection:
    def __init__(
        self,
        detection_threshold: float = 0.99,
        id_threshold: int = 250,
        num_matches: int = 1,
        num_features: int = 576,
    ):
        self.detection_threshold = detection_threshold
        self.id_threshold = id_threshold
        self.num_matches = num_matches
        self.index = CosineIndex(num_features)

    def __len__(self) -> int:
        return self.index.ntotal

    def add(self, frame_id: int, embedding: np.ndarray) -> None:
        emb = normalize_l2(np.asarray(embedding, np.float32).reshape(1, -1))
        self.index.add_with_ids(emb, [frame_id])

    def search(self, frame_id: int) -> Tuple[List[int], List[float]]:
        """Candidate loop closures for a stored keyframe: (frame ids, their
        similarities)."""
        query = self.index.reconstruct(frame_id)[None]
        sims, ids = self.index.search(query, min(100, self.index.ntotal))
        sims, ids = sims[0], ids[0]
        valid = (
            (ids >= 0)
            & (ids != frame_id)
            & (sims > self.detection_threshold)
            & (np.abs(ids - frame_id) > self.id_threshold)
        )
        sims, ids = sims[valid], ids[valid]
        keep = slice(0, self.num_matches)
        matched = sorted(int(i) for i in ids[keep])
        return matched, [float(s) for s in sims[keep]]

    @staticmethod
    def predict(embedding_0: np.ndarray, embedding_1: np.ndarray) -> float:
        """Cosine similarity between two embeddings."""
        a = normalize_l2(np.asarray(embedding_0, np.float32).reshape(-1))
        b = normalize_l2(np.asarray(embedding_1, np.float32).reshape(-1))
        return float(a @ b)

    def display_matches(
        self,
        frame_id: int,
        image,
        match_ids,
        match_images,
        similarities=None,
        filename=None,
    ):
        """Debug figure of a query frame against each of its matches, one
        `viz.plot_image_matches` panel per match."""
        from tpuslam_torch.viz.plots import plot_image_matches

        outs = []
        for k, (mid, mimg) in enumerate(zip(match_ids, match_images)):
            sim = None if similarities is None else similarities[k]
            out = None
            if filename is not None:
                f = Path(filename)
                out = f.with_name(f"{f.stem}_{frame_id}_{mid}{f.suffix}")
            outs.append(plot_image_matches(image, mimg, frame_id, mid, sim, out))
        return outs
