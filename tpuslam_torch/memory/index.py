"""Exact cosine-similarity index — the faiss replacement.

The reference uses brute-force faiss `Flat` inner-product indexes wrapped in
`IndexIDMap` (reference slam/replay_buffer.py:95-96 and
loop_closure_detection.py:35-36) over at most a few thousand 512/576-d
vectors.  Exact top-k over that scale is a single small matmul; no ANN
structure is warranted.  This index reproduces the IDMap semantics
(add_with_ids / remove_ids / reconstruct / search) as contiguous numpy
arrays.  Searches run on the host; the embeddings themselves are produced
on the device by the fused step.  `batched_cosine_topk` is the device path
for large batched searches (matmul + torch.topk).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from tpuslam_torch import full_fp32


class CosineIndex:
    """Flat exact inner-product index with stable integer ids."""

    def __init__(self, dim: int):
        self.dim = dim
        self._vectors = np.zeros((0, dim), np.float32)
        self._ids = np.zeros((0,), np.int64)

    # -- faiss-compatible surface ------------------------------------------
    @property
    def ntotal(self) -> int:
        return len(self._ids)

    @property
    def ids(self) -> np.ndarray:
        return self._ids.copy()

    def add_with_ids(self, vectors: np.ndarray, ids) -> None:
        vectors = np.atleast_2d(np.asarray(vectors, np.float32))
        ids = np.atleast_1d(np.asarray(ids, np.int64))
        if vectors.shape[1] != self.dim:
            raise ValueError(f"expected dim {self.dim}, got {vectors.shape[1]}")
        if len(ids) != len(vectors):
            raise ValueError("ids/vectors length mismatch")
        if np.intersect1d(ids, self._ids).size:
            raise ValueError("duplicate id")
        self._vectors = np.concatenate([self._vectors, vectors])
        self._ids = np.concatenate([self._ids, ids])

    def remove_ids(self, ids) -> int:
        ids = np.atleast_1d(np.asarray(ids, np.int64))
        keep = ~np.isin(self._ids, ids)
        removed = int((~keep).sum())
        self._vectors = self._vectors[keep]
        self._ids = self._ids[keep]
        return removed

    def reconstruct(self, id_: int) -> np.ndarray:
        (pos,) = np.nonzero(self._ids == id_)
        if not len(pos):
            raise KeyError(id_)
        return self._vectors[pos[0]].copy()

    def search(self, query: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k by inner product.  Returns (similarities (Q, k), ids (Q, k));
        missing entries padded with (-inf, -1) like faiss."""
        query = np.atleast_2d(np.asarray(query, np.float32))
        Q = len(query)
        if self.ntotal == 0:
            return (
                np.full((Q, k), -np.inf, np.float32),
                np.full((Q, k), -1, np.int64),
            )
        sims = query @ self._vectors.T  # (Q, N)
        n = min(k, self.ntotal)
        top = np.argpartition(-sims, n - 1, axis=1)[:, :n]
        top = np.take_along_axis(
            top, np.argsort(-np.take_along_axis(sims, top, 1), axis=1), 1
        )
        out_s = np.full((Q, k), -np.inf, np.float32)
        out_i = np.full((Q, k), -1, np.int64)
        out_s[:, :n] = np.take_along_axis(sims, top, 1)
        out_i[:, :n] = self._ids[top]
        return out_s, out_i

    def pairwise_similarity(self) -> np.ndarray:
        """(N, N) inner-product matrix over the stored vectors."""
        return self._vectors @ self._vectors.T

    def total_similarity(self) -> np.ndarray:
        """Per-vector summed similarity to all others (self excluded) —
        the diversity-eviction score (replay_buffer.py:141-143)."""
        sims = self.pairwise_similarity()
        return sims.sum(axis=0) - np.diag(sims)

    # -- persistence --------------------------------------------------------
    def state_dict(self) -> Dict[str, np.ndarray]:
        return {"vectors": self._vectors.copy(), "ids": self._ids.copy()}

    @classmethod
    def from_state_dict(cls, state: Dict[str, np.ndarray]) -> "CosineIndex":
        idx = cls(int(state["vectors"].shape[1]))
        idx._vectors = np.asarray(state["vectors"], np.float32).copy()
        idx._ids = np.asarray(state["ids"], np.int64).copy()
        return idx


def normalize_l2(x: np.ndarray, eps: float = 1e-12) -> np.ndarray:
    x = np.asarray(x, np.float32)
    return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), eps)


@full_fp32()
def batched_cosine_topk(queries: torch.Tensor, vectors: torch.Tensor, k: int = 100):
    """Exact top-k inner-product search of many queries (Q, D) against
    (N, D) vectors on their device, in full float32 (TF32 off): returns
    (similarities (Q, k), indices (Q, k)), best first."""
    return torch.topk(queries @ vectors.T, k, dim=-1)
