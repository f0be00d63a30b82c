"""Deterministic synthetic data pipeline.

Produces seeded, host-sharded token streams with next-token labels — the
same interface a real corpus loader (OpenWebText / C4 / FineWeb) would have.
Determinism is per (seed, host, step), so checkpoint-restart resumes the
stream exactly (fault tolerance) and elastic re-sharding just changes the
(host_id, num_hosts) split.

The synthetic distribution is a small-order Markov chain over the vocab so
the loss is learnable (optimizer comparisons produce meaningful curves)
rather than irreducible uniform noise.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    host_id: int = 0
    num_hosts: int = 1
    # order 1 => vocab-sized transition table: learnable by small models
    # (order 2 is a random hash over vocab^2 contexts - pure memorization)
    markov_order: int = 1
    frontend: str = "none"       # mirror of ModelConfig.frontend
    n_frontend_tokens: int = 0
    d_model: int = 0


class SyntheticStream:
    """Iterator of host-local batches: dict(tokens, labels[, frontends])."""

    def __init__(self, cfg: DataConfig, start_step: int = 0):
        assert cfg.global_batch % cfg.num_hosts == 0
        self.cfg = cfg
        self.local_batch = cfg.global_batch // cfg.num_hosts
        self.step = start_step
        # fixed random projection defining the Markov transition structure
        rng = np.random.default_rng(cfg.seed)
        k = min(cfg.vocab, 4096)
        self._proj = rng.integers(1, 2**31 - 1, size=(cfg.markov_order,), dtype=np.int64)
        self._bias = rng.integers(0, 2**31 - 1, dtype=np.int64)
        self._k = k

    def _batch_rng(self, step: int) -> np.random.Generator:
        c = self.cfg
        return np.random.default_rng(
            np.random.SeedSequence([c.seed, c.host_id, step]))

    def sample(self, step: Optional[int] = None) -> Dict[str, np.ndarray]:
        c = self.cfg
        step = self.step if step is None else step
        rng = self._batch_rng(step)
        B, S = self.local_batch, c.seq_len
        toks = np.zeros((B, S + 1), np.int64)
        toks[:, :c.markov_order] = rng.integers(0, self._k, size=(B, c.markov_order))
        noise = rng.random((B, S + 1))
        for t in range(c.markov_order, S + 1):
            ctx = sum(toks[:, t - i - 1] * self._proj[i]
                      for i in range(c.markov_order)) + self._bias
            det = (ctx % self._k).astype(np.int64)
            rand = rng.integers(0, self._k, size=B)
            toks[:, t] = np.where(noise[:, t] < 0.75, det, rand)
        batch = {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
        }
        if c.frontend == "vision":
            batch["vision_embeds"] = rng.standard_normal(
                (B, c.n_frontend_tokens, c.d_model)).astype(np.float32) * 0.02
        elif c.frontend == "audio_frames":
            batch["frames"] = rng.standard_normal(
                (B, S, c.d_model)).astype(np.float32) * 0.02
        return batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self):
        b = self.sample()
        self.step += 1
        return b


def make_stream(model_cfg, seq_len: int, global_batch: int, seed: int = 0,
                host_id: int = 0, num_hosts: int = 1,
                start_step: int = 0) -> SyntheticStream:
    return SyntheticStream(DataConfig(
        vocab=model_cfg.vocab, seq_len=seq_len, global_batch=global_batch,
        seed=seed, host_id=host_id, num_hosts=num_hosts,
        frontend=model_cfg.frontend,
        n_frontend_tokens=model_cfg.n_frontend_tokens,
        d_model=model_cfg.d_model), start_step=start_step)
