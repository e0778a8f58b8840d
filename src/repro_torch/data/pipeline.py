"""Deterministic synthetic LM data (the port of
``repro/data/pipeline.py``).

- Batch ``i`` is a pure function of (seed, i): restoring ``{seed, step}``
  from a checkpoint resumes the exact stream, with no replay or skip.
- Tokens follow a Zipf law over the vocabulary (``zipf_alpha``), the
  skew a real embedding and softmax see.
- ``batch_shard(step, host_id, n_hosts)`` is a host's slice of the same
  global batch.

The stream is JAX's, bit for bit: ``jax.random.fold_in`` twice from
``PRNGKey(seed)`` (by step, then by 0), ``jax.random.uniform`` over
(global_batch, seq_len) and ``searchsorted`` on the float32 Zipf CDF.
Threefry-2x32 and JAX's partitionable bit layout (each element's bits
are the two output words of its 64-bit linear index, xor-ed) are
computed here in numpy, on the host; a batch is then copied to the
device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

__all__ = ["DataConfig", "SyntheticDataset", "threefry2x32", "fold_in",
           "uniform"]

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_alpha: float = 1.1


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key, x0: np.ndarray, x1: np.ndarray):
    """The Threefry-2x32 block cipher, 20 rounds (Salmon et al., SC'11),
    as JAX's ``threefry2x32_p``: key (k0, k1) and counter words x0, x1
    (uint32 arrays) → the two output words."""
    k0, k1 = (np.uint32(k) for k in key)
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    x0 = x0.astype(np.uint32) + ks[0]
    x1 = x1.astype(np.uint32) + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def fold_in(key, data: int):
    """``jax.random.fold_in`` on a threefry key: the cipher of the counter
    (0, data) under ``key``."""
    y0, y1 = threefry2x32(key, np.zeros(1, np.uint32),
                          np.array([data], np.uint32))
    return int(y0[0]), int(y1[0])


def uniform(key, shape) -> np.ndarray:
    """``jax.random.uniform(key, shape)`` in float32 under JAX's
    partitionable threefry: element i's 32 bits are the xor of the two
    words the cipher gives its 64-bit index (hi, lo); the top 23 become
    the mantissa of a float in [1, 2), minus 1."""
    size = int(np.prod(shape))
    idx = np.arange(size, dtype=np.uint64)
    hi = (idx >> np.uint64(32)).astype(np.uint32)
    lo = (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    y0, y1 = threefry2x32(key, hi, lo)
    bits = (y0 ^ y1) >> np.uint32(9) | np.uint32(0x3F800000)
    return (bits.view(np.float32) - np.float32(1.0)).reshape(shape)


class SyntheticDataset:
    """Deterministic synthetic token stream with checkpointable state."""

    def __init__(self, cfg: DataConfig, start_step: int = 0,
                 device=None):
        self.cfg = cfg
        self.step = start_step
        self.device = device
        ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64)
        probs = ranks ** -cfg.zipf_alpha
        self._cdf = np.cumsum(probs / probs.sum()).astype(np.float32)

    # -- state (goes into checkpoints) -------------------------------------
    def state(self) -> Dict[str, int]:
        return {"seed": self.cfg.seed, "step": self.step}

    @classmethod
    def restore(cls, cfg: DataConfig, state: Dict[str, int],
                device=None) -> "SyntheticDataset":
        if state["seed"] != cfg.seed:
            raise ValueError(f"seed mismatch on restore: checkpoint "
                             f"{state['seed']}, config {cfg.seed}")
        return cls(cfg, start_step=int(state["step"]), device=device)

    # -- batches ------------------------------------------------------------
    def tokens(self, step: int, batch: int, offset: int) -> np.ndarray:
        """The (batch, seq_len) int32 tokens of ``step`` on the host."""
        key = fold_in(fold_in((0, self.cfg.seed), step), offset)
        u = uniform(key, (batch, self.cfg.seq_len))
        return np.searchsorted(self._cdf, u).astype(np.int32)

    def _on_device(self, toks: np.ndarray) -> torch.Tensor:
        out = torch.from_numpy(toks)
        return out if self.device is None else out.to(self.device)

    def batch(self, step: Optional[int] = None) -> Dict[str, torch.Tensor]:
        step = self.step if step is None else step
        toks = self.tokens(step, self.cfg.global_batch, 0)
        if step == self.step:
            self.step += 1
        return {"tokens": self._on_device(toks)}

    def batch_shard(self, step: int, host_id: int, n_hosts: int
                    ) -> Dict[str, torch.Tensor]:
        """Host ``host_id``'s slice of the *same* global batch."""
        if self.cfg.global_batch % n_hosts:
            raise ValueError(f"global batch {self.cfg.global_batch} does "
                             f"not split over {n_hosts} hosts")
        per = self.cfg.global_batch // n_hosts
        toks = self.tokens(step, self.cfg.global_batch, 0)
        return {"tokens": self._on_device(
            toks[host_id * per: (host_id + 1) * per])}
