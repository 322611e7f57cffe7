"""Token data pipeline of the port: deterministic, shardable,
restart-exact (counterpart of ``repro.data.pipeline``, whose numpy code
this copies).

Two sources behind one interface:

* :class:`SyntheticTokens`: seeded per (step, host shard), infinite; a
  bigram skeleton under noise, so a smoke run's loss falls;
* :class:`MemmapTokens`: a flat int32 token file (``np.memmap``), strided
  across hosts.

``batch_at(step)`` is a pure function of (seed, step, shard), so a
restart from the checkpoint of step k reads the same tokens again: the
supervisor's restart equivalence rests on it.  Each batch is a page of the
port's :class:`~repro_torch.core.pool.HostStagingPool` (pinned where CUDA
is present, so its copy to the card can be asynchronous), an int32 CPU
tensor holding the reference's tokens for the same arguments.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np
import torch

from repro_torch.core.pool import HostStagingPool

#: the pool batch pages come from unless a source is given its own
GLOBAL_TOKEN_POOL = HostStagingPool()


@dataclasses.dataclass
class ShardInfo:
    shard: int = 0
    n_shards: int = 1


class TokenSource:
    vocab: int
    pool: HostStagingPool

    def batch_at(self, step: int, batch: int, seq: int) -> torch.Tensor:
        raise NotImplementedError

    def stream(self, start_step: int, batch: int, seq: int) -> Iterator:
        step = start_step
        while True:
            yield step, self.batch_at(step, batch, seq)
            step += 1

    def _page(self, toks: np.ndarray) -> torch.Tensor:
        out = self.pool.acquire(toks.shape, torch.int32)
        out.copy_(torch.from_numpy(np.ascontiguousarray(toks, np.int32)))
        return out

    def release(self, batch: torch.Tensor) -> None:
        """Hand a batch page back to the pool (the caller reads it no
        more)."""
        self.pool.release(batch)


class SyntheticTokens(TokenSource):
    """Markov-ish synthetic tokens: learnable structure (a bigram
    skeleton), fully seeded."""

    def __init__(self, vocab: int, seed: int = 0,
                 shard: ShardInfo = ShardInfo(),
                 pool: Optional[HostStagingPool] = None):
        self.vocab = vocab
        self.seed = seed
        self.shard = shard
        self.pool = pool or GLOBAL_TOKEN_POOL
        rng = np.random.RandomState(seed)
        self._succ = rng.randint(0, vocab, size=(min(vocab, 4096),))

    def tokens_at(self, step: int, batch: int, seq: int) -> np.ndarray:
        """The batch of ``step`` as an int32 numpy array."""
        rng = np.random.RandomState(
            (self.seed * 1_000_003 + step) * 97 + self.shard.shard)
        start = rng.randint(0, min(self.vocab, 4096), size=(batch,))
        noise = rng.rand(batch, seq)
        toks = np.empty((batch, seq), np.int64)
        toks[:, 0] = start
        for t in range(1, seq):
            follow = self._succ[toks[:, t - 1] % len(self._succ)]
            rand = rng.randint(0, self.vocab, size=(batch,))
            toks[:, t] = np.where(noise[:, t] < 0.8, follow, rand)
        return toks.astype(np.int32)

    def batch_at(self, step: int, batch: int, seq: int) -> torch.Tensor:
        return self._page(self.tokens_at(step, batch, seq))


class MemmapTokens(TokenSource):
    """Flat int32 token file; host h reads blocks h, h + n_shards, ..."""

    def __init__(self, path: str, vocab: int, shard: ShardInfo = ShardInfo(),
                 pool: Optional[HostStagingPool] = None):
        self.tokens = np.memmap(path, dtype=np.int32, mode="r")
        self.vocab = vocab
        self.shard = shard
        self.pool = pool or GLOBAL_TOKEN_POOL

    def tokens_at(self, step: int, batch: int, seq: int) -> np.ndarray:
        n = len(self.tokens)
        block = batch * seq
        base = (step * self.shard.n_shards + self.shard.shard) * block
        idx = (base + np.arange(block)) % (n - 1)
        return np.asarray(self.tokens[idx]).reshape(batch, seq)

    def batch_at(self, step: int, batch: int, seq: int) -> torch.Tensor:
        return self._page(self.tokens_at(step, batch, seq))


def make_source(kind: str, vocab: int, *, path: str = "", seed: int = 0,
                shard: ShardInfo = ShardInfo()) -> TokenSource:
    if kind == "synthetic":
        return SyntheticTokens(vocab, seed=seed, shard=shard)
    if kind == "memmap":
        return MemmapTokens(path, vocab, shard=shard)
    raise ValueError(kind)
