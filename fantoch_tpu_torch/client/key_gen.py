"""Key generators: conflict-rate (single hot key) and zipfian.

Reference: fantoch/src/client/key_gen.rs:8-117.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Optional, Union

import numpy as np

from fantoch_tpu_torch.core.ids import ClientId
from fantoch_tpu_torch.core.kvs import Key

# single color accessed by all conflicting operations
CONFLICT_COLOR = "CONFLICT"


@dataclass(frozen=True)
class ConflictRateKeyGen:
    """With probability `conflict_rate`% produce the shared hot key, else a
    client-private key."""

    conflict_rate: int

    def __str__(self) -> str:
        return f"conflict{self.conflict_rate}"


@dataclass(frozen=True)
class ZipfKeyGen:
    coefficient: float
    keys_per_shard: int

    def __str__(self) -> str:
        return f"zipf{self.coefficient:.2f}".replace(".", "-")


KeyGen = Union[ConflictRateKeyGen, ZipfKeyGen]


class KeyGenState:
    """Per-client sampling state (key_gen.rs:46-108)."""

    def __init__(self, key_gen: KeyGen, shard_count: int, client_id: ClientId,
                 rng: Optional[random.Random] = None):
        self._key_gen = key_gen
        self._client_id = client_id
        self._rng = rng or random.Random()
        self._zipf_cdf: Optional[np.ndarray] = None
        if isinstance(key_gen, ZipfKeyGen):
            key_count = key_gen.keys_per_shard * shard_count
            # zipf pmf over ranks 1..key_count with exponent `coefficient`
            ranks = np.arange(1, key_count + 1, dtype=np.float64)
            weights = ranks ** (-key_gen.coefficient)
            self._zipf_cdf = np.cumsum(weights / weights.sum())

    @property
    def rng(self) -> random.Random:
        return self._rng

    def gen_cmd_key(self) -> Key:
        if isinstance(self._key_gen, ConflictRateKeyGen):
            if true_if_random_is_less_than(self._key_gen.conflict_rate, self._rng):
                return CONFLICT_COLOR
            return str(self._client_id)
        # zipf: sample a rank from the precomputed cdf
        assert self._zipf_cdf is not None
        u = self._rng.random()
        rank = int(np.searchsorted(self._zipf_cdf, u)) + 1
        return str(rank)


def true_if_random_is_less_than(percentage: int, rng: Optional[random.Random] = None) -> bool:
    """Reference: key_gen.rs:111-117 (0 and 100 are deterministic)."""
    if percentage == 0:
        return False
    if percentage == 100:
        return True
    rng = rng or random
    return rng.randrange(100) < percentage
