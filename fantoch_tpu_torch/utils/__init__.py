"""Shared utilities: the framework-wide key hash and the package logger.

Reference: fantoch/src/util.rs.  The port carries only what the graph
executor slice needs; the distance-based process sorting of the JAX
package's ``utils`` (which needs ``core.planet``) comes with a later slice.
"""

from __future__ import annotations

import logging

from fantoch_tpu_torch.core.kvs import Key

logger = logging.getLogger("fantoch_tpu_torch")

# 64-bit FNV-1a: a stable, fast, dependency-free key hash.  The reference uses
# ahash (fantoch/src/util.rs:107-111); any stable 64-bit hash works as long as
# every process agrees on it, so we pick one that is reproducible across runs
# (Python's builtin hash() is salted per-process and therefore unusable here).
_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3
_MASK = (1 << 64) - 1


def key_hash(key: Key) -> int:
    h = _FNV_OFFSET
    for b in key.encode():
        h = ((h ^ b) * _FNV_PRIME) & _MASK
    return h
