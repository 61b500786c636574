"""Workload: command generation for clients.

Reference: fantoch/src/client/workload.rs:12-230.
"""

from __future__ import annotations

import random
import string
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from fantoch_tpu_torch.client.key_gen import (
    ConflictRateKeyGen,
    KeyGen,
    KeyGenState,
    true_if_random_is_less_than,
)
from fantoch_tpu_torch.core.command import Command
from fantoch_tpu_torch.core.ids import RiflGen, ShardId
from fantoch_tpu_torch.core.kvs import KVOp, Key, Value
from fantoch_tpu_torch.utils import key_hash

_PAYLOAD_ALPHABET = string.ascii_letters + string.digits


@dataclass
class Workload:
    shard_count: int
    key_gen: KeyGen
    keys_per_command: int
    commands_per_client: int
    payload_size: int
    read_only_percentage: int = 0
    command_count: int = 0  # commands already issued

    def __post_init__(self) -> None:
        # valid-workload checks (workload.rs:37-49)
        if isinstance(self.key_gen, ConflictRateKeyGen):
            assert self.key_gen.conflict_rate <= 100, "conflict rate must be <= 100"
            if self.key_gen.conflict_rate == 100 and self.keys_per_command > 1:
                raise ValueError(
                    "can't generate more than one key when the conflict_rate is 100"
                )
            if self.key_gen.conflict_rate == 0 and self.keys_per_command > 1:
                raise ValueError(
                    "conflict_rate 0 yields a single distinct key per client; "
                    "keys_per_command > 1 would loop forever"
                )
            if self.keys_per_command > 2:
                raise ValueError(
                    "can't generate more than two keys with the conflict_rate key generator"
                )
        assert 0 <= self.read_only_percentage <= 100

    def initial_key_gen_state(self, client_id: int, rng: Optional[random.Random] = None) -> KeyGenState:
        return KeyGenState(self.key_gen, self.shard_count, client_id, rng)

    def next_cmd(
        self, rifl_gen: RiflGen, key_gen_state: KeyGenState
    ) -> Optional[Tuple[ShardId, Command]]:
        if self.command_count >= self.commands_per_client:
            return None
        self.command_count += 1
        return self._gen_cmd(rifl_gen, key_gen_state)

    @property
    def issued_commands(self) -> int:
        return self.command_count

    def finished(self) -> bool:
        return self.command_count == self.commands_per_client

    def _gen_cmd(self, rifl_gen: RiflGen, key_gen_state: KeyGenState) -> Tuple[ShardId, Command]:
        """Generate one command; the target shard is the shard of the first
        key generated (workload.rs:136-177)."""
        rifl = rifl_gen.next_id()
        keys = self._gen_unique_keys(key_gen_state)
        read_only = true_if_random_is_less_than(self.read_only_percentage, key_gen_state.rng)
        ops: Dict[ShardId, Dict[Key, tuple]] = {}
        target_shard: Optional[ShardId] = None
        for key in keys:
            op = KVOp.get() if read_only else KVOp.put(self._gen_cmd_value(key_gen_state.rng))
            shard_id = self.shard_id(key)
            ops.setdefault(shard_id, {})[key] = (op,)
            if target_shard is None:
                target_shard = shard_id
        assert target_shard is not None
        return target_shard, Command(rifl, ops)

    def _gen_unique_keys(self, key_gen_state: KeyGenState) -> List[Key]:
        keys: List[Key] = []
        while len(keys) != self.keys_per_command:
            key = key_gen_state.gen_cmd_key()
            if key not in keys:
                keys.append(key)
        return keys

    def _gen_cmd_value(self, rng: random.Random) -> Value:
        return "".join(rng.choices(_PAYLOAD_ALPHABET, k=self.payload_size))

    def shard_id(self, key: Key) -> ShardId:
        """Key -> shard by stable hash (workload.rs:203)."""
        return key_hash(key) % self.shard_count
