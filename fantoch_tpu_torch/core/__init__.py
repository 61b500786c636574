from fantoch_tpu_torch.core.command import Command, CommandResult
from fantoch_tpu_torch.core.config import Config
from fantoch_tpu_torch.core.ids import (
    AtomicIdGen,
    ClientId,
    Dot,
    IdGen,
    ProcessId,
    Rifl,
    RiflGen,
    ShardId,
    all_process_ids,
    process_ids,
)
from fantoch_tpu_torch.core.kvs import KVOp, KVOpKind, KVOpResult, KVStore, Key, Value
from fantoch_tpu_torch.core.metrics import Histogram, Metrics
from fantoch_tpu_torch.core.planet import Planet, Region
from fantoch_tpu_torch.core.timing import RunTime, SimTime, SysTime
