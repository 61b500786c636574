from fantoch_tpu_torch.protocol.base import (
    Action,
    BaseProcess,
    Executed,
    Protocol,
    ProtocolMetricsKind,
    ToForward,
    ToSend,
)
from fantoch_tpu_torch.protocol.gc import GCTrack
from fantoch_tpu_torch.protocol.info import CommandsInfo

_LAZY = {
    "Basic": "fantoch_tpu_torch.protocol.basic",
    "EPaxos": "fantoch_tpu_torch.protocol.graph_protocol",
    "Atlas": "fantoch_tpu_torch.protocol.graph_protocol",
    "Newt": "fantoch_tpu_torch.protocol.newt",
    "FPaxos": "fantoch_tpu_torch.protocol.fpaxos",
    "Caesar": "fantoch_tpu_torch.protocol.caesar",
}


def __getattr__(name):
    # lazy protocol exports (PEP 562): protocols import executors, which
    # import protocol commons — eager imports here would be circular
    module = _LAZY.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(module), name)
