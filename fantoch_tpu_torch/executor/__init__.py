from fantoch_tpu_torch.executor.aggregate import AggregatePending
from fantoch_tpu_torch.executor.base import Executor, ExecutorMetricsKind, ExecutorResult, MessageKey
from fantoch_tpu_torch.executor.basic import BasicExecutionInfo, BasicExecutor
from fantoch_tpu_torch.executor.monitor import ExecutionOrderMonitor
from fantoch_tpu_torch.executor.graph.executor import GraphExecutor
