"""The paper's runtime DAG scheduler, ported to PyTorch: the same DAG
inference, lanes and simulator as ``repro.core``, with lanes that run on
CUDA streams."""
from .element import (AccessMode, Arg, ComputationalElement, DEFAULT_TENANT,
                      ElementKind, ElementState, PRIORITY_WEIGHT_BASE, const,
                      dep_key, inout, kernel, out, priority_weight)
from .deadlines import DeadlineMonitor
from .dag import ComputationDAG, DAGSnapshot
from .capture import (CaptureContext, ExecutionPlan, PlanCache, PlanElement,
                      SlotSpec)
from .streams import (DataAffinityPlacement, Lane, MinLoadPlacement,
                      MinPressurePlacement, NewStreamPolicy,
                      ParentStreamPolicy, PlacementPolicy,
                      PLACEMENT_POLICIES, RoundRobinPlacement, StreamManager)
from .managed import ManagedArray
from .memory import DeviceOutOfMemoryError, MemoryManager, MemoryPool
from .tiers import (BackingTier, CompressedHostTier, DiskTier,
                    PeerDeviceTier, make_tiers)
from .submission import SubmissionPipeline
from .timeline import Timeline, Span
from .history import KernelHistory
from .executor import (Executor, SimExecutor, SimHardware,
                       ThreadLaneExecutor)
from .scheduler import GrScheduler, make_scheduler
from .frontend import (GrFunction, NoActiveRuntimeError, current_runtime,
                       function, get_runtime, runtime, set_runtime)

__all__ = [
    "AccessMode", "Arg", "ComputationalElement", "DEFAULT_TENANT",
    "ElementKind", "ElementState", "PRIORITY_WEIGHT_BASE",
    "DeadlineMonitor",
    "const", "dep_key", "inout", "kernel", "out", "priority_weight",
    "SubmissionPipeline",
    "ComputationDAG", "DAGSnapshot",
    "CaptureContext", "ExecutionPlan", "PlanCache", "PlanElement", "SlotSpec",
    "NewStreamPolicy", "ParentStreamPolicy", "StreamManager",
    "Lane", "PlacementPolicy", "PLACEMENT_POLICIES", "RoundRobinPlacement",
    "MinLoadPlacement", "DataAffinityPlacement", "MinPressurePlacement",
    "DeviceOutOfMemoryError", "MemoryManager", "MemoryPool",
    "BackingTier", "CompressedHostTier", "DiskTier", "PeerDeviceTier",
    "make_tiers",
    "ManagedArray", "Timeline", "Span", "KernelHistory",
    "Executor", "SimExecutor", "SimHardware", "ThreadLaneExecutor",
    "GrScheduler", "make_scheduler",
    "GrFunction", "NoActiveRuntimeError", "current_runtime", "function",
    "get_runtime", "runtime", "set_runtime",
]
