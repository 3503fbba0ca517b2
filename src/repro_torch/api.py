"""``repro_torch.api`` — the polyglot frontend, in one import.

    import repro_torch.api as gr

    with gr.runtime(policy="parallel"):
        x = gr.array(host_data, name="x")
        sq = gr.function(square_kernel, modes=("const", "out"),
                         outputs=0, name="square")
        y = sq(x)                 # runtime allocates y, infers the DAG

This is the single stable call surface the serving engine, the trainer,
graph capture and the benchsuite all speak; later frontends (autotuning,
tracing, other host languages) target it rather than the scheduler
internals.  The annotation helpers (``const``/``out``/``inout``) and the
scheduler factory are re-exported for code that still builds argument lists
explicitly or constructs runtimes by hand.
"""
from .core.frontend import (GrFunction, NoActiveRuntimeError, array,
                            current_runtime, function, get_runtime, runtime,
                            set_runtime)
from .core import (AccessMode, Arg, BackingTier, CompressedHostTier,
                   DiskTier, GrScheduler, ManagedArray, PeerDeviceTier,
                   const, inout, make_scheduler, out)

__all__ = [
    "GrFunction", "NoActiveRuntimeError", "array", "current_runtime",
    "function", "get_runtime", "runtime", "set_runtime",
    "AccessMode", "Arg", "GrScheduler", "ManagedArray", "const", "inout",
    "make_scheduler", "out",
    "BackingTier", "CompressedHostTier", "DiskTier", "PeerDeviceTier",
]
