"""PyTorch/CUDA port of GrJAX: runtime DAG scheduling with resource sharing
(GrCUDA paper repro) whose lanes are CUDA streams on an NVIDIA GPU.

The package mirrors ``repro``'s module layout and imports neither ``jax``
nor ``repro``.  Every entry point runs on ``device="cuda"`` unless the caller
passes ``device="cpu"``; without a card a CUDA entry point raises.
"""

__version__ = "0.1.0"
