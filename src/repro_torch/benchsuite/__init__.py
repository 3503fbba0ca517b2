"""The paper's benchmark suite (§V-B) on the PyTorch port: 6 task-parallel
GPU workloads that run on CUDA-stream lanes, plus the out-of-core,
multi-tenant, SLO and multi-device scenarios."""
from .costmodel import GPUS, GPUSpec, GTX960, GTX1660S, P100, kernel_cost, occupancy
from .suite import BENCHMARKS, Benchmark, BS, DL, HITS, IMG, ML, VEC
from .multidevice import build_locality_heavy, build_task_parallel
from .outofcore import build_outofcore, verify_outofcore, working_set_bytes
from .slo import build_slo_workload

__all__ = ["BENCHMARKS", "Benchmark", "VEC", "BS", "IMG", "ML", "HITS", "DL",
           "GPUS", "GPUSpec", "P100", "GTX1660S", "GTX960", "kernel_cost",
           "occupancy", "build_task_parallel", "build_locality_heavy",
           "build_outofcore", "verify_outofcore", "working_set_bytes",
           "build_slo_workload"]
