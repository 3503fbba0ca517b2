"""Analytic kernel cost model for the discrete-event simulator.

Per-kernel solo times are derived from a roofline over the paper's three
testbed GPUs (§V-A): ``t = max(flops/peak, bytes/bw) + launch latency``.
The per-kernel ``parallel_fraction`` (device occupancy while running solo)
determines how much head-room space-sharing can exploit (Fig. 9/12).

The simulator compares *schedules*, so what matters is the relative magnitude
of transfer vs. compute and the dependency structure — both of which come
from the benchmark definitions, not from this table.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class GPUSpec:
    name: str
    fp32_tflops: float
    fp64_tflops: float
    mem_gbps: float            # device memory bandwidth
    pcie_gbps: float           # effective host link bandwidth (per direction)
    mem_gb: float
    launch_latency_s: float = 3e-6
    # Effective UM demand-migration bandwidth.  Pascal+ GPUs serve UM through
    # the page-fault controller when data is not prefetched — the serial
    # GrCUDA scheduler (no prefetching) pays this price (§V-C); pre-Pascal
    # GPUs (GTX 960) always transfer explicitly at full PCIe bandwidth.
    um_fault_gbps: float = 0.0     # 0 -> no page-fault mechanism

    @property
    def page_faults(self) -> bool:
        return self.um_fault_gbps > 0


# The paper's three testbeds (§V-A).
P100 = GPUSpec("P100", fp32_tflops=9.3, fp64_tflops=4.7, mem_gbps=732.0,
               pcie_gbps=12.0, mem_gb=12.0, um_fault_gbps=7.6)
GTX1660S = GPUSpec("GTX1660Super", fp32_tflops=5.0, fp64_tflops=0.157,
                   mem_gbps=336.0, pcie_gbps=12.0, mem_gb=6.0,
                   um_fault_gbps=9.5)
GTX960 = GPUSpec("GTX960", fp32_tflops=2.4, fp64_tflops=0.075, mem_gbps=112.0,
                 pcie_gbps=12.0, mem_gb=2.0)

GPUS = {g.name: g for g in (P100, GTX1660S, GTX960)}


def kernel_cost(gpu: GPUSpec, flops: float, bytes_moved: float,
                fp64: bool = False) -> float:
    peak = (gpu.fp64_tflops if fp64 else gpu.fp32_tflops) * 1e12
    t_compute = flops / peak
    t_memory = bytes_moved / (gpu.mem_gbps * 1e9)
    return max(t_compute, t_memory) + gpu.launch_latency_s


# Global occupancy multiplier: benchmarks set this to ~0 to simulate the
# contention-free bound of Fig. 9 (every kernel computes at solo speed even
# when overlapped).
OCCUPANCY_SCALE = 1.0


def occupancy(gpu: GPUSpec, flops: float, bytes_moved: float,
              fp64: bool = False, parallelism: float = 1.0) -> float:
    """Estimate the device fraction a kernel occupies while running solo.

    A kernel *saturating* its bottleneck resource (bandwidth or FLOPs) cannot
    space-share for free — concurrent saturating kernels merely time-slice
    (Fig. 9: B&S at 15-20 % of the contention-free bound).  Head-room exists
    when a kernel underutilizes its bottleneck: ``parallelism`` < 1 encodes
    structural underutilization (tall matrices / low IPC, shared-memory-tiled
    stencils, irregular SpMV, tiny launches — §V-F), and launch latency makes
    very small kernels nearly free to overlap.  Clamped to [0.1, 1.0].
    """
    peak = (gpu.fp64_tflops if fp64 else gpu.fp32_tflops) * 1e12
    t_c = flops / peak
    t_m = bytes_moved / (gpu.mem_gbps * 1e9)
    t_busy = max(t_c, t_m)
    frac = t_busy / (t_busy + gpu.launch_latency_s)
    frac *= parallelism * OCCUPANCY_SCALE
    return float(min(1.0, max(0.01, frac)))


def sim_hardware(gpu: GPUSpec, policy: str, prefetch: bool = True):
    """Host-link model for a policy: the parallel scheduler prefetches at
    full PCIe bandwidth; the serial scheduler on page-fault GPUs pays
    demand-migration bandwidth (§V-C).  ``prefetch=False`` reproduces the
    paper's prefetch-disabled ablation (page-fault controller becomes the
    bottleneck)."""
    from ..core import SimHardware
    demand = gpu.page_faults and (policy == "serial" or not prefetch)
    bw = gpu.um_fault_gbps if demand else gpu.pcie_gbps
    return SimHardware(h2d_gbps=bw, d2h_gbps=gpu.pcie_gbps)
