"""Hardware specifications (paper Table 2 + §4 system setup).

XPU-A/B/C are the paper's Table 2 parameters (resembling TPU v5e / v4 /
v5p), kept so that plans can be compared with the JAX package's; they are
not timings of any chip the port runs on.  ``H100_SXM`` is the card the
port serves on, and the port's ``SystemConfig`` defaults to it.  Hosts
are AMD EPYC-Milan-like with 4 XPUs per server; retrieval runs on the
host CPUs (paper §4: "XPU host servers support distributed retrieval").

Copied from ``src/repro/core/hardware.py``; the port imports
nothing of ``repro``, so it keeps its own copy.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class XPUSpec:
    name: str
    tflops: float                  # int8/bf16 peak, TFLOP/s
    hbm_gb: float
    mem_bw: float                  # bytes/s
    ici_bw: float                  # inter-chip link bytes/s
    flops_eff: float = 0.6         # achievable fraction of peak (MFU-like)
    mem_eff: float = 0.8
    op_overhead: float = 10e-6     # per-operator dispatch floor (P_comp(F))
    coll_overhead: float = 20e-6   # per-collective latency floor

    @property
    def peak_flops(self) -> float:
        return self.tflops * 1e12 * self.flops_eff

    @property
    def eff_mem_bw(self) -> float:
        return self.mem_bw * self.mem_eff


XPU_A = XPUSpec("XPU-A", 197, 16, 819e9, 200e9)     # ~TPU v5e
XPU_B = XPUSpec("XPU-B", 275, 32, 1200e9, 300e9)    # ~TPU v4
XPU_C = XPUSpec("XPU-C", 459, 96, 2765e9, 600e9)    # ~TPU v5p (default)

# NVIDIA H100 SXM data sheet: 989 TFLOP/s dense bf16, 80 GB of HBM3 at
# 3.35 TB/s, NVLink 900 GB/s per card, 450 GB/s each way.  Data-sheet
# values, not yet calibrated against the port's kernels on the card.
H100_SXM = XPUSpec("H100-SXM", 989, 80, 3.35e12, 450e9)

XPUS = {"A": XPU_A, "B": XPU_B, "C": XPU_C}


@dataclass(frozen=True)
class CPUHostSpec:
    name: str = "EPYC-Milan"
    cores: int = 96
    mem_gb: float = 384.0
    mem_bw: float = 460e9          # bytes/s
    mem_bw_util: float = 0.8       # measured with ScaNN (§4b)
    pq_scan_bw_per_core: float = 18e9   # bytes/s PQ code scan (§4b)


EPYC_MILAN = CPUHostSpec()


@dataclass(frozen=True)
class SystemConfig:
    """Data-center serving slice (§4): 16..32 servers, 4 XPUs each (the
    JAX package defaults to XPU-C; the port to the H100)."""
    n_servers: int = 32
    xpus_per_server: int = 4
    xpu: XPUSpec = H100_SXM
    host: CPUHostSpec = EPYC_MILAN

    @property
    def n_xpus(self) -> int:
        return self.n_servers * self.xpus_per_server
