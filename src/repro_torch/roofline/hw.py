"""Target hardware constants of the port: one NVIDIA H100 SXM5 80GB, and
the links of a node of eight such cards and between nodes.

Sources, by constant:

- NVIDIA H100 Tensor Core GPU datasheet (SXM5 column): HBM3 at 3.35 TB/s;
  FP32 67 TFLOP/s on the CUDA cores; dense BF16 989 and TF32 495 TFLOP/s
  on the tensor cores (the sheet's 1,979 and 989 are with 2:4 sparsity,
  twice the dense rate); NVLink 4 at 900 GB/s a card, 450 GB/s each way.
- The special-function units' exp rate: 16 a streaming multiprocessor a
  clock (CUDA C++ Programming Guide, arithmetic instruction throughput,
  compute capability 9.0) on the SXM5's 132 SMs at its 1.98 GHz boost
  clock (the datasheet).
- Between nodes: one 400 Gb/s NDR InfiniBand port a card (the DGX H100
  and HGX H100 reference designs pair each card with a ConnectX-7 port),
  50 GB/s each way.
- ``HBM_BYTES``: the memory the card reports,
  ``torch.cuda.get_device_properties(0).total_memory``, on an NVIDIA
  H100 80GB HBM3 at a 700 W power limit (torch 2.11.0+cu128);
  ``chip_smoke.py``'s phase 18 fails if the card reports another value.

No time, rate or size of another chip appears here.
"""
from __future__ import annotations

import dataclasses

import torch

HBM_BYTES_PER_S = 3.35e12              # HBM3, bytes/s
CORE_OPS_PER_S = 67e12                 # f32 / int32 on the CUDA cores, op/s
BF16_TENSOR_OPS_PER_S = 989e12         # dense bf16 on the tensor cores, op/s
TF32_TENSOR_OPS_PER_S = 495e12         # dense TF32 on the tensor cores, op/s
SFU_EXP_PER_S = 16 * 132 * 1.98e9      # exps/s on the special-function units
HBM_BYTES = 85_017_493_504             # the card's own report, bytes (79.18 GiB)
NVLINK_BYTES_PER_S = 450e9             # NVLink 4, each way, inside a node
IB_BYTES_PER_S = 50e9                  # 400 Gb/s NDR InfiniBand a card, between nodes
GPUS_PER_NODE = 8

# operations/s by the kind of unit that runs them (``roofline.kernels``)
OPS_PER_S = {"f32": CORE_OPS_PER_S, "bf16": BF16_TENSOR_OPS_PER_S,
             "tf32": TF32_TENSOR_OPS_PER_S}

DTYPE_BYTES = {
    torch.float64: 8, torch.float32: 4, torch.float16: 2, torch.bfloat16: 2,
    torch.float8_e4m3fn: 1, torch.float8_e5m2: 1,
    torch.int64: 8, torch.int32: 4, torch.int16: 2, torch.int8: 1,
    torch.uint8: 1, torch.bool: 1, torch.complex64: 8, torch.complex128: 16,
}


@dataclasses.dataclass(frozen=True)
class Hardware:
    """What the roofline reads of a machine: the dense bf16 peak, the
    memory's rate and size, and the collective links, inside a node of
    ``gpus_per_node`` ranks (consecutive global ranks) and between
    nodes."""
    name: str
    peak_flops: float
    hbm_bytes_per_s: float
    hbm_bytes: float
    intra_node_bytes_per_s: float
    inter_node_bytes_per_s: float
    gpus_per_node: int

    def link_bytes_per_s(self, link: str) -> float:
        return self.intra_node_bytes_per_s if link == "intra" else self.inter_node_bytes_per_s


H100 = Hardware(name="NVIDIA H100 SXM5 80GB", peak_flops=BF16_TENSOR_OPS_PER_S,
                hbm_bytes_per_s=HBM_BYTES_PER_S, hbm_bytes=HBM_BYTES,
                intra_node_bytes_per_s=NVLINK_BYTES_PER_S,
                inter_node_bytes_per_s=IB_BYTES_PER_S, gpus_per_node=GPUS_PER_NODE)


__all__ = [
    "BF16_TENSOR_OPS_PER_S",
    "CORE_OPS_PER_S",
    "DTYPE_BYTES",
    "GPUS_PER_NODE",
    "H100",
    "HBM_BYTES",
    "HBM_BYTES_PER_S",
    "Hardware",
    "IB_BYTES_PER_S",
    "NVLINK_BYTES_PER_S",
    "OPS_PER_S",
    "SFU_EXP_PER_S",
    "TF32_TENSOR_OPS_PER_S",
]
