"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet: dense
rates, no sparsity, at the 700 W limit)."""

HBM_BYTES_PER_S = 3.35e12
FLOPS = {
    "bfloat16": 989e12,  # tensor cores
    "tf32": 495e12,      # tensor cores, float32 operands rounded to TF32
    "float32": 67e12,    # CUDA cores
}


def least_seconds(flops: float, nbytes: float, dtype: str) -> float:
    """The least time an operation can take: its FLOPs over the peak of
    its arithmetic or its bytes over the memory's bandwidth, whichever
    is larger."""
    return max(flops / FLOPS[dtype], nbytes / HBM_BYTES_PER_S)
