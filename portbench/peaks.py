"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at the full 700 W power limit), and the byte bound of the SpMM.

The port sets no TF32 anywhere, so its float32 matrix products run outside
the tensor cores: a float32 step's share of the chip's peak is taken
against FP32_FLOPS_PER_S. Every reading is printed with the card's power
limit beside it, since a card set below 700 W cannot reach these rates.
"""

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
TF32_FLOPS_PER_S = 495e12
BF16_FLOPS_PER_S = 989e12


def spmm_bytes(n, nnz, d):
    """The least bytes of y = A @ x for a float32 CSR A of n rows and nnz
    edges and x of d columns: the column ids and values (4 + 4 bytes an
    edge) and the n + 1 row pointers read once, x read once, y written
    once."""
    return nnz * 8 + (n + 1) * 4 + 2 * n * d * 4


def spmm_least_seconds(n, nnz, d):
    """The least time of that product on the chip: its bytes at the HBM
    rate or its 2 * nnz * d operations at the float32 rate, the larger."""
    return max(spmm_bytes(n, nnz, d) / HBM_BYTES_PER_S,
               2 * nnz * d / FP32_FLOPS_PER_S)
