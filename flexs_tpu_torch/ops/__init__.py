"""Tensor ops: the duplex DP (plain and CUDA kernel), the fold DP and distance ops."""
from flexs_tpu_torch.ops import cuda_duplex, hamming, packed_hamming  # noqa: F401
from flexs_tpu_torch.ops import padding, pdb, rna_duplex, rna_fold  # noqa: F401
from flexs_tpu_torch.ops.hamming import (  # noqa: F401
    edit_distance_matrix,
    hamming_distance_matrix,
)
