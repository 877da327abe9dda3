"""Tensor ops: the duplex DP (plain and CUDA kernel) and distance ops."""
from flexs_tpu_torch.ops import cuda_duplex, hamming, packed_hamming  # noqa: F401
from flexs_tpu_torch.ops import padding, pdb, rna_duplex  # noqa: F401
