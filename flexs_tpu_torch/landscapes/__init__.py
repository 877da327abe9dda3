"""Ground-truth landscapes and their problem registries."""
from flexs_tpu_torch.landscapes import rna  # noqa: F401
from flexs_tpu_torch.landscapes.rna import RNABinding  # noqa: F401
