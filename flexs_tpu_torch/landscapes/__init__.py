"""Ground-truth landscapes and their problem registries."""
from flexs_tpu_torch.landscapes import rna, tf_binding  # noqa: F401
from flexs_tpu_torch.landscapes.rna import RNABinding  # noqa: F401
from flexs_tpu_torch.landscapes.tf_binding import TFBinding  # noqa: F401
