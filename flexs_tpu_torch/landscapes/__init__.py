"""Ground-truth landscapes and their problem registries."""
from flexs_tpu_torch.landscapes import additive_aav_packaging, rna, rosetta  # noqa: F401
from flexs_tpu_torch.landscapes import tf_binding  # noqa: F401
from flexs_tpu_torch.landscapes.additive_aav_packaging import (  # noqa: F401
    AdditiveAAVPackaging,
)
from flexs_tpu_torch.landscapes.rna import RNABinding  # noqa: F401
from flexs_tpu_torch.landscapes.rosetta import RosettaFolding  # noqa: F401
from flexs_tpu_torch.landscapes.tf_binding import TFBinding  # noqa: F401
