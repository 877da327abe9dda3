"""Ground-truth landscapes and their problem registries."""
from flexs_tpu_torch.landscapes import additive_aav_packaging  # noqa: F401
from flexs_tpu_torch.landscapes import bert_gfp, rna, rosetta, tf_binding  # noqa: F401
from flexs_tpu_torch.landscapes.bert_gfp import BertGFPBrightness  # noqa: F401
from flexs_tpu_torch.landscapes.additive_aav_packaging import (  # noqa: F401
    AdditiveAAVPackaging,
)
from flexs_tpu_torch.landscapes.rna import RNABinding, RNAFolding  # noqa: F401
from flexs_tpu_torch.landscapes.rosetta import RosettaFolding  # noqa: F401
from flexs_tpu_torch.landscapes.tf_binding import TFBinding  # noqa: F401
