"""Utility subpackage: sequence codecs and token-space primitives."""
from flexs_tpu_torch.alphabet import AAS, BA, DNAA, RNAA  # noqa: F401
from flexs_tpu_torch.utils import sequence_utils  # noqa: F401
