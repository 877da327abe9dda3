"""Utility subpackage: sequence codecs, replay buffers, generative models."""
from flexs_tpu_torch.alphabet import AAS, BA, DNAA, RNAA  # noqa: F401
from flexs_tpu_torch.utils import checkpointing, profiling  # noqa: F401
from flexs_tpu_torch.utils import replay_buffers, sequence_utils  # noqa: F401

# `VAE_utils` alias mirrors the reference module name
# (flexs/utils/VAE_utils.py); the implementation lives in
# flexs_tpu_torch.utils.vae.
from flexs_tpu_torch.utils import vae  # noqa: F401
from flexs_tpu_torch.utils import vae as VAE_utils  # noqa: F401
