"""flexs_tpu_torch: the sequence-design sandbox on PyTorch and CUDA.

A port of `flexs_tpu` (JAX) to PyTorch for NVIDIA Hopper GPUs, with the
same public surface:

    import flexs_tpu_torch as flexs
    problem = flexs.landscapes.rna.registry()["L100_RNA1"]
    landscape = flexs.landscapes.RNABinding(**problem["params"])
    model = flexs.baselines.models.NoisyAbstractModel(landscape, seed=0)
    explorer = flexs.baselines.explorers.Adalead(
        model, rounds=10, sequences_batch_size=100,
        model_queries_per_batch=2000,
        starting_sequence=problem["starts"][1], alphabet=flexs.RNAA, seed=0)
    df, metadata = explorer.run(landscape)

Entry points run on the card (device="cuda") unless given device="cpu".
"""

__version__ = "0.1.0"

from flexs_tpu_torch import types  # noqa: F401
from flexs_tpu_torch.alphabet import AAS, BA, DNAA, RNAA, Alphabet  # noqa: F401
from flexs_tpu_torch.landscape import Landscape  # noqa: F401
from flexs_tpu_torch.model import LandscapeAsModel, Model  # noqa: F401
from flexs_tpu_torch.ensemble import Ensemble  # noqa: F401
from flexs_tpu_torch.explorer import Explorer  # noqa: F401

from flexs_tpu_torch import baselines, evaluate, landscapes, utils  # noqa: F401
from flexs_tpu_torch import ops, parallel, rl, runtime  # noqa: F401
