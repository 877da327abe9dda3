"""Baseline surrogate models."""
from flexs_tpu_torch.baselines.models.cnn import CNN, CNNModule  # noqa: F401
from flexs_tpu_torch.baselines.models.global_epistasis_model import (  # noqa: F401
    GlobalEpistasisModel,
    GlobalEpistasisModule,
)
from flexs_tpu_torch.baselines.models.mlp import MLP, MLPModule  # noqa: F401
from flexs_tpu_torch.baselines.models.noisy_abstract_model import (  # noqa: F401
    NoisyAbstractModel,
)
from flexs_tpu_torch.baselines.models.torch_model import TorchModel  # noqa: F401

# Alias for users migrating from the reference's TF/Keras stack: the torch
# wrapper fills the same role as flexs.baselines.models.KerasModel.
KerasModel = TorchModel
