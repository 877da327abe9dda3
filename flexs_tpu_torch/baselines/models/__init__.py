"""Baseline surrogate models (noisy oracles and empirical regressors)."""
from flexs_tpu_torch.baselines.models.adaptive_ensemble import (  # noqa: F401
    AdaptiveEnsemble,
    r2_weights,
)
from flexs_tpu_torch.baselines.models.cnn import CNN, CNNModule  # noqa: F401
from flexs_tpu_torch.baselines.models.global_epistasis_model import (  # noqa: F401
    GlobalEpistasisModel,
    GlobalEpistasisModule,
)
from flexs_tpu_torch.baselines.models.mlp import MLP, MLPModule  # noqa: F401
from flexs_tpu_torch.baselines.models.noisy_abstract_model import (  # noqa: F401
    NoisyAbstractModel,
)
from flexs_tpu_torch.baselines.models.sklearn_models import (  # noqa: F401
    LinearRegression,
    LogisticRegression,
    RandomForest,
    SklearnClassifier,
    SklearnModel,
    SklearnRegressor,
)
from flexs_tpu_torch.baselines.models.torch_gp import (  # noqa: F401
    TorchGaussianProcessRegressor,
    TorchKNNRegressor,
)
from flexs_tpu_torch.baselines.models.torch_linear import (  # noqa: F401
    TorchBayesianRidge,
    TorchLasso,
    TorchRidgeRegression,
)
from flexs_tpu_torch.baselines.models.torch_model import TorchModel  # noqa: F401
from flexs_tpu_torch.baselines.models.torch_trees import (  # noqa: F401
    TorchExtraTree,
    TorchGradientBoosting,
    TorchRandomForest,
)

# Alias for users migrating from the reference's TF/Keras stack: the torch
# wrapper fills the same role as flexs.baselines.models.KerasModel.
KerasModel = TorchModel
