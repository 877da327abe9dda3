"""Sklearn model wrappers and pre-wrapped baselines.

Parity contract (reference baselines/models/sklearn_models.py):
  * `SklearnModel` trains on flattened one-hot encodings (:28-36).
  * `SklearnRegressor._fitness_function` = `model.predict` (:42-50).
  * `SklearnClassifier._fitness_function` = `model.predict_proba[:, 1]`
    (:55-63).
  * Concrete `LinearRegression` / `LogisticRegression` / `RandomForest`
    with names "linear_regression" / "logistic_regression" / "random_forest"
    (:67-91).  As in the reference, LogisticRegression subclasses the
    regressor wrapper (predicts class labels, not probabilities).

These members run on the host CPU.  `SklearnModel` wraps any object with
`fit` and `predict`; sklearn itself is imported only by the constructors
of the three concrete wrappers, so the package imports, and every other
model runs, where sklearn is not installed (as on the machine with the
card).  The device-side members live in `torch_linear`, `torch_gp` and
`torch_trees`.
"""
import abc

import numpy as np

from flexs_tpu_torch.alphabet import as_alphabet
from flexs_tpu_torch.model import Model
from flexs_tpu_torch.types import SEQUENCES_TYPE


class SklearnModel(Model, abc.ABC):
    """Base sklearn model wrapper."""

    def __init__(self, model, alphabet: str, name: str):
        """Wrap the fitted-API `model` over flattened one-hot features."""
        super().__init__(name)

        self.model = model
        self.alphabet = as_alphabet(alphabet)

    def _flat_one_hot(self, sequences) -> np.ndarray:
        return self._flat_one_hot_tokens(self.alphabet.encode(list(sequences)))

    def _flat_one_hot_tokens(self, tokens) -> np.ndarray:
        tokens = np.asarray(tokens)
        eye = np.eye(len(self.alphabet), dtype=np.float64)
        return eye[tokens].reshape(len(tokens), -1)

    def train(self, sequences: SEQUENCES_TYPE, labels):
        """Flatten one-hot sequences and train via `model.fit`."""
        self.model.fit(self._flat_one_hot(sequences), labels)


class SklearnRegressor(SklearnModel, abc.ABC):
    """Class for sklearn regressors (uses `model.predict`)."""

    def _fitness_function(self, sequences: SEQUENCES_TYPE) -> np.ndarray:
        return self.model.predict(self._flat_one_hot(sequences))

    def fitness_from_tokens(self, tokens) -> np.ndarray:
        """Token fast path (no string round-trip)."""
        return self.model.predict(self._flat_one_hot_tokens(tokens))


class SklearnClassifier(SklearnModel, abc.ABC):
    """Class for sklearn classifiers (uses `model.predict_proba(...)[:, 1]`)."""

    def _fitness_function(self, sequences: SEQUENCES_TYPE) -> np.ndarray:
        return self.model.predict_proba(self._flat_one_hot(sequences))[:, 1]

    def fitness_from_tokens(self, tokens) -> np.ndarray:
        """Token fast path (no string round-trip)."""
        return self.model.predict_proba(self._flat_one_hot_tokens(tokens))[:, 1]


class LinearRegression(SklearnRegressor):
    """Sklearn linear regression."""

    def __init__(self, alphabet: str, **kwargs):
        """Create a linear regression model."""
        import sklearn.linear_model

        model = sklearn.linear_model.LinearRegression(**kwargs)
        super().__init__(model, alphabet, "linear_regression")


class LogisticRegression(SklearnRegressor):
    """Sklearn logistic regression."""

    def __init__(self, alphabet: str, **kwargs):
        """Create a logistic regression model."""
        import sklearn.linear_model

        model = sklearn.linear_model.LogisticRegression(**kwargs)
        super().__init__(model, alphabet, "logistic_regression")


class RandomForest(SklearnRegressor):
    """Sklearn random forest regressor."""

    def __init__(self, alphabet: str, **kwargs):
        """Create a random forest regressor."""
        import sklearn.ensemble

        model = sklearn.ensemble.RandomForestRegressor(**kwargs)
        super().__init__(model, alphabet, "random_forest")
