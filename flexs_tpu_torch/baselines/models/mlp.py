"""Baseline multilayer perceptron surrogate.

Contract (reference baselines/models/mlp.py:21-44): Flatten -> 3 x
Dense(hidden_size, relu) -> Dense(1); Adam + MSE; default name
"MLP_hidden_size_{h}".
"""
from typing import Optional

import torch
from torch import nn

from flexs_tpu_torch.baselines.models.torch_model import Dense, TorchModel


class MLPModule(nn.Module):
    """Flatten, then three relu dense layers and a linear head; a leading net axis."""

    def __init__(self, hidden_size: int, seq_len: int, alphabet_size: int, device=None):
        super().__init__()
        self.Dense_0 = Dense(seq_len * alphabet_size, hidden_size, device=device)
        self.Dense_1 = Dense(hidden_size, hidden_size, device=device)
        self.Dense_2 = Dense(hidden_size, hidden_size, device=device)
        self.Dense_3 = Dense(hidden_size, 1, device=device)

    def forward(self, x: torch.Tensor, dropout_mask=None):
        """One-hot f32[nets, B, L, A] -> f32[nets, B] (no dropout)."""
        x = x.reshape(x.shape[0], x.shape[1], -1)
        for dense in (self.Dense_0, self.Dense_1, self.Dense_2):
            x = torch.relu(dense(x))
        return self.Dense_3(x)[..., 0]


class MLP(TorchModel):
    """A baseline MLP with three dense layers and relu activations."""

    def __init__(
        self,
        seq_len: int,
        hidden_size: int,
        alphabet: str,
        loss=None,
        name: Optional[str] = None,
        batch_size: int = 256,
        epochs: int = 20,
        **kwargs,
    ):
        """Create an MLP (the layer definition lives on the meta device)."""
        if name is None:
            name = f"MLP_hidden_size_{hidden_size}"
        extra = {} if loss is None else {"loss": loss}
        super().__init__(
            MLPModule(hidden_size, seq_len, len(alphabet), device="meta"),
            alphabet=alphabet, name=name, batch_size=batch_size, epochs=epochs,
            **extra, **kwargs,
        )
