"""Global epistasis surrogate.

Contract (reference baselines/models/global_epistasis_model.py:26-48):
Flatten -> Dense(1, relu) (the additive "trait" bottleneck) -> Dense(h,
relu) -> Dense(h, relu) -> Dense(1) (the nonlinear link); Adam + MSE.  The
reference's default name is "MLP_hidden_size_{h}"
(global_epistasis_model.py:41, kept as it is for the run logs).
"""
from typing import Optional

import torch
from torch import nn

from flexs_tpu_torch.baselines.models.torch_model import Dense, TorchModel


class GlobalEpistasisModule(nn.Module):
    """A scalar additive trait followed by a nonlinear link network; a leading net axis."""

    def __init__(self, hidden_size: int, seq_len: int, alphabet_size: int, device=None):
        super().__init__()
        self.Dense_0 = Dense(seq_len * alphabet_size, 1, device=device)
        self.Dense_1 = Dense(1, hidden_size, device=device)
        self.Dense_2 = Dense(hidden_size, hidden_size, device=device)
        self.Dense_3 = Dense(hidden_size, 1, device=device)

    def forward(self, x: torch.Tensor, dropout_mask=None):
        """One-hot f32[nets, B, L, A] -> f32[nets, B] (no dropout)."""
        x = x.reshape(x.shape[0], x.shape[1], -1)
        x = torch.relu(self.Dense_0(x))
        x = torch.relu(self.Dense_1(x))
        x = torch.relu(self.Dense_2(x))
        return self.Dense_3(x)[..., 0]


class GlobalEpistasisModel(TorchModel):
    """Weighted sum of input features followed by dense layers."""

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
        """Create a global epistasis model (the layer definition lives on the meta device)."""
        if name is None:
            name = f"MLP_hidden_size_{hidden_size}"
        extra = {} if loss is None else {"loss": loss}
        super().__init__(
            GlobalEpistasisModule(hidden_size, seq_len, len(alphabet), device="meta"),
            alphabet=alphabet, name=name, batch_size=batch_size, epochs=epochs,
            **extra, **kwargs,
        )
