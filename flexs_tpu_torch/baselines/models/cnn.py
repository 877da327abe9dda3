"""Baseline CNN surrogate.

Contract (reference baselines/models/cnn.py:23-67, through the JAX
package's `cnn.py`): Conv1D(filters, k=5, valid, relu) -> Conv1D(filters,
k=5, same, relu) -> MaxPool1D(1) (the identity at stride 1) ->
Conv1D(filters, k=max(len(alphabet) - 1, 1), same, relu) -> global max pool
-> Dense(h, relu) -> Dense(h, relu) -> Dropout(0.25) -> Dense(1); Adam +
MSE; default name "CNN_hidden_size_{h}_num_filters_{f}".
"""
from typing import Optional

import torch
from torch import nn

from flexs_tpu_torch.baselines.models.torch_model import Conv, Dense, TorchModel


class CNNModule(nn.Module):
    """Three conv layers, two dense layers, dropout before the head; a leading net axis.

    Layer names and layouts are Flax's (`Conv_0` .. `Dense_2`, kernels
    [k, in, out] and [in, out]), so Flax weights carry over as they are
    (`baselines.models.convert.params_from_flax`).
    """

    dropout_rate = 0.25
    keep_prob = 1.0 - dropout_rate

    def __init__(self, num_filters: int, hidden_size: int, alphabet_size: int,
                 kernel_size: int = 5, device=None):
        super().__init__()
        self.Conv_0 = Conv(alphabet_size, num_filters, kernel_size, "VALID", device=device)
        self.Conv_1 = Conv(num_filters, num_filters, kernel_size, "SAME", device=device)
        self.Conv_2 = Conv(num_filters, num_filters, max(alphabet_size - 1, 1), "SAME", device=device)
        self.Dense_0 = Dense(num_filters, hidden_size, device=device)
        self.Dense_1 = Dense(hidden_size, hidden_size, device=device)
        self.Dense_2 = Dense(hidden_size, 1, device=device)
        self.dropout_features = hidden_size

    def forward(self, x: torch.Tensor, dropout_mask: Optional[torch.Tensor] = None):
        """One-hot f32[nets, B, L, A] -> f32[nets, B]; a mask [nets, B, h] turns dropout on."""
        x = torch.relu(self.Conv_0(x))
        x = torch.relu(self.Conv_1(x))
        x = torch.relu(self.Conv_2(x))
        x = x.amax(dim=2)  # global max pool over positions
        x = torch.relu(self.Dense_0(x))
        x = torch.relu(self.Dense_1(x))
        if dropout_mask is not None:
            x = torch.where(dropout_mask, x / self.keep_prob, 0.0)
        return self.Dense_2(x)[..., 0]


class CNN(TorchModel):
    """A baseline CNN model with 3 conv layers and 2 dense layers."""

    def __init__(
        self,
        seq_len: int,
        num_filters: int,
        hidden_size: int,
        alphabet: str,
        loss=None,
        kernel_size: int = 5,
        name: Optional[str] = None,
        batch_size: int = 256,
        epochs: int = 20,
        **kwargs,
    ):
        """Create the CNN (the layer definition lives on the meta device)."""
        module = CNNModule(num_filters, hidden_size, len(alphabet), kernel_size, device="meta")
        if name is None:
            name = f"CNN_hidden_size_{hidden_size}_num_filters_{num_filters}"
        extra = {} if loss is None else {"loss": loss}
        super().__init__(
            module, alphabet=alphabet, name=name, batch_size=batch_size, epochs=epochs,
            **extra, **kwargs,
        )
