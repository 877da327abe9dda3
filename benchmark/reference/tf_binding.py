"""Plain reference of the TF-Bind-8 oracle: Barrera et al. (2016) score tables gathered in numpy.

The tables are read as data from the configuration's `data` file (one
float32 row of 4^8 min-max normalised E-scores per landscape, both strands
already mapped to one score).  A sequence's index is its tokens in base 4,
the first position most significant, tokens numbered in the order of the
configuration's `alphabet`.  This file imports numpy and torch only.
"""
import os

import numpy as np
import torch


class Reference:
    """The TF-Bind-8 truth of rows of tokens on a named landscape."""

    def __init__(self, config, root: str, inputs, device):
        with np.load(os.path.join(root, config["data"])) as data:
            self.names = [str(n) for n in data["names"]]
            self.tables = np.asarray(data["tables"], np.float32)
        self.row = {name: i for i, name in enumerate(self.names)}
        self.base = len(config["alphabet"])
        self.device = torch.device(device)

    def index(self, tokens) -> np.ndarray:
        tokens = np.asarray(tokens, np.int64)
        return tokens @ (self.base ** np.arange(tokens.shape[1] - 1, -1, -1, dtype=np.int64))

    def truth(self, key, tokens) -> np.ndarray:
        """float64[n]: landscape `key`'s score of int[n, L] tokens."""
        return self.tables[self.row[key]][self.index(tokens)].astype(np.float64)

    def bf16_oracle(self):
        """The control: the stacked tables rounded to bfloat16, as `(params, tokens) -> f32[C, B]`.

        `params` is the sweep's (tables, int64[C] landscape row of each cell),
        its rows in this file's order; the program's tables are not read.
        """
        tables = torch.as_tensor(self.tables, device=self.device).to(torch.bfloat16).float()

        def oracle(params, tokens):
            _, rows = params
            length = tokens.shape[-1]
            powers = self.base ** torch.arange(length - 1, -1, -1, device=tokens.device)
            return tables[rows[:, None], (tokens.long() * powers).sum(-1)]

        return oracle
