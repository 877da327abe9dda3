"""Common type aliases.

SEQUENCES_TYPE is the public host representation (a list or numpy array of
strings); TOKENS_TYPE is the integer-token representation every compute
path uses.
"""
from typing import List, Union

import numpy as np
import torch

#: A batch of sequences as strings (host representation, I/O edge only).
SEQUENCES_TYPE = Union[List[str], np.ndarray]

#: A batch of sequences as integer tokens `int[batch, length]`.
TOKENS_TYPE = Union[np.ndarray, torch.Tensor]
