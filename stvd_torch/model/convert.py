"""Parameter dicts between numpy and torch.

The JAX package hands its parameters over as numpy (``np.asarray`` on
each leaf); the port computes the same function from them.  0-d scalars
(``c_att``, ``b_sel``) stay 0-d tensors.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .step import Params


def params_from_numpy(arrays: Dict[str, np.ndarray],
                      device: torch.device | str = "cuda",
                      dtype: torch.dtype = torch.float32) -> Params:
    return {k: torch.from_numpy(np.array(v, copy=True)).to(device=device,
                                                           dtype=dtype)
            for k, v in arrays.items()}


def params_to_numpy(params: Params) -> Dict[str, np.ndarray]:
    """float32 numpy copies (bf16 widens to float32 without loss)."""
    return {k: v.detach().to("cpu", torch.float32).numpy()
            for k, v in params.items()}
