"""Sample type shared by every sampler (the oracles come in a later slice)."""
from __future__ import annotations

from typing import NamedTuple

import torch


class Sample(NamedTuple):
    keys: torch.Tensor       # (..., k) int32 sampled keys, by decreasing |nu*|
    freqs: torch.Tensor      # (..., k) frequencies nu_x (exact or estimated)
    threshold: torch.Tensor  # (...) tau = (k+1)-st largest |nu*|
    transformed: torch.Tensor  # (..., k) nu*_x of the sampled keys
