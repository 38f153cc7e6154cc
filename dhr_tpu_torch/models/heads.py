"""Projection heads shared across the retriever family.

Port of ``dhr_tpu/models/heads.py``:

- :class:`Projector` — linear pooler over [CLS] hidden states (DHR, Dense,
  Aggretriever) or over token reps (the ColBERT projection);
- :class:`TermWeightTrans` — one scalar term weight per sequence position
  (DHR and Aggretriever lexical heads).

Both compute in their input's dtype with f32 parameters.
"""

from __future__ import annotations

from torch import nn

from dhr_tpu_torch.models.transformer import Dense


class Projector(nn.Module):
    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.linear = Dense(in_dim, out_dim)

    def forward(self, x):
        return self.linear(x)


class TermWeightTrans(nn.Module):
    """Hidden state -> scalar term weight, one per sequence position."""

    def __init__(self, in_dim: int):
        super().__init__()
        self.linear = Dense(in_dim, 1)

    def forward(self, x):
        return self.linear(x)
