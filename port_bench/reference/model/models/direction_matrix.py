"""Direction matrix A: the linear map from the k-dim Δp vector (k = 15
learned directions) to a W+ latent shift (num_layers × 512 when
``w_plus``). Its parameters are named like the reference's
(``linear.weight``, ``linear.bias``)."""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


class DirectionMatrix(nn.Module):
    def __init__(self, shift_dim: int = 512, input_dim: int = 15, *,
                 w_plus: bool = True, num_layers: int = 8, bias: bool = True):
        super().__init__()
        self.shift_dim, self.input_dim = shift_dim, input_dim
        self.w_plus, self.num_layers = w_plus, num_layers
        out_dim = shift_dim * num_layers if w_plus else shift_dim
        self.linear = nn.Linear(input_dim, out_dim, bias=bias)
        with torch.no_grad():
            self.linear.weight.zero_()
            if bias:
                self.linear.bias.zero_()

    def forward(self, delta_p):
        return direction_matrix_forward(self, delta_p)


def direction_matrix_forward(a: DirectionMatrix, delta_p: torch.Tensor) -> torch.Tensor:
    """Δp (B, input_dim) → shift (B, num_layers, shift_dim) if w_plus else
    (B, shift_dim), in float32."""
    x = delta_p.reshape(-1, a.input_dim).float()
    out = F.linear(x, a.linear.weight.float(),
                   None if a.linear.bias is None else a.linear.bias.float())
    if a.w_plus:
        out = out.reshape(x.shape[0], a.num_layers, a.shift_dim)
    return out
