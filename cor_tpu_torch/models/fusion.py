"""Gated cross-modal fusion (CirFuse), the PyTorch counterpart of
``cor_tpu.models.fusion``:

    atten_I, atten_T = sigmoid(MLP([img ; txt]))        (modality gates)
    gated_img, gated_txt = atten_I * img, atten_T * txt
    dynamic = sigmoid(MLP([gated_img ; gated_txt]))     (scalar in [0, 1])
    repres = normalize(dynamic * gated_img + (1 - dynamic) * gated_txt)

Each gate's sigmoid is taken in fp32, as in ``cor_tpu``.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from cor_tpu_torch.ops.common import Dense, dropout, l2_normalize


class Gate(nn.Module):
    """Linear -> ReLU -> Dropout(0.5) -> Linear -> Sigmoid (fp32)."""

    def __init__(self, in_dim: int, hidden: int, out_dim: int):
        super().__init__()
        self.lin1 = Dense(in_dim, hidden)
        self.lin2 = Dense(hidden, out_dim)

    def forward(
        self, x: torch.Tensor, generator: Optional[torch.Generator] = None, train: bool = False
    ) -> torch.Tensor:
        h = dropout(torch.relu(self.lin1(x)), 0.5, generator, train)
        return torch.sigmoid(self.lin2(h).float()).to(x.dtype)


class CirFuse(nn.Module):
    def __init__(self, image_dim: int, text_dim: int):
        super().__init__()
        cat = image_dim + text_dim
        self.atten_image = Gate(cat, image_dim, image_dim)
        self.atten_text = Gate(cat, text_dim, text_dim)
        self.dynamic_scalar = Gate(cat, image_dim, 1)

    def forward(
        self,
        image_features: torch.Tensor,  # [N, D]
        text_features: torch.Tensor,  # [N, D]
        generator: Optional[torch.Generator] = None,
        train: bool = False,
    ) -> Dict[str, torch.Tensor]:
        """cor_tpu ``cir_fuse_compose``."""
        raw = torch.cat([image_features, text_features], dim=-1)
        gated_img = self.atten_image(raw, generator, train) * image_features
        gated_txt = self.atten_text(raw, generator, train) * text_features
        new = torch.cat([gated_img, gated_txt], dim=-1)
        dynamic = self.dynamic_scalar(new, generator, train)  # [N, 1]
        combined = dynamic * gated_img + (1.0 - dynamic) * gated_txt
        return {
            "repres": l2_normalize(combined),
            "fuseimg": gated_img,
            "fusetxt": gated_txt,
            "dynamic_scalar": dynamic,
        }
