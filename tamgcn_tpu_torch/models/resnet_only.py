"""RGB-only ResNet-50 classifier over ST-ROI images.

Counterpart of tamgcn_tpu/models/resnet_only.py (reference
models/resnet_only.py:5-13): a stock ResNet-50 (no block dropout unless
`block_dropout` says so) with a num_class head, under `.model` as the Flax
module wraps it, so its state-dict names are `model.conv1.weight`, ... and
its Flax paths `model/conv1/kernel`, ....

`pretrained` is a path to a locally exported torchvision ResNet-50 `.npz`
(tools/export_torch_weights.py; no download): `load_pretrained()` loads its
trunk, `fc` skipped, into the model in place. Neither the JAX trainer nor
the port's calls it: a run starts from the seeded init or from --weights.
"""
from __future__ import annotations

import torch
from torch import nn

from .ctrgcn import compute_dtype
from .resnet import resnet50


class ResNetOnly(nn.Module):
    def __init__(self, num_class: int = 10, pretrained: str | None = None,
                 block_dropout: float = 0.0, dtype=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.num_class = num_class
        self.pretrained = pretrained
        self.dtype = compute_dtype(dtype)
        self.model = resnet50(num_classes=num_class, block_dropout=block_dropout,
                              dtype=self.dtype, generator=generator)

    def forward(self, x):
        return self.model(x)

    def load_pretrained(self) -> None:
        """The torchvision trunk of `pretrained` (fc excluded) into the model,
        in place; every tensor but the head's must come from the file."""
        if not self.pretrained:
            return
        from ..convert import from_flax
        from ..utils.torch_import import load_torch_resnet_npz

        fc = self.model.fc
        head = {"fc": {"kernel": fc.weight.detach().cpu().numpy().T,
                       "bias": fc.bias.detach().cpu().numpy()}}
        variables = load_torch_resnet_npz(self.pretrained, {"params": {"model": head}},
                                          submodule="model", skip_fc=True)
        self.load_state_dict(from_flax(variables, self))
