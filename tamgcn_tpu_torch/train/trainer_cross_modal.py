"""Cross-modal fusion trainer: two-input batches, GCN-submodule weight loading.

Counterpart of tamgcn_tpu/train/trainer_cross_modal.py (reference
processor/recognition_cross_modal.py):

  * the train and test loops feed model(skeleton, rgb): RecognitionTrainer
    already passes every input of the feeder's tuple;
  * --weights of a CTR-GCN go into the model's `gcn` submodule only, its
    `fc` dropped (reference :101-113), in any of the port's forms: a
    reference state dict (`.npz` or `.pt`), a port CTR-GCN `.pt` (names
    without `gcn.`; a directory names its best.pt or latest epoch{n}.pt)
    or a CTR-GCN Flax `.npz`; the partial-load check then counts the GCN's
    tensors. Weights of the whole fusion model (its own `.pt`, a reference
    fusion state dict, its Flax `.npz`) load whole;
  * freezing the GCN is config-driven (--freeze_params gcn): a zero update
    and no weight decay on its parameters (train/packing.py:freeze_mask_for);
    the model itself stops the gradient and keeps the GCN in eval mode
    (models/resnet_gcn_attention.py).

It also serves `recognition_fusion` (main.py:17-27), whose reference
processor names a model that does not exist: configs/nucla/fused.yaml
trains the cross-modal attention model through the same trainer.
"""
from __future__ import annotations

import numpy as np

from ..convert import from_flax
from ..utils.torch_import import ctrgcn_variables, import_state_dict, strip_module_prefix
from .checkpoint import flax_tree
from .trainer import RecognitionTrainer

# names only the whole fusion model's weights have
_FUSION_PREFIXES = ("gcn.", "resnet.", "attention_transform", "classifier.")


class CrossModalTrainer(RecognitionTrainer):
    def _weights_for(self, form: str, contents: dict):
        """(the module the weights load into, its state dict): the fusion
        model for its own weights, its `gcn` for a CTR-GCN's."""
        model, gcn = self.model, self.model.gcn
        if form == "flax npz":
            tree = flax_tree(contents)
            if "gcn" in tree.get("params", {}):
                return model, from_flax(tree, model)
            tree["params"].pop("fc", None)  # the fusion never uses the GCN head
            return gcn, from_flax(tree, gcn)
        names = strip_module_prefix(contents) if form != "pt" else contents
        if any(k.startswith(_FUSION_PREFIXES) for k in names):
            if form == "pt":
                return model, contents
            return model, import_state_dict(self.arg.model, names, model)
        if form == "pt":
            return gcn, {k: v for k, v in contents.items() if not k.startswith("fc.")}
        variables = ctrgcn_variables({k: np.asarray(v) for k, v in names.items()}, gcn)
        variables["params"].pop("fc", None)
        return gcn, from_flax(variables, gcn)
