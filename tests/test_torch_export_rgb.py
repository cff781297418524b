"""The serving export of the RGB and fusion families on the CPU
(tamgcn_tpu_torch/tools/export_serving.py; the skeleton families are in
tests/test_torch_export.py): `configs/nucla/smoke_resnet.yaml` (ResNet-50)
and `smoke_cross_modal.yaml` (the fusion model, its frozen CTR-GCN through
`tamgcn.unit_ctr_gc`) at 32 x 32 images, exported, saved, reloaded and held
against the program and the live model. The input side comes from the
feeder's `image_size` (the JAX tool reads only `size` and would export
224 x 224)."""
import json
import os

import pytest
import torch

from tamgcn_tpu_torch.tools import export_serving

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CASES = {
    "rgb": ("smoke_resnet.yaml", [[2, 3, 32, 32]], {}),
    "fusion": ("smoke_cross_modal.yaml", [[2, 3, 16, 20, 1], [2, 15, 32, 32]],
               {"tamgcn.unit_ctr_gc.default": 10}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_rgb_and_fusion_roundtrip(case, tmp_path, capsys):
    config, shapes, ops = CASES[case]
    out = tmp_path / f"{case}.pt2"
    assert export_serving.main([
        "--out", str(out), "--platforms", "cpu", "--batch", "2", "--time", "16",
        "-c", os.path.join(REPO, "configs", "nucla", config),
        "--test_feeder_args", "image_size=32"]) == 0
    record = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert record["metric"] == "serving_export_roundtrip"
    assert record["input_shapes"] == shapes and record["output_shape"] == [2, 10]
    assert record["roundtrip_max_abs_err"] <= 2e-5
    assert record["custom_ops"] == ops
    assert os.path.getsize(out) == record["bytes"]
