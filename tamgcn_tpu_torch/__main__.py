"""tamgcn_tpu_torch CLI, the counterpart of main.py:

    python -m tamgcn_tpu_torch recognition -c configs/nucla/gcn.yaml [overrides]
    python -m tamgcn_tpu_torch recognition -c configs/nucla/gcn.yaml \\
        --phase test --weights w.pt [overrides]
    python -m tamgcn_tpu_torch recognition -c configs/ntu60.yaml --distributed false
    python -m tamgcn_tpu_torch recognition_rgb_only -c configs/nucla/resnet.yaml
    python -m tamgcn_tpu_torch recognition_cross_modal -c configs/nucla/cross_modal.yaml
    python -m tamgcn_tpu_torch recognition_fusion -c configs/nucla/fused.yaml

Runs on cuda:<--device> unless --use_gpu false asks for the CPU.
"""
from __future__ import annotations

import sys


def _registry() -> dict:
    """Subcommand -> trainer class, as main.py:17-27."""
    from tamgcn_tpu_torch.train.trainer import RecognitionTrainer
    from tamgcn_tpu_torch.train.trainer_cross_modal import CrossModalTrainer

    return {"recognition": RecognitionTrainer,
            "recognition_rgb_only": RecognitionTrainer,
            "recognition_cross_modal": CrossModalTrainer,
            "recognition_fusion": CrossModalTrainer}


def main(argv=None) -> int:
    from tamgcn_tpu_torch.train.config import base_parser, load_config

    argv = list(sys.argv[1:] if argv is None else argv)
    registry = _registry()
    if not argv or argv[0] not in registry:
        print(f"usage: python -m tamgcn_tpu_torch {{{','.join(registry)}}} "
              "[-c CONFIG] [--phase train | --phase test --weights W] [overrides]")
        return 2
    arg = load_config(argv[1:], parser=base_parser(add_help=True))
    registry[argv[0]](arg).start()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
