"""tamgcn_tpu_torch CLI, the counterpart of main.py:

    python -m tamgcn_tpu_torch recognition -c configs/nucla/gcn.yaml [overrides]
    python -m tamgcn_tpu_torch recognition -c configs/nucla/gcn.yaml \\
        --phase test --weights w.pt [overrides]

Runs on cuda:<--device> unless --use_gpu false asks for the CPU.
"""
from __future__ import annotations

import sys

_LATER = {
    "recognition_rgb_only": "the RGB slice",
    "recognition_cross_modal": "the cross-modal slice",
    "recognition_fusion": "the cross-modal slice",
}


def main(argv=None) -> int:
    from tamgcn_tpu_torch.train.config import base_parser, load_config
    from tamgcn_tpu_torch.train.trainer import RecognitionTrainer

    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] in _LATER:
        raise NotImplementedError(f"{argv[0]} comes with {_LATER[argv[0]]}")
    if not argv or argv[0] != "recognition":
        print("usage: python -m tamgcn_tpu_torch recognition [-c CONFIG] "
              "[--phase train | --phase test --weights W.pt] [overrides]")
        return 2
    arg = load_config(argv[1:], parser=base_parser(add_help=True))
    RecognitionTrainer(arg).start()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
