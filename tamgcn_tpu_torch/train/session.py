"""Work-dir session management: logging, config snapshot, score pickle.

The part of tamgcn_tpu/train/session.py that the test phase uses, copied
(yaml/stdlib only), after reference torchlight/torchlight/io.py:
  * timestamped print_log to screen + <work_dir>/log.txt (:121-130);
  * save_arg session snapshot incl. the exact command line -> config.yaml
    (:109-119);
  * save_pkl artifact writer (:92-99).
The split timers and the progress csv come with the training slice.
"""
from __future__ import annotations

import os
import pickle
import sys
import time

import yaml


class Session:
    def __init__(self, work_dir: str, save_log: bool = True, print_log: bool = True):
        self.work_dir = work_dir
        self.save_log = save_log
        self.print_to_screen = print_log
        os.makedirs(work_dir, exist_ok=True)

    # -- logging ------------------------------------------------------------

    def print_log(self, msg: str, print_time: bool = True):
        if print_time:
            msg = time.strftime("[ %a %b %d %H:%M:%S %Y ] ", time.localtime()) + msg
        if self.print_to_screen:
            print(msg)
        if self.save_log:
            with open(os.path.join(self.work_dir, "log.txt"), "a") as f:
                print(msg, file=f)

    # -- config snapshot ------------------------------------------------------

    def save_arg(self, arg):
        arg_dict = vars(arg) if not isinstance(arg, dict) else dict(arg)
        with open(os.path.join(self.work_dir, "config.yaml"), "w") as f:
            f.write(f"# command line: {' '.join(sys.argv)}\n\n")
            yaml.dump(arg_dict, f, default_flow_style=False, indent=4)

    # -- artifacts -------------------------------------------------------------

    def save_pkl(self, result, filename: str):
        with open(os.path.join(self.work_dir, filename), "wb") as f:
            pickle.dump(result, f)
