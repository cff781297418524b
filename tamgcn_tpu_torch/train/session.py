"""Work-dir session management: logging, config snapshot, timers, artifacts.

A copy of tamgcn_tpu/train/session.py (numpy/yaml/stdlib only), after
reference torchlight/torchlight/io.py:
  * timestamped print_log to screen + <work_dir>/log.txt (:121-130);
  * save_arg session snapshot incl. the exact command line -> config.yaml
    (:109-119);
  * named split timers with proportion reporting (:132-157);
  * save_pkl artifact writer (:92-99);
  * progress_info.csv epoch matrix (processor/processor.py:45,145).
"""
from __future__ import annotations

import os
import pickle
import sys
import time

import numpy as np
import yaml


class Session:
    def __init__(self, work_dir: str, save_log: bool = True, print_log: bool = True):
        self.work_dir = work_dir
        self.save_log = save_log
        self.print_to_screen = print_log
        os.makedirs(work_dir, exist_ok=True)
        self.cur_time = time.time()
        self.split_timer = {}

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

    # -- timers ---------------------------------------------------------------

    def init_timer(self, *names: str):
        self.record_time()
        self.split_timer = {name: 1e-6 for name in names}

    def check_time(self, name: str):
        self.split_timer[name] = self.split_timer.get(name, 1e-6) + self.split_time()

    def record_time(self):
        self.cur_time = time.time()
        return self.cur_time

    def split_time(self):
        split = time.time() - self.cur_time
        self.record_time()
        return split

    def print_timer(self):
        total = sum(self.split_timer.values())
        proportion = {
            k: f"{int(round(v * 100 / total)):02d}%"
            for k, v in self.split_timer.items()
        }
        self.print_log(f"Time consumption: {proportion}")

    # -- artifacts -------------------------------------------------------------

    def save_pkl(self, result, filename: str):
        with open(os.path.join(self.work_dir, filename), "wb") as f:
            pickle.dump(result, f)

    def save_progress_csv(self, progress: np.ndarray, filename="progress_info.csv"):
        np.savetxt(
            os.path.join(self.work_dir, filename),
            progress,
            fmt="%f",
            delimiter=",",
            header=" Train_mean_loss, Test_mean_loss, Top_1, Top_5",
        )
