"""Drivers, one per kind of traffic: `train_loop`, `eval_loop`. A traffic
file names its driver."""
