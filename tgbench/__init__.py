"""The benchmark of tamgcn_tpu_torch: harness, traffic, work counts and the
plain reference that decides `correct`. Run `python3 tgbench/run.py
--workload <cell> --seed <n> --seconds <s> --trace <0|1>` from the root of a
checkout; BENCHMARK.json names the cells."""
