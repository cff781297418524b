"""The benchmark's own tests, all on the CPU: `python -m pytest
tgbench/tests -q` from the root of the repository (~2.5 min). What needs
the card is measured by the harness itself (`tgbench/tools/readings.py`)."""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
