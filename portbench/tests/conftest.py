"""The benchmark's own tests: ``python -m pytest portbench/tests`` (CPU
only; the benchmark's card runs are ``run.py`` and ``control.py``)."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
