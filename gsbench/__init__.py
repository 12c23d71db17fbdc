"""The benchmark of gsrast_tpu_torch on one NVIDIA H100: graphed train
steps and viewer frames of the configurations under `gsbench/configs/`,
driven by the traffic mixes under `gsbench/traffic/`, checked against the
plain reference under `gsbench/reference/`. `python3 gsbench/run.py
--workload <cell> --seed <n> --seconds <s> --trace <0|1>` runs one cell
once; see `gsbench/README.md`.
"""

import os

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
