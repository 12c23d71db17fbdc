"""The plain reference: a splat render (`splat.py`) and a train step
(`train.py`) in PyTorch ops, importing nothing of the measured program."""
