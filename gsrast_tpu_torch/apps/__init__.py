"""Small programs on the port, each run as `python -m
gsrast_tpu_torch.apps.<name> [--device cpu]`: `basic` (one render over an
orange clear), `fbtest` (nested render targets), `spheretrace` (one
ellipsoid and its projection diagnostics) and `render_app` (the viewer:
orbit or first-person frames in the three modes, frame statistics)."""
