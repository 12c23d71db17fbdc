"""The frozen work model (`model.py`) and the shares read from it
(`shares.py`)."""
