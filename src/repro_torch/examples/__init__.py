"""Runnable examples of the port (``python -m repro_torch.examples.<name>``),
the counterparts of the repository's ``examples/*.py``.  Each takes
``--device`` and runs on the CUDA card unless given ``--device cpu``."""
