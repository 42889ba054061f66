"""PyTorch/CUDA port of the lock-free linear-probing hash table serving
stack (``repro``).  See ``README.md`` in this directory."""
