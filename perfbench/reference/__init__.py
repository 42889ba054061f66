"""The plain reference: float32 PyTorch and NumPy, independent of the
program.  It imports nothing of ``repro_torch``, ``repro`` or ``jax``,
draws its weights again from the run's seed (``weights.py``, the same
draws the harness hands to the port) and works out again everything the
port derives from them: the decoder's logits (``decoder.py``) and the
page table the allocator should hold (``allocator.py``)."""
