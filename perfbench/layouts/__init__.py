"""The port's side of each model (``layouts/<model>.py``, found by the
configuration's ``"model"`` key through ``perfbench.modules``): the
port's ``ModelConfig``, its parameter tree from the benchmark's draws,
its full-sequence forward and the CPU tests' cut.  Each imports the
program when called, never when loaded."""
