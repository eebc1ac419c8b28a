"""Example training scripts of the port (``torchrun -m ...``)."""
