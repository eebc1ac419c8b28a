"""The LM examples (``torchrun -m ...examples.lm.train_lm``)."""
