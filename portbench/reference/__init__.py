"""Plain PyTorch reference of the measured towers and training step.

It imports neither JAX nor anything of the measured program."""
