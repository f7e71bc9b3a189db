"""Training (``agplace_tpu/train/``): losses, the grouped optimizers, the
train state and step, mining, checkpoints and the loop.  The entry point
is ``python -m agplace_tpu_torch.train`` (``train/cli.py``)."""
