"""Training: the flow-matching train step, optimizers, LoRA."""
