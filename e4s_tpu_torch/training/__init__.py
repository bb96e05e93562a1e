"""Training: the Coach's G, D and R1 steps and its optimizers."""
