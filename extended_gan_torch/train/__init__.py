"""conv-GAT training: losses, optimizers, the trainer and its driver."""
