"""The training side of the port: the dataset, the training step, the optimizer's
moments beside a checkpoint, LoRA adapters and adapter-only checkpoints."""
