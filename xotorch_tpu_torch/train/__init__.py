"""The training side of the port: LoRA adapters and adapter-only checkpoints
(train/lora.py). The train and eval steps, the optimizer state and the dataset are
the training leaf, still to port (ROADMAP queue 1)."""
