"""The port's train and eval steps, optimizer and checkpoints."""
