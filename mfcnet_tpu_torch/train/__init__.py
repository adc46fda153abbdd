"""Training: losses, metrics, schedule, optimizer state, steps, epochs."""
