"""Plain PyTorch reference of what the cells serve and train. It imports
torch and numpy only: nothing of the served package, nothing of JAX."""
