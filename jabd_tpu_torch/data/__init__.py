"""Training data of the port (numpy, no image libraries)."""
