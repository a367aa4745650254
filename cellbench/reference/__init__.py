"""Plain PyTorch reference of the renderer; imports nothing of the program."""
