"""The plain reference: float64 PyTorch, independent of the program."""
