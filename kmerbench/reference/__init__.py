"""The plain reference that decides `correct`: NumPy and PyTorch only,
nothing of the program."""
