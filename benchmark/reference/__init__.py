"""Plain references: NumPy and Python integers, nothing of the program."""
