"""The plain reference of what the benchmark runs: plain PyTorch, nothing of the program."""
