"""The frozen plain-PyTorch references. Nothing here imports the program."""
