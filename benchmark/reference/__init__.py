"""The frozen plain reference: the KV-Net in plain PyTorch and its own
reading of the scene files. Imports nothing of the program under test."""
