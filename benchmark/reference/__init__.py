"""The plain PyTorch reference and the comparisons that decide correct."""
