"""PyTorch/CUDA port of the Collie workload zoo (serving slice)."""
