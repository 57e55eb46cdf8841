import torch

# The CPU tests run full-width networks on tiny images: keep each process to
# two threads so that parallel workers do not starve one another.
torch.set_num_threads(2)
