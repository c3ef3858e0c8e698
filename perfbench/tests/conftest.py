"""The benchmark's CPU tests run on one thread."""

import torch

torch.set_num_threads(1)
