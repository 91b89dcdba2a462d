"""The benchmark's CPU tests run tiny cells in several worker processes: one
torch thread each keeps them from contending for the cores."""

import torch

torch.set_num_threads(1)
