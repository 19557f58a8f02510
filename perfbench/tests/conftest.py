"""The benchmark's CPU tests run tiny grids: a few threads each, so that
parallel workers do not contend for every core."""

import torch

torch.set_num_threads(2)
