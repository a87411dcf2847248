"""A toy net (JAX-free) with one leaf of each kind the JAX package splits
over a 'model' axis of 2, for tests/test_torch_tp_eval.py and
tests/torch_tp_child.py: a conv with a bias (split dim 0, the bias whole),
a depthwise conv (its groups split with their input channels), a
transposed conv (split dim 1), a Linear (split dim 0) and a parameter the
weight bridge keeps as it is (gathered before use)."""

import torch
import torch.nn.functional as F
from torch import nn


class Toy(nn.Module):
    def __init__(self, seed: int = 0):
        super().__init__()
        self.conv = nn.Conv2d(8, 256, 3, padding=1)
        self.dw = nn.Conv2d(256, 256, 3, padding=1, groups=256, bias=False)
        self.deconv1 = nn.ConvTranspose2d(256, 256, 4, 2, 1, bias=False)
        self.fc = nn.Linear(256, 512)
        self.pos = nn.Parameter(torch.zeros(1, 4, 512))
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for p in self.parameters():
                p.copy_(torch.randn(p.shape, generator=gen) * 0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.deconv1(F.relu(self.dw(self.conv(x))))
        return self.fc(y.mean((2, 3)))[:, None, :] + self.pos


SPLIT = {"conv.weight": 0, "dw.weight": 0, "deconv1.weight": 1, "fc.weight": 0, "pos": 2}
COMPUTED = ("conv", "dw", "deconv1", "fc")


def toy_input(seed: int = 1) -> torch.Tensor:
    return torch.randn(2, 8, 4, 4, generator=torch.Generator().manual_seed(seed))
