"""Operations and bytes, counted from a configuration's layer shapes by
running the plain reference on shape-only ("meta") tensors: no number of
the program enters.

- `forward_flops(net, size, ...)`: 2 x the multiply-adds of every
  convolution of one image's forward. `deploy=True` counts the serving
  network: BN folded and each RepConv's 1x1 branch folded into its 3x3
  (that 1x1 is not counted), the main branch only. `deploy=False` counts
  the train forward as written: both RepConv branches, both heads.
- `site_bound_s(net, site, batch, size)`: the least time a module site
  can take on the card: the larger of its bytes at the peak bandwidth
  (its input read once, its output written once, its deployed weights and
  biases read once, all bfloat16) and its operations at the bfloat16 peak.
"""

from __future__ import annotations

import torch

from lib.peaks import BF16_BYTES, H100_SXM
from reference.model import Network, Run

REPCONV_1X1 = ".conv1.conv2"


class _Counter(Run):
    """A Run on meta tensors that records each convolution's operations
    and weights and each block's input and output shapes."""

    def __init__(self, sd, train: bool, deploy: bool):
        super().__init__(sd, train=train)
        self.deploy = deploy
        self.convs: list[tuple[str, int, int, int]] = []  # key, flops, w, b
        self.blocks: dict[str, tuple[int, int]] = {}      # key: in, out

    def conv(self, key, x, stride=1, padding=0, groups=1):
        y = super().conv(key, x, stride, padding, groups)
        w = self.sd[key + ".weight"]
        if not (self.deploy and key.endswith(REPCONV_1X1 + ".conv")):
            macs = y.numel() * w[0].numel()
            self.convs.append((key, 2 * macs, w.numel(), w.shape[0]))
        return y

    def mark(self, key, x, y):
        self.blocks.setdefault(key, (_numel(x), _numel(y)))


def _numel(t) -> int:
    return sum(map(_numel, t)) if isinstance(t, (tuple, list)) else t.numel()


def _count(net: Network, batch: int, size: int, train: bool,
           deploy: bool) -> _Counter:
    meta = torch.device("meta")
    sd = {n: torch.empty(s, device=meta) for n, s, _ in net.spec()}
    c = _Counter(sd, train=train, deploy=deploy)
    x = torch.empty(batch, 3, size, size, device=meta)
    feats = net.features(c, x, main_only=deploy)
    net.head_maps(c, feats, main_only=deploy)
    return c


def forward_flops(net: Network, size: int, deploy: bool) -> int:
    """Operations of one image's forward (see the module docstring)."""
    return sum(f for _, f, _, _ in _count(net, 1, size, not deploy,
                                          deploy).convs)


def site_cost(net: Network, site: str, batch: int, size: int
              ) -> tuple[int, int]:
    """(operations, bytes) of one call of the deployed module at `site`
    (a path under `layers`, e.g. "down1" or "stage1.block1.0") for a
    batch of `batch` images."""
    c = _count(net, batch, size, train=False, deploy=True)
    key = f"layers.{site}"
    if key not in c.blocks:
        raise KeyError(f"no module site {site!r}")
    n_in, n_out = c.blocks[key]
    convs = [(f, w, b) for k, f, w, b in c.convs if k.startswith(key + ".")]
    flops = sum(f for f, _, _ in convs)
    params = sum(w + b for _, w, b in convs)
    return flops, BF16_BYTES * (n_in + n_out + params)


def site_bound_s(net: Network, site: str, batch: int, size: int) -> float:
    flops, nbytes = site_cost(net, site, batch, size)
    return max(nbytes / H100_SXM["hbm_bytes_per_s"],
               flops / H100_SXM["bf16_flops_per_s"])
