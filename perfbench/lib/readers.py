"""What a per-layer metric's reader (metrics/<name>.py) gets: the traced
stretch's summary (lib/trace.py), the units it completed (requests or
optimizer steps), the images of one unit, and the cell."""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property

from lib.flops import forward_flops, site_bound_s
from lib.peaks import H100_SXM
from reference.model import Network

MIN_WINDOW_S = 0.25


@dataclass
class Context:
    cell: object
    summary: object
    units: int
    images_per_unit: int

    def __post_init__(self):
        if self.summary.untraced_us / 1e6 < MIN_WINDOW_S or self.units < 1:
            raise RuntimeError(
                f"the traced stretch ({self.summary.untraced_us / 1e6:.3f} s, "
                f"{self.units} units) is too short to read shares from")

    @cached_property
    def net(self) -> Network:
        return Network(self.cell.cfg)

    @property
    def wall_s(self) -> float:
        """The stretch's wall time untraced (the same units, run just
        before the traced stretch)."""
        return self.summary.untraced_us / 1e6

    def per_unit_ms(self, us: float) -> float:
        return us / self.units / 1e3

    def forward_us(self) -> float:
        """Device time inside the model's layer ranges."""
        return sum(self.summary.by_layer.values())

    def mfu(self, flops_per_image: float) -> float:
        """% of the bf16 peak: flops_per_image x the images completed in
        the stretch, over its untraced wall time."""
        done = flops_per_image * self.images_per_unit * self.units
        return 100.0 * done / self.wall_s / H100_SXM["bf16_flops_per_s"]

    def image_flops(self, deploy: bool) -> float:
        return forward_flops(self.net, self.cell.cfg["img_size"], deploy)

    def site_bound_s(self, site: str) -> float:
        return site_bound_s(self.net, site, self.images_per_unit,
                            self.cell.cfg["img_size"])

    def idle_share(self) -> float:
        """% of the stretch's untraced wall time in which the card ran
        nothing: 1 - the traced stretch's busy time over it. Busy time
        over that wall means the two runs of the stretch did not do the
        same work, and fails the run."""
        s = self.summary
        if s.busy_us > s.untraced_us:
            raise RuntimeError(
                f"the traced stretch's busy time ({s.busy_us / 1e6:.3f} s) "
                f"exceeds its untraced wall time ({s.untraced_us / 1e6:.3f}"
                " s)")
        return 100.0 * (1.0 - s.busy_us / s.untraced_us)
