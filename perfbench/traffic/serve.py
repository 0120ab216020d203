"""Serving traffic: one client in a closed loop over `Detector.__call__`.

A mix file (mixes/<traffic>.json) sets:
- `batch`, `height`, `width`: each request's uint8 RGB frames;
- `pool`: the number of distinct requests, drawn from the seed (noise
  frames, made on the card in one call); every seed sends the same sizes,
  in an order drawn from the seed;
- `frames_on`: "host" (pageable host memory, as cameras hand frames to a
  service) or "device" (already on the card, as a GPU video decoder hands
  them over);
- `conf_thres`, `iou_thres`, `max_det`: the detector's thresholds;
- `check_requests`: requests the reference re-computes after the window
  (drawn from the seed, the slowest among them);
- `trace_requests`: the requests of a traced stretch.

Each request's padded detections are copied to the host before the next
is sent; a request's latency runs from the call until they are there.
"""

from __future__ import annotations

import copy
import time

import numpy as np
import torch

from lib.device import peak_bytes, phase, release, sync
from lib.judge import judge_detections, merge_worst
from lib.trace import record, ranges, summarize
from lib.weights import generator, make_weights
from reference.model import Network, Run
from reference.serve import letterbox, nms

REFERENCE_ROWS = 8


def p95_ms(latency_s: list[float]) -> float:
    """The 95th percentile of every request's latency (numpy's linear
    interpolation between order statistics), in ms."""
    return float(np.percentile(np.asarray(latency_s), 95)) * 1e3


class Serve:
    def __init__(self, cell):
        from yolo_re_tpu_torch.models.config import ModelConfig
        from yolo_re_tpu_torch.models.yolo import YOLO
        from yolo_re_tpu_torch.serving import Detector

        self.cell, cfg, mix = cell, cell.cfg, cell.mix
        self.dev = cell.device
        self.net = Network(cfg)
        self.size = cfg["img_size"]
        phase("port imported", cell.t0)
        self.sd = make_weights(self.net.spec(), cell.seed, self.dev,
                               cfg["class_bias"], cfg["num_classes"],
                               self.net.strides, cfg.get("init"))
        model = YOLO.from_config(ModelConfig(
            cfg["num_classes"], cfg["depth_multiplier"],
            cfg["width_multiplier"], copy.deepcopy(cfg["layers"])))
        self.thres = {k: mix[k] for k in ("conf_thres", "iou_thres",
                                          "max_det")}
        self.det = Detector(model, self.sd, device=self.dev,
                            img_size=self.size,
                            compute_dtype=cfg["precision"], **self.thres)
        del model
        phase("detector built", cell.t0)
        g = generator(cell.seed + 1, self.dev)
        shape = (mix["pool"], mix["batch"], mix["height"], mix["width"], 3)
        pool = torch.randint(0, 256, shape, dtype=torch.uint8,
                             device=self.dev, generator=g)
        self.pool = pool.cpu() if mix["frames_on"] == "host" else pool
        rng = np.random.default_rng(cell.seed)
        self.order = rng.permutation(mix["pool"])
        self.n = 0
        self.latency: list[float] = []
        self.outputs: list[dict] = []

    def frames(self, i: int) -> torch.Tensor:
        return self.pool[self.order[i % len(self.order)]]

    def request(self) -> None:
        frames = self.frames(self.n)
        t = time.perf_counter()
        out = {k: v.cpu() for k, v in self.det(frames).items()}
        self.latency.append(time.perf_counter() - t)
        self.outputs.append(out)
        self.n += 1

    def warm_up(self) -> None:
        """Every pool entry once; these requests are not measured."""
        for _ in range(len(self.order)):
            self.request()
            phase(f"warm-up request {self.latency[-1]:.3f} s")
        sync(self.dev)
        self.latency, self.outputs, self.first = [], [], self.n

    def window(self, seconds: float) -> dict:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            self.request()
        elapsed = time.perf_counter() - t0
        return {"serve.images_per_s":
                len(self.latency) * self.cell.mix["batch"] / elapsed,
                "serve.p95_ms": p95_ms(self.latency)}

    def traced(self) -> tuple:
        layers = [n.name for n in self.net.nodes
                  if n.name in self.net.layers_needed(True)]
        sites = [s for group in self.cell.cfg.get("kernel_sites", {})
                 .values() for s in group]
        k = self.cell.mix["trace_requests"]

        def stretch():
            for _ in range(k):
                self.request()

        def hooked():
            with ranges(self.det.model, layers, sites):
                stretch()
        t0 = time.perf_counter()
        stretch()
        untraced_s = time.perf_counter() - t0
        prof, _ = record(hooked, self.dev)
        return summarize(prof, untraced_s), k

    def release(self) -> None:
        """Free the program's state before the reference runs."""
        del self.det
        release()

    def sample(self) -> list[int]:
        """Requests to check: the slowest, and more drawn from the seed."""
        n = len(self.outputs)
        rng = np.random.default_rng([self.cell.seed, 1])
        picks = {int(np.argmax(self.latency))}
        for i in rng.permutation(n):
            if len(picks) >= min(self.cell.mix["check_requests"], n):
                break
            picks.add(int(i))
        return sorted(picks)

    @torch.no_grad()
    def reference(self, frames: torch.Tensor, precision: str = "f32"):
        """The reference's (B, A, 4 + nc) predictions for `frames`."""
        frames = frames.to(self.dev)
        run = Run(self.sd, precision=precision)
        return torch.cat([
            self.net.decoded(run, letterbox(frames[i:i + REFERENCE_ROWS],
                                            self.size))
            for i in range(0, frames.shape[0], REFERENCE_ROWS)])

    def judge(self, dec: torch.Tensor, out: dict) -> dict:
        return judge_detections(dec, out, topk=self.cell.mix["topk"],
                                **self.thres)

    def check(self) -> dict:
        readings = []
        for i in self.sample():
            dec = self.reference(self.frames(self.first + i))
            readings.append(self.judge(dec, self.outputs[i]))
        return merge_worst(readings)

    def control(self, i: int) -> dict:
        """The reference in float8 put in the program's place: its
        detections for the window's request i, judged as the program's
        are."""
        frames = self.frames(self.first + i)
        dec = self.reference(frames)
        low = self.reference(frames, precision="fp8")
        return self.judge(dec, nms(low, topk=self.cell.mix["topk"],
                                   **self.thres))


def run(cell) -> dict:
    s = Serve(cell)
    phase("frames made", cell.t0)
    s.warm_up()
    setup_s = time.perf_counter() - cell.t0
    phase("warmed up", cell.t0)
    out = {"setup_s": setup_s, "units": 0}
    if cell.trace:
        out["summary"], out["units"] = s.traced()
    else:
        out["end_to_end"] = s.window(cell.seconds)
    out["attempted"], out["failed"] = len(s.outputs), 0
    out["memory_peak_bytes"] = peak_bytes(cell.device)
    s.release()
    out["checks"] = s.check()
    out["images_per_unit"] = cell.mix["batch"]
    return out
