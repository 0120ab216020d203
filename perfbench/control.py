"""Readings that set the limits of a cell's correctness check, on the card.

    python3 perfbench/control.py --workload <cell> --seeds <n> [<n> ...]

For each seed, one JSON line on standard output with the numbers the
check compares, read three ways:
- "program": the program as a run times it, against the float32 reference;
- "control": the reference computed in float8 (lib: reference/model.py,
  `precision="fp8"`) put in the program's place;
- "faults": the program's output broken where it is produced. Serving:
  "half" (the detections of half the batch left out), "altered" (one
  detection's class changed). Training: "half" (the reference on half of
  each batch, the mean taken over the rest); a state left unchanged reads
  1 on the change by construction and is not run.
`--dump <dir>` also writes each training seed's per-leaf norms there.

`--witness` reads, instead of the control and the faults, two witnesses
of the program's readings, each against the float32 reference as the
program is: "reference_bf16", the reference with every stored tensor and
its gradient rounded to bfloat16 (reference/model.py, `precision="bf16"`;
in training also "reference_bf16_affine", with BN applied at a bfloat16
program's rounding points), and "port_f32", the program with the configuration's precision set to
float32 (training with `remat`, so that float32 fits at the cell's
batch). Training numbers come at the worst and at the median leaf, with
the worst leaves' names. `--init '<json>'` replaces the configuration's
weight init (lib/weights.py), `--steps <n>` the training mix's check
steps. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

import run


def serve_readings(cell) -> dict:
    s = run.module(run.HERE / "traffic" / "serve.py").Serve(cell)
    s.warm_up()
    for _ in range(cell.mix["check_requests"]):
        s.request()
    s.release()
    picks = list(range(len(s.outputs)))
    out = {"program": s.check()}
    control = [s.control(i) for i in picks]
    out["control"] = {k: max(c[k] for c in control) for k in control[0]}
    half, altered = [], []
    for i in picks:
        dec = s.reference(s.frames(s.first + i))
        o = {k: v.clone() for k, v in s.outputs[i].items()}
        b = o["valid"].shape[0]
        o["valid"][b // 2:] = False
        half.append(s.judge(dec, o))
        o = {k: v.clone() for k, v in s.outputs[i].items()}
        o["classes"][0, 0] = (o["classes"][0, 0] + 1) % cell.cfg[
            "num_classes"]
        altered.append(s.judge(dec, o))
    out["faults"] = {"half": {k: max(c[k] for c in half) for k in half[0]},
                     "altered": {k: max(c[k] for c in altered)
                                 for k in altered[0]}}
    return out


def serve_witness(cell) -> dict:
    from lib.judge import merge_worst
    from reference.serve import nms

    mod = run.module(run.HERE / "traffic" / "serve.py")
    s = mod.Serve(cell)
    s.warm_up()
    for _ in range(cell.mix["check_requests"]):
        s.request()
    s.release()
    picks = range(len(s.outputs))
    decs = [s.reference(s.frames(s.first + i)) for i in picks]
    low = [s.judge(decs[i], nms(s.reference(s.frames(s.first + i), "bf16"),
                                topk=cell.mix["topk"], **s.thres))
           for i in picks]
    f32 = mod.Serve(dataclasses.replace(
        cell, cfg={**cell.cfg, "precision": "float32"}))
    f32.warm_up()
    for _ in picks:
        f32.request()
    f32.release()
    port = [s.judge(decs[i], f32.outputs[i]) for i in picks]
    return {"program": merge_worst([s.judge(decs[i], s.outputs[i])
                                    for i in picks]),
            "reference_bf16": merge_worst(low),
            "port_f32": merge_worst(port)}


def leaf_readings(norms: dict, ref: dict) -> dict:
    """Each training number at the worst and the median leaf, and the
    names of the five worst leaves."""
    from lib.judge import CHANGE_FLOOR, leaf_gaps, judge_training

    out = {"loss_gap": judge_training(norms, ref)["loss_gap"]}
    med = sorted(ref["grad"].values())[(len(ref["grad"]) - 1) // 2]
    moving = {k for k, v in ref["grad"].items() if v >= CHANGE_FLOOR * med}
    for key, keep in (("grad", None), ("change", moving), ("ema", moving)):
        gaps = leaf_gaps(norms[key], ref[key], keep)
        ranked = sorted(gaps, key=gaps.get)
        out[key] = {"worst": gaps[ranked[-1]],
                    "median": gaps[ranked[(len(ranked) - 1) // 2]],
                    "worst_leaves": [[k, gaps[k]] for k in ranked[:-6:-1]]}
    return out


def train_witness(cell, dump=None) -> dict:
    mod = run.module(run.HERE / "traffic" / "train.py")
    s = mod.Train(cell)
    norms = {"program": s.check_steps()}
    s.release()
    norms["reference"] = ref = s.reference()
    norms["reference_bf16"] = s.reference("bf16")
    norms["reference_bf16_affine"] = s.reference("bf16_affine")
    f32 = mod.Train(dataclasses.replace(
        cell, cfg={**cell.cfg, "precision": "float32", "remat": True}))
    norms["port_f32"] = f32.check_steps()
    f32.release()
    if dump is not None:
        dump.mkdir(parents=True, exist_ok=True)
        (dump / f"witness.{cell.name}.{cell.seed}.json").write_text(
            json.dumps(norms))
    out = {k: leaf_readings(v, ref) for k, v in norms.items()
           if k != "reference"}
    out["program_vs_reference_bf16"] = leaf_readings(
        norms["program"], norms["reference_bf16"])
    return out


def train_readings(cell, dump=None) -> dict:
    from lib.device import phase
    from lib.judge import judge_training

    s = run.module(run.HERE / "traffic" / "train.py").Train(cell)
    norms = {"program": s.check_steps()}
    s.release()
    norms["reference"] = ref = s.reference()
    norms["control"] = s.reference("fp8")
    norms["half"] = s.reference(rows=cell.mix["batch"] // 2)
    if dump is not None:
        dump.mkdir(parents=True, exist_ok=True)
        (dump / f"norms.{cell.name}.{cell.seed}.json").write_text(
            json.dumps(norms))
    return {"program": judge_training(norms["program"], ref, log=phase),
            "control": judge_training(norms["control"], ref, log=phase),
            "faults": {"half": judge_training(norms["half"], ref,
                                              log=phase)}}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--dump", type=Path, default=None,
                   help="a directory for each training seed's norms (JSON)")
    p.add_argument("--witness", action="store_true",
                   help="read the bf16-rounded reference and the f32 port")
    p.add_argument("--init", type=json.loads, default=None,
                   help="replace the configuration's weight init (JSON)")
    p.add_argument("--steps", type=int, default=None,
                   help="replace the training mix's check steps")
    args = p.parse_args()
    run._environment()
    sys.path[:0] = [str(run.HERE), str(run.ROOT)]
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    work = run.load(run.HERE / "workloads" / f"{args.workload}.json")
    cfg = run.load(run.HERE / "configs" / f"{work['config']}.json")
    mix = run.load(run.HERE / "mixes" / f"{work['traffic']}.json")
    if args.init is not None:
        cfg["init"] = args.init
    if args.steps is not None:
        mix["check_steps"] = args.steps
    for seed in args.seeds:
        cell = run.Cell(args.workload, cfg, mix, work["limits"], seed, 0,
                        False, device, time.perf_counter())
        if args.witness:
            out = serve_witness(cell) if mix["kind"] == "serve" \
                else train_witness(cell, args.dump)
        else:
            out = serve_readings(cell) if mix["kind"] == "serve" \
                else train_readings(cell, args.dump)
        print(json.dumps({"seed": seed, **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
