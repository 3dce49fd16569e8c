"""The readings that the limits of the check deciding ``correct`` are set
from, at a cell's own size, one JSON line per seed. The benchmark's runs
do not run it.

    python3 -m portbench.control --workload <cell> --seeds <n> [<n> ...]

the control: the plain reference computed in TF32
(``Reference(precision="tf32")``) put in the program's place, judged
against the float64 reference by the same numbers as a run's planes over
every plane of one job; it must fail.

    ... --fault <name> [--seconds <s>]

a whole run of the cell (window of ``--seconds``, 5 by default) with the
fault ``name`` of ``faults.py`` planted underneath the timed path; it
must come out not correct.

    ... --witness cpu [--calls <driver> ...]

the program's own planes of one job, or of its calls named, computed on
the CPU (the program's plain PyTorch routes in place of its CUDA kernels)
and judged against the float64 reference on the card: a second witness of
the gaps the program reads there.
"""

from __future__ import annotations

import argparse
import io
import json
import sys

import torch

from portbench import faults, outputs, terrain
from portbench import run as runner
from portbench.reference.descriptors import Reference
from portbench.run import load, substitute


def _cell(cell: str, seed: int, device: str) -> tuple:
    workload = load("workloads", cell)
    config = load("configs", workload["config"])
    dem, x, y = terrain.make_dem(config, seed, device)
    return workload, config, dem, x, y


def _planes(workload, config, calls=None) -> dict:
    return {p.name: p for step in workload["job"] if step["call"].startswith("compute_")
            and (calls is None or step["call"] in calls)
            for p in outputs.expected(step["call"], substitute(step.get("args", {}), config))}


def readings(cell: str, seed: int, device: str) -> dict:
    """Each number of ``cell`` for the TF32 reference against the float64
    one, over every plane of one job."""
    workload, config, dem, x, y = _cell(cell, seed, device)
    crs = config["grid"]["crs"]
    exact = Reference(dem, x, y, crs, device)
    tf32 = Reference(dem, x, y, crs, device, precision="tf32")
    by_name = _planes(workload, config)
    kept = [(0, name, p.reference(tf32)) for name, p in by_name.items()]
    return outputs.judge(by_name, kept, exact, device)[0]


def witness(cell: str, seed: int, on: str, device: str, calls=None) -> dict:
    """Each number of ``cell`` for the program's planes of one job (its
    ``calls`` only, where given) computed on ``on``, judged against the
    float64 reference on ``device``."""
    from portbench.sink import MemorySink

    workload, config, dem, x, y = _cell(cell, seed, device)
    program = runner.Program(dem, x, y, config["grid"]["crs"], on)
    sink = MemorySink(0, seed)
    sink.recording = True
    by_name = _planes(workload, config, calls)
    with sink.installed(program.pipeline):
        program.fill_na()
        for step in workload["job"]:
            if step["call"].startswith("compute_") and (calls is None or step["call"] in calls):
                sink.begin(0)
                program(step["call"], substitute(step.get("args", {}), config))
    reference = Reference(dem, x, y, config["grid"]["crs"], device)
    return outputs.judge(by_name, sink.planes(), reference, device)[0]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--fault", choices=sorted(faults.FAULTS))
    parser.add_argument("--seconds", type=float, default=5.0)
    parser.add_argument("--witness", choices=("cpu",))
    parser.add_argument("--calls", nargs="+")
    args = parser.parse_args(argv)
    if args.device != "cpu" and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    limits = load("workloads", args.workload)["limits"]
    for seed in args.seeds:
        line = {"workload": args.workload, "seed": seed}
        if args.fault:
            with faults.planted(args.fault):
                result = runner.run(args.workload, seed, args.seconds, False, args.device,
                                    log=io.StringIO())
            line.update(fault=args.fault, correct=result["correct"],
                        attempted=result["attempted"], failed=result["failed"],
                        numbers=result["checks"])
        else:
            if args.witness:
                numbers = witness(args.workload, seed, args.witness, args.device, args.calls)
                line["witness"] = args.witness
            else:
                numbers = readings(args.workload, seed, args.device)
            line["fails"] = [n for n, v in numbers.items() if n in limits and v > limits[n]]
            line["numbers"] = {n: {"value": v, "limit": limits.get(n)}
                               for n, v in sorted(numbers.items())}
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
