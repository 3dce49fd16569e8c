"""The benchmark of topo_descriptors_tpu_torch, the PyTorch/CUDA port.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Everything a cell needs is found by name:
the cell in ``portbench/workloads/<cell>.json``, its configuration in
``portbench/configs/<config>.json``, and each metric that
``BENCHMARK.json`` gives the cell in ``portbench/metrics/<metric>.py``.

One run: the DEM of the configuration from the seed (made on the card,
copied to the host once), the cell's set-up steps, one untimed job (every
call of the cell, so every kernel is built and every shape warm), then a
closed loop of one caller that issues the job's calls back to back until
the first job that completes at or after ``--seconds``; the drivers' NetCDF
sink is replaced by an in-memory one (``sink.py``). After the window the
kept planes are compared with the plain reference (``reference/``), and
the last line of standard output is the result. ``--trace 1`` runs the
window under ``torch.profiler`` and reports the per-layer metrics instead
of the end-to-end ones.

Exits non-zero without printing a result when there is no CUDA device or
too few of them, or when JAX or the JAX package got loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()  # set-up counts from here

import argparse  # noqa: E402
import contextlib  # noqa: E402
import importlib.util  # noqa: E402
import inspect  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from pathlib import Path  # noqa: E402

import torch  # noqa: E402

from portbench import importcheck, outputs, terrain, trace  # noqa: E402
from portbench.sink import MemorySink  # noqa: E402

HERE = Path(__file__).resolve().parent
BENCHMARK = HERE.parent / "BENCHMARK.json"


def load(kind: str, name: str) -> dict:
    path = HERE / kind / f"{name}.json"
    if not path.is_file():
        raise SystemExit(f"no {kind[:-1]} named {name!r} ({path} is missing)")
    return json.loads(path.read_text())


def metric_module(name: str):
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cell_metrics(cell: str, traced: bool) -> list:
    """This cell's entries of BENCHMARK.json: its end-to-end metrics, or its
    per-layer ones in a traced run."""
    bench = json.loads(BENCHMARK.read_text())
    group = bench["per_layer" if traced else "end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def substitute(value, config: dict):
    """``"$key"`` stands for the configuration's ``key``."""
    if isinstance(value, str) and value.startswith("$"):
        return config[value[1:]]
    if isinstance(value, dict):
        return {k: substitute(v, config) for k, v in value.items()}
    return value


@dataclass
class Call:
    step: int  # index in the job
    call: str
    args: dict
    start: float = 0.0
    end: float = 0.0
    pixels: int = 0
    planes: int = 0
    ok: bool = True
    error: str = ""

    @property
    def driver(self) -> bool:
        return self.call.startswith("compute_")

    @property
    def seconds(self) -> float:
        return self.end - self.start


@dataclass
class Run:
    """What a metric reader reads: the window's calls, its length, the
    jobs it completed, the program's counters over it and the trace."""

    workload: dict
    config: dict
    shape: tuple
    x: object
    y: object
    setup_s: float = 0.0
    calls: list = field(default_factory=list)
    window_s: float = 0.0
    steps_per_job: int = 1
    counters: dict = field(default_factory=dict)
    trace: object = None

    @property
    def jobs(self) -> float:
        return len(self.calls) / self.steps_per_job


class Program:
    """The system under test: the port's drivers on a host Raster, as the
    reference's script calls them, with the harness's sink in place."""

    def __init__(self, dem, x, y, crs: str, device: str):
        from topo_descriptors_tpu_torch import pipeline
        from topo_descriptors_tpu_torch.grid import Raster, RasterGrid

        self.pipeline = pipeline
        self.device = device
        self.raw = Raster(data=dem, grid=RasterGrid(y=y, x=x, crs=crs), name="DEM", units="m")
        self.dem, self.ind_nans = self.raw, None
        self.takes_nans = {}  # driver name -> whether it takes ind_nans

    def fill_na(self) -> list:
        from topo_descriptors_tpu_torch.grid import fill_na

        self.ind_nans, self.dem = fill_na(self.raw)
        return []

    def __call__(self, call: str, args: dict) -> list:
        if call == "fill_na":
            return self.fill_na()
        driver = getattr(self.pipeline, call)
        if call not in self.takes_nans:
            self.takes_nans[call] = "ind_nans" in inspect.signature(driver).parameters
        kwargs = dict(args, device=self.device)
        if self.takes_nans[call]:
            kwargs["ind_nans"] = self.ind_nans
        return driver(self.dem, **kwargs)


@contextlib.contextmanager
def scale_spans(pipeline, enabled: bool):
    """Open a profiler span around each of the drivers' ``timer`` blocks (one
    per scale or fused group), so that idle time can be told by scale."""
    if not enabled:
        yield
        return
    saved = pipeline.timer

    @contextlib.contextmanager
    def timer(name):
        with torch.profiler.record_function(trace.SPAN + name), saved(name):
            yield

    pipeline.timer = timer
    try:
        yield
    finally:
        pipeline.timer = saved


def run_job(program, job, sink, calls_out, traced: bool, stamp: bool):
    """Each ``(call, args, plane names)`` of the job in turn; a driver call
    must return and write exactly its planes."""
    for i, (call, args, want) in enumerate(job):
        rec = Call(i, call, args)
        sink.begin(len(calls_out))
        span = (torch.profiler.record_function(f"{trace.SPAN}{call} #{i}") if traced
                else contextlib.nullcontext())
        rec.start = time.perf_counter()
        try:
            with span:
                paths = program(call, args)
            rec.end = time.perf_counter()
            if want is not None:
                got = [Path(p).name[len("topo_"):-len(".nc")] for p in paths]
                if got != want or sorted(sink.names) != sorted(want):
                    raise RuntimeError(f"{call} returned {got}, wrote {sink.names}; expected {want}")
        except Exception:  # a failed call is counted and the loop goes on
            rec.end = rec.end or time.perf_counter()
            rec.ok, rec.error = False, traceback.format_exc(limit=3)
        rec.pixels, rec.planes = sink.pixels, len(sink.names)
        if stamp:
            calls_out.append(rec)
        elif not rec.ok:
            raise RuntimeError(f"warm-up call {call} failed:\n{rec.error}")


def window(one_job, seconds: float, clock=time.perf_counter) -> float:
    """Run whole jobs back to back until the first that ends at or after
    ``seconds``; returns the window's start on ``clock``."""
    t0 = clock()
    while True:
        one_job()
        if clock() - t0 >= seconds:
            return t0


def run(cell: str, seed: int, seconds: float, traced: bool, device: str = "cuda",
        t_start: float = None, log=sys.stderr) -> dict:
    """One run of ``cell``; returns the result line's object."""
    t_start = time.perf_counter() if t_start is None else t_start
    workload = load("workloads", cell)
    config = load("configs", workload["config"])
    metrics = cell_metrics(cell, traced)
    readers = {m["name"]: metric_module(m["name"]) for m in metrics}

    marks = [("start", t_start), ("imports", time.perf_counter())]
    dem, x, y = terrain.make_dem(config, seed, device)
    marks.append(("dem", time.perf_counter()))
    program = Program(dem, x, y, config["grid"]["crs"], device)
    setup = [(s["call"], substitute(s.get("args", {}), config)) for s in workload.get("setup", [])]
    job = [(s["call"], substitute(s.get("args", {}), config)) for s in workload["job"]]
    job = [(call, args, [p.name for p in outputs.expected(call, args)]
            if call.startswith("compute_") else None) for call, args in job]
    sink = MemorySink(workload["sample"]["extra_planes"], seed)
    state = Run(workload, config, dem.shape, x, y, steps_per_job=len(job))

    with sink.installed(program.pipeline):
        for call, args in setup:
            program(call, args)
        marks.append(("set-up steps", time.perf_counter()))
        run_job(program, job, sink, [], traced=False, stamp=False)  # warm-up
        if device != "cpu":
            torch.cuda.synchronize()
        marks.append(("warm job", time.perf_counter()))
        before = {n: r.counters() for n, r in readers.items() if hasattr(r, "counters")}
        state.setup_s = time.perf_counter() - t_start

        sink.recording = True
        with trace.profiled(traced) as traced_out, scale_spans(program.pipeline, traced):
            with (torch.profiler.record_function(trace.WINDOW) if traced
                  else contextlib.nullcontext()):
                def one_job():
                    run_job(program, job, sink, state.calls, traced, stamp=True)
                    sink.first_job = False

                t0 = window(one_job, seconds)
        state.window_s = state.calls[-1].end - t0
        state.trace = traced_out[0] if traced_out else None
        state.counters = {n: {k: v - before[n][k] for k, v in readers[n].counters().items()}
                          for n in before}

    memory_peak = torch.cuda.max_memory_allocated() if device != "cpu" else 0

    # the program's outputs are judged once the window has closed and its
    # device memory is released
    kept = sink.planes()
    del program, sink
    if device != "cpu":
        torch.cuda.empty_cache()
    checks, failed_ids = judge(workload, config, job, dem, x, y, kept, device, log)
    for i, c in enumerate(state.calls):
        if i in failed_ids:
            c.ok = False

    driver_calls = [c for c in state.calls if c.driver]
    values = {}
    for m in metrics:
        v = readers[m["name"]].read(state)
        if v is not None:
            values[m["name"]] = {"value": float(v), "unit": m["unit"]}
    failed = sum(not c.ok for c in driver_calls)
    for c in state.calls:
        if c.error:
            print(f"call {c.call} #{c.step} failed:\n{c.error}", file=log)
    dev = {"platform": "cpu" if device == "cpu" else "gpu",
           "kind": "cpu" if device == "cpu" else torch.cuda.get_device_name(0),
           "count": 1, "memory_peak_bytes": int(memory_peak)}
    result = {"correct": all(c.ok for c in state.calls) and all(
                  v["value"] is not None and v["value"] <= v["limit"] for v in checks.values()),
              "attempted": len(driver_calls), "failed": failed, "metrics": values, "device": dev}
    if state.trace is not None:
        dev["busy_s"], dev["window_s"] = state.trace.busy_s, state.trace.window_s
        result["breakdown"] = state.trace.breakdown()
    result["checks"] = checks
    print(f"window {state.window_s} s, {len(driver_calls)} driver calls, "
          f"{state.jobs} jobs, set-up {state.setup_s} s", file=log)
    print("set-up s " + ", ".join(f"{name} {t - prev:.4f}" for (_, prev), (name, t)
                                  in zip(marks, marks[1:])), file=log)
    n = state.steps_per_job
    jobs = [state.calls[j:j + n] for j in range(0, len(state.calls), n)]
    print("job seconds " + " ".join(f"{j[-1].end - j[0].start:.4f}" for j in jobs), file=log)
    if device != "cpu":
        print(f"card {power_line()}", file=log)
    for name, c in checks.items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=log)
    return result


def judge(workload, config, job, dem, x, y, kept, device, log) -> tuple:
    """``(checks, ids of calls with a plane over a limit)``."""
    from portbench.reference.descriptors import Reference

    limits = workload["limits"]
    by_name = {p.name: p for call, args, want in job if want is not None
               for p in outputs.expected(call, args)}
    reference = Reference(dem, x, y, config["grid"]["crs"], device)
    numbers, per_call = outputs.judge(by_name, kept, reference, device)
    checks = {n: {"value": numbers.get(n), "limit": limit} for n, limit in sorted(limits.items())}
    bad = {cid for cid, worst in per_call.items()
           if any(n in limits and v > limits[n] for n, v in worst.items())}
    for n in sorted(set(numbers) - set(limits)):
        print(f"reading {n} {numbers[n]} (not compared)", file=log)
    return checks, bad


def power_line() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as err:
        return f"nvidia-smi: {err}"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    if args.seed < 0:
        parser.error("--seed must be a non-negative whole number")
    chips = json.loads(BENCHMARK.read_text()) if BENCHMARK.is_file() else {"workloads": []}
    chips = next((w["chips"] for w in chips["workloads"] if w["name"] == args.workload), 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 2
    result = run(args.workload, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    found = importcheck.forbidden_loaded(sys.modules)
    if found:
        print(importcheck.ForbiddenModules(found), file=sys.stderr)
        return 3
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
