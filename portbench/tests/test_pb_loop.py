"""A cell's loop end to end on the CPU at a tiny grid, the window rule and
the metrics' arithmetic, and the harness's lookup by name."""

from __future__ import annotations

import io
import json
import re
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from portbench import run as runner
from portbench.tests.conftest import CELLS

ROOT = Path(runner.__file__).resolve().parent


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("traced", [False, True])
def test_cell_runs_on_the_cpu(tiny, cell, traced):
    log = io.StringIO()
    result = runner.run(cell, 2**31 + 77, 0.3, traced, "cpu", log=log)
    assert result["correct"], log.getvalue()
    assert result["failed"] == 0 and result["attempted"] > 0
    wanted = {m["name"] for m in runner.cell_metrics(cell, traced)}
    if traced:  # the CPU trace holds no device events: device metrics stay silent
        assert set(result["metrics"]) <= wanted
        assert {"busy_s", "window_s"} <= set(result["device"])
    else:
        assert set(result["metrics"]) == wanted
    assert list(result)[-1] == "checks"
    lines = log.getvalue().strip().splitlines()
    assert all(line.startswith("check ") for line in lines[-len(result["checks"]):])
    json.dumps(result)


@pytest.mark.parametrize("job_s, seconds, jobs", [(0.4, 1.0, 3), (0.5, 1.0, 2), (2.0, 1.0, 1)])
def test_window_closes_at_the_first_job_end_at_or_after_the_seconds(job_s, seconds, jobs):
    now = [10.0]
    done = []

    def one_job():
        now[0] += job_s
        done.append(now[0])

    t0 = runner.window(one_job, seconds, clock=lambda: now[0])
    assert t0 == 10.0 and len(done) == jobs
    assert done[-1] - t0 >= seconds and (jobs == 1 or done[-2] - t0 < seconds)


def _run(calls, window_s, steps=1):
    return SimpleNamespace(calls=calls, window_s=window_s, steps_per_job=steps,
                           jobs=len(calls) / steps, trace=None, counters={})


def test_rate_and_tail_arithmetic():
    rate = runner.metric_module("out_mpix_s")
    p95 = runner.metric_module("call_p95_ms")
    calls = [SimpleNamespace(pixels=2_000_000, error="", driver=True, seconds=(i + 1) / 1000)
             for i in range(100)]
    assert rate.read(_run(calls, 4.0)) == pytest.approx(100 * 2.0 / 4.0)
    calls[3].error = "boom"  # a call that raised did no work
    assert rate.read(_run(calls, 4.0)) == pytest.approx(99 * 2.0 / 4.0)
    assert p95.read(_run(calls, 4.0)) == pytest.approx(np.percentile(np.arange(1, 101), 95))


def test_every_name_has_its_file():
    bench = json.loads(runner.BENCHMARK.read_text())
    for c in bench["configs"]:
        assert (ROOT.parent / c["file"]).is_file()
        assert json.loads((ROOT.parent / c["file"]).read_text())["name"] == c["name"]
    for w in bench["workloads"]:
        cell = json.loads((ROOT / "workloads" / f"{w['name']}.json").read_text())
        assert cell["config"] == w["config"] and cell["why"] == w["why"]
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(runner.metric_module(m["name"]).read)


def test_benchmark_file_keeps_its_format():
    bench = json.loads(runner.BENCHMARK.read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    unit = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
    names = [c["name"] for c in bench["configs"]] + [w["name"] for w in bench["workloads"]]
    metrics = bench["end_to_end"] + bench["per_layer"]
    assert all(name.match(n) for n in names + [m["name"] for m in metrics])
    assert len(set(m["name"] for m in metrics)) == len(metrics)
    assert all(unit.match(m["unit"]) and m["better"] in ("lower", "higher") for m in metrics)
    assert all(0 < m["bound"] <= 0.25 for m in bench["end_to_end"])
    assert all(0 < len(x["why"]) <= 200 for x in bench["configs"] + bench["workloads"])
    assert {m["moves"] for m in bench["per_layer"]} <= {m["name"] for m in bench["end_to_end"]}
    assert 1 <= bench["run_seconds"] <= 51
