"""One run of one cell: set-up, the measured window, the check, the result.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (``setup_s``, from the start of the process): torch and the CUDA
context, the program's import and its kernel library (built on the first
run of a checkout, into ``build/`` inside it), the traffic's set-up with
one warm job of the cell's own case.  The window runs jobs back to back
until ``--seconds`` have passed, and the job running then completes: the
window holds whole jobs only, and all of their time.  With ``--trace 1``
the window runs under ``torch.profiler`` with the traffic's spans
(:mod:`lbmbench.tracing`), and the run reports the per-layer metrics;
else the end-to-end metrics.  Then the program is released and the
sampled answers are compared with the plain reference
(:mod:`lbmbench.compare`).  The last line of standard output is one JSON
object; the numbers compared, each beside its limit, are the last lines of
standard error.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import importlib
import json
import pathlib
import statistics
import sys
import time
import traceback

from lbmbench import compare, spec, tracing

FORBIDDEN = ("jax", "jaxlib", "flax", "lbm_tpu")
PORT = "lbm_tpu_torch"


def parse_args(argv):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return parser.parse_args(argv)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (``lbm_tpu_torch`` is not ``lbm_tpu``)."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def import_port(port_root: pathlib.Path):
    """The program under test, from ``port_root`` and from nowhere else."""
    sys.path.insert(0, str(port_root))
    pkg = importlib.import_module(PORT)
    where = pathlib.Path(pkg.__file__).resolve()
    if not where.is_relative_to(port_root.resolve()):
        raise ImportError(f"{PORT} was found at {where}, outside {port_root}")
    for module in ("runtime", "cli", "config", "ops.fused"):
        importlib.import_module(f"{PORT}.{module}")
    return pkg


@dataclasses.dataclass
class RunRecord:
    """What a metric's reader reads (``metrics/<name>.py``: ``read(run)``)."""

    cell: spec.Cell
    device_name: str
    peaks: dict | None
    setup_s: float
    window_s: float
    attempted: int
    failed: int
    jobs: list
    spans: list = dataclasses.field(default_factory=list)   # tracing.Span, host clock
    device: tracing.DeviceTrace | None = None

    @property
    def entry(self) -> str:
        return self.cell.traffic["entry"]

    @property
    def params(self) -> dict:
        return self.cell.config["params"]

    def span_seconds(self, name: str) -> list[float]:
        return [s.seconds for s in self.spans if s.name == name]


def breakdown(device: tracing.DeviceTrace) -> dict:
    """The device operations that took most time, by name, and the idle
    time by the span open while the device waited."""
    ops = collections.Counter()
    for op in device.ops:
        ops[op.name] += op.end - op.start
    return {"device_ops": [[k, v] for k, v in ops.most_common(10)],
            "idle_gaps": [[k, v] for k, v in device.idle_by_span().most_common(10)]}


def run_window(job, seconds: float) -> tuple[list, int, int, float, list[float]]:
    """Jobs ``job(0), job(1), ...`` back to back until ``seconds`` have
    passed; the job running then completes.  Returns the jobs' results, the
    jobs attempted and failed, the window's wall seconds (all the time of
    every job, whole jobs only) and each job's seconds."""
    jobs, attempted, failed, ends = [], 0, 0, []
    tic = time.perf_counter()
    while True:
        attempted += 1
        try:
            jobs.append(job(attempted - 1))
        except Exception:  # a job that fails is counted, and the loop goes on
            failed += 1
            if failed == 1:
                traceback.print_exc()
        ends.append(time.perf_counter() - tic)
        if ends[-1] >= seconds:
            break
    return jobs, attempted, failed, ends[-1], [b - a for a, b in zip([0.0] + ends, ends)]


def main(argv=None, *, started: float, root: pathlib.Path, port_root: pathlib.Path | None = None,
         card: bool = True) -> int:
    args = parse_args(argv)
    bench = spec.Spec.load(root)
    cell = bench.cell(args.workload)

    import torch

    if card:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            print(f"{cell.name} needs {cell.chips} CUDA card(s); torch sees "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
        torch.zeros(1, device=device)  # the context
        device_name = torch.cuda.get_device_name(device)
    else:
        device, device_name = torch.device("cpu"), "cpu"
    try:
        port = import_port(pathlib.Path(port_root or root))
    except ImportError as err:
        print(f"cannot import the program under test: {err}", file=sys.stderr)
        return 3

    from lbmbench import traffic as traffic_mod

    fused = sys.modules[f"{PORT}.ops.fused"]
    work_dir = pathlib.Path(root) / ".bench_work" / cell.name
    traffic = traffic_mod.make(cell, port, args.seed, device, work_dir)
    traffic.setup()

    spans = tracing.Spans()
    if args.trace:
        for target in cell.traffic.get("spans", []):
            spans.wrap(target)
        activities = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=activities)
        prof.start()
        tracing.spin(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    before = dict(fused.LAUNCHES)
    setup_s = time.perf_counter() - started
    with spans.span("window"):
        jobs, attempted, failed, window_s, job_s = run_window(traffic.job, args.seconds)
    launches = {k: v - before[k] for k, v in fused.LAUNCHES.items() if v != before[k]}
    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    record = RunRecord(cell, device_name, bench.peaks(device_name), setup_s, window_s,
                       attempted, failed, jobs)
    result_device = {"platform": "gpu" if device.type == "cuda" else "cpu",
                     "kind": device_name, "count": cell.chips,
                     "memory_peak_bytes": memory_peak}
    extra = {}
    if args.trace:
        tracing.spin(device)
        prof.stop()
        spans.restore()
        record.spans = spans.items
        record.device = tracing.read_profile(prof, launches, bench.launches())
        del prof
        if device.type == "cuda":
            if record.device is None or not record.device.whole:
                why = "no window span" if record.device is None else record.device.why_not_whole
                print(f"the profile of the window is not whole: {why}", file=sys.stderr)
                return 4
            result_device["busy_s"] = record.device.busy()
            result_device["window_s"] = record.device.window.seconds
            extra["breakdown"] = breakdown(record.device)

    metrics = {}
    for metric in bench.metrics(cell.name, bool(args.trace)):
        value = bench.reader(metric["name"])(record)
        if value is not None:
            metrics[metric["name"]] = {"value": value, "unit": metric["unit"]}

    traffic.release()
    check_tic = time.perf_counter()
    numbers = traffic.check(jobs) if jobs else {}
    check_s = time.perf_counter() - check_tic
    correct, shown = compare.verdict(numbers, cell.check["limits"])
    correct = correct and failed == 0 and bool(jobs)

    bad = forbidden_modules()
    if bad:
        print(f"modules of JAX or of the JAX package were loaded: {', '.join(bad)}",
              file=sys.stderr)
        return 5
    q = statistics.quantiles(job_s, n=4) if len(job_s) > 1 else job_s * 3
    print(f"{cell.name}: {len(jobs)} jobs in {window_s:.3f} s (a job {min(job_s):.4f} "
          f"{q[0]:.4f} {q[1]:.4f} {q[2]:.4f} {max(job_s):.4f} s), set-up {setup_s:.3f} s, "
          f"check {check_s:.3f} s, launches {launches}", file=sys.stderr)
    for name, shown_value in shown.items():
        print(f"check {name}: {shown_value['value']} (limit {shown_value['limit']})",
              file=sys.stderr)
    line = {"correct": correct, "attempted": attempted, "failed": failed,
            "metrics": metrics, "device": result_device, **extra, "checks": shown}
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
