"""Run one cell of BENCHMARK.json once and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds the program.  The cell names a
configuration (`configs/`), whose `driver` names the module of `drivers/`
that drives the program, and a traffic mix (`workloads/<traffic>.json`);
each metric is read by `metrics/<name>.py`.  Nothing here changes for a
new cell, configuration or metric: each is a file found by its name.

A run: set-up (the program's CUDA libraries built or loaded, inputs made
from the seed, the system built, every shape warmed up), then the window:
`--seconds` of committed epochs, one after another, each returning when
its verdict reaches the host.  With `--trace 1` the window runs under
`torch.profiler` for at most TRACE_SECONDS and the per-layer metrics are
read from it.  After the window: the import guard, the peak memory, the
program's outputs to the host and its state freed, then the comparison
with the plain reference.  The result is the last line of standard
output; the numbers compared, each with its limit, are the last lines of
standard error and the last key of the result.

Exits 2 without a result where there is no card or too few cards, 3 where
a forbidden module is loaded (benchmark/guard.py).
"""
from __future__ import annotations

import time

T_IMPORT = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

from . import guard  # noqa: E402
from .yardstick import trace as tr  # noqa: E402

CHECKOUT = Path(__file__).resolve().parents[1]
TRACE_SECONDS = 2.0  # the longest traced window
TRACE_MIN_EPOCHS = 3
TOP = 10  # entries of each breakdown list


def process_age_s() -> float:
    """Seconds since this process started (the kernel's record), or since
    this module was imported where that record cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - T_IMPORT


# -- finding things by name ---------------------------------------------------


def load_spec(root: Path = CHECKOUT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def cell_parts(spec: dict, name: str, root: Path = CHECKOUT):
    """(cell, config, traffic) of the cell `name`."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(cells)}")
    cell = cells[name]
    entry = next(c for c in spec["configs"] if c["name"] == cell["config"])
    with open(root / entry["file"]) as f:
        config = json.load(f)
    with open(root / "benchmark" / "workloads" / f"{cell['traffic']}.json") as f:
        traffic = json.load(f)
    return cell, config, traffic


def load_module(kind: str, name: str, root: Path = CHECKOUT):
    """benchmark/<kind>/<name>.py as a module of the package benchmark.<kind>."""
    path = root / "benchmark" / kind / f"{name}.py"
    mod_name = f"benchmark.{kind}.{name.replace('.', '_').replace('-', '_')}"
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None or not path.exists():
        raise SystemExit(f"no {kind} module {path}")
    module = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = module
    spec.loader.exec_module(module)
    return module


def metrics_of(spec: dict, cell: str):
    """(end-to-end, per-layer) metric entries the cell reports."""
    e2e = [m for m in spec["end_to_end"] if cell in m.get("workloads", [cell])]
    reported = {m["name"] for m in e2e}

    def reports(m):
        return cell in m["workloads"] if "workloads" in m else m["moves"] in reported

    return e2e, [m for m in spec["per_layer"] if reports(m)]


# -- the window -----------------------------------------------------------------


def window(driver, seconds: float, min_epochs: int = 1, max_epochs=None):
    """Committed epochs back to back for `seconds`: (latencies s, verdicts
    failed, window s).  An epoch's latency runs from the previous epoch's
    return (the window's start for the first) to its own."""
    lat, failed = [], 0
    t0 = prev = time.perf_counter()
    while True:
        ok = driver.step()
        now = time.perf_counter()
        lat.append(now - prev)
        prev = now
        failed += not ok
        if max_epochs is not None and len(lat) >= max_epochs:
            break
        if now - t0 >= seconds and len(lat) >= min_epochs:
            break
    return lat, failed, prev - t0


def traced_window(driver, seconds: float, on_card: bool, max_epochs=None):
    """The window under torch.profiler: (latencies, failed, window s,
    device events, outermost host events)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    with profile(activities=acts):  # the profiler's own first start, untimed
        driver.step()
    with profile(activities=acts) as prof:
        lat, failed, window_s = window(driver, min(seconds, TRACE_SECONDS),
                                       TRACE_MIN_EPOCHS, max_epochs)
    if on_card:
        torch.cuda.synchronize()
    device, host = [], []
    for e in prof.events():
        ev = tr.Event(e.name, e.time_range.start, e.time_range.end)
        if e.device_type == DeviceType.CUDA:
            device.append(ev)
        elif e.cpu_parent is None:
            host.append(ev)
    return lat, failed, window_s, device, host


# -- one run --------------------------------------------------------------------


def run_cell(name: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             root: Path = CHECKOUT, max_epochs=None, system=None) -> dict:
    """One run of the cell `name`; returns the result object.

    `device` "cpu" runs the program's plain versions (the tests' way of
    driving a run without a card).  `system(driver)`, where given, builds
    the system in the program's place (a control or a broken program);
    `max_epochs` ends the window early.  Neither is reachable from the
    command line."""
    spec = load_spec(root)
    cell, config, traffic = cell_parts(spec, name, root)
    e2e, layer = metrics_of(spec, name)
    driver_mod = load_module("drivers", config["driver"], root)
    on_card = device.startswith("cuda")
    import torch

    if on_card:
        from hydrabadger_tpu_torch.ops import _kernels

        _kernels.build(driver_mod.Driver.libraries)  # in parallel; loads where built
    driver = driver_mod.Driver(config, traffic, seed, device)
    if system is None:
        driver.setup()
    else:
        driver.make_inputs()
        driver.sim = system(driver)
    if on_card:
        torch.cuda.synchronize()
    setup_s = process_age_s()

    if trace:
        lat, failed, window_s, dev_events, host_events = traced_window(
            driver, seconds, on_card, max_epochs)
    else:
        lat, failed, window_s = window(driver, seconds, 1, max_epochs)
        dev_events = host_events = []
    guard.check("after the window")
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    driver.collect()
    if on_card:
        torch.cuda.empty_cache()
    checks = driver.check()

    busy_s = tr.busy_us(dev_events) / 1e6
    ctx = SimpleNamespace(
        cell=cell, config=config, traffic=traffic,
        setup_s=setup_s, latencies_s=lat, epochs=len(lat), window_s=window_s,
        contributions_per_epoch=driver.contributions_per_epoch,
        device_events=dev_events, host_events=host_events, busy_s=busy_s,
    )
    metrics = {}
    for m in (layer if trace else e2e):
        value = load_module("metrics", m["name"], root).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {
        "correct": all(v <= lim for _, v, lim in checks),
        "attempted": len(lat),
        "failed": failed,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if on_card else "cpu",
            "kind": torch.cuda.get_device_name() if on_card else "cpu",
            "count": cell["chips"] if on_card else 0,
            "memory_peak_bytes": peak,
        },
    }
    if trace:
        result["device"].update(busy_s=busy_s, window_s=window_s)
        host_gaps = tr.idle_gaps(dev_events, host_events)
        result["breakdown"] = {
            "device_ops": [[k, v / 1e6] for k, v in list(tr.by_name(dev_events).items())[:TOP]],
            "idle_gaps": [[k, v / 1e6] for k, v in list(host_gaps.items())[:TOP]],
        }
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    guard.check("start")
    # the program's caches at fixed paths inside the checkout
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton_cache"), ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(CHECKOUT / "build" / sub)
    for var in ("HYDRABADGER_DECRYPT_T", "HYDRABADGER_WIN_CIRCUIT"):
        os.environ.pop(var, None)  # the program's default engines
    spec = load_spec()
    cell, _, _ = cell_parts(spec, args.workload)

    import torch

    torch.set_num_threads(2)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"needs {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    guard.check("before the result")
    for n, c in result["checks"].items():
        print(f"check {n}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(result, allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
