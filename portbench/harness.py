"""The benchmark's general machinery: the manifest, the files a cell is
made of, the measured window's trace, the per-layer readers, the checks
that decide ``correct``, and the result line.

A cell is an entry of ``workloads`` in ``BENCHMARK.json``.  Everything
else is found by name, so a new cell, configuration, traffic mix or
per-layer metric is new files and new manifest entries:

- ``portbench/configs/<config>.json``: the model configuration as it runs
  (``source``, ``reduced``, ``assumed``, ``deployment``, the widths);
- ``portbench/traffic/<traffic>.json``: the traffic mix's parameters; its
  ``driver`` names the general driver that reads them;
- ``portbench/drivers/<driver>.py``: a ``Driver`` class (``setup``,
  ``window``, ``release``, ``verify``);
- ``portbench/limits/<cell>.json``, or failing that
  ``portbench/limits/<config>.json``: the limit of every number the
  cell's comparison reads;
- ``portbench/layers/<metric>.py``: ``read(readings)`` of one per-layer
  metric, ``None`` where the run holds nothing to read.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "one2345_tpu")


def log(msg: str) -> None:
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """Import the Python file ``path`` as module ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"no module file {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_manifest(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def applies(metric: dict, cell: str, reported: set | None = None) -> bool:
    """Whether ``metric`` is read in ``cell``: its ``workloads`` list names
    the cell, or (with no list) the cell reports the metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return reported is None or metric.get("moves") in reported or "moves" not in metric


@dataclass
class Cell:
    """One cell and the files it is made of."""

    name: str
    entry: dict
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list

    @classmethod
    def load(cls, name: str, root: Path = ROOT, manifest: dict | None = None) -> "Cell":
        manifest = manifest or load_manifest(root)
        entries = [w for w in manifest["workloads"] if w["name"] == name]
        if not entries:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        entry = entries[0]
        configs = {c["name"]: c for c in manifest["configs"]}
        config = load_json(root / configs[entry["config"]]["file"])
        traffic = load_json(root / "portbench" / "traffic" / f"{entry['traffic']}.json")
        limits = load_json(limits_file(root, name, entry["config"]))
        e2e = [m for m in manifest["end_to_end"] if applies(m, name)]
        reported = {m["name"] for m in e2e}
        layers = [m for m in manifest["per_layer"] if applies(m, name, reported)]
        return cls(name, entry, config, traffic, limits, e2e, layers)

    @property
    def env(self) -> dict:
        """Environment variables the configuration states for its runs
        (its ``env`` entry), set before the process first touches CUDA."""
        return {str(k): str(v) for k, v in self.config.get("env", {}).items()}

    def driver(self):
        """The ``Driver`` class of the cell's traffic mix."""
        return importlib.import_module(f"portbench.drivers.{self.traffic['driver']}").Driver


def limits_file(root: Path, cell: str, config: str) -> Path:
    """The cell's own limits, or its configuration's."""
    d = root / "portbench" / "limits"
    own = d / f"{cell}.json"
    return own if own.is_file() else d / f"{config}.json"


def reader(metric: str, root: Path = ROOT):
    """``read(readings)`` of one per-layer metric."""
    path = root / "portbench" / "layers" / f"{metric}.py"
    return load_module(path, "portbench_layer_" + metric.replace(".", "_").replace("-", "_")).read


# ------------------------------------------------------------------ checks
@dataclass
class Check:
    """One number that decides ``correct``: it passes at or under its limit."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


def rel_err(program, reference) -> float:
    """||program - reference|| / ||reference||, in float64."""
    import torch

    a = program.detach().to(torch.float64)
    b = reference.detach().to(a.device, torch.float64)
    den = float(torch.linalg.vector_norm(b))
    return float(torch.linalg.vector_norm(a - b)) / max(den, 1e-30)


# ---------------------------------------------------------- layer readings
def unprofiled(readings: dict) -> list:
    """The window's items (meshes or blocks of steps) that ran outside
    the profiler."""
    return [i for i in readings.get("items", []) if not i["profiled"]]


def span_mean(readings: dict, names) -> float | None:
    """Seconds of the named spans per mesh: the mean over the unprofiled
    meshes of the traced run (the profiled one pays the profiler)."""
    items = [i for i in unprofiled(readings) if "spans" in i]
    if not items:
        return None
    return sum(sum(i["spans"].get(n, 0.0) for n in names) for i in items) / len(items)


def mfu(readings: dict) -> float | None:
    """%: the counted UNet work of the unprofiled items over their wall
    time, against the bf16 peak."""
    from portbench.yardstick import PEAK_BF16_FLOPS

    items = unprofiled(readings)
    seconds = sum(i["seconds"] for i in items)
    if not items or seconds <= 0:
        return None
    return 100.0 * sum(i["flops"] for i in items) / seconds / PEAK_BF16_FLOPS


def idle_share(readings: dict) -> float | None:
    """%: the traced interval's time with no operation on the device."""
    trace = readings.get("trace")
    if trace is None or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)


# ------------------------------------------------------------------- trace
@dataclass
class Trace:
    """What the readers take from a ``torch.profiler`` trace of part of
    the window: device operations (name, start, end; seconds on the
    trace's clock), the host's ``record_function`` ranges, and the traced
    interval."""

    ops: list = field(default_factory=list)
    ranges: list = field(default_factory=list)
    start: float = 0.0
    end: float = 0.0

    @property
    def window_s(self) -> float:
        return self.end - self.start

    def busy_intervals(self):
        """The union of the device operations' intervals inside the
        traced interval, as sorted disjoint (start, end) pairs."""
        spans = sorted((max(s, self.start), min(e, self.end)) for _, s, e in self.ops
                       if e > self.start and s < self.end)
        merged = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def op_seconds(self, *substrings) -> float:
        return sum(e - s for name, s, e in self.ops if any(k in name for k in substrings))

    def top_ops(self, n: int = 10) -> list:
        by = {}
        for name, s, e in self.ops:
            key = name[:120]
            by[key] = by.get(key, 0.0) + (e - s)
        return sorted(([k, v] for k, v in by.items()), key=lambda kv: -kv[1])[:n]

    def idle_by_range(self, n: int = 10) -> list:
        """Idle seconds of the device inside the traced interval, summed
        by the innermost host range open when each gap began."""
        import numpy as np

        busy = self.busy_intervals()
        edges = [self.start] + [x for se in busy for x in se] + [self.end]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        if not gaps:
            return []
        rs = np.array([[s, e] for _, s, e in self.ranges]) if self.ranges else np.zeros((0, 2))
        names = [r[0] for r in self.ranges]
        by = {}
        g = np.array(gaps)
        for i in range(0, len(g), 4096):
            chunk = g[i:i + 4096]
            t = chunk[:, :1]
            inside = (rs[None, :, 0] <= t) & (rs[None, :, 1] >= t) if len(rs) else None
            for j, (s, e) in enumerate(chunk):
                label = "(no host range)"
                if inside is not None and inside[j].any():
                    idx = np.flatnonzero(inside[j])
                    label = names[idx[np.argmax(rs[idx, 0])]]
                by[label] = by.get(label, 0.0) + float(e - s)
        return sorted(([k, v] for k, v in by.items()), key=lambda kv: -kv[1])[:n]


class Profiler:
    """``with profiler:`` traces the block (CPU and CUDA activity) inside a
    ``portbench.profiled`` range; ``trace()`` reads it afterwards."""

    RANGE = "portbench.profiled"

    def __init__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        self._cuda = torch.cuda.is_available()
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self._cuda else [])
        self._prof = profile(activities=activities)
        self._range = None

    def __enter__(self):
        import torch

        self._prof.__enter__()
        self._range = torch.profiler.record_function(self.RANGE)
        self._range.__enter__()
        return self

    def __exit__(self, *exc):
        import torch

        if self._cuda:
            torch.cuda.synchronize()
        self._range.__exit__(*exc)
        self._prof.__exit__(*exc)
        return False

    def trace(self) -> Trace:
        from torch.autograd import DeviceType

        out = Trace()
        raw = []
        for e in self._prof.profiler.kineto_results.events():
            if e.is_user_annotation():
                if e.device_type() == DeviceType.CUDA:
                    continue  # a range's shadow on the device's timeline
                kind = "range"
            elif e.device_type() == DeviceType.CUDA:
                kind = "op"
            else:
                continue
            raw.append((kind, e.name(), e.start_ns(), e.duration_ns()))
        # seconds from the first event: nanoseconds since the epoch do not
        # fit a float's mantissa
        base = min((r[2] for r in raw), default=0)
        for kind, name, s, d in raw:
            s = (s - base) * 1e-9
            end = s + d * 1e-9
            if kind == "op":
                out.ops.append((name, s, end))
            elif name == self.RANGE:
                out.start, out.end = s, end
            else:
                out.ranges.append((name, s, end))
        return out


def warm_profiler() -> None:
    """Start and stop one profiler on a trivial kernel, so that the first
    traced block does not pay the profiler's own start-up."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()


# ------------------------------------------------------------------ driver
@dataclass
class Context:
    """What a driver is given."""

    cell: Cell
    seed: int
    device: object
    trace: bool


@dataclass
class Window:
    """What a driver's measured window reports."""

    attempted: int
    failed: int
    seconds: float
    end_to_end: dict
    readings: dict
    trace: Trace | None = None


def nvidia_smi() -> str:
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,power.draw,clocks.sm,clocks.max.sm,"
             "temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        return res.stdout.strip().splitlines()[0] if res.stdout.strip() else res.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def forbidden_loaded() -> list:
    """Modules of JAX or of the JAX package in this process, by top-level
    name compared whole."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def collect_metrics(cell: Cell, window: Window, trace: bool) -> dict:
    """The result line's metrics: the cell's end-to-end metrics, or with
    ``trace`` its per-layer ones (a reader that finds nothing is left out)."""
    out = {}
    if not trace:
        for m in cell.end_to_end:
            if m["name"] in window.end_to_end:
                out[m["name"]] = {"value": window.end_to_end[m["name"]], "unit": m["unit"]}
        return out
    readings = dict(window.readings, trace=window.trace)
    for m in cell.per_layer:
        value = reader(m["name"])(readings)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run(cell: Cell, seed: int, seconds: float, trace: bool, device, t_start: float,
        cuda: bool = True) -> tuple:
    """Set up, measure, free, compare: (result dict, checks, driver); the
    driver keeps what ``verify`` compared, for ``calibrate.py``."""
    import torch

    ctx = Context(cell, seed, torch.device(device), trace)
    driver = cell.driver()(ctx)
    driver.setup()
    if trace and cuda:
        warm_profiler()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.3f} s")
    window = driver.window(seconds)
    window.end_to_end["setup_s"] = setup_s
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    log(f"window {window.seconds:.3f} s: {window.attempted} attempted, {window.failed} failed; "
        f"peak {peak / 2**30:.2f} GiB")
    driver.release()
    t0 = time.perf_counter()
    checks = driver.verify()
    log(f"reference comparison in {time.perf_counter() - t0:.2f} s")
    result = {
        "correct": bool(checks) and all(c.ok for c in checks),
        "attempted": window.attempted,
        "failed": window.failed,
        "metrics": collect_metrics(cell, window, trace),
    }
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": int(cell.entry.get("chips", 1)), "memory_peak_bytes": int(peak)}
    if trace and window.trace is not None:
        dev["busy_s"] = window.trace.busy_s()
        dev["window_s"] = window.trace.window_s
        result["breakdown"] = {"device_ops": window.trace.top_ops(),
                               "idle_gaps": window.trace.idle_by_range()}
    result["device"] = dev
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in checks}
    return result, checks, driver
