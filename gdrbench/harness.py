"""The benchmark's data: ``BENCHMARK.json`` at the checkout's root, and the
files it names by name.

- a configuration: ``configs[].file`` (JSON);
- a traffic mix: ``gdrbench/traffic/<traffic>.json``, which names its
  driver;
- a driver: ``gdrbench/drivers/<driver>.py`` with ``run(ctx) -> dict``;
- a per-layer metric: ``gdrbench/metrics/<name>.py`` with ``read(layer)
  -> float | None``.

Adding a configuration, a cell or a metric is adding files and entries;
no file here names one.  :func:`validate` checks the names, units and
files against the benchmark's rules.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
import sys
from dataclasses import dataclass
from pathlib import Path

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "gdr_tpu"}


def load_spec(root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def with_pending(spec: dict, root: Path = ROOT) -> dict:
    """``spec`` with the entries of ``gdrbench/pending/*.json`` added:
    cells, with their configurations and metrics, whose drivers run and
    check but which ``BENCHMARK.json`` does not hold yet (``PERF.md``
    says why).  The benchmark's runs never read them; its tests and
    ``control.py`` do."""
    out = {k: list(v) if isinstance(v, list) else v for k, v in spec.items()}
    for f in sorted((Path(root) / "gdrbench" / "pending").glob("*.json")):
        for key, entries in json.loads(f.read_text()).items():
            have = {e["name"] for e in out[key]}
            out[key] += [e for e in entries if e["name"] not in have]
    return out


def traffic_file(root: Path, traffic: str) -> Path:
    return Path(root) / "gdrbench" / "traffic" / f"{traffic}.json"


def driver_file(root: Path, driver: str) -> Path:
    return Path(root) / "gdrbench" / "drivers" / f"{driver}.py"


def metric_file(root: Path, metric: str) -> Path:
    return Path(root) / "gdrbench" / "metrics" / f"{metric}.py"


def _load_module(path: Path, tag: str):
    spec = importlib.util.spec_from_file_location(tag, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    driver: object
    end_to_end: list[dict]
    per_layer: list[dict]


@dataclass
class Run:
    """What a driver is given: the cell's data and the run's arguments."""
    cell: str
    chips: int
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: object            # torch.device
    t_start: float            # time.perf_counter() at the process's start
    root: Path

    @classmethod
    def of(cls, cell_: "Cell", seed: int, seconds: float, trace: bool,
           device, t_start: float, root: Path) -> "Run":
        return cls(cell_.name, cell_.chips, cell_.config, cell_.traffic, seed,
                   seconds, trace, device, t_start, Path(root))


def cell(spec: dict, name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` with its configuration, traffic, driver and the
    metrics it reports."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[name]
    cfg_entry = {c["name"]: c for c in spec["configs"]}[w["config"]]
    config = json.loads((Path(root) / cfg_entry["file"]).read_text())
    traffic = json.loads(traffic_file(root, w["traffic"]).read_text())
    driver = _load_module(driver_file(root, traffic["driver"]),
                          f"gdrbench_driver_{traffic['driver']}")
    e2e = [m for m in spec["end_to_end"]
           if name in m.get("workloads", [name])]
    moved = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"]
             if (name in m["workloads"] if "workloads" in m
                 else m["moves"] in moved)]
    return Cell(name, w["chips"], config, traffic, driver, e2e, layer)


def read_layer_metrics(cell_: Cell, layer: dict, root: Path = ROOT
                       ) -> dict[str, dict]:
    """Each per-layer metric's reader over the driver's ``layer`` record;
    a reader that finds nothing to read leaves its metric out."""
    out = {}
    for m in cell_.per_layer:
        mod = _load_module(metric_file(root, m["name"]),
                           "gdrbench_metric_" + m["name"].replace(".", "_"))
        v = mod.read(layer)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


class ForbiddenModules(RuntimeError):
    """A process of the run loaded the JAX stack or the JAX package."""


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is the JAX stack's or the JAX
    package's (compared whole, so ``gdr_tpu_torch`` passes)."""
    return sorted(n for n in list(sys.modules)
                  if n.split(".")[0] in FORBIDDEN)


def set_cache_dirs(root: Path = ROOT) -> None:
    """Build and kernel caches at fixed paths inside the checkout (the
    port builds its kernels into ``build/kernels`` there itself); nothing
    loads flax through ``transformers``."""
    build = Path(root) / "build"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(build / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")


def validate(spec: dict, root: Path = ROOT) -> list[str]:
    """Every breach of the benchmark's rules that can be seen without a
    run: names, units, sources, cross references and the files named."""
    err = []
    keys = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
    if set(spec) != keys:
        err.append(f"top-level keys {sorted(spec)}")
    seen: set[str] = set()

    def name_ok(n, what):
        if not isinstance(n, str) or not NAME.match(n):
            err.append(f"{what}: bad name {n!r}")

    def one_line(s, what):
        if not (isinstance(s, str) and 1 <= len(s) <= 200
                and "\n" not in s and "\t" not in s):
            err.append(f"{what}: not 1-200 characters on one line")

    for c in spec.get("configs", []):
        name_ok(c.get("name"), "config")
        if set(c) != {"name", "source", "file", "reduced", "why"}:
            err.append(f"config {c.get('name')}: keys {sorted(c)}")
        one_line(c.get("source"), f"config {c.get('name')} source")
        for k in c.get("reduced", []):
            name_ok(k, f"config {c.get('name')} reduced")
        f = Path(root) / c.get("file", "")
        if not f.is_file():
            err.append(f"config {c.get('name')}: no file {f}")
    configs = {c.get("name") for c in spec.get("configs", [])}
    cells = set()
    for w in spec.get("workloads", []):
        name_ok(w.get("name"), "workload")
        name_ok(w.get("traffic"), "traffic")
        cells.add(w.get("name"))
        if set(w) != {"name", "config", "traffic", "chips", "why"}:
            err.append(f"workload {w.get('name')}: keys {sorted(w)}")
        if w.get("config") not in configs:
            err.append(f"workload {w.get('name')}: unknown config")
        if w.get("chips") not in (1, 4):
            err.append(f"workload {w.get('name')}: chips {w.get('chips')}")
        one_line(w.get("why"), f"workload {w.get('name')} why")
        t = traffic_file(root, w.get("traffic", ""))
        if not t.is_file():
            err.append(f"workload {w.get('name')}: no traffic file {t}")
        elif not driver_file(root, json.loads(t.read_text())
                             .get("driver", "")).is_file():
            err.append(f"workload {w.get('name')}: no driver file")
    e2e = set()
    for kind in ("end_to_end", "per_layer"):
        for m in spec.get(kind, []):
            n = m.get("name")
            name_ok(n, kind)
            if n in seen:
                err.append(f"{kind}: {n} twice")
            seen.add(n)
            if not (isinstance(m.get("unit"), str) and UNIT.match(m["unit"])):
                err.append(f"{n}: bad unit {m.get('unit')!r}")
            if m.get("better") not in ("lower", "higher"):
                err.append(f"{n}: better {m.get('better')!r}")
            if m.get("source") not in SOURCES:
                err.append(f"{n}: source {m.get('source')!r}")
            for c in m.get("workloads", []):
                if c not in cells:
                    err.append(f"{n}: unknown workload {c}")
            if kind == "end_to_end":
                e2e.add(n)
                if set(m) - {"workloads"} != {"name", "unit", "better",
                                              "bound", "source"}:
                    err.append(f"{n}: keys {sorted(m)}")
            else:
                if set(m) - {"workloads"} != {"name", "unit", "better",
                                              "source", "layer", "moves"}:
                    err.append(f"{n}: keys {sorted(m)}")
                one_line(m.get("layer"), f"{n} layer")
                if not metric_file(root, n).is_file():
                    err.append(f"{n}: no reader {metric_file(root, n)}")
    for m in spec.get("per_layer", []):
        if m.get("moves") not in e2e:
            err.append(f"{m.get('name')}: moves unknown {m.get('moves')!r}")
    if "setup_s" not in e2e:
        err.append("no setup_s")
    return err
