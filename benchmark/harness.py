"""One run of one cell: set-up, the measured window, the traced stretch,
the comparison with the plain reference, and the result.

Everything that belongs to one configuration, traffic mix or metric is a
file found by its name in ``BENCHMARK.json``: ``configs/<config>.json``,
``traffic/<traffic>.json``, ``metrics/<metric>.py`` and
``limits/<cell>.json``; the traffic file's ``runner`` names
``runners/<runner>.py``, the path a request takes through the program, and
the configuration's ``reference`` names ``references/<reference>.py``, its
plain reference (``references/rbcd.py`` where it names none). The program
(``dpgo_ros_tpu_torch``) is driven as its CLI drives it:
``LiftedProblem.from_data`` → ``RBCDEngine`` → ``initialize``, then the
runner's ``solve`` and ``finalize``. A request is one such solve, ending
when the rounded trajectory is on the host.
"""

from __future__ import annotations

import contextlib
import dataclasses
import enum
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from benchmark import compare, gauge, world
from benchmark import trace as tr
from benchmark.host_reads import ReadCounter

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "dpgo_ros_tpu")
DEFAULT_REFERENCE = "rbcd"  # a configuration whose file names none: reference.py


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one the benchmark must never
    import, compared whole."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def graph_seeds(seed: int, count: int) -> List[int]:
    return [int(s) for s in np.random.SeedSequence([seed, 1]).generate_state(count)]


@dataclasses.dataclass
class Cell:
    name: str
    config: Dict
    traffic: Dict
    limits: Dict
    metrics: List[Dict]  # the manifest's entries this run reports
    runner: ModuleType  # runners/<traffic's runner>.py
    reference: ModuleType  # references/<configuration's reference>.py

    @staticmethod
    def load(manifest: Dict, name: str, trace: bool) -> "Cell":
        cells = {w["name"]: w for w in manifest["workloads"]}
        if name not in cells:
            raise SystemExit(f"unknown workload {name!r}; the manifest has {sorted(cells)}")
        w = cells[name]
        cfgs = {c["name"]: c for c in manifest["configs"]}
        config = load_json(ROOT / cfgs[w["config"]]["file"])
        traffic = load_json(BENCH / "traffic" / f"{w['traffic']}.json")
        lim_path = BENCH / "limits" / f"{name}.json"
        limits = load_json(lim_path) if lim_path.exists() else {}
        kind = "per_layer" if trace else "end_to_end"
        metrics = [m for m in manifest[kind] if name in m.get("workloads", [name])]
        return Cell(name, config, traffic, limits, metrics, runner(traffic["runner"]),
                    reference_of(config))


def plugin(folder: str, name: str) -> ModuleType:
    """``<folder>/<name>.py`` of the benchmark, loaded anew as a module of
    its own."""
    path = BENCH / folder / f"{name}.py"
    if not path.is_file():
        raise ValueError(f"{folder}/{name}.py: no such file in the benchmark")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{folder}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod  # where a dataclass of the module looks itself up
    spec.loader.exec_module(mod)
    return mod


def reader(name: str) -> Callable:
    """``metrics/<name>.py``'s ``read``."""
    return plugin("metrics", name).read


def runner(name: str) -> ModuleType:
    """``runners/<name>.py``: the path of a request through the program.
    It defines ``SOURCES`` (names of ``fused_rtr``'s ``*_SOURCE``
    constants, built in set-up), ``RECORDS_SCHEDULE``, ``STEP`` (the
    kernel wrapper a step calls, ``"module:function"``), ``solve(eng, st,
    spans)`` → (state, updates or ticks, cost, tCG, schedule or None),
    ``finalize(eng, st)`` → (T, state), ``captured(calls)`` (a context
    that records its kernels' calls) and ``work(g, r, calls)`` → (work,
    launches) under the keys the metric readers read, at 0 for no calls.
    A run loads it once, in ``Cell.load``, and passes that module along."""
    return plugin("runners", name)


def reference_of(config: Dict) -> ModuleType:
    """The configuration's plain reference, ``references/<name>.py`` by its
    ``reference`` key: its declared numbers and its hooks
    (``references/rbcd.py`` says which)."""
    return plugin("references", config.get("reference", DEFAULT_REFERENCE))


class Spans:
    """Host-clock spans around the calls into each layer, synchronized at
    their boundaries, and named regions on the profiler's timeline; off
    (no synchronization, nothing recorded) outside the traced run."""

    def __init__(self, device):
        self.device, self.on, self.acc = device, False, {}

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def __call__(self, name: str):
        if not self.on:
            yield
            return
        self._sync()
        t0 = time.perf_counter()
        with torch.profiler.record_function(tr.SPAN_PREFIX + name):
            yield
            self._sync()
        self.acc[name] = self.acc.get(name, 0.0) + time.perf_counter() - t0

    def take(self) -> Dict[str, float]:
        out, self.acc = self.acc, {}
        return out


class Program:
    """The system under test, driven as its CLI drives it."""

    def __init__(self, config: Dict, graph: Dict, device: torch.device):
        from dpgo_ros_tpu_torch.models.problem import LiftedProblem
        from dpgo_ros_tpu_torch.parallel.rbcd import RBCDEngine
        from dpgo_ros_tpu_torch.types import MeasurementBatch, PoseGraphData
        from dpgo_ros_tpu_torch.utils.config import AgentConfig

        self._LP, self._Engine = LiftedProblem, RBCDEngine
        self._MB, self._PGD = MeasurementBatch, PoseGraphData
        solver = dict(config["solver"])
        kw = {}
        fields = {f.name: f for f in dataclasses.fields(AgentConfig)}
        for k, v in solver.items():
            if k not in fields:
                raise ValueError(f"config key {k!r} is not an AgentConfig field")
            default = fields[k].default
            kw[k] = type(default)(v) if isinstance(default, enum.Enum) else v
        kw["num_robots"] = len(graph["num_poses"])
        self.cfg = AgentConfig(**kw)
        self.dtype = torch.float64 if self.cfg.dtype == "float64" else torch.float32
        self.r = int(self.cfg.relaxation_rank)
        self.device = device

    def data(self, g: Dict):
        """The graph as the program's input, in fresh arrays."""
        keys = [f.name for f in dataclasses.fields(self._MB)]
        m = self._MB(**{k: np.array(g[k], copy=True) for k in keys})
        return self._PGD(measurements=m, num_poses=np.array(g["num_poses"], copy=True), d=3)

    def build(self, g: Dict):
        prob = self._LP.from_data(self.data(g), r=self.r, dtype=self.dtype, device=self.device)
        return self._Engine(prob, self.cfg)


class Traffic:
    """The general request generator: a closed loop of one client over the
    cell's graphs, as the traffic file's parameters say.

    Every seed gets the same work in another order: the graphs are the
    ``pool`` noise draws ``world_seed``, ``world_seed + 1``, … of the
    configuration's world, each with its own lifting matrix; ``--seed``
    orders them (and sets the warm requests' gauge angles and the samples
    the comparison reads)."""

    def __init__(self, cell: Cell, seed: int, device: torch.device, spans: Spans,
                 world_override: Optional[Dict] = None):
        t, c = cell.traffic, cell.config
        if t.get("loop") != "closed" or t.get("clients") != 1:
            raise ValueError("the generator runs a closed loop of one client")
        self.params = t
        self.kind, self.runner = t["request"], cell.runner
        if self.kind not in ("cold", "warm"):
            raise ValueError(f"request {self.kind!r}")
        wkw = dict(c["world"], **(world_override or {}))
        base = int(t["world_seed"])
        pool = int(t["pool"])
        self.graphs = [world.generate_world(**wkw, seed=base + k) for k in range(pool)]
        self.order = np.random.default_rng([seed, 1]).permutation(pool)
        self.device, self.spans = device, spans
        self.prog = Program(c, self.graphs[0], device)
        d = self.graphs[0]["R"].shape[-1]
        self.ylifts = [cell.reference.lifting_matrix(base + k, self.prog.r, d)
                       for k in range(pool)]
        self.ylifts_t = [torch.as_tensor(y, dtype=self.prog.dtype, device=device)
                         for y in self.ylifts]
        self.step_rad = float(t.get("step_rad", gauge.STEP_RAD))
        self.phase = float(np.random.default_rng([seed, 3]).uniform(0.0, 2.0 * math.pi))
        self.robust = c["solver"].get("robust_cost_type", "L2") != "L2"
        self.eng = self.st0 = None
        if self.kind == "warm":  # the graph the team already holds, built and initialized
            self.eng = self.prog.build(self.graphs[self.order[0]])
            self.st0 = self.eng.initialize(ylift=self.ylifts_t[self.order[0]])
        self.reads_in: Optional[ReadCounter] = None

    def graph_of(self, i: int) -> int:
        return int(self.order[i % len(self.order)])

    def request(self, i: int) -> Dict:
        """Request ``i``: its answer and what the comparison reads."""
        sp = self.spans
        with torch.profiler.record_function(tr.REQUEST_SPAN) if sp.on else contextlib.nullcontext():
            gi = self.graph_of(i)
            if self.kind == "cold":
                with sp("build"):
                    eng = self.prog.build(self.graphs[gi])
                with sp("init"):
                    st = eng.initialize(ylift=self.ylifts_t[gi])
            else:
                eng = self.eng
                with sp("rotate"):
                    X = gauge.rotate(self.st0.X, self.phase + i * self.step_rad)
                    st = self.st0._replace(X=X, X_prev=X, V=X)
            stages = staged(eng, st) if self.robust else None
            counter = self.reads_in
            with counter if counter is not None else contextlib.nullcontext():
                st, iters, cost, tcg, sched = self.runner.solve(eng, st, sp)
            w_pre = getattr(st, "weights", None)  # a state without weights has none
            with sp("finalize"):
                T, st = self.runner.finalize(eng, st)
        if stages is not None:
            stages["final"] = dict(X=st.X, weights=w_pre, iteration=int(iters))
        return dict(graph=gi, T=T, cost=float(cost), iterations=int(iters), tcg=int(tcg),
                    sched=sched, X=st.X, w_pre=w_pre, w_final=getattr(st, "weights", None),
                    stages=stages, spans=sp.take())


def staged(eng, st) -> Dict:
    """The stage boundaries of a robust solve, as references to the
    program's own states (no copy): its start, and at each weight round the
    state before it and the weights it set."""
    stages = {"start": dict(X=st.X, weights=st.weights, iteration=st.iteration),
              "rounds": []}
    update = type(eng)._weight_update_impl

    def weight_update(s):
        out = update(eng, s)
        stages["rounds"].append(dict(X=s.X, iteration=s.iteration, weights=out.weights))
        return out

    eng._weight_update_impl = weight_update
    return stages


def traced_work(runner: ModuleType, graphs: List[Dict], r: int,
                per_request: List) -> Tuple[Dict, Dict]:
    """The traced requests' (work, launches) under the cell's runner's
    keys, summed over their ``(graph, calls)``."""
    work, launches = runner.work(graphs[0], r, [])
    for g, calls in per_request:
        w, n = runner.work(g, r, calls)
        for k in w:
            work[k] += w[k]
        for k in n:
            launches[k] += n[k]
    return work, launches


@dataclasses.dataclass
class RunData:
    """What the metric readers read."""

    cell: Cell
    setup_s: float
    window_s: float
    requests: List[Dict]
    reads: Optional[Dict] = None  # {"reads", "iterations"} of one request
    trace: Optional[Dict] = None  # trace.summarize(...) plus the work


def run_cell(manifest: Dict, name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: Optional[float] = None,
             world_override: Optional[Dict] = None, solver_override: Optional[Dict] = None,
             log=None) -> Dict:
    """One run of cell ``name``; returns the result object. The overrides
    shrink a cell for the tests on the CPU."""
    t_start = time.perf_counter() if t_start is None else t_start
    log = log or (lambda m: print(m, file=sys.stderr, flush=True))
    cell = Cell.load(manifest, name, trace)
    if solver_override:
        cell.config = dict(cell.config, solver=dict(cell.config["solver"], **solver_override))
    dev = torch.device(device)
    spans = Spans(dev)
    t = cell.traffic
    traffic = Traffic(cell, seed, dev, spans, world_override)
    on_card = dev.type == "cuda"
    if on_card:
        from dpgo_ros_tpu_torch.ops import fused_rtr

        fused_rtr.build_all([getattr(fused_rtr, src) for src in cell.runner.SOURCES])
    for j in range(int(t.get("warmup", 1))):  # every shape of the cell, before the window
        traffic.request(-1 - j)
    if on_card:
        torch.cuda.synchronize(dev)
    spans.on = trace
    keep = int(t.get("kept_states", 4))
    pick = np.random.default_rng([seed, 11])
    records, kept = [], []
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    i = 0
    while True:
        ts = time.perf_counter()
        rec = traffic.request(i)
        te = time.perf_counter()
        rec["latency_s"] = te - ts
        # a reservoir sample of the states, drawn from the seed
        if len(kept) < keep:
            kept.append(i)
        else:
            j = int(pick.integers(0, i + 1))
            if j < keep:
                records[kept[j]].update(STATE_KEYS)
                kept[j] = i
            else:
                rec.update(STATE_KEYS)
        records.append(rec)
        i += 1
        if te - t0 >= seconds:
            break
    window_s = te - t0
    spans.on = False
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    lat = np.percentile([r["latency_s"] for r in records], [0, 10, 50, 90, 100]) * 1e3
    log(f"window: {len(records)} requests in {window_s:.3f} s; set-up {setup_s:.3f} s; "
        f"latency ms min/p10/p50/p90/max {' '.join(f'{x:.1f}' for x in lat)}")

    data = RunData(cell, setup_s, window_s, records)
    if trace:
        data.reads, data.trace = traced_stretch(traffic, spans, dev, i, log)
    # the program's state goes before the reference runs
    states = []
    for i, rec in enumerate(records):
        if rec["X"] is not None:
            states.append(dict(index=i, graph=rec["graph"], T=rec["T"], cost=rec["cost"],
                               **{k: host(rec[k]) for k in STATE_KEYS}))
        for k in STATE_KEYS:
            rec.pop(k)
    traffic.eng = traffic.st0 = None
    if on_card:
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()

    n_check = int(cell.config.get("check_graphs", 1))
    refs = {}
    t_ref = time.perf_counter()
    solver = cell.config["solver"]
    plain = cell.reference
    if traffic.robust and hasattr(plain, "follow"):
        # the reference follows the sampled solves stage by stage from the
        # program's own states (the reservoir's first, drawn from the seed)
        for st in states[:n_check]:
            st["follow"] = plain.follow(traffic.graphs[st["graph"]], solver,
                                        traffic.ylifts[st["graph"]], st["stages"],
                                        device=dev)
    elif not traffic.robust and hasattr(plain, "solve"):
        # the whole solve over a sample of the graphs the window solved
        solved = sorted({r["graph"] for r in records})
        sample = np.random.default_rng([seed, 13]).choice(
            solved, min(n_check, len(solved)), replace=False)
        for gi in sorted(int(x) for x in sample):
            refs[gi] = plain.solve(traffic.graphs[gi], solver, traffic.ylifts[gi],
                                   device=dev)
    log(f"reference: {len(refs) or min(n_check, len(states))} solve(s) in "
        f"{time.perf_counter() - t_ref:.3f} s")
    checks, failed = compare.compare(records, states, refs, traffic.graphs,
                                     cell.config, cell.limits, plain)
    # every number the cell's limits name has to be read, and within its limit
    correct = bool(cell.limits) and all(
        k in checks and checks[k]["value"] is not None and checks[k]["value"] <= lim
        for k, lim in cell.limits.items())
    for k, lim in cell.limits.items():
        if k not in checks:  # read nowhere: the run cannot be judged on it
            checks[k] = {"value": None, "limit": float(lim)}
            failed = max(failed, 1)

    metrics = {}
    for m in cell.metrics:
        v = reader(m["name"])(data)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    # after the window, the reference and every metric reader
    bad = forbidden_modules()
    if bad:
        raise ForbiddenImport(bad)
    out = {"correct": bool(correct), "attempted": len(records), "failed": int(failed),
           "metrics": metrics,
           "device": {"platform": "gpu" if on_card else "cpu",
                      "kind": torch.cuda.get_device_name(dev) if on_card else "cpu",
                      "count": 1, "memory_peak_bytes": int(peak)}}
    if trace and data.trace is not None:
        out["device"]["busy_s"] = data.trace["busy_s"]
        out["device"]["window_s"] = data.trace["window_s"]
        out["breakdown"] = {"device_ops": data.trace["device_ops"],
                            "idle_gaps": data.trace["idle_gaps"]}
    out["checks"] = checks
    return out


STATE_KEYS = dict(X=None, w_pre=None, w_final=None, stages=None)


def host(x):
    """Tensors, in nested dicts and lists, as host arrays."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: host(v) for k, v in x.items()}
    if isinstance(x, list):
        return [host(v) for v in x]
    return x


class ForbiddenImport(RuntimeError):
    def __init__(self, names):
        super().__init__(f"modules the benchmark must not load: {', '.join(names)}")
        self.names = names


def traced_stretch(traffic: Traffic, spans: Spans, dev, i0: int, log):
    """After the window: the host reads of one request, then one short
    profiler session over a few requests."""
    counter = ReadCounter(dev)
    traffic.reads_in = counter
    rec = traffic.request(i0)
    traffic.reads_in = None
    reads = {"reads": counter.reads, "iterations": rec["iterations"]}
    if dev.type != "cuda":
        return reads, None
    if not tr.keeps_known_launch():
        log("trace: the profiler kept no device interval of a known launch; "
            "device metrics not measured")
        return reads, None
    n = int(traffic.params.get("trace_requests", 2))
    per_request = []
    spans.on = True
    with tr.padded_profile() as prof:
        for j in range(n):
            calls: List = []
            with traffic.runner.captured(calls):
                rec = traffic.request(i0 + 1 + j)
            per_request.append((rec, calls))
    spans.on = False
    summary = tr.summarize(tr.chrome_events(prof))
    if summary is None:
        return reads, None
    work, launches = traced_work(
        traffic.runner, traffic.graphs, traffic.prog.r,
        [(traffic.graphs[rec["graph"]], calls) for rec, calls in per_request])
    summary.update(work=work, launches=launches, tcg=sum(r["tcg"] for r, _ in per_request),
                   iterations=sum(r["iterations"] for r, _ in per_request))
    log(f"trace: {n} requests, busy {summary['busy_s']:.4f} s of {summary['window_s']:.4f} s")
    return reads, summary
