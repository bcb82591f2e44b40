"""One cell of the benchmark: its workload entry, configuration file, traffic
file and limits, all found by name under ``benchmarks/``, and the port's
controller built from them through its own CLI's config builder."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Dict, List

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmarks"
RUNS = ROOT / "build" / "bench_runs"  # the controller's run_dir; nothing is written there


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """A module of the benchmark by file path (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(
        "benchmarks_" + path.stem.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclasses.dataclass
class Cell:
    name: str
    workload: Dict
    config: Dict
    traffic: Dict
    limits: Dict[str, float]
    seed: int
    seconds: float
    trace: bool
    device: object = None

    @classmethod
    def load(cls, name: str, seed: int, seconds: float, trace: bool) -> "Cell":
        bench = load_json(ROOT / "BENCHMARK.json")
        workloads = {w["name"]: w for w in bench["workloads"]}
        if name not in workloads:
            raise KeyError(f"unknown workload {name!r}; have {sorted(workloads)}")
        w = workloads[name]
        configs = {c["name"]: c for c in bench["configs"]}
        config = load_json(ROOT / configs[w["config"]]["file"])
        traffic = load_json(BENCH / "traffic" / f"{w['traffic']}.json")
        limits_path = BENCH / "limits" / f"{name}.json"
        limits = load_json(limits_path)["limits"] if limits_path.exists() else {}
        return cls(name, w, config, traffic, limits, seed, seconds, trace)

    def cli_args(self) -> List[str]:
        """The MBPO CLI's arguments of this cell: the configuration's, then
        the overrides every cell of it takes, then the traffic's."""
        return (list(self.config["args"]) + list(self.config.get("overrides", []))
                + list(self.traffic.get("args", []))
                + ["--seed", str(self.seed), "--run_dir", str(RUNS / self.name)])

    def mbpo_config(self):
        from pdecontrol_tpu_torch.mbrl import script

        return script.config_from_args(script.build_parser().parse_args(self.cli_args()))

    def controller(self, config=None):
        from pdecontrol_tpu_torch.mbrl.controller import PDEModelBasedController

        return PDEModelBasedController(config or self.mbpo_config(),
                                       logger=RecordingLogger(), device=self.device)


def env_config(env) -> Dict:
    """The plain reference's view of the controller's KS env: its sizes and
    objective, which the reference's control period takes."""
    return {k: getattr(env, k) for k in ("n", "length", "dt", "cfg_steps", "sigma", "objective",
                                         "legacy_objective", "max_episode_steps")}


class RecordingLogger:
    """The controller's metrics sink, kept in memory: the committed records
    in order.  The benchmark writes no metrics file."""

    def __init__(self):
        self.records: List[Dict] = []
        self._pending: Dict = {}

    def log(self, metrics: Dict, commit: bool = True) -> None:
        self._pending.update(metrics)
        if commit:
            self.records.append(self._pending)
            self._pending = {}
