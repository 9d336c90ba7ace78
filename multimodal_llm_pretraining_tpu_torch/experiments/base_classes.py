"""Experiment and Sweep (counterpart of ``experiments/base_classes.py``).

An Experiment is a named graph of cacheable steps; a Sweep generates one
experiment for each point of a search space's cartesian product and keeps
the valid ones, with the run / count / print-incomplete / print-results
commands. ``Sweep.results()`` returns a list of row dicts, and
``print-results`` prints them as an aligned text table: the card's machine
has no pandas.

There is no SLURM here yet (ROADMAP Queue 1 item 10): an experiment's
``slurm_job`` is None, and ``launch`` and ``sweep`` run in this process.
"""

import abc
import itertools
from dataclasses import dataclass, fields
from typing import Any

from ..utils import get_logger
from .cache import StepAlreadyRunning, StepCall, StepFailure, get_workspace

logger = get_logger()


@dataclass
class Experiment(abc.ABC):
    """A named graph of steps. Subclasses define ``step_dict`` (in order;
    a later step may take an earlier StepCall as a lazy input)."""

    @property
    @abc.abstractmethod
    def step_dict(self) -> dict[str, StepCall]:
        raise NotImplementedError

    def to_dict(self) -> dict[str, Any]:
        return {f.name: getattr(self, f.name) for f in fields(self)}

    def is_valid(self) -> bool:
        return True

    @property
    def slurm_job(self) -> None:
        return None

    @property
    def dependencies(self) -> list["Experiment"]:
        return []

    # ------------------------------------------------------------ execution

    def run(self, record_failures: bool = False) -> None:
        for dep in self.dependencies:
            dep.run(record_failures=record_failures)
        ws = get_workspace()
        for name, call in self.step_dict.items():
            logger.info(f"[{type(self).__name__}] step '{name}'")
            try:
                call.result(ws, record_failure=record_failures)
            except StepAlreadyRunning:
                raise
            except Exception as e:
                if not record_failures:
                    raise
                # the failure is cached; go on so that the steps downstream
                # cache theirs and the arm reads "done"
                logger.info(f"step '{name}' failed ({type(e).__name__}): {e}")

    def launch(self) -> None:
        self.run()

    # ------------------------------------------------------------ status

    def is_cached(self) -> bool:
        ws = get_workspace()
        return all(call.is_cached(ws) for call in self.step_dict.values())

    def is_running(self) -> bool:
        ws = get_workspace()
        return any(call.is_running(ws) for call in self.step_dict.values())

    def step_result(self, name: str):
        return self.step_dict[name].result(get_workspace())

    def results(self) -> dict[str, Any]:
        return {name: self.step_result(name) for name in self.step_dict}

    # ------------------------------------------------------------ CLI

    @classmethod
    def cli(cls) -> None:
        """argparse CLI: scalar fields map to flags; dataclass fields (e.g.
        ``--config``) take a JSON object."""
        import argparse
        import dataclasses as dc
        import json
        import typing

        hints = typing.get_type_hints(cls)
        parser = argparse.ArgumentParser(description=cls.__doc__)
        for f in fields(cls):
            arg = "--" + f.name.replace("_", "-")
            if hints.get(f.name, str) is bool:
                parser.add_argument(arg, action="store_true")
            else:
                parser.add_argument(arg, type=str)
        kwargs = {}
        for k, v in vars(parser.parse_args()).items():
            if v is None:
                continue
            ftype = hints.get(k, str)
            if dc.is_dataclass(ftype) and isinstance(v, str):
                kwargs[k] = ftype(**json.loads(v))
            elif ftype in (int, float) and isinstance(v, str):
                kwargs[k] = ftype(v)
            else:
                kwargs[k] = v
        cls(**kwargs).launch()  # type: ignore[arg-type]


def _cell(value: Any) -> str:
    """One line for a table cell: a value of several lines (a failed
    worker's error, which ends in its cause) shows its first and last."""
    lines = [line.strip() for line in str(value).splitlines() if line.strip()]
    return " ... ".join([lines[0], lines[-1]] if len(lines) > 1 else lines)


def format_table(rows: list[dict[str, Any]]) -> str:
    """Rows as an aligned text table: one column per key (in order of first
    appearance), one line per row, empty cells where a row lacks a key."""
    columns: list[str] = []
    for row in rows:
        columns += [k for k in row if k not in columns]
    cells = [[("" if k not in row else _cell(row[k])) for k in columns] for row in rows]
    widths = [max([len(c)] + [len(r[i]) for r in cells]) for i, c in enumerate(columns)]
    lines = ["  ".join(c.ljust(w) for c, w in zip(columns, widths))]
    lines += ["  ".join(v.ljust(w) for v, w in zip(r, widths)) for r in cells]
    return "\n".join(line.rstrip() for line in lines)


class Sweep(abc.ABC):
    """Cartesian-product experiment generator over a search-space dict."""

    def __init__(self, search_space: dict[str, list]):
        self.search_space = search_space

    @abc.abstractmethod
    def build_experiment(self, **assignment) -> Experiment:
        raise NotImplementedError

    def experiments(self) -> list[Experiment]:
        keys = list(self.search_space.keys())
        out = []
        for values in itertools.product(*(self.search_space[k] for k in keys)):
            exp = self.build_experiment(**dict(zip(keys, values)))
            if exp.is_valid():
                out.append(exp)
        return out

    # ------------------------------------------------------------ commands

    def sweep(self) -> None:
        """Run every experiment not cached and not running elsewhere; a failed
        step is cached as a ``StepFailure`` and the sweep goes on."""
        exps = self.experiments()
        for i, exp in enumerate(exps):
            if exp.is_cached() or exp.is_running():
                continue
            logger.info(f"--- experiment {i + 1}/{len(exps)}: {exp.to_dict()}")
            try:
                exp.run(record_failures=True)
            except StepAlreadyRunning as e:
                logger.info(f"experiment step already running elsewhere, skipping: {e}")
            except Exception as e:  # cached as a StepFailure; the sweep goes on to the next arm
                logger.warning(f"experiment failed ({type(e).__name__}): {e}", exc_info=True)

    def count(self) -> tuple[int, int]:
        exps = self.experiments()
        done = sum(1 for e in exps if e.is_cached())
        return done, len(exps)

    def incomplete(self) -> list[Experiment]:
        return [e for e in self.experiments() if not e.is_cached() and not e.is_running()]

    def results(self) -> list[dict[str, Any]]:
        """One row per experiment: its fields, then each cached step's
        result (None and a ``failure`` column for a cached failure; a dict
        result flattened into the row too)."""
        rows = []
        for exp in self.experiments():
            row = dict(exp.to_dict())
            if exp.is_cached():
                res = exp.results()
                for k, v in res.items():
                    if isinstance(v, StepFailure):
                        row[k] = None
                        row["failure"] = f"{v.error_type}: {v.message}"
                    else:
                        row[k] = v if not isinstance(v, dict) else str(v)
                flat = res.get("benchmarking_results")
                if isinstance(flat, dict):
                    row.update(flat)
            rows.append(row)
        return rows

    @staticmethod
    def run(experiment_sweep: "Sweep", cmd: str = "run") -> None:
        match cmd:
            case "run":
                experiment_sweep.sweep()
            case "count":
                done, total = experiment_sweep.count()
                print(f"{done} / {total} experiments cached")
            case "print-incomplete":
                for e in experiment_sweep.incomplete():
                    print(e.to_dict())
            case "print-results":
                print(format_table(experiment_sweep.results()))
            case _:
                raise ValueError(f"unknown cmd {cmd}")
