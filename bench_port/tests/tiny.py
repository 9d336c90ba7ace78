"""Tiny cells for the CPU tests: the measured configurations' families at
sizes a test run holds, with limits set from CPU readings at these sizes."""

import json
from pathlib import Path

from bench_port.harness import Cell

CONFIGS = Path(__file__).resolve().parent.parent / "configs"


def pythia_cell(mbs: int = 2, acc: int = 3, compared_acc: int = 2, remat=None, limits=None) -> Cell:
    cfg = json.loads((CONFIGS / "pythia-1b.json").read_text())
    cfg.update(model_type="pythia-14m", hidden_size=128, intermediate_size=512, num_attention_heads=4,
               num_hidden_layers=6, sequence_length=33, reference_rows=1)
    cfg["optimizer"] = dict(cfg["optimizer"], lr=1e-3)  # pythia-14m's recipe
    wl = {"micro_batch_size": mbs, "accumulation": acc, "compared_accumulation": compared_acc, "remat": remat,
          "limits": limits or {}}
    return Cell("pythia-14m.tiny", cfg, wl, [], [])
