"""What every kind of cell shares. A kind is a module of its own,
``benchmark/kinds/<kind>.py``, named by a traffic mix's ``kind`` and
found by that name (``Bench.kind``); it gives ``Cell``, a subclass of
``Cell`` below, which

- builds in set-up everything the window needs, warmed up (``__init__``);
- drives the timed window (``window``) and a traced sub-window
  (``traced``), and counts the model work of both (``work``);
- turns the window into its end-to-end metrics (``end_to_end``);
- after the program is freed, holds what the timed path produced against
  the plain reference (``outputs``, ``reference``, ``compare``).

``wrap`` (tests and ``readings.py`` only) replaces the program's timed
call by a broken one before the first call; ``faults`` names the ones a
kind's limits are held against.
"""

from __future__ import annotations

import torch

from harness import rig as rig_mod
from reference import body as ref_body


def ref_cfg(config: dict) -> dict:
    keys = ("k_neigh", "dis_threshold", "n_samples", "n_importance", "arch",
            "train")
    return {k: config[k] for k in keys}


def samples_per_ray(config: dict) -> int:
    """Model work of a ray: n_samples through the coarse field and
    n_samples + n_importance through the fine one."""
    return 2 * config["n_samples"] + config["n_importance"]


class Cell:
    kind = None
    # {name: wrap} of the faults the kind's limits are held against
    faults = {}

    def __init__(self, run, wrap=None):
        self.run = run
        self.config = run.config
        self.traffic = run.traffic
        self.dev = run.device
        self.rig_arrays = rig_mod.config_rig(self.config)
        self.rig = ref_body.Rig(self.rig_arrays, self.config["model_type"],
                                self.dev)

    def sync(self) -> None:
        if self.dev.type == "cuda":
            torch.cuda.synchronize()

    def release(self) -> None:
        for k in ("trainer", "system", "renderer", "stream", "step_fn"):
            if hasattr(self, k):
                delattr(self, k)
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def window(self, seconds: float) -> dict:
        """{"seconds", "count", "failed", ...} of the timed window."""
        raise NotImplementedError

    def traced(self, count: int) -> dict:
        raise NotImplementedError

    def work(self) -> dict:
        """{"model_flop": of the window's calls, ...}."""
        raise NotImplementedError

    def end_to_end(self, win: dict, setup_s: float) -> dict:
        """{metric: (value, unit)}, ``setup_s`` among them."""
        raise NotImplementedError

    def outputs(self):
        raise NotImplementedError

    def reference(self, quant=None):
        raise NotImplementedError

    @staticmethod
    def compare(prog, ref) -> dict:
        """{number: value} of the program's outputs against the
        reference's."""
        raise NotImplementedError

    def diagnostics(self, prog, ref) -> dict:
        """Further readings ``readings.py`` prints beside the numbers."""
        return {}

    def numbers(self, outputs) -> dict:
        return self.compare(outputs, self.reference())
