"""Kinds of request: the code a traffic file's ``"kind"`` names.

A traffic mix is data (``traffic/<name>.json``); the one module here whose
name its ``kind`` gives reads it and drives the program.  Each module holds
a :class:`Task` subclass as ``TASK``.  A task makes its inputs from the seed
and builds the program in :meth:`Task.setup`, runs the closed loop in
:meth:`Task.window`, profiles a bounded segment in :meth:`Task.trace`, and
gives what the reference answers to the same questions
(:meth:`Task.reference_answers`) and how far each of the program's answers
lies from it (:meth:`Task.gaps`).
"""

from __future__ import annotations

import importlib


class Task:
    e2e: tuple = ()          # the end-to-end metrics this kind measures
    warmup: int = 5          # requests run in set-up, after the first
    check_params: dict = {}  # the parameters of the comparison (limits file)

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, int(seed), device
        self.answers = []

    def setup(self):
        raise NotImplementedError

    def window(self, seconds: float) -> dict:
        """Requests until ``seconds`` have passed: ``{"attempted", "e2e":
        {metric: value}, "wall_per_request_s"}``; keeps the answers."""
        raise NotImplementedError

    def trace(self) -> dict:
        """A profiled segment: ``{"window": Trace, ...}`` for the readers."""
        raise NotImplementedError

    def free(self):
        """Drop the program's state before the reference runs."""

    def reference_answers(self, prec) -> list:
        raise NotImplementedError

    def as_answers(self, ref_answers) -> list:
        """Reference answers in the form of the program's (the control)."""
        return ref_answers

    def gaps(self, answers, ref_answers) -> list:
        """``[({check: gap}, number of answers it stands for), ...]``."""
        raise NotImplementedError

    def notes(self) -> dict:
        """What the comparison found beside its checks (counts, exclusions)."""
        return {}

    def shapes(self) -> dict:
        return {}


def load(kind: str):
    """The :class:`Task` subclass of ``kinds/<kind>.py``."""
    return importlib.import_module(f"portbench.kinds.{kind}").TASK
