"""Tagged stdout logging, the ``[i]/[ok]/[warn]/[err]`` console convention.

Counterpart of ``bluerov2_dynamics_tpu/utils/log.py``; the port keeps its
own copy so that it imports nothing of the JAX package.
"""

from __future__ import annotations

import sys


def _emit(tag: str, *parts, file=None):
    print(tag, *parts, file=file or sys.stdout, flush=True)


def info(*parts):
    _emit("[i]", *parts)


def ok(*parts):
    _emit("[ok]", *parts)


def warn(*parts):
    _emit("[warn]", *parts)


def err(*parts):
    _emit("[err]", *parts, file=sys.stderr)
