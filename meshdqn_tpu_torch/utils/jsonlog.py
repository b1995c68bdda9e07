"""Structured JSON-lines logging.

The port of meshdqn_tpu/utils/jsonlog.py (a copy: the JAX package's module
imports no JAX, but importing it would run the JAX package's __init__).
One JSON object per line, appended, next to the .npy metric artifacts.
"""
from __future__ import annotations

import json
import os
import time


class JsonLogger:
    """Append-only JSONL event log.

    >>> log = JsonLogger("/tmp/run.jsonl")
    >>> log.log("episode", episode=3, reward=-1.2)
    """

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "a", buffering=1)  # line-buffered

    def log(self, event: str, **fields):
        rec = {"ts": round(time.time(), 3), "event": event}
        for k, v in fields.items():
            if hasattr(v, "item"):  # numpy / torch scalars
                v = v.item()
            rec[k] = v
        self._f.write(json.dumps(rec) + "\n")

    def close(self):
        self._f.close()


def read_jsonl(path: str) -> list[dict]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out
