"""Launcher-side fault tolerance: the heartbeat file.

Every worker writes (step, step time, wall time) after each step to its
own file, atomically, so a coordinator reading the directory sees each
worker's last complete beat. Copy of the reference's ``HeartbeatFile``;
its heartbeat monitor, restart policy and elastic re-mesh plan arrive with
the distributed slice.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict


class HeartbeatFile:
    """File-backed heartbeat transport (shared-fs coordination pattern)."""

    def __init__(self, directory: str, worker: int):
        self.path = os.path.join(directory, f"hb_{worker:05d}.json")
        os.makedirs(directory, exist_ok=True)

    def write(self, step: int, step_time: float) -> None:
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"step": step, "step_time": step_time,
                       "time": time.time()}, f)
        os.replace(tmp, self.path)

    @staticmethod
    def read_all(directory: str) -> Dict[int, Dict]:
        out = {}
        if not os.path.isdir(directory):
            return out
        for name in os.listdir(directory):
            if name.startswith("hb_") and name.endswith(".json"):
                try:
                    with open(os.path.join(directory, name)) as f:
                        out[int(name[3:8])] = json.load(f)
                except (json.JSONDecodeError, ValueError):
                    continue   # torn write: ignore this round
        return out
