"""Launcher-side fault tolerance: heartbeats, stragglers, restarts,
elasticity. The reference's ``runtime/fault.py``, field for field.

* **heartbeats**: every worker writes (step, step time, wall time) after
  each step, to its own file (:class:`HeartbeatFile`, atomically, so a
  reader sees each worker's last complete beat); :class:`HeartbeatMonitor`
  flags a worker *straggling* when its last step time exceeds
  ``straggler_factor`` times the fleet's median, and *dead* after
  ``timeout_s`` without a beat (or never having beaten);
* **bounded restarts**: :class:`RestartPolicy` backs off exponentially,
  capped, and fails the job once its budget is spent; a stable run
  resets the budget;
* **elasticity**: :class:`ElasticPlan` shrinks the data axis by powers of
  two to fit the healthy workers (a model-parallel group is
  indivisible). Checkpoints are mesh-shape-agnostic: the data-parallel
  path's replicated checkpoint restores at any data size.

Everything is pure logic and files, testable without a cluster;
``launch.train.run_qat`` writes one heartbeat file a rank.
"""
from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class HeartbeatMonitor:
    n_workers: int
    timeout_s: float = 300.0
    straggler_factor: float = 2.0
    window: int = 16
    _beats: Dict[int, List[float]] = field(default_factory=dict)
    _last: Dict[int, float] = field(default_factory=dict)

    def beat(self, worker: int, step_time: float,
             now: Optional[float] = None) -> None:
        now = time.monotonic() if now is None else now
        self._beats.setdefault(worker, []).append(step_time)
        self._beats[worker] = self._beats[worker][-self.window:]
        self._last[worker] = now

    def median_step_time(self) -> Optional[float]:
        times = [b[-1] for b in self._beats.values() if b]
        if not times:
            return None
        times.sort()
        return times[len(times) // 2]

    def stragglers(self) -> List[int]:
        med = self.median_step_time()
        if med is None or med == 0:
            return []
        return sorted(w for w, b in self._beats.items()
                      if b and b[-1] > self.straggler_factor * med)

    def dead(self, now: Optional[float] = None) -> List[int]:
        now = time.monotonic() if now is None else now
        known = set(self._last)
        missing = set(range(self.n_workers)) - known
        timed_out = {w for w, t in self._last.items()
                     if now - t > self.timeout_s}
        return sorted(missing | timed_out) if self._last else sorted(missing)

    def healthy_quorum(self, now: Optional[float] = None) -> List[int]:
        bad = set(self.dead(now)) | set(self.stragglers())
        return [w for w in range(self.n_workers) if w not in bad]


@dataclass
class RestartPolicy:
    max_restarts: int = 10
    backoff_base_s: float = 5.0
    backoff_cap_s: float = 600.0
    restarts: int = 0

    def next_delay(self) -> Optional[float]:
        """None when the budget is exhausted (the job should fail)."""
        if self.restarts >= self.max_restarts:
            return None
        d = min(self.backoff_base_s * (2 ** self.restarts),
                self.backoff_cap_s)
        self.restarts += 1
        return d

    def record_success(self, steps_since_restart: int,
                       stable_after: int = 100) -> None:
        if steps_since_restart >= stable_after:
            self.restarts = 0    # stable again: reset the budget


@dataclass
class ElasticPlan:
    """Decide the new mesh when workers are lost (power-of-two shrink)."""
    data_axis: int
    model_axis: int

    def shrink_for(self, healthy: int) -> Optional[tuple]:
        """Largest (data', model) mesh fitting the healthy worker count.

        Model-parallel groups are indivisible (a TP shard loss kills the
        whole replica), so only the data axis shrinks.
        """
        if healthy < self.model_axis:
            return None
        data = self.data_axis
        while data * self.model_axis > healthy:
            data //= 2
        return (data, self.model_axis) if data >= 1 else None


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
