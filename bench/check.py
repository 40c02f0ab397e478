"""The comparison that decides ``correct``, and its limits.

Each compared answer is the program's distance vector for one ticket,
held against the reference's (``reference.relax``) for the same root,
algorithm and round bound.  The numbers compared:

* ``missing``: answers due in the window that never came (refused at
  submit, dead-lettered, or not resolved);
* ``bfs_wrong``: vertices, over every compared BFS answer, whose hop
  distance differs from the reference's;
* ``sssp_reach_wrong``: vertices, over every compared SSSP answer,
  reached on one side and not on the other;
* ``sssp_gap``: the widest gap between the program's and the
  reference's SSSP distance over vertices both reach, relative to the
  reference's distance or 1, whichever is larger.

Every distance is a float32 sum along its path, which any sound
implementation reproduces bit for bit, so the comparison is exact and
every limit is 0.  The control (the program's own bfloat16 message
channel) and the planted faults read above them; PERF.md gives the
readings.
"""
from __future__ import annotations

import torch

LIMITS = {"missing": 0, "bfs_wrong": 0, "sssp_reach_wrong": 0,
          "sssp_gap": 0.0}


class Tally:
    def __init__(self):
        self.values = {"missing": 0, "bfs_wrong": 0, "sssp_reach_wrong": 0,
                       "sssp_gap": 0.0}
        self.compared = 0

    def add_missing(self, n: int = 1) -> None:
        self.values["missing"] += n

    def add(self, algorithm: str, got: torch.Tensor,
            want: torch.Tensor) -> None:
        """Compare one answer (``got``, the program's) with the
        reference's (``want``); both are moved to ``want``'s device."""
        self.compared += 1
        got = got.to(device=want.device, dtype=torch.float32).flatten()
        want = want.to(torch.float32)
        v = self.values
        if got.shape != want.shape:
            key = "bfs_wrong" if algorithm == "bfs" else "sssp_reach_wrong"
            v[key] += int(want.numel())
            return
        if algorithm == "bfs":
            v["bfs_wrong"] += int((got != want).sum())
            return
        fin_got, fin_want = torch.isfinite(got), torch.isfinite(want)
        v["sssp_reach_wrong"] += int((fin_got != fin_want).sum())
        both = fin_got & fin_want
        if bool(both.any()):
            g, w = got[both], want[both]
            gap = ((g - w).abs() / w.abs().clamp_min(1.0)).max()
            v["sssp_gap"] = max(v["sssp_gap"], float(gap))

    def correct(self) -> bool:
        return all(self.values[k] <= LIMITS[k] for k in LIMITS)

    def lines(self) -> list:
        return [f"check {k} = {self.values[k]!r} (limit {LIMITS[k]!r})"
                for k in LIMITS]

    def as_json(self) -> dict:
        return {k: {"value": self.values[k], "limit": LIMITS[k]}
                for k in LIMITS}
