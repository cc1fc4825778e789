"""Structured JSONL metrics (SURVEY.md §5.5).

The reference prints ad-hoc stdout; here every pipeline stage appends one
JSON record per frame to a JSONL file (frame id, inliers, hypotheses scored,
ms/frame, pose), and ``summary()`` aggregates the run — these files are the
source for the measured columns and for ``eval/report.py``.
"""

from __future__ import annotations

import json
import time
from typing import Optional

#: The ONE definition of the "hypotheses" metric (round-2 verdict Weak #8):
#: the number of candidate POSES whose residuals were scored against the
#: full correspondence set — i.e. the K dimension the MSAC scoring kernel
#: actually processes. Consequences: a 3D-3D minimal sample contributes 1
#: pose; a P3P sample contributes its 4 quartic roots (all are scored,
#: invalid ones at +inf); an adaptive schedule reports the SUM of its
#: rounds' poses. ``RansacResult.num_hypotheses`` follows this definition
#: on every engine path, and ``hypotheses_per_s`` in :meth:`summary` /
#: eval/report.py therefore means poses-scored-per-second on all configs.
HYPOTHESES_DEFINITION = "candidate poses scored against all correspondences"


class MetricsLogger:
    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._f = open(path, "a") if path else None
        self.records = []

    def log(self, **fields):
        rec = {"t": time.time(), **fields}
        self.records.append(rec)
        if self._f:
            self._f.write(json.dumps(rec) + "\n")
            self._f.flush()

    def summary(self) -> dict:
        frames = [r for r in self.records if "frame" in r]
        out = {"num_records": len(self.records), "num_frames": len(frames)}
        if frames:
            ms = [r["ms"] for r in frames if "ms" in r]
            if ms:
                out["mean_ms_per_frame"] = sum(ms) / len(ms)
                out["frames_per_s"] = 1000.0 / out["mean_ms_per_frame"]
            hyp = [r["hypotheses"] for r in frames if "hypotheses" in r]
            if hyp and ms:
                out["hypotheses_per_s"] = sum(hyp) / (sum(ms) / 1000.0)
        return out

    def close(self):
        if self._f:
            self._f.close()
            self._f = None
