"""Cost-model audit: predicted per-row step cost vs measured dispatch time.

``launch/costmodel.py`` feeds the router's view of what each nested
submodel row costs; nothing checks that view against the hardware the
engine actually runs on. This audit closes the loop: for every engine
iteration it accumulates the measured dispatch seconds into a
``(row, batch-bucket)`` cell (the bucket is the engine's padded
power-of-two token width, the width its operands are packed to), and
compares against the analytic decode-step HBM traffic for that cell.

The analytic model predicts *bytes*, the engine measures *seconds*, so a
bytes/sec scale must come from the run itself: the audit calibrates one
global effective bandwidth as the median implied bandwidth
(``predicted_bytes / measured_mean_s``) across all cells, then reports

    error_ratio(cell) = measured_mean_s / (predicted_bytes / bandwidth)

A ratio of 1 means the cell behaves exactly as the model predicts
*relative to the other cells*; systematic per-row drift (a low-rank row
dispatching slower than its byte count says it should) shows up as
ratios away from 1 — exactly the drift that would silently skew
``BudgetRouter`` decisions. Per-row predicted bytes scale the params
term by the row's deployed-param fraction (``cost_table[row] /
cost_table[-1]``); the KV-cache and activation terms are kept at the
full-model value (the paged cache is allocated rank-independently and
boundary activations are ``d_model``-shaped on every row).

Published as ``repro_costmodel_error_ratio{row=,bucket=}`` gauges and
surfaced as a table in ``/statusz``. Spec-decode rounds are *not*
audited — a round interleaves draft-row and verify-row dispatches in one
measured span, so there is no clean (row, bucket) attribution.
"""
from __future__ import annotations

import statistics
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = ["CostModelAudit"]


class CostModelAudit:
    """Accumulates measured dispatch time per (row, bucket) and audits it
    against the analytic cost model; see module docstring."""

    def __init__(self, cfg, cost_table, *, max_len: int = 256,
                 registry=None):
        self.cfg = cfg
        self.cost_table = np.asarray(cost_table, np.int64)
        self.max_len = max_len
        self.registry = registry
        # bucket -> (params_bytes, other_bytes) from the analytic model;
        # computed once per new bucket (the decode state on ``meta``)
        self._bucket_bytes: Dict[int, Tuple[float, float]] = {}
        # (row, bucket) -> [sum_seconds, count]
        self._meas: Dict[Tuple[int, int], List[float]] = {}
        self._since_publish = 0

    # ------------------------------------------------------------ predict

    def predicted_bytes(self, row: int, bucket: int) -> float:
        """Analytic decode-step HBM bytes for one (row, bucket) cell."""
        pb = self._bucket_bytes.get(bucket)
        if pb is None:
            from repro_torch.configs.base import ShapeConfig
            from repro_torch.launch.costmodel import memory_traffic
            shape = ShapeConfig("audit", self.max_len, max(bucket, 1),
                                "decode")
            out = memory_traffic(self.cfg, shape)
            pb = (out["params"], out["total"] - out["params"])
            self._bucket_bytes[bucket] = pb
        params_b, other_b = pb
        frac = float(self.cost_table[row]) / float(self.cost_table[-1])
        return params_b * frac + other_b

    # ------------------------------------------------------------ observe

    def observe(self, row: int, bucket: int, dispatch_s: float) -> None:
        """One measured engine iteration: ``dispatch_s`` seconds of
        forward on the host clock (dispatch and the read of the sampled
        ids) at padded token width ``bucket`` on ``row``."""
        cell = self._meas.get((row, bucket))
        if cell is None:
            cell = self._meas[(row, bucket)] = [0.0, 0.0]
            self.predicted_bytes(row, bucket)     # warm the bucket cache
        cell[0] += dispatch_s
        cell[1] += 1.0
        # recomputing every ratio per iteration is measurable in the hot
        # loop; refresh the gauges on a cadence (and on every statusz()
        # scrape, so the live table is always current)
        self._since_publish += 1
        if self.registry is not None and (
                self._since_publish >= 32 or cell[1] == 1.0):
            self._publish()

    # -------------------------------------------------------------- audit

    def _cells(self) -> List[dict]:
        out = []
        for (row, bucket), (sum_s, n) in sorted(self._meas.items()):
            if n == 0 or sum_s <= 0:
                continue
            out.append({"row": row, "bucket": bucket, "count": int(n),
                        "measured_mean_s": sum_s / n,
                        "predicted_bytes": self.predicted_bytes(row, bucket)})
        return out

    def bandwidth(self) -> Optional[float]:
        """Calibrated effective bytes/s: median implied bandwidth across
        cells (None until something was measured)."""
        cells = self._cells()
        if not cells:
            return None
        return statistics.median(
            c["predicted_bytes"] / c["measured_mean_s"] for c in cells)

    def error_ratios(self) -> Dict[Tuple[int, int], float]:
        """(row, bucket) -> measured/predicted time ratio at the
        calibrated bandwidth. The median cell is 1.0 by construction."""
        bw = self.bandwidth()
        if bw is None:
            return {}
        return {(c["row"], c["bucket"]):
                c["measured_mean_s"] * bw / c["predicted_bytes"]
                for c in self._cells()}

    def _publish(self) -> None:
        self._since_publish = 0
        bw = self.bandwidth()
        if bw is None:
            return
        g = self.registry.gauge(
            "repro_costmodel_error_ratio",
            "measured/predicted per-row dispatch time at the calibrated "
            "bandwidth (labels row, bucket)")
        for (row, bucket), ratio in self.error_ratios().items():
            g.labels(row=row, bucket=bucket).set(ratio)
        self.registry.gauge(
            "repro_costmodel_bandwidth_bytes_per_s",
            "median implied HBM bandwidth across audit cells").set(bw)

    # ------------------------------------------------------------ status

    def statusz(self) -> dict:
        """Audit table for ``/statusz``; also refreshes the gauges so a
        scrape never sees stale ratios from the publish cadence."""
        if self.registry is not None:
            self._publish()
        bw = self.bandwidth()
        ratios = self.error_ratios()
        cells = []
        for c in self._cells():
            cells.append({
                "row": c["row"], "bucket": c["bucket"], "count": c["count"],
                "measured_mean_ms": c["measured_mean_s"] * 1e3,
                "predicted_mb": c["predicted_bytes"] / 1e6,
                "error_ratio": ratios.get((c["row"], c["bucket"]))})
        return {"bandwidth_gb_per_s": None if bw is None else bw / 1e9,
                "cells": cells}
